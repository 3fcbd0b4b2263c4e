"""The port's analysis gate (`repro_torch.analysis`): the kernel registry
against the JAX package's contracts, its completeness, the host-sync
lint, the seeded-bad fixtures under `tests/torch_analysis_fixtures/` and
the CLI. The taint check is `tests/test_torch_taint.py`.

Parity: every JAX contract name (`repro.analysis.registry.REGISTRY`) has
at least one port entry standing for it; the JAX entries' declared
`pallas_call` sites add up to the sites `pallas_call_lines` finds in
their files (10 in 9 functions); every port entry names a twin in
`kernels/ref.py`, and on the CPU (where each wrapper takes its plain
version) the twin call equals the wrapper exactly.
"""
import json
import os
import shutil
from pathlib import Path

import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import exemptions
from repro_torch.analysis import kernel_contracts as kc
from repro_torch.analysis.host_lint import (collect_host_ok, lint_file,
                                            lint_paths, lint_source)
from repro_torch.analysis.registry import (capture_registrations,
                                           kernel_contract)
from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.tree import tree_leaves

FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"


@pytest.fixture(scope="module")
def entries():
    return kc.head_entries()


@pytest.fixture(scope="module")
def jax_entries():
    from repro.analysis.kernel_contracts import head_entries
    return head_entries()


# ---------------------------------------------------------------------------
# registry parity with the JAX contracts
# ---------------------------------------------------------------------------
def test_every_jax_contract_has_a_port_entry(entries, jax_entries):
    jax_names = {e.name for e in jax_entries}
    assert len(jax_names) == 9
    assert {e.stands_for for e in entries} == jax_names
    assert len(entries) == 10
    assert sorted(e.name for e in entries
                  if e.stands_for == "selection_ann") == [
        "selection_ann", "selection_ann_grouped"]


def test_jax_sites_are_the_pallas_calls_of_their_files(jax_entries):
    from repro.analysis.kernel_contracts import (_entry_loc,
                                                 pallas_call_lines)
    by_file = {}
    for e in jax_entries:
        path = os.path.realpath(_entry_loc(e)[0])
        by_file[path] = by_file.get(path, 0) + e.sites
    assert {os.path.basename(p): n for p, n in by_file.items()} == {
        "exchange.py": 3, "flash_attention.py": 1, "hamming.py": 1,
        "lsh_projection.py": 2, "selection.py": 3}
    for path, sites in by_file.items():
        assert len(pallas_call_lines(path)) == sites, path


@pytest.mark.parametrize("name", [
    "exchange", "exchange_streamed", "flash_attention", "hamming",
    "lsh_projection", "lsh_single", "selection", "selection_ann",
    "selection_ann_grouped", "selection_tiled"])
def test_entry_twin_is_the_wrappers_plain_version(entries, name):
    """Each entry names a real twin, and its twin call on the contract
    point's inputs equals the wrapper's CPU path bit for bit."""
    (e,) = [x for x in entries if x.name == name]
    assert hasattr(ref, e.twin) and e.exactness in ("exact", "tolerance")
    assert isinstance(e.kernel, CudaKernel)
    args, kwargs = e.make_args(e.points[0])
    got = e.fn(*args, **kwargs)
    want = (e.twin_call(args, kwargs) if e.twin_call is not None
            else getattr(ref, e.twin)(*args, **kwargs))
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    ok, err = kc.compare(e, got, want)
    assert ok and err == 0.0


def test_kernel_contract_rejects_unknown_exactness():
    k = CudaKernel("fixture_k", "hamming.cu", "hamming_all_pairs", [])
    with pytest.raises(ValueError, match="unknown exactness"):
        kernel_contract(kernel=k, stands_for="hamming", twin="x",
                        exactness="bit_exact", points=({},),
                        make_args=lambda p: ((), {}))


def test_compare_holds_each_class():
    with capture_registrations():
        k = CudaKernel("fixture_cmp", "hamming.cu", "hamming_all_pairs", [])
        kernel_contract(kernel=k, stands_for="hamming", twin="x",
                        exactness="tolerance", rtol=1e-5, atol=1e-6,
                        points=({},), make_args=lambda p: ((), {}))(
            lambda: None)
        (e,) = [x for x in kc.REGISTRY.values() if x.name == "fixture_cmp"]
    ids = torch.tensor([1, 2], dtype=torch.int32)
    w = torch.tensor([1.0, -torch.inf])
    ok, err = kc.compare(e, (ids, w), (ids, w * (1 + 1e-6)))
    assert ok and err == pytest.approx(1e-6, rel=0.1)
    assert not kc.compare(e, (ids, w), (ids + 1, w))[0]
    assert not kc.compare(e, (ids, w), (ids, w + 1e-3))[0]


# ---------------------------------------------------------------------------
# completeness
# ---------------------------------------------------------------------------
def test_head_contracts_and_completeness_clean(entries):
    assert kc.check_entries(entries) == []
    assert kc.completeness_findings(entries) == []


def test_every_exported_symbol_and_cuda_kernel_is_registered(entries):
    exported = {s for cu in kc.CSRC.glob("*.cu")
                for s in kc.exported_symbols(cu)}
    declared = {s for e in entries for s in (e.kernel.symbol, *e.helpers)}
    assert exported == declared and len(exported) == 15
    assert len({id(e.kernel) for e in entries}) == 10
    sites = sum(len(kc.cuda_kernel_lines(p))
                for p in kc.PORT_ROOT.rglob("*.py"))
    assert sites == 10


def test_a_stray_c_symbol_is_unregistered(entries, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kc.CSRC, csrc)
    with open(csrc / "hamming.cu", "a") as fh:
        fh.write('\nextern "C" int hamming_stray(int n) { return n; }\n')
    fs = kc.completeness_findings(entries, csrc=csrc)
    assert [f.rule for f in fs] == ["unregistered-kernel"]
    assert "hamming_stray" in fs[0].message


BAD_CONTRACTS = [("bad_unregistered_kernel.py", "unregistered-kernel"),
                 ("bad_missing_twin.py", "oracle-missing"),
                 ("bad_missing_helper.py", "estimator-missing")]


@pytest.mark.parametrize("fname,rule", BAD_CONTRACTS,
                         ids=[f for f, _ in BAD_CONTRACTS])
def test_contract_fixture_trips_its_rule(fname, rule):
    from repro_torch.analysis.registry import REGISTRY
    before = dict(REGISTRY)
    fs = cli.check_fixture_file(str(FIXTURES / fname))
    assert [f.rule for f in fs] == [rule], [str(f) for f in fs]
    assert os.path.basename(fs[0].path) == fname
    assert REGISTRY == before          # the fixture left no registration


# ---------------------------------------------------------------------------
# the host-sync lint
# ---------------------------------------------------------------------------
def test_head_lint_clean():
    fs = lint_paths(cli.default_lint_paths())
    assert fs == [], "\n".join(str(f) for f in fs)


def test_host_ok_inventory_equals_the_pin():
    inventory = collect_host_ok(cli.default_lint_paths())
    assert len(inventory) == exemptions.EXPECTED_HOST_OK
    assert all(why.split("host-ok", 1)[1].strip() for _, _, why in inventory)
    _, drift = cli.host_ok_findings(cli.default_lint_paths())
    assert drift == []


def test_host_ok_drift_fails_strict(monkeypatch, capsys):
    from repro_torch.analysis import taint
    monkeypatch.setattr(exemptions, "EXPECTED_HOST_OK",
                        exemptions.EXPECTED_HOST_OK + 1)
    monkeypatch.setattr(taint, "head_targets", lambda device: [])
    assert cli.run(["--device", "cpu"]) == 0          # a warning
    assert cli.run(["--device", "cpu", "--strict"]) == 1
    assert "host-ok-drift" in capsys.readouterr().out


def test_bad_host_sync_and_exemption_covers_its_own_line_only():
    fs = lint_file(str(FIXTURES / "bad_host_sync.py"))
    assert [(f.rule, f.line) for f in fs] == [("host-sync", 8),
                                              ("host-sync", 13)]


def test_bad_unseeded_draw():
    fs = lint_file(str(FIXTURES / "bad_unseeded_draw.py"))
    assert [(f.rule, f.line) for f in fs] == [("unseeded-draw", 8)]


def test_lint_rules():
    src = "\n".join([
        "import numpy as np",
        "import torch",
        "def f(x, g, t):",
        "    a = x.to('cpu')",                                    # 4
        "    b = x.to(device=torch.device('cpu'))",               # 5
        "    torch.cuda.synchronize()",                           # 6
        "    c = int(x.sum())",                                   # 7
        "    d = float(np.mean(t))",
        "    e = bool(x.any())",                                  # 9
        "    x.uniform_(0, 1)",                                   # 10
        "    x.uniform_(0, 1, generator=g)",
        "    torch.nn.init.normal_(x)",                           # 12
        "    y = torch.randint(0, 5, (3,),",
        "                      generator=g)",
        "    z = x.to(torch.float32)",
        "    w = x.numpy(",
        "    )  # analysis: host-ok the comment may sit on any line of it",
        "    # analysis: host-ok exempts nothing here",            # 18
        "    return a, b, c, d, e, y, z, w",
    ])
    got = [(f.rule, f.line, f.severity) for f in lint_source(src, "m.py")]
    assert got == [("host-sync", 4, "error"), ("host-sync", 5, "error"),
                   ("host-sync", 6, "error"), ("host-sync", 7, "error"),
                   ("host-sync", 9, "error"), ("unseeded-draw", 10, "error"),
                   ("unseeded-draw", 12, "error"),
                   ("host-ok-unused", 18, "warning")]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _payload(path):
    d = json.loads(Path(path).read_text())
    assert d.pop("wall_time_s") > 0
    return d


def test_cli_strict_clean_and_deterministic_json(tmp_path, capsys):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert cli.run(["--device", "cpu", "--strict", "--json", str(a)]) == 0
    assert cli.run(["--device", "cpu", "--strict", "--json", str(b)]) == 0
    pa, pb = _payload(a), _payload(b)
    assert pa == pb
    assert pa["clean"] and pa["device"] == "cpu" and pa["total"] == 0
    assert len(pa["kernel_entries"]) == 10 and len(pa["taint_targets"]) == 16
    assert pa["host_ok"]["count"] == exemptions.EXPECTED_HOST_OK
    assert "clean (0 findings)" in capsys.readouterr().out


ALL_FIXTURES = BAD_CONTRACTS + [
    ("bad_host_sync.py", "host-sync"),
    ("bad_unseeded_draw.py", "unseeded-draw"),
    ("leak_announce_field.py", "taint-sink"),
    ("leak_metric_tap.py", "taint-host-read"),
    ("leak_served_private.py", "taint-sink")]


@pytest.mark.parametrize("fname,rule", ALL_FIXTURES,
                         ids=[f for f, _ in ALL_FIXTURES])
def test_each_fixture_fails_the_strict_cli(fname, rule, tmp_path):
    out = tmp_path / "r.json"
    assert cli.run(["--device", "cpu", "--strict", "--json", str(out),
                    str(FIXTURES / fname)]) == 1
    assert set(json.loads(out.read_text())["rules"]) == {rule}


def test_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--strict"])
    # the lint of a path needs no device
    assert cli.run([str(FIXTURES / "bad_unseeded_draw.py")]) == 1


def test_warnings_fail_only_strict(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("x = 1  # analysis: host-ok nothing to exempt\n")
    assert cli.run(["--device", "cpu", str(f)]) == 0
    assert cli.run(["--device", "cpu", "--strict", str(f)]) == 1
