"""The port's privacy-taint check (`repro_torch.analysis.taint`) held
against the JAX package's (`repro.analysis.taint`).

* The head: the 16 targets of `repro.analysis.taint._head_target_builders`
  (names read from the JAX module) run clean on the CPU in the port.
* Leak parity: each of the JAX leak fixtures (`tests/analysis_fixtures/
  leak_*.py`) checked by the JAX engine and its twin
  (`tests/torch_analysis_fixtures/`) checked by the port give exactly one
  finding each, with the same sink name (or `taint-callback` <->
  `taint-host-read`) and the same source labels; the JAX engine reports
  `<jaxpr>` as the path on this jax, so paths are compared only on the
  port's side.
* The engine's mechanics, the markers' registry rules, and the markers'
  runtime cost: none (same objects; rounds, taps, service periods and
  served logits bitwise equal with the markers replaced by plain
  passthroughs).
"""
import importlib.util
import os
import re

import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch.analysis import privacy as pprivacy
from repro_torch.analysis import taint
from repro_torch.analysis.privacy import (DECLASSIFIERS, SINKS,
                                          capture_declassifiers,
                                          declassifier, sink)
from repro_torch.analysis.registry import (capture_registrations,
                                           kernel_contract)
from repro_torch.analysis.taint import (EMPTY, SRC_DATA, SRC_OPT,
                                        SRC_PARAMS, TaintTarget,
                                        capture_targets, check_target,
                                        check_targets, run_labelled,
                                        taint_target)

HERE = os.path.dirname(__file__)
JAX_FIXDIR = os.path.join(HERE, "analysis_fixtures")
PORT_FIXDIR = os.path.join(HERE, "torch_analysis_fixtures")


def _check(fn, args, labels, name="t"):
    return check_target(TaintTarget(name, lambda: (fn, args, labels)))


def _load(path, prefix):
    spec = importlib.util.spec_from_file_location(
        prefix + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the head, and the JAX module's numbers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_target_names():
    from repro.analysis import taint as jtaint
    return [name for name, _ in jtaint._head_target_builders()]


def test_head_targets_are_the_jax_targets(jax_target_names):
    assert len(jax_target_names) == 16
    assert [t.name for t in taint.head_targets()] == jax_target_names


def test_head_targets_clean():
    findings = check_targets(taint.head_targets("cpu"), device="cpu")
    assert findings == [], [str(f) for f in findings]


def test_sinks_are_the_jax_sinks():
    from repro.analysis import privacy as jprivacy
    assert SINKS == jprivacy.SINKS
    assert len(SINKS) == 4


def test_declassifiers_are_the_jax_declassifiers():
    """The same 7 names, equations and justifications, each on the port's
    counterpart of the JAX function."""
    import repro.core.protocol  # noqa: F401 (fills the JAX registry)
    import repro.service.serving  # noqa: F401
    from repro.analysis.privacy import DECLASSIFIERS as JAX
    import repro_torch.core.protocol  # noqa: F401
    import repro_torch.service.serving  # noqa: F401
    assert set(DECLASSIFIERS) == set(JAX) and len(JAX) == 7
    for name, j in JAX.items():
        p = DECLASSIFIERS[name]
        assert (p.paper_eq, p.justification, p.qualname) == \
            (j.paper_eq, j.justification, j.qualname)
        assert p.module == j.module.replace("repro.", "repro_torch.", 1)


# ---------------------------------------------------------------------------
# leak parity with the JAX engine
# ---------------------------------------------------------------------------
LEAKS = [("leak_announce_field.py", "taint-sink", "taint-sink"),
         ("leak_metric_tap.py", "taint-callback", "taint-host-read"),
         ("leak_served_private.py", "taint-sink", "taint-sink")]


def _labels(message):
    return set(re.search(r"tainted by \{([^}]*)\}", message).group(1)
               .split(", "))


def _sink_name(message):
    m = re.search(r"sink '([^']+)'", message)
    return m and m.group(1)


@pytest.mark.parametrize("fname,jax_rule,port_rule", LEAKS,
                         ids=[f for f, _, _ in LEAKS])
def test_leak_fixture_matches_the_jax_engine(fname, jax_rule, port_rule):
    from repro.analysis import privacy as jprivacy
    from repro.analysis import taint as jtaint
    with jtaint.capture_targets() as jt, jprivacy.capture_declassifiers():
        _load(os.path.join(JAX_FIXDIR, fname), "_jax_leak_")
    jf = jtaint.check_targets(jt)
    with capture_targets() as pt, capture_declassifiers():
        _load(os.path.join(PORT_FIXDIR, fname), "_port_leak_")
    pf = check_targets(pt, device="cpu")
    assert len(jf) == 1 and len(pf) == 1, ([str(f) for f in jf],
                                           [str(f) for f in pf])
    (j,), (p,) = jf, pf
    assert (j.rule, p.rule) == (jax_rule, port_rule)
    assert _sink_name(p.message) == _sink_name(j.message)
    assert _labels(p.message) == _labels(j.message)
    # the port's finding points into the fixture, at the leaking line
    assert os.path.basename(p.path) == fname and p.line > 0


# ---------------------------------------------------------------------------
# engine mechanics
# ---------------------------------------------------------------------------
def test_declassifier_clears_its_output_and_not_its_input():
    from repro_torch.core.chain import fnv1a_commit

    def fn(r):
        c = fnv1a_commit(r)
        return c, r

    run = run_labelled("d", fn, (torch.ones((2, 3), dtype=torch.int32),),
                       (SRC_PARAMS,))
    c, r = run.out
    assert run.findings == []
    assert run.engine.labels(c) == EMPTY
    assert run.engine.labels(r) == {SRC_PARAMS}
    assert _check(lambda r: sink("chain-announcement", fnv1a_commit(r)),
                  (torch.ones((2, 3), dtype=torch.int32),),
                  (SRC_PARAMS,)) == []
    bad = _check(lambda r: sink("chain-announcement", r),
                 (torch.ones((2, 3), dtype=torch.int32),), (SRC_PARAMS,))
    assert [f.rule for f in bad] == ["taint-sink"]


def test_identity_declassifier_returns_a_clean_clone():
    """An identity declassifier (public_ref_logits) must not clear its
    input's labels, which share the output's storage at runtime."""
    from repro_torch.core.exchange import public_ref_logits

    def fn(x):
        return public_ref_logits(x), x

    run = run_labelled("id", fn, (torch.ones(3),), (SRC_DATA,))
    out, x = run.out
    assert out is not x and torch.equal(out, x)
    assert run.engine.labels(out) == EMPTY
    assert run.engine.labels(x) == {SRC_DATA}


def test_in_place_write_through_a_view_taints_its_base():
    def fn(p, buf):
        view = buf[1:]
        view.add_(p.sum())
        return buf

    run = run_labelled("v", fn, (torch.ones(3), torch.zeros(4)),
                       (SRC_PARAMS, ""))
    assert run.engine.labels(run.out) == {SRC_PARAMS}
    # out= writes add the union to the target
    run = run_labelled("o", lambda d, out: torch.add(d, 1, out=out),
                       (torch.ones(2), torch.zeros(2)), (SRC_DATA, ""))
    assert run.engine.labels(run.out) == {SRC_DATA}


def test_fresh_outputs_do_not_inherit_a_reused_address():
    """A fresh op output is SET to its inputs' labels, and a label whose
    storage died does not stick to a new storage at the same address."""
    def fn(p):
        t = p * 2
        del t
        return torch.zeros(3)

    run = run_labelled("r", fn, (torch.ones(3),), (SRC_PARAMS,))
    assert run.engine.labels(run.out) == EMPTY


def test_autograd_grad_of_a_tainted_loss_gives_tainted_grads():
    def fn(w, x):
        w = w.detach().requires_grad_(True)
        loss = (w * x).square().sum()
        (g,) = torch.autograd.grad(loss, [w])
        return g

    run = run_labelled("g", fn, (torch.ones(3), torch.ones(3)),
                       ("", SRC_DATA))
    assert run.engine.labels(run.out) == {SRC_DATA}


def test_update_phase_params_carry_every_source():
    t = {x.name: x for x in taint.head_targets("cpu")}
    run = taint.run_target(t["phase-update"])
    params, opt_state, metrics = run.out
    assert run.findings == []
    for leaf in params.values():
        assert run.engine.labels(leaf) == {SRC_PARAMS, SRC_OPT, SRC_DATA}
    assert run.engine.of(opt_state) == {SRC_PARAMS, SRC_OPT, SRC_DATA}


def test_registered_wrapper_unions_its_inputs_labels():
    """A kernel the mode cannot see (here a write through numpy into a
    fresh buffer) gets its inputs' labels only through the registered
    wrapper."""
    from repro_torch.kernels.build import CudaKernel

    def opaque(x, y):
        out = torch.empty_like(x)
        out.numpy()[:] = 1.0          # invisible to the dispatch mode
        return out

    with capture_registrations():
        fake = CudaKernel("fixture_fake", "hamming.cu", "hamming_all_pairs",
                          [])
        wrapped = kernel_contract(
            kernel=fake, stands_for="hamming", twin="hamming_all_pairs_ref",
            exactness="exact", points=({},),
            make_args=lambda p: ((), {}))(opaque)
    args, labels = (torch.ones(2), torch.ones(2)), (SRC_PARAMS, SRC_DATA)
    run = run_labelled("k", wrapped, args, labels)
    assert run.engine.labels(run.out) == {SRC_PARAMS, SRC_DATA}
    assert run.engine.kernels == {"fixture_fake"}
    assert run_labelled("k", opaque, args, labels).engine.labels(
        run_labelled("k", opaque, args, labels).out) == EMPTY
    # at runtime the wrapper returns the wrapped function's object
    assert torch.equal(wrapped(*args), opaque(*args))


def test_exchange_output_before_the_declassifier_is_tainted():
    """The exchange of a web that did not pass public_ref_logits carries
    client-params and client-data, and the wrapper's rule fired (the
    card's probe in chip_smoke.py, on the CPU's plain version)."""
    from repro_torch.core import protocol
    from repro_torch.kernels import exchange
    t = taint._tiny("cpu")
    fed, apply_fn = t["fed"], t["apply_fn"]

    def fn(st, d):
        sel = protocol.select_phase(st, fed)
        own = torch.stack([apply_fn(protocol.client(st.params, i),
                                    d["x_ref"][i]) for i in range(t["m"])])
        web = own[sel.ids.long()]
        return exchange.fused_exchange(own, web, d["y_ref"], sel.sel_mask)

    run = run_labelled("probe", fn, (t["state"], t["data"]),
                       (taint._fed_labels(t["state"]),
                        taint._data_labels(t["data"])))
    assert run.findings == []
    assert "exchange" in run.engine.kernels
    l_ij, valid, target, has = run.out
    assert {SRC_PARAMS, SRC_DATA} <= run.engine.labels(target)
    assert {SRC_PARAMS, SRC_DATA} <= run.engine.labels(l_ij)


def test_host_read_flagged_only_when_tainted():
    def reads(p, r):
        r.item()
        r.tolist()
        int(r)
        p.sum().item()
        return p

    fs = _check(reads, (torch.ones(3), torch.zeros(())), (SRC_PARAMS, ""))
    assert [f.rule for f in fs] == ["taint-host-read"]
    assert "item" in fs[0].message and fs[0].path.endswith(
        "test_torch_taint.py")

    def branch(p):
        if p.sum() > 0:               # a Python if on a private value
            return p
        return -p

    fs = _check(branch, (torch.ones(3),), (SRC_DATA,))
    assert [f.rule for f in fs] == ["taint-host-read"]
    assert "__bool__" in fs[0].message
    fs = _check(lambda p: p.cpu(), (torch.ones(3),), (SRC_OPT,))
    assert [f.rule for f in fs] == ["taint-host-read"]


def test_trace_error_is_a_finding():
    def boom(x):
        raise RuntimeError("nope")

    fs = _check(boom, (torch.ones(2),), ("",), name="boom-target")
    assert [f.rule for f in fs] == ["taint-trace-error"]
    assert "boom-target" in fs[0].message


def test_label_arity_mismatch_is_a_finding():
    fs = _check(lambda a, b: a + b, (torch.ones(2), torch.ones(2)),
                (SRC_PARAMS,))
    assert [f.rule for f in fs] == ["taint-trace-error"]


# ---------------------------------------------------------------------------
# registry rules
# ---------------------------------------------------------------------------
def test_sink_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown sink"):
        sink("not-a-sink", torch.zeros(()))


def test_declassifier_requires_justification():
    with pytest.raises(ValueError, match="justification"):
        declassifier(name="x", paper_eq="Eq. 0", justification="  ")


def test_declassifier_name_collision_rejected():
    with capture_declassifiers():
        @declassifier(name="collide-test", paper_eq="Eq. 0",
                      justification="first")
        def first(x):
            return x

        with pytest.raises(ValueError, match="already registered"):
            @declassifier(name="collide-test", paper_eq="Eq. 0",
                          justification="second")
            def second(x):
                return x
    assert "collide-test" not in DECLASSIFIERS


def test_capture_targets_isolated():
    before = dict(taint.TARGETS)
    with capture_targets() as got:
        taint_target(name="tmp-target",
                     build=lambda: (lambda x: x, (torch.ones(2),), ("",)))
    assert [t.name for t in got] == ["tmp-target"]
    assert taint.TARGETS == before


# ---------------------------------------------------------------------------
# no runtime cost
# ---------------------------------------------------------------------------
def test_markers_are_runtime_passthroughs():
    from repro_torch.core.exchange import public_ref_logits
    from repro_torch.core.rounds import release_round_telemetry
    from repro_torch.service.serving import served_logits
    x = torch.ones(2, 3)
    assert not pprivacy._ACTIVE[0]
    assert public_ref_logits(x) is x and served_logits(x) is x
    assert sink("serving-response", x) is x
    d = {"a": torch.zeros(())}
    assert release_round_telemetry(d) is d


def _strip_markers(monkeypatch):
    """Replace every marker by a plain passthrough (the wrapped function
    for the declassifiers, the identity for the sinks)."""
    from repro_torch.core import (chain, exchange, lsh, protocol, ranking,
                                  rounds, verify)
    from repro_torch.service import driver, serving
    for mod, name in ((lsh, "stacked_lsh_codes"), (chain, "fnv1a_commit"),
                      (protocol, "fnv1a_commit"), (verify, "fnv1a_commit"),
                      (exchange, "public_ref_logits"),
                      (protocol, "public_ref_logits"),
                      (ranking, "make_ranking"), (ranking, "ranking_scores"),
                      (rounds, "release_round_telemetry"),
                      (serving, "served_logits")):
        monkeypatch.setattr(mod, name, getattr(mod, name).__wrapped__)
    for mod in (protocol, rounds, driver, serving):
        monkeypatch.setattr(mod, "sink", lambda name, value: value)


def _round_trip():
    """A tapped wpfed segment, a tapped service segment and a served
    batch on the tiny federation: (states, taps, served logits)."""
    from repro_torch.core import protocol
    from repro_torch.core.rounds import make_segment_fn
    from repro_torch.service import driver
    from repro_torch.service.membership import (ServiceConfig,
                                                init_service_state)
    from repro_torch.service.serving import PersonalizedServer
    t = taint._tiny("cpu")
    taps = []
    prog = protocol.wpfed_program(t["apply_fn"], t["opt"], t["fed"])
    st, m1 = make_segment_fn(prog, 3, metrics_tap=taps.append)(
        t["state"], t["data"])
    svc = ServiceConfig(reselect_every=2)
    sprog = driver.service_program(t["apply_fn"], t["opt"], t["fed"], svc)
    sst, m2 = make_segment_fn(sprog, 2, metrics_tap=taps.append)(
        init_service_state(st, svc), t["data"])
    server = PersonalizedServer(t["apply_fn"], sst.fed.params)
    for i in range(t["m"]):
        server.submit(i, t["data"]["x_test"][i, 0])
    taps = [{k: v for k, v in d.items() if k != "seconds"} for d in taps]
    return (st, sst), taps, server.flush()


def test_rounds_taps_and_serving_bitwise_equal_without_markers(monkeypatch):
    from repro_torch.tree import tree_leaves
    states, taps, served = _round_trip()
    _strip_markers(monkeypatch)
    states2, taps2, served2 = _round_trip()
    a, b = tree_leaves(states), tree_leaves(states2)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert taps == taps2 and len(taps) == 5
    assert all((x == y).all() for x, y in zip(served, served2))


# ---------------------------------------------------------------------------
# telemetry and served logits
# ---------------------------------------------------------------------------
def test_round_telemetry_rejects_non_scalars():
    from repro_torch.core.rounds import release_round_telemetry
    with pytest.raises(ValueError, match="scalars only"):
        release_round_telemetry({"v": torch.ones(3)})
    with pytest.raises(ValueError, match="scalars only"):
        release_round_telemetry({"v": 1.5})     # as JAX: no ndim, no release
    out = release_round_telemetry({"v": torch.ones(())})
    assert out["v"].ndim == 0


def test_metrics_tap_delivers_the_round_scalars():
    """The tap gets every 0-d metric as a Python number and the Python
    numbers themselves; per-client tensors stay out."""
    from repro_torch.core import protocol
    from repro_torch.core.rounds import make_segment_fn
    t = taint._tiny("cpu")
    taps = []
    prog = protocol.wpfed_program(t["apply_fn"], t["opt"], t["fed"])
    _, metrics = make_segment_fn(prog, 2, metrics_tap=taps.append)(
        t["state"], t["data"])
    assert len(taps) == 2
    for tap, m in zip(taps, metrics):
        want = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in m.items()
                if not isinstance(v, torch.Tensor) or v.ndim == 0}
        assert tap == want
        assert "neighbor_ids" not in tap and "mean_loss" in tap


def test_served_logits_leave_the_logits_unchanged():
    from repro_torch.service.serving import PersonalizedServer
    t = taint._tiny("cpu")
    ps = t["state"].params
    server = PersonalizedServer(t["apply_fn"], ps)
    x = t["data"]["x_test"][:, 0] + 0.5
    got = server._forward(torch.arange(t["m"]), x)
    want = torch.stack([t["apply_fn"]({k: v[i] for k, v in ps.items()},
                                      x[i][None])[0]
                        for i in range(t["m"])])
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)
