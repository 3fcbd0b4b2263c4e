"""The port's twins of the JAX package's smoke scripts and examples
(`scripts/torch_*_smoke.py`, `examples/torch_*.py`) held against the JAX
originals on the CPU. Each twin is imported by path; what an existing
test already holds against JAX (the service's rounds, kill/resume under a
fault plan, the selection paths, the attacks) is not repeated: these
tests hold the scripts' own composition.

Inputs that JAX draws in the original are carried across as numpy (the
client state through `_port_state`). `tests/test_torch_examples_attack.py`
holds the attack-resilience example. Tolerances:

* the service fixture, fault trace, degraded rounds and resume period,
  ANN ids, candidates and recall, tiled selection ids, the train_lm
  config: exact;
* tiled selection weights: within 2 ulps of the JAX oracle's (torch's
  and XLA's f32 exp give Eq. 8 table entries 1 ulp apart, as in
  `tests/test_torch_tiled.py`);
* the streamed exchange: l_ij and target within rtol 2e-5, atol 1e-5,
  the §3.5 mask equal (the JAX script's contract);
* quickstart's LSH codes: every bit equal but where the JAX projection
  sum is within 1e-3 of 0 (`ROADMAP.md`, rules), the Hamming values
  equal on pairs of codes without such a bit.
"""
import dataclasses
import functools
import importlib.util
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs as jconfigs
from repro import service as jsvc
from repro.configs.paper_models import FedConfig as JaxFedConfig
from repro.core import ann as jann
from repro.core import init_state as jax_init_state
from repro.core.chain import Blockchain as JaxBlockchain
from repro.core.neighbor import select_partners as jax_select_partners
from repro.kernels import ops as jops
from repro.kernels import ref as jref

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import backends
from repro_torch.kernels.build import MAX_SHARED_BYTES
from test_torch_protocol import _port_state, _t
from test_torch_tiled import _ulps

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def load(path: str):
    """A script or example of the repository, imported from its file."""
    name = "_twin_" + Path(path).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _clone(state):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


def _codes(codes) -> torch.Tensor:
    """JAX uint32 codes -> the port's int32 words, bit for bit."""
    return torch.from_numpy(np.asarray(codes).view(np.int32).copy())


# ---------------------------------------------------------------------------
# every twin: the card unless told
# ---------------------------------------------------------------------------
TWINS = ("scripts/torch_service_smoke.py", "scripts/torch_chaos_smoke.py",
         "scripts/torch_ann_smoke.py", "scripts/torch_tiled_smoke.py",
         "examples/torch_attack_resilience.py", "examples/torch_quickstart.py",
         "examples/torch_serve_batch.py", "examples/torch_train_lm.py")


@pytest.mark.parametrize("path", TWINS)
def test_twin_needs_a_card_unless_told(path, monkeypatch):
    """Without a card and without `--device cpu` a twin raises before any
    work (its process exits non-zero); it never falls back to the CPU."""
    twin = load(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])


# ---------------------------------------------------------------------------
# the service fixture and the chaos soak
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def service_jax():
    """The JAX script's fixture and its state from PRNGKey(0)."""
    fed, apply_fn, init_fn, opt, data = load("scripts/service_smoke.py").build()
    state = jax_init_state(apply_fn, init_fn, opt, fed, jax.random.PRNGKey(0))
    return {"fed": fed, "apply_fn": apply_fn, "opt": opt, "data": data,
            "state": state}


def test_service_build_equals_jax(service_jax):
    """The twin's fixture is the JAX script's, config and array for
    array, exactly."""
    fed, _, _, _, data = load("scripts/torch_service_smoke.py").build(
        device=torch.device("cpu"))
    assert dataclasses.asdict(fed) == dataclasses.asdict(service_jax["fed"])
    assert sorted(data) == sorted(service_jax["data"])
    for k, v in service_jax["data"].items():
        assert data[k].dtype == _t(v).dtype, k
        assert np.array_equal(data[k].numpy(), np.asarray(v)), k


def test_chaos_soak_matches_jax_run_f(service_jax, monkeypatch):
    """The whole soak passes on the CPU from the JAX state carried across;
    its run F's fault trace and degraded-round count equal the JAX
    script's run F on the same fixture, exactly, and it resumes at
    period 1."""
    jcs = load("scripts/chaos_smoke.py")
    svc = jsvc.ServiceConfig(reselect_every=3, keep_last_k=2)
    xp = jsvc.BulletinTransport(JaxBlockchain(), plan=dataclasses.replace(
        jcs.PLAN, crash_periods=()))
    _, _, hist = jsvc.run_service(
        service_jax["apply_fn"], service_jax["opt"], service_jax["fed"], svc,
        jsvc.init_service_state(service_jax["state"], svc),
        service_jax["data"], periods=jcs.PERIODS, transport=xp)
    jtrace = xp.trace.snapshot()
    jdegraded = sum(h.get("degraded_round", 0) for h in hist)

    twin = load("scripts/torch_chaos_smoke.py")
    assert dataclasses.asdict(twin.PLAN) == dataclasses.asdict(jcs.PLAN)
    assert (twin.PERIODS, twin.ACC_TOLERANCE) == \
        (jcs.PERIODS, jcs.ACC_TOLERANCE)
    pmc = pcfg.ClientModelConfig("smoke-mlp", "mlp", (16,), 3, hidden=(32,))
    carried = _port_state(service_jax["state"], pmc)
    monkeypatch.setattr(twin, "init_state", lambda *a: _clone(carried))
    res = twin.main(CPU)
    print("JAX", jtrace, jdegraded, "port", res)
    assert res["fault_trace"] == jtrace
    assert res["degraded_rounds"] == int(jdegraded)
    assert res["resume_period"] == 1


# ---------------------------------------------------------------------------
# ANN selection
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ann_jax():
    return load("scripts/ann_smoke.py")


def test_ann_one_bucket_matches_jax(ann_jax):
    """On the JAX script's codes, the one-bucket ids equal JAX
    `select_partners(backend="ann")` exactly."""
    m, bits, n = 256, 128, 12
    codes = ann_jax._clustered_codes(m, bits, m // 32, seed=7)
    scores = jax.random.uniform(jax.random.PRNGKey(8), (m,))
    fed = JaxFedConfig(
        num_clients=m, num_neighbors=n, lsh_bits=bits, ann_prefix_bits=0,
        ann_probes=0)
    jids, _ = jax_select_partners(codes, scores, fed, backend="ann", seed=9)
    ids = load("scripts/torch_ann_smoke.py").one_bucket_ids(
        _codes(codes), _t(scores), n, bits)
    assert np.array_equal(ids.numpy(), np.asarray(jids))


def test_ann_recall_matches_jax(ann_jax):
    """At M = 2,048 on the JAX script's codes: the candidate ids equal
    `ann_candidates`' and the recall equals the JAX recall, exactly. The
    port is held to the reference's measured recall, not the 0.9 bar."""
    m, bits, n = 2048, 256, 12
    codes = ann_jax._clustered_codes(m, bits, m // 32, seed=3)
    scores = 0.75 + 0.25 * jax.random.uniform(jax.random.PRNGKey(5), (m,))
    kw = dict(bits=bits, gamma=1.0, num_neighbors=n)
    ids_e, _ = jax.jit(functools.partial(jref.fused_select_ref, **kw))(
        codes, scores)
    cand = jann.ann_candidates(codes, scores, seed=6, prefix_bits=7,
                               probes=7, num_neighbors=n)
    ids_a, _ = jax.jit(functools.partial(jref.ann_select_ref, **kw))(
        codes, scores, cand.ids)
    e, a = np.asarray(ids_e), np.asarray(ids_a)
    jrecall = sum(len(set(e[i]) & set(a[i])) for i in range(m)) / (m * n)
    recall, cand_ids = load("scripts/torch_ann_smoke.py").recall_at_n(
        _codes(codes), _t(scores), n, bits)
    print(f"recall@{n}: JAX {jrecall}, port {recall}")
    assert np.array_equal(cand_ids.numpy(), np.asarray(cand.ids))
    assert recall == jrecall


# ---------------------------------------------------------------------------
# tiled kernels
# ---------------------------------------------------------------------------
def test_tiled_shapes_are_past_the_oneshot_budget():
    """At the twin's shapes the port's estimators put both one-shot
    kernels past the card's shared memory, so "auto" tiles."""
    twin = load("scripts/torch_tiled_smoke.py")
    sel = inspect.signature(twin.smoke_selection).parameters
    exch = inspect.signature(twin.smoke_exchange).parameters
    est_s = backends.selection_oneshot_smem_bytes(sel["m"].default)
    est_e = backends.exchange_oneshot_smem_bytes(exch["n"].default,
                                                 exch["r"].default)
    for est in (est_s, est_e):
        assert est > MAX_SHARED_BYTES
        assert backends.resolve_tiling("auto", est) == "tiled"
    # one power of two below, the one-shot kernels fit
    assert backends.resolve_tiling("auto", backends.selection_oneshot_smem_bytes(
        sel["m"].default // 2)) == "oneshot"
    assert backends.resolve_tiling("auto", backends.exchange_oneshot_smem_bytes(
        exch["n"].default, exch["r"].default // 2)) == "oneshot"


def test_tiled_selection_matches_jax_oracle():
    """At M = 2,048 on JAX-drawn codes, the twin's tiled selection check
    returns the JAX oracle's ids bit for bit, its weights within 2
    ulps."""
    m, bits, n = 2048, 256, 16
    raw = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5, (m, bits))
    codes = jops.pack_bits(jnp.where(raw, 1.0, -1.0))
    scores = jax.random.uniform(jax.random.PRNGKey(1), (m,))
    jids, jw = jax.jit(functools.partial(
        jref.fused_select_ref, bits=bits, gamma=1.0, num_neighbors=n))(
            codes, scores)
    ids, w, _ = load("scripts/torch_tiled_smoke.py").check_selection(
        _codes(codes), _t(scores), n, bits)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.all(_ulps(w.numpy(), np.asarray(jw)) <= 2)


def test_tiled_exchange_matches_jax_streaming_twin():
    """On JAX-drawn logits (the JAX script's draws at M 2, N 8, R 64,
    C 1,024), the twin's streamed exchange check is within rtol 2e-5,
    atol 1e-5 of JAX `streamed_exchange_ref`, the mask equal."""
    m, n, r, c = 2, 8, 64, 1024
    k = jax.random.PRNGKey(2)
    own = jax.random.normal(k, (m, r, c)) * 3
    nb = jax.random.normal(jax.random.fold_in(k, 1), (m, n, r, c)) * 3
    y = jax.random.randint(jax.random.fold_in(k, 2), (m, r), 0, c)
    sel = jax.random.bernoulli(jax.random.fold_in(k, 3), 0.8, (m, n))
    jout = jax.jit(jref.streamed_exchange_ref)(own, nb, y, sel)
    out, _ = load("scripts/torch_tiled_smoke.py").check_exchange(
        _t(own), _t(nb), _t(y), _t(sel))
    for i in (0, 2):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(jout[i]),
                                   rtol=2e-5, atol=1e-5)
    for i in (1, 3):
        assert np.array_equal(out[i].numpy(), np.asarray(jout[i]))


# ---------------------------------------------------------------------------
# quickstart, batched serving, LM training
# ---------------------------------------------------------------------------
def test_quickstart_codes_and_distances_match_jax():
    """Quickstart's three 4,096-vectors (a near-copy and an unrelated
    one), drawn by JAX: the codes equal JAX's `ops.lsh_code` on every bit
    off the near-zero sums, the Hamming values JAX's `hamming_matrix`."""
    p_a = {"w": jax.random.normal(jax.random.PRNGKey(1), (4096,))}
    p_b = jax.tree.map(lambda x: x + 0.02 * jax.random.normal(
        jax.random.PRNGKey(2), x.shape), p_a)
    p_c = {"w": jax.random.normal(jax.random.PRNGKey(3), (4096,))}
    ps = (p_a, p_b, p_c)
    jcodes = jnp.stack([jops.lsh_code(p, seed=5, bits=256) for p in ps])
    jd = np.asarray(jops.hamming_matrix(jcodes))
    sums = np.stack([np.asarray(jref.lsh_project_sums_ref(
        jops.flatten_params(p), 5, bits=256)) for p in ps])
    near = np.abs(sums) <= 1e-3
    codes, d = load("examples/torch_quickstart.py").codes_and_distances(
        [{"w": _t(p["w"])} for p in ps])
    pbits = np.unpackbits(codes.numpy().view(np.uint8), bitorder="little")
    jbits = np.unpackbits(np.asarray(jcodes).view(np.uint8),
                          bitorder="little")
    print(f"{int(near.sum())} of {near.size} sums within 1e-3 of 0")
    assert np.array_equal(pbits.reshape(3, -1)[~near],
                          jbits.reshape(3, -1)[~near])
    clean = ~near.any(axis=1)
    pairs = clean[:, None] & clean[None, :]
    assert np.array_equal(d.numpy()[pairs], jd[pairs])
    assert d[0, 1] < d[0, 2]


def test_quickstart_runs_on_cpu(capsys):
    res = load("examples/torch_quickstart.py").main(CPU)
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    assert np.isfinite(res["train_loss"]) and len(res["greedy"]) == 5
    assert res["hamming_similar"] < res["hamming_unrelated"]


def test_serve_batch_prints_four_runs_on_cpu(capsys):
    res = load("examples/torch_serve_batch.py").main(CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "prefill" in ln and "tok/s" in ln]
    assert len(lines) == 4 and len(res["runs"]) == 4
    assert "window=16" in lines[1]


def test_train_lm_config_equals_jax():
    """The widened xlstm config equals the JAX script's field for field,
    with the same `param_count()`."""
    base = jconfigs.get_config("xlstm-350m")
    jcfg = dataclasses.replace(
        base.reduced(), name=base.name + "-100m",
        num_layers=4, d_model=768, num_heads=8, num_kv_heads=8,
        head_dim=96, vocab_size=32768)
    cfg = load("examples/torch_train_lm.py").widened_config("xlstm-350m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
