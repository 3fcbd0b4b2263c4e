"""The client axis as one batched call: the port's exchange, evaluation,
local update and baseline forwards run as `torch.func.vmap` over the
stacked (M, ...) client params, and the flash-attention op carries a
vmap rule. Held on the CPU against the JAX package's phases (which vmap
the same per-client function) and against per-client loops written here.

Inputs are drawn with numpy from a seed: JAX-shaped weights for 5
clients of a narrowed MLP, CNN and TCN (`test_torch_protocol.
SMALL_MODELS`), carried into the port by `params_from_jax`; the JAX
update's minibatch indices are injected through `batch_idx`.
Tolerances (those `test_torch_protocol.py` states):

* ids, masks and has_target: exact; per-client accuracies equal to the
  loop's and within rtol 1e-6 of JAX's (XLA's mean of the same hits
  rounds the last bit differently);
* forwards and the exchange's l_ij and target_ref: rtol 1e-5, atol 1e-6
  (f32 convolutions and matmuls reduce in another order when batched);
* one Adam step over the stacked state: rtol 1e-6;
* two local steps (params, losses): rtol 1e-4, atol 1e-6;
* the update in chunks of the client axis against one call: rtol 1e-6,
  atol 1e-7 (each client's arithmetic is the same; only the batch of the
  batched products differs);
* the flash op under vmap against its plain version on the folded batch:
  equal, since the rule calls that plain version on those tensors.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs.paper_models as jcfg
from repro.core import evaluate as jax_evaluate
from repro.core import exchange_phase as jax_exchange_phase
from repro.core import update_phase as jax_update_phase
from repro.core.exchange import ExchangeResult as JaxExchangeResult
from repro.core.protocol import SelectResult as JaxSelectResult
from repro.models import apply_client_model as jax_apply
from repro.models import init_client_model as jax_init
from repro.optim import adam as jax_adam

import repro_torch.configs.paper_models as pcfg
from repro_torch.analysis import taint
from repro_torch.core import baselines, distill
from repro_torch.core import protocol as P
from repro_torch.core.exchange import ExchangeResult, all_in_one_exchange
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam
from repro_torch.optim.optimizers import apply_updates
from test_torch_protocol import (SMALL_MODELS, _close, _np, _t,
                                 _update_batch_idx, program_apply)

M, N, R, N_LOCAL, N_TEST = 5, 3, 4, 12, 6
KINDS = sorted(SMALL_MODELS)


def _fwd_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module", params=KINDS)
def fed(request):
    """One narrowed model's federation of M clients on both sides."""
    kind = request.param
    spec = SMALL_MODELS[kind]
    jc, pc = jcfg.ClientModelConfig(**spec), pcfg.ClientModelConfig(**spec)
    classes = spec["num_classes"]
    rs = np.random.RandomState(11)
    shapes = jax.eval_shape(lambda k: jax_init(jc, k), jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda s: (rs.randn(M, *s.shape) * 0.3).astype(np.float32), shapes)
    data = {"x_train": rs.randn(M, N_LOCAL, *spec["input_shape"]),
            "y_train": rs.randint(0, classes, (M, N_LOCAL)),
            "x_ref": rs.randn(M, R, *spec["input_shape"]),
            "y_ref": rs.randint(0, classes, (M, R)),
            "x_test": rs.randn(M, N_TEST, *spec["input_shape"]),
            "y_test": rs.randint(0, classes, (M, N_TEST))}
    data = {k: v.astype(np.float32 if k[0] == "x" else np.int32)
            for k, v in data.items()}
    # N distinct neighbours per client, never itself; some slots unselected
    ids = np.stack([rs.permutation([j for j in range(M) if j != i])[:N]
                    for i in range(M)]).astype(np.int32)
    sel_mask = rs.rand(M, N) < 0.8
    sel_mask[0] = True
    return {"kind": kind, "jc": jc, "pc": pc, "params": params,
            "pparams": params_from_jax(pc, params), "data": data,
            "pdata": {k: _t(v) for k, v in data.items()},
            "ids": ids, "sel_mask": sel_mask,
            "japply": lambda p, x: jax_apply(jc, p, x),
            "papply": program_apply(pc)}


def _feds(ref_mode, **kw):
    jfed = jcfg.FedConfig(num_clients=M, num_neighbors=N, ref_mode=ref_mode,
                          dedupe_rankings=jcfg.recommended_dedupe(ref_mode),
                          **kw)
    return jfed, pcfg.FedConfig(**dataclasses.asdict(jfed))


def _psel(f):
    m = len(f["ids"])
    return P.SelectResult(_t(f["ids"]), _t(f["sel_mask"]),
                          torch.zeros(m), torch.ones(m, dtype=torch.bool))


def _loop_exchange(f, pfed):
    """The exchange with one forward per client and per (client,
    neighbour) pair."""
    apply_fn, p, d = f["papply"], f["pparams"], f["pdata"]
    m = len(f["ids"])
    with torch.no_grad():
        if pfed.ref_mode == "public":
            own = torch.stack([apply_fn(P.client(p, i), d["x_ref"][0])
                               for i in range(m)])
            web = own[_t(f["ids"]).long()]
            y_ref = d["y_ref"][0][None].expand(m, -1)
        else:
            own = torch.stack([apply_fn(P.client(p, i), d["x_ref"][i])
                               for i in range(m)])
            web = torch.stack([torch.stack([
                apply_fn(P.client(p, int(j)), d["x_ref"][i])
                for j in f["ids"][i]]) for i in range(m)])
            y_ref = d["y_ref"]
    return all_in_one_exchange(own, web, y_ref, _t(f["sel_mask"]), pfed)


def _same_exchange(got, want):
    assert np.array_equal(np.asarray(got.valid_mask),
                          np.asarray(want.valid_mask))
    assert np.array_equal(np.asarray(got.has_target),
                          np.asarray(want.has_target))
    _fwd_close(got.l_ij, want.l_ij)
    _fwd_close(got.target_ref, want.target_ref)


@pytest.mark.parametrize("ref_mode", ["personal", "public"])
def test_exchange_phase_matches_jax_and_the_loop(fed, ref_mode):
    jfed, pfed = _feds(ref_mode)
    jsel = JaxSelectResult(jnp.asarray(fed["ids"]),
                           jnp.asarray(fed["sel_mask"]), jnp.zeros(M),
                           jnp.ones(M, bool))
    want = jax_exchange_phase(fed["japply"], jfed,
                              jax.tree.map(jnp.asarray, fed["params"]),
                              {k: jnp.asarray(v)
                               for k, v in fed["data"].items()}, jsel)
    got = P.exchange_phase(fed["papply"], pfed, fed["pparams"], fed["pdata"],
                           _psel(fed))
    _same_exchange(got, want)
    _same_exchange(got, _loop_exchange(fed, pfed))


def test_evaluate_matches_jax_and_the_loop(fed):
    honest = np.array([1, 0, 1, 1, 0], np.float32)
    for mask in (None, honest):
        want = jax_evaluate(
            fed["japply"],
            types.SimpleNamespace(params=jax.tree.map(jnp.asarray,
                                                      fed["params"])),
            {k: jnp.asarray(v) for k, v in fed["data"].items()},
            honest_mask=None if mask is None else jnp.asarray(mask))
        got = P.evaluate(fed["papply"],
                         types.SimpleNamespace(params=fed["pparams"]),
                         fed["pdata"],
                         honest_mask=None if mask is None else _t(mask))
        np.testing.assert_allclose(got["per_client_acc"].numpy(),
                                   np.asarray(want["per_client_acc"]),
                                   rtol=1e-6)
        _fwd_close(float(got["mean_acc"]), float(want["mean_acc"]))
    d = fed["pdata"]
    with torch.no_grad():
        loop = torch.stack([distill.accuracy(
            fed["papply"](P.client(fed["pparams"], i), d["x_test"][i]),
            d["y_test"][i]) for i in range(M)])
    assert torch.equal(got["per_client_acc"], loop)


def _target(f):
    rs = np.random.RandomState(3)
    classes = SMALL_MODELS[f["kind"]]["num_classes"]
    return (rs.randn(M, R, classes).astype(np.float32),
            np.array([True, False, True, True, False]))


def _loop_update(apply_fn, pfed, opt, params, opt_state, data_per, target,
                 has, batch_idx):
    """Each client's local steps one after another, with
    `torch.autograd.grad` of the combined loss."""
    out_p, out_s, losses = [], [], []
    for i in range(len(has)):
        p, s = P.client(params, i), P.client(opt_state, i)
        for step in range(pfed.local_steps):
            idx = batch_idx[i, step]
            batch = {"x": data_per["x_train"][i][idx],
                     "y": data_per["y_train"][i][idx]}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            loss, (l_loc, l_ref) = distill.combined_loss(
                apply_fn, leaves, batch, data_per["x_ref"][i], target[i],
                has[i], pfed.alpha)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            updates, s = opt.update(grads, s, p)
            p = apply_updates(p, updates)
        out_p.append(p)
        out_s.append(s)
        losses.append(torch.stack([loss, l_loc, l_ref]).detach())
    return P.stack(out_p), P.stack(out_s), torch.stack(losses)


@pytest.mark.parametrize("ref_mode", ["personal", "public"])
def test_update_phase_matches_jax_and_the_loop(fed, ref_mode):
    """Two local Adam steps for every client (one with no distillation
    target); `participate` freezes two of them bitwise."""
    jfed, pfed = _feds(ref_mode, local_steps=2, local_batch=8, lr=1e-2)
    target, has = _target(fed)
    jopt, popt = jax_adam(jfed.lr), adam(pfed.lr)
    rng = jax.random.PRNGKey(5)
    jparams = jax.tree.map(jnp.asarray, fed["params"])
    jp, _, jm = jax_update_phase(
        fed["japply"], jopt, jfed, jparams, jax.vmap(jopt.init)(jparams),
        {k: jnp.asarray(v) for k, v in fed["data"].items()},
        JaxExchangeResult(None, None, jnp.asarray(target), jnp.asarray(has)),
        rng)
    pstate = P.stack([popt.init(P.client(fed["pparams"], i))
                      for i in range(M)])
    batch_idx = _update_batch_idx(rng, jfed, N_LOCAL)
    exch = ExchangeResult(None, None, _t(target), _t(has))
    pp, ps, pm = P.update_phase(fed["papply"], popt, pfed, fed["pparams"],
                                pstate, fed["pdata"], exch,
                                batch_idx=batch_idx)
    for k, v in params_from_jax(fed["pc"], _np(jp)).items():
        _close(pp[k].numpy(), v.numpy())
    for k in ("loss", "local_loss", "ref_loss"):
        _close(pm[k].numpy(), np.asarray(jm[k]))

    data_per = dict(fed["pdata"])
    if ref_mode == "public":
        data_per["x_ref"] = data_per["x_ref"][0][None].expand(
            M, *data_per["x_ref"].shape[1:])
    lp, ls, losses = _loop_update(fed["papply"], pfed, popt, fed["pparams"],
                                  pstate, data_per, _t(target), _t(has),
                                  batch_idx)
    for k in lp:
        _close(pp[k].numpy(), lp[k].numpy())
        for part in ("m", "v"):
            _close(ps[part][k].numpy(), ls[part][k].numpy())
    assert torch.equal(ps["step"], ls["step"])
    _close(torch.stack([pm["loss"], pm["local_loss"], pm["ref_loss"]],
                       1).numpy(), losses.numpy())

    part = torch.tensor([True, False, True, False, True])
    fp, fs, _ = P.update_phase(fed["papply"], popt, pfed, fed["pparams"],
                               pstate, fed["pdata"], exch,
                               batch_idx=batch_idx, participate=part)
    for k in fp:
        assert torch.equal(fp[k][~part], fed["pparams"][k][~part])
        assert torch.equal(fp[k][part], pp[k][part])
    assert torch.equal(fs["step"], torch.where(part, 2, 0).to(torch.int32))


def test_one_adam_step_over_the_stacked_state_matches_jax():
    rs = np.random.RandomState(4)
    params = {"a": rs.randn(M, 3, 4).astype(np.float32),
              "b": rs.randn(M, 4).astype(np.float32)}
    grads = {k: rs.randn(*v.shape).astype(np.float32) * 1e-2
             for k, v in params.items()}
    jopt, popt = jax_adam(1e-2), adam(1e-2)
    jstate = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    pstate = vmap(popt.init)({k: _t(v) for k, v in params.items()})
    for _ in range(2):                           # second step: bias terms
        ju, jstate = jax.vmap(jopt.update)(jax.tree.map(jnp.asarray, grads),
                                           jstate,
                                           jax.tree.map(jnp.asarray, params))
        pu, pstate = vmap(popt.update)({k: _t(v) for k, v in grads.items()},
                                       pstate,
                                       {k: _t(v) for k, v in params.items()})
        for k in params:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6)
    assert pstate["step"].tolist() == [2] * M
    assert np.asarray(jstate["step"]).tolist() == [2] * M


def _chunks_seen(monkeypatch):
    """The chunk sizes `client_chunk` returns, call by call."""
    seen, real = [], P.client_chunk

    def spy(per_client):
        seen.append(real(per_client))
        return seen[-1]

    monkeypatch.setattr(P, "client_chunk", spy)
    return seen


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_update_equals_one_call(fed, chunk, monkeypatch):
    """CHUNK_BYTES set to `chunk` clients' local-step bytes: chunks of 1,
    2 (2 + 2 + 1) and 4 (4 + 1) against one call of all 5 clients."""
    _, pfed = _feds("personal", local_steps=2, local_batch=8, lr=1e-2)
    target, has = _target(fed)
    popt = adam(pfed.lr)
    pstate = P.stack([popt.init(P.client(fed["pparams"], i))
                      for i in range(M)])
    data_per = {k: fed["pdata"][k] for k in ("x_train", "y_train", "x_ref")}
    batch_idx = torch.from_numpy(
        np.random.RandomState(2).randint(0, N_LOCAL, (M, 2, 8)))
    seen = _chunks_seen(monkeypatch)

    def run():
        return P.batched_local_update(fed["papply"], popt, pfed,
                                      fed["pparams"], pstate, data_per,
                                      _t(target), _t(has),
                                      batch_idx=batch_idx)

    p1, s1, m1 = run()
    assert seen[-1] >= M                           # one call by default
    per = P.written_bytes(
        "test", functools.partial(P.local_update, fed["papply"], popt,
                                  dataclasses.replace(pfed, local_steps=1)),
        *P.client((fed["pparams"], pstate, data_per, _t(target), _t(has)),
                  0), batch_idx[0, :1])
    monkeypatch.setattr(P, "CHUNK_BYTES", chunk * per)
    p2, s2, m2 = run()
    assert seen[-1] == chunk
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=1e-6,
                                   atol=1e-7)
        for part in ("m", "v"):
            np.testing.assert_allclose(s2[part][k].numpy(),
                                       s1[part][k].numpy(), rtol=1e-6,
                                       atol=1e-7)
    assert torch.equal(s1["step"], s2["step"])
    for k in m1:
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("chunk", [1, 2])
def test_chunked_web_equals_one_call(fed, chunk, monkeypatch):
    """CHUNK_BYTES set to `chunk` rows of the personal web (N gathered
    params and N forwards a row): chunks of 1 and 2 (2 + 2 + 1) against
    one call of all 5 rows, within the forwards' tolerance."""
    ids = _t(fed["ids"]).to(torch.int64)
    p, x_ref = fed["pparams"], fed["pdata"]["x_ref"]
    seen = _chunks_seen(monkeypatch)
    with torch.no_grad():
        one = P.neighbour_web(fed["papply"], p, x_ref, ids)
        assert seen[-1] >= M
        row = N * (P.written_bytes("test", fed["papply"], P.client(p, 0),
                                   x_ref[0])
                   + sum(t[0].numel() * t.element_size()
                         for t in p.values()))
        monkeypatch.setattr(P, "CHUNK_BYTES", chunk * row)
        got = P.neighbour_web(fed["papply"], p, x_ref, ids)
    assert seen[-1] == chunk
    assert got.shape == one.shape == (M, N, R, fed["pc"].num_classes)
    _fwd_close(got, one)


def test_client_chunk_from_the_calls_shapes():
    """Clients per vmapped call at the federation dry run's shapes
    (reduced phi3 in bf16, mb 64 and 8 reference sequences of 32 tokens):
    64 a local-step call and 256 web rows, the chunks measured on the
    card (PERF.md, section 4); fewer at 4 times the sequence, since the
    activations grow with it; one client past CHUNK_BYTES."""
    from repro_torch.configs import get_config
    from repro_torch.launch.fed import lm_client_fns
    cfg = get_config("phi3-medium-14b").reduced()
    apply_fn, init_fn = lm_client_fns(cfg, "cpu")
    params = P.tree_map(lambda t: torch.empty_like(t, device="meta"),
                        init_fn(torch.Generator().manual_seed(0)))
    popt = adam(1e-3)
    pfed = pcfg.FedConfig(num_clients=8, num_neighbors=8, local_steps=1,
                          local_batch=64)
    step = functools.partial(P.local_update, apply_fn, popt, pfed)

    def chunks(seq):
        tok = lambda *s: torch.empty(s, dtype=torch.int32,  # noqa: E731
                                     device="meta")
        data = {"x_train": tok(64, seq), "y_train": tok(64),
                "x_ref": tok(8, seq)}
        per = P.written_bytes(("step", seq), step, params, popt.init(params),
                              data, torch.empty((8, cfg.vocab_size),
                                                device="meta"),
                              torch.empty((), dtype=torch.bool,
                                          device="meta"),
                              torch.empty((1, 64), dtype=torch.int64,
                                          device="meta"))
        with torch.no_grad():
            fwd = P.written_bytes(("fwd", seq), apply_fn, params,
                                  data["x_ref"])
        row = 8 * (fwd + sum(t.numel() * t.element_size()
                             for t in params.values()))
        return P.client_chunk(per), P.client_chunk(row)

    assert chunks(32) == (64, 256)
    longer = chunks(128)
    assert longer[0] <= 16 and longer[1] <= 128
    assert P.client_chunk(P.CHUNK_BYTES + 1) == 1
    assert P.client_chunk(P.CHUNK_BYTES) == 1
    assert P.client_chunk(P.CHUNK_BYTES // 3) == 2


# ---------------------------------------------------------------------------
# the baselines' forwards
# ---------------------------------------------------------------------------
def test_peer_mean_matches_the_loop(fed):
    peers = torch.from_numpy(np.random.RandomState(6).randint(0, M, (M, 3)))
    got = baselines._peer_mean(fed["papply"], fed["pparams"],
                               fed["pdata"]["x_ref"], peers)
    with torch.no_grad():
        want = torch.stack([torch.stack([
            fed["papply"](P.client(fed["pparams"], int(j)),
                          fed["pdata"]["x_ref"][i])
            for j in peers[i]]).mean(0) for i in range(M)])
    _fwd_close(got, want)


def test_kdpdfl_and_fedmd_rounds_match_the_loop(fed, monkeypatch):
    """KD-PDFL's ids from the M x M web and FedMD's consensus target, each
    against the outputs of a per-client loop (the update is stubbed to
    capture its target)."""
    pfed = pcfg.FedConfig(num_clients=M, num_neighbors=N, local_steps=1,
                          local_batch=8)
    popt = adam(pfed.lr)
    params, d, apply_fn = fed["pparams"], fed["pdata"], fed["papply"]
    state = P.FedState(params, P.stack([popt.init(P.client(params, i))
                                        for i in range(M)]),
                       None, None, None, 0, 0)
    seen = {}

    def capture(*args, **kw):
        seen["target"], seen["has"] = args[6], args[7]
        return args[3], args[4], {"loss": torch.zeros(M)}

    monkeypatch.setattr(baselines, "batched_local_update", capture)
    _, ids, _ = baselines.kdpdfl_program(apply_fn, popt, pfed).global_round(
        state, d)
    kd_target = seen["target"]
    baselines.fedmd_program(apply_fn, popt, pfed,
                            d["x_ref"][0].numpy()).global_round(state, d)
    with torch.no_grad():
        y_all = torch.stack([torch.stack([
            apply_fn(P.client(params, j), d["x_ref"][i]) for j in range(M)])
            for i in range(M)])
        own = torch.stack([apply_fn(P.client(params, i), d["x_ref"][i])
                           for i in range(M)])
        consensus = torch.stack([apply_fn(P.client(params, i), d["x_ref"][0])
                                 for i in range(M)]).mean(0)
    kls = baselines.verify.kl_divergence(own[:, None], y_all)
    kls = torch.where(torch.eye(M, dtype=torch.bool), torch.inf, kls)
    want_ids = torch.sort(kls, dim=1, stable=True).indices[:, :N]
    assert torch.equal(ids, want_ids)
    _fwd_close(kd_target, torch.stack([y_all[i, want_ids[i]].mean(0)
                                       for i in range(M)]))
    _fwd_close(seen["target"], consensus[None].expand(M, -1, -1))
    assert bool(seen["has"].all())


# ---------------------------------------------------------------------------
# transformer clients (the federation dry run's reduced phi3, in f32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_fed():
    from repro_torch.configs import get_config
    from repro_torch.launch.fed import lm_client_fns
    cfg = get_config("phi3-medium-14b").reduced()
    apply_fn, init_fn = lm_client_fns(cfg, "cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    params = P.stack([init_fn(g) for _ in range(4)])
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s,  # noqa: E731
                                   generator=g, dtype=torch.int32)
    data = {"x_train": tok(4, 6, 8), "y_train": tok(4, 6),
            "x_ref": tok(4, 3, 8), "y_ref": tok(4, 3)}
    return {"cfg": cfg, "papply": apply_fn, "pparams": params,
            "pdata": data,
            "ids": np.array([[1, 2], [3, 0], [0, 1], [2, 3]], np.int32),
            "sel_mask": np.array([[1, 1], [1, 0], [1, 1], [0, 1]], bool)}


def test_lm_clients_exchange_vmapped_matches_the_loop(lm_fed, monkeypatch):
    """4 reduced-phi3 clients: the personal exchange through the flash
    op's vmap rule (one call of the plain version per layer and per
    vmapped forward: 2 layers x (own + web)) against a loop of 4 + 8
    forwards."""
    calls = []
    real = fa.plain_gqa_attention

    def counting(q, *a):
        if q.device.type != "meta":     # not the chunk rule's count
            calls.append(q.shape[0])
        return real(q, *a)

    pfed = pcfg.FedConfig(num_clients=4, num_neighbors=2)
    monkeypatch.setattr(fa, "plain_gqa_attention", counting)
    got = P.exchange_phase(lm_fed["papply"], pfed, lm_fed["pparams"],
                           lm_fed["pdata"], _psel(lm_fed))
    assert calls == [4 * 3, 4 * 3, 4 * 2 * 3, 4 * 2 * 3]   # folded batches
    monkeypatch.setattr(fa, "plain_gqa_attention", real)
    _same_exchange(got, _loop_exchange(lm_fed, pfed))


def test_lm_clients_local_step_vmapped_matches_the_loop(lm_fed):
    """One local Adam step of 4 reduced-phi3 clients (the differentiable
    attention route) as one vmapped call and as a loop of
    `torch.autograd.grad` steps. The moments carry the gradient (after a
    first step m = (1 - b1) g, v = (1 - b2) g^2): each element within
    1e-5 of its leaf's largest |value| (measured 1.0e-6). The update
    p1 - p0 of a first Adam step is ~lr * sign(g), so entries whose
    gradient is near 0 may flip: each leaf's update within a relative L2
    distance of 1e-3 (measured 9.9e-5). Losses rtol 1e-4, atol 1e-6."""
    pfed = pcfg.FedConfig(num_clients=4, num_neighbors=2, local_steps=1,
                          local_batch=4)
    popt = adam(pfed.lr)
    params, d = lm_fed["pparams"], lm_fed["pdata"]
    pstate = P.stack([popt.init(P.client(params, i)) for i in range(4)])
    target = torch.randn(4, 3, lm_fed["cfg"].vocab_size,
                         generator=torch.Generator().manual_seed(1))
    has = torch.tensor([True, True, False, True])
    batch_idx = torch.from_numpy(
        np.random.RandomState(8).randint(0, 6, (4, 1, 4)))
    lp, ls, losses = _loop_update(lm_fed["papply"], pfed, popt, params,
                                  pstate, d, target, has, batch_idx)
    pp, ps, pm = P.batched_local_update(lm_fed["papply"], popt, pfed, params,
                                        pstate, d, target, has,
                                        batch_idx=batch_idx)
    for k in lp:
        for part in ("m", "v"):
            a, b = ps[part][k], ls[part][k]
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), (k, part)
        du, want = pp[k] - params[k], lp[k] - params[k]
        assert (du - want).norm() <= 1e-3 * want.norm(), k
    assert torch.equal(ps["step"], ls["step"])
    _close(torch.stack([pm["loss"], pm["local_loss"], pm["ref_loss"]],
                       1).numpy(), losses.numpy())


# ---------------------------------------------------------------------------
# the flash op's vmap rule and fake implementation
# ---------------------------------------------------------------------------
def _qkv(v, b, s, h, kv, dh, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((v, b, s, h, dh), generator=g).to(dtype),
            torch.randn((v, b, s, kv, dh), generator=g).to(dtype),
            torch.randn((v, b, s, kv, dh), generator=g).to(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_under_vmap_is_the_plain_version_on_the_folded_batch(
        causal, monkeypatch):
    v_, b, s, h, kv, dh = 3, 2, 9, 4, 2, 8
    q, k, v = _qkv(v_, b, s, h, kv, dh)
    calls = []
    real = fa.plain_gqa_attention

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(fa, "plain_gqa_attention", counting)
    with torch.no_grad():
        got = vmap(lambda a, b_, c: fa.gqa_attention(a, b_, c,
                                                     causal=causal))(q, k, v)
        # nested, with k and v not vmapped at the inner level
        nested = vmap(vmap(lambda a, b_, c: fa.gqa_attention(
            a, b_, c, causal=causal), in_dims=(0, None, None)))(
                q[:, None].expand(v_, 2, b, s, h, dh), k, v)
    assert calls == [(v_ * b, s, h, dh), (v_ * 2 * b, s, h, dh)]
    monkeypatch.setattr(fa, "plain_gqa_attention", real)
    want = real(q.reshape(v_ * b, s, h, dh), k.reshape(v_ * b, s, kv, dh),
                v.reshape(v_ * b, s, kv, dh), causal, 0.0)
    assert got.shape == (v_, b, s, h, dh)
    assert torch.equal(got, want.reshape(v_, b, s, h, dh))
    for i in range(2):
        np.testing.assert_allclose(nested[:, i].numpy(), got.numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_fake_shapes_on_meta(dtype):
    q, k, v = (t.to("meta") for t in _qkv(3, 2, 16, 8, 2, 32, dtype=dtype))
    out = fa.gqa_attention_op(q[0], k[0], v[0], True, 0.0)
    assert (out.shape, out.dtype, out.device.type) == \
        ((2, 16, 8, 32), dtype, "meta")
    out = vmap(lambda a, b_, c: fa.gqa_attention_op(a, b_, c, True, 0.0))(
        q, k, v)
    assert (out.shape, out.dtype, out.device.type) == \
        ((3, 2, 16, 8, 32), dtype, "meta")
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fq = torch.empty((5, 7, 4, 16), dtype=dtype)
        fk = torch.empty((5, 7, 1, 16), dtype=dtype)
        out = fa.gqa_attention_op(fq, fk, fk, False, 0.5)
    assert (out.shape, out.dtype) == ((5, 7, 4, 16), dtype)


def test_flash_wrapper_rule_fires_once_under_vmap(monkeypatch):
    """The taint engine on a vmapped flash call: the wrapper rule fires
    once per call, the dispatch mode sees the op once (on the folded
    batch), and the output carries exactly the union of the inputs'
    labels."""
    q, k, v = _qkv(3, 2, 8, 4, 2, 16)
    seen, rules = [], []
    real_dispatch = taint._Propagate.__torch_dispatch__
    real_rule = taint.kernel_value

    def dispatch(self, func, types_, args=(), kwargs=None):
        if "gqa_attention" in str(func):
            seen.append(tuple(args[0].shape))
        return real_dispatch(self, func, types_, args, kwargs)

    def rule(out, inputs, name):
        rules.append(name)
        return real_rule(out, inputs, name)

    monkeypatch.setattr(taint._Propagate, "__torch_dispatch__", dispatch)
    monkeypatch.setattr(taint, "kernel_value", rule)

    def fn(q, k, v):
        with torch.no_grad():
            return vmap(lambda a, b_, c: fa.gqa_attention(a, b_, c))(q, k, v)

    run = taint.run_labelled("flash-vmap", fn, (q, k, v),
                             (taint.SRC_PARAMS, taint.SRC_DATA, ""))
    assert run.findings == []
    assert rules == ["flash_attention"] and run.engine.kernels == {
        "flash_attention"}
    assert seen == [(6, 8, 4, 16)]
    assert run.engine.labels(run.out) == {taint.SRC_PARAMS, taint.SRC_DATA}
