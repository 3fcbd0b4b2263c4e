"""The federation with transformer clients and its dry run
(`repro_torch.launch.fed`: `lm_client_fns`, `dryrun_fed_round`, `--dryrun`).

* One global round of the JAX `wpfed_program` with reduced-phi3 clients in
  f32 at M = 4 (the dry run's FedConfig at 32-bit codes: the dry run's
  128 bits take four times the hash work over the 1.64e6 parameters, and
  32 bits still project every parameter), in both ref modes, against the
  port's on the same weights
  (`models/convert.py:lm_params_from_jax`, flattened by
  `tree.flatten_dotted`) and the JAX round's minibatch indices: ids,
  sel_mask, valid mask, ranking scores, rankings and commitments exactly;
  codes on every bit whose JAX projection sum has |sum| > 1e-3; l_ij and
  the metrics rtol 1e-4, atol 1e-6 (as `test_round_matches_jax`); the
  updated params within lr / 2 = 5e-4 everywhere and within 2e-5 on all
  but 1e-4 of the entries: the first Adam step moves a weight by
  lr * g / (|g| + eps), whose slope at g = 0 is lr / eps = 1e5, so a
  gradient near 0 that the two packages' f32 sums put 1e-9 apart moves
  the weight up to 0.17 * lr apart (44 of 6.6e6 entries past 2e-5 in the
  personal round); a wrong gradient would move most entries by ~lr.
  The new Adam moments m and v, which hold the gradient itself (a wrong
  loss scale or reduction changes them and not the sign of a first
  step), per leaf at rtol 1e-4 (as `test_round_matches_jax`) and atol
  1e-5 of the leaf's largest |value| (the two packages' f32 sums came
  at most 2.3e-6 of it apart here).
* `dryrun_fed_round(device="cpu")` at 16 clients with the default flags
  and with public, tiled and G = 2: the JAX keys in JAX's order, and
  `flops` = G * ((M [+ M * N]) * one forward + M * one local step) + the
  LSH projection's 2 * M * P * bits, the forward and the step each
  counted alone here (the forward on CPU tensors through the naive
  attention, whose full square is swapped for the causal formula).
* The CLI mapping, as `tests/test_exchange_pipeline.py` checks the JAX
  one, and the ValueError at 17 clients.

The card's test (the 16-client segment against the CPU's) is
`tests/test_torch_cuda.py::test_fed_dryrun_segment_matches_the_cpu`.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.paper_models as jcfg
from repro.core import exchange_phase as jax_exchange_phase
from repro.core import init_state as jax_init_state
from repro.core import make_wpfed_round as jax_make_round
from repro.core import select_phase as jax_select_phase
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.optim import adam as jax_adam

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch.configs import get_config
from repro_torch.configs.paper_models import FedConfig, recommended_dedupe
from repro_torch.core import protocol as P
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_flops
from repro_torch.launch import fed as fed_launch
from repro_torch.models import attention
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.optim import adam
from repro_torch.tree import dotted_names, flatten_dotted

ARCH = "phi3-medium-14b"
JAX_KEYS = ["fed_round_clients", "client_arch", "ref_mode", "tiling",
            "reselect_every", "attack", "mesh", "flops_per_device",
            "temp_bytes", "ok"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# one whole round against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_fed():
    """The JAX dry run's construction at M = 4 in f32 (backends on their
    jnp oracles), its round-0 state, and numpy data drawn from seed 0."""
    cfg = jconfigs.get_config(ARCH).reduced()
    fed = jcfg.FedConfig(num_clients=4, num_neighbors=8, top_k=4,
                         local_steps=1, lsh_bits=32, ref_batch=8,
                         selection_backend="oracle",
                         exchange_backend="oracle")

    def apply_fn(params, tokens):
        logits, _ = jax_forward(cfg, params, tokens)
        return logits[:, -1, :]

    def init_fn(key):
        return jax_init_params(cfg, key, dtype=jnp.float32)

    opt = jax_adam(fed.lr)
    rs = np.random.RandomState(0)
    v = cfg.vocab_size
    data = {"x_train": rs.randint(0, v, (4, 64, 32)).astype(np.int32),
            "y_train": rs.randint(0, v, (4, 64)).astype(np.int32),
            "x_ref": rs.randint(0, v, (4, 8, 32)).astype(np.int32),
            "y_ref": rs.randint(0, v, (4, 8)).astype(np.int32)}
    state = jax_init_state(apply_fn, init_fn, opt, fed,
                           jax.random.PRNGKey(0))
    return {"cfg": cfg, "fed": fed, "apply_fn": apply_fn,
            "opt": opt, "data": data, "state": state}


def _stacked_flat(cfg, tree, m):
    """A stacked (M, ...) JAX params pytree -> the port's stacked flat
    dict, one client at a time through `lm_params_from_jax`."""
    clients = [flatten_dotted(lm_params_from_jax(cfg, _slice(tree, i)))
               for i in range(m)]
    return {k: torch.stack([c[k] for c in clients]) for k in clients[0]}


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice(v, i) for v in tree)
    return np.asarray(tree)[i]


def _batch_idx(state, fed, n_local):
    """The minibatch indices the JAX global round draws."""
    _, _, rng_upd = jax.random.split(state.rng, 3)
    mb = min(fed.local_batch, n_local)
    out = []
    for i in range(fed.num_clients):
        keys = jax.random.split(jax.random.fold_in(rng_upd, i),
                                fed.local_steps)
        out.append([np.asarray(jax.random.randint(k, (mb,), 0, n_local))
                    for k in keys])
    return torch.from_numpy(np.asarray(out))


def test_flat_names_give_jax_leaf_order(jax_fed):
    """Sorted by `ops.leaf_key`, the dotted names are `jax.tree.leaves`
    order, so the flattened vector (and so the Eq. 5 code) is JAX's."""
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray, jax_fed["state"].params)
    flat = _stacked_flat(cfg, jp, 4)
    names = list(flat)
    assert sorted(names, key=ops.leaf_key) == names == dotted_names(
        lm_params_from_jax(cfg, _slice(jp, 0)))
    want = np.asarray(jops.flatten_params_batched(jax_fed["state"].params))
    assert np.array_equal(ops.flatten_params_batched(flat).numpy(), want)


@pytest.mark.parametrize("ref_mode", ["personal", "public"])
def test_lm_round_matches_jax(jax_fed, ref_mode):
    jfed = dataclasses.replace(jax_fed["fed"], ref_mode=ref_mode,
                               dedupe_rankings=recommended_dedupe(ref_mode))
    pfed = FedConfig(**dataclasses.asdict(jfed))
    cfg = get_config(ARCH).reduced()
    jstate = jax_fed["state"]
    m = jfed.num_clients
    jp = jax.tree.map(np.asarray, jstate.params)
    jo = jax.tree.map(np.asarray, jstate.opt_state)
    pstate = P.FedState(
        _stacked_flat(cfg, jp, m),
        {"step": _t(jo["step"]).to(torch.int32),
         "m": _stacked_flat(cfg, jo["m"], m),
         "v": _stacked_flat(cfg, jo["v"], m)},
        _t(np.asarray(jstate.codes).view(np.int32)),
        _t(jstate.rankings).to(torch.int32),
        _t(np.asarray(jstate.commitments).astype(np.int64)), 0, 0)
    apply_fn, _ = fed_launch.lm_client_fns(cfg, "cpu", torch.float32)
    program = P.wpfed_program(apply_fn, adam(pfed.lr), pfed)
    jdata = {k: jnp.asarray(v) for k, v in jax_fed["data"].items()}
    pdata = {k: _t(v) for k, v in jax_fed["data"].items()}

    jsel = jax_select_phase(jstate, jfed)
    jnew, jm = jax.jit(jax_make_round(jax_fed["apply_fn"], jax_fed["opt"],
                                      jfed))(jstate, jdata)
    pnew, _, pm = program.global_round(
        pstate, pdata, batch_idx=_batch_idx(jstate, jfed, 64))

    assert np.array_equal(pm["neighbor_ids"].numpy(),
                          np.asarray(jm["neighbor_ids"]))
    assert np.array_equal(P.select_phase(pstate, pfed).sel_mask.numpy(),
                          np.asarray(jsel.sel_mask))
    assert np.array_equal(pm["valid_mask"].numpy(),
                          np.asarray(jm["valid_mask"]))
    assert np.array_equal(pm["ranking_scores"].numpy(),
                          np.asarray(jm["ranking_scores"]))
    assert np.array_equal(pnew.rankings.numpy(), np.asarray(jnew.rankings))
    assert np.array_equal(pnew.commitments.numpy().astype(np.uint32),
                          np.asarray(jnew.commitments))
    for k in ("mean_loss", "mean_local_loss", "mean_ref_loss",
              "mean_neighbor_loss", "valid_neighbor_frac",
              "honest_reporter_frac"):
        _close(float(pm[k]), float(jm[k]))
    want = _stacked_flat(cfg, jax.tree.map(np.asarray, jnew.params), m)
    apart = total = 0
    for k, v in want.items():
        d = (pnew.params[k] - v).abs()
        assert float(d.max()) <= jfed.lr / 2, k
        apart += int((d > 2e-5).sum())
        total += d.numel()
    assert apart <= 1e-4 * total, (apart, total)
    # the moments carry the gradient itself (m = (1 - b1) g, v = (1 - b2)
    # g^2 after a first step), which the params' lr * sign(g) step does
    # not: a wrong loss scale or reduction shows here
    for part in ("m", "v"):
        want = _stacked_flat(cfg, jax.tree.map(np.asarray,
                                               jnew.opt_state[part]), m)
        for k, v in want.items():
            _close(pnew.opt_state[part][k].numpy(), v.numpy(),
                   atol=1e-5 * float(v.abs().max()))
    assert np.array_equal(pnew.opt_state["step"].numpy(),
                          np.asarray(jnew.opt_state["step"]))
    sums = np.asarray(jref.lsh_project_sums_batched_ref(
        jops.flatten_params_batched(jnew.params), 1, bits=jfed.lsh_bits))
    pbits = ops.unpack_bits(pnew.codes, jfed.lsh_bits).numpy()
    jbits = np.asarray(jops.unpack_bits(jnew.codes, jfed.lsh_bits))
    near = np.abs(sums) <= 1e-3
    assert np.array_equal(pbits[~near], jbits[~near])
    print(f"{ref_mode}: {int(near.sum())} code bits with |JAX sum| <= 1e-3")


def test_exchange_l_ij_and_target_match_jax(jax_fed):
    """The personal exchange on the round-0 state: l_ij and the
    distillation target within rtol 1e-4, masks exactly."""
    jfed, jstate = jax_fed["fed"], jax_fed["state"]
    cfg = get_config(ARCH).reduced()
    jsel = jax_select_phase(jstate, jfed)
    jdata = {k: jnp.asarray(v) for k, v in jax_fed["data"].items()}
    jexch = jax_exchange_phase(jax_fed["apply_fn"], jfed, jstate.params,
                               jdata, jsel)
    pfed = FedConfig(**dataclasses.asdict(jfed))
    apply_fn, _ = fed_launch.lm_client_fns(cfg, "cpu", torch.float32)
    params = _stacked_flat(cfg, jax.tree.map(np.asarray, jstate.params), 4)
    psel = P.SelectResult(_t(jsel.ids).to(torch.int32), _t(jsel.sel_mask),
                          _t(jsel.scores), _t(jsel.reporter_mask))
    pexch = P.exchange_phase(apply_fn, pfed, params,
                             {k: _t(v) for k, v in jax_fed["data"].items()},
                             psel)
    _close(pexch.l_ij.numpy(), jexch.l_ij)
    _close(pexch.target_ref.numpy(), jexch.target_ref, atol=1e-5)
    assert np.array_equal(pexch.valid_mask.numpy(),
                          np.asarray(jexch.valid_mask))
    assert np.array_equal(pexch.has_target.numpy(),
                          np.asarray(jexch.has_target))


# ---------------------------------------------------------------------------
# the dry run on the CPU
# ---------------------------------------------------------------------------
def _forward_alone(dr):
    """One client forward on a reference batch counted on CPU tensors
    through the naive attention, whose full-square products are swapped
    for the flash kernel's causal formula."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg, r, s = dr.cfg, dr.fed.ref_batch, 32
    params = P.client(dr.state.params, 0)
    old = attention.get_attn_impl()
    attention.set_attn_impl("naive")
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            dr.apply_fn(params, dr.data["x_ref"][0])
    finally:
        attention.set_attn_impl(old)
    dh, h = cfg.resolved_head_dim, cfg.num_heads
    return (fc.get_total_flops() + cfg.num_layers
            * (attention_flops(r, h, s, s, dh, True) - 4 * r * h * s * s * dh))


def _step_alone(dr):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dr.cfg
    with FlopCounterMode(display=False) as fc:
        P.local_update(
            dr.apply_fn, dr.optimizer, dr.fed, P.client(dr.state.params, 0),
            P.client(dr.state.opt_state, 0),
            {k: dr.data[k][0] for k in ("x_train", "y_train", "x_ref")},
            torch.zeros((dr.fed.ref_batch, cfg.vocab_size)),
            torch.tensor(True), torch.zeros((1, 64), dtype=torch.int64))
    return fc.get_total_flops()


@pytest.mark.parametrize("kw", [
    {}, {"ref_mode": "public", "tiling": "tiled", "reselect_every": 2}],
    ids=["default", "public-tiled-G2"])
def test_dryrun_on_cpu(kw, capsys):
    dr = fed_launch.prepare_fed_dryrun(16, device="cpu", **kw)
    wq0 = dr.state.params["layers.0.attn.wq"].clone()
    report, state = fed_launch.run_fed_dryrun(dr, warmup=0)
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(report))
    assert list(report)[:len(JAX_KEYS)] == JAX_KEYS
    assert report["fed_round_clients"] == 16 and report["ok"] is True
    assert report["client_arch"] == "phi3-medium-14b-smoke"
    assert report["mesh"] == "16x16" and report["device"] == "cpu"
    assert report["temp_bytes"] is None and report["peak_bytes"] is None
    assert report["attack"] == "none"
    g = kw.get("reselect_every", 1)
    assert report["reselect_every"] == g and len(report["round_s"]) == g
    m, n = 16, 8
    fwd = m + (m * n if kw.get("ref_mode", "personal") == "personal" else 0)
    p = sum(t[0].numel() for t in dr.state.params.values())
    p += (-p) % ops.CHUNK
    want = (g * (fwd * _forward_alone(dr) + m * _step_alone(dr))
            + 2 * m * p * 128)
    assert report["flops"] == want
    assert report["flops_per_device"] == want / 16
    # the update reached attention: every client's projections moved
    for name in ("wq", "wk", "wv"):
        a = state.params[f"layers.0.attn.{name}"]
        b = dr.state.params[f"layers.0.attn.{name}"]
        assert all(not torch.equal(a[i], b[i]) for i in range(m)), name
    assert torch.equal(dr.state.params["layers.0.attn.wq"], wq0)
    assert state.params["layers.0.attn.wq"].dtype == torch.bfloat16


def test_dryrun_cli_mapping(monkeypatch):
    calls = {}

    def fake(num_clients=256, arch="phi3-medium-14b", backend="kernel",
             ref_mode="personal", tiling="auto", reselect_every=1,
             attack="none", attack_frac=0.5, attack_start=-1, *,
             device=None, seed=0):
        calls.update(num_clients=num_clients, backend=backend,
                     ref_mode=ref_mode, tiling=tiling,
                     reselect_every=reselect_every, attack=attack,
                     attack_frac=attack_frac, attack_start=attack_start,
                     device=device, seed=seed)

    monkeypatch.setattr(fed_launch, "dryrun_fed_round", fake)
    fed_launch.main(["--dryrun", "--clients", "32", "--ref-mode", "public"])
    assert calls == {"num_clients": 32, "backend": "kernel",
                     "ref_mode": "public", "tiling": "auto",
                     "reselect_every": 1, "attack": "none",
                     "attack_frac": 0.5, "attack_start": -1,
                     "device": None, "seed": 0}
    fed_launch.main(["--dryrun", "--backend", "oracle", "--tiling", "tiled",
                     "--schedule", "gossip", "--reselect-every", "4",
                     "--attack", "poison", "--attack-frac", "0.25",
                     "--attack-start", "5", "--device", "cpu",
                     "--seed", "3"])
    assert calls == {"num_clients": 256, "backend": "oracle",
                     "ref_mode": "personal", "tiling": "tiled",
                     "reselect_every": 4, "attack": "poison",
                     "attack_frac": 0.25, "attack_start": 5,
                     "device": "cpu", "seed": 3}
    fed_launch.main(["--dryrun", "--backend", "ann", "--schedule", "gossip",
                     "--attack", "lsh_cheat"])
    assert (calls["backend"], calls["reselect_every"], calls["attack"]) == \
        ("ann", 4, "lsh_cheat")


def test_dryrun_refuses_clients_off_the_data_axis():
    with pytest.raises(ValueError, match="16 data shards"):
        fed_launch.dryrun_fed_round(17, device="cpu")


def test_dryrun_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_launch.dryrun_fed_round(16)
