"""Properties of the port's main path held against the JAX package on the
CPU beyond the default-flag round of `test_torch_protocol.py`: whole
rounds under the Table-3 flags, one gossip period, `select_partners` at
the smallest federations, `serve` for two more model families, and the
unfused §3.5 references the fused exchange is held against.

Inputs are made with numpy from a seed or carried across from the JAX
package (`params_from_jax`; minibatch indices injected through
`batch_idx`). Tolerances:

* bit-exact: ids, sel_mask, valid mask, rankings, commitments, Eq. 7
  scores, `select_partners`' ids and masks, generated tokens, the §3.5
  masks of `lsh_verification_mask` and `has_any`;
* LSH codes in a round: equal except bits whose JAX projection sum is
  within 1e-3 of zero (counted);
* params and round metrics: rtol 1e-4, atol 1e-6 (as
  `test_round_matches_jax`);
* `kl_divergence` and `aggregate_neighbor_outputs` against JAX, and the
  fused exchange against the unfused composition: rtol 1e-6, atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs.paper_models as jcfg
from repro.core import distill as jdistill
from repro.core import exchange as jexchange
from repro.core import init_state as jax_init_state
from repro.core import make_wpfed_round as jax_make_round
from repro.core import neighbor as jneighbor
from repro.core import verify as jverify
from repro.core import wpfed_program as jax_wpfed_program
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as jtf
from repro import configs as jconfigs

import repro_torch.configs.paper_models as pcfg
from repro_torch import configs
from repro_torch.core import distill, exchange, neighbor, verify
from repro_torch.core import protocol as P
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models.convert import lm_params_from_jax, params_from_jax
from repro_torch.optim import adam
from test_torch_protocol import (_close, _np, _port_state, _t,
                                 _update_batch_idx, program_apply)


def _setup(tiny_fed, **flags):
    jfed = dataclasses.replace(tiny_fed["fed"], **flags)
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(tiny_fed["mcfg"]))
    apply_fn = program_apply(pmc)
    pdata = {k: _t(v) for k, v in tiny_fed["data"].items()}
    jstate = jax_init_state(tiny_fed["apply_fn"], tiny_fed["init_fn"],
                            tiny_fed["opt"], jfed, jax.random.PRNGKey(0))
    return jfed, pfed, pmc, apply_fn, pdata, jstate


def _assert_round_equal(pnew, pm, jnew, jm, pmc, jfed, jround):
    """Ids, masks, rankings, commitments exact; params and metrics within
    rtol 1e-4; codes off near-zero sums. Returns the near-zero bit count
    (0 when `jround` is None: a gossip epoch publishes no codes)."""
    for k in ("neighbor_ids", "valid_mask", "ranking_scores"):
        assert np.array_equal(pm[k].numpy(), np.asarray(jm[k])), k
    assert np.array_equal(pnew.rankings.numpy(), np.asarray(jnew.rankings))
    assert np.array_equal(pnew.commitments.numpy().astype(np.uint32),
                          np.asarray(jnew.commitments))
    for k, v in params_from_jax(pmc, _np(jnew.params)).items():
        _close(pnew.params[k].numpy(), v.numpy())
    for k in ("mean_loss", "mean_local_loss", "mean_ref_loss",
              "mean_neighbor_loss", "valid_neighbor_frac",
              "honest_reporter_frac"):
        _close(float(pm[k]), float(jm[k]))
    if jround is None:
        assert np.array_equal(pnew.codes.numpy().view(np.uint32),
                              np.asarray(jnew.codes))
        return 0
    sums = np.asarray(jref.lsh_project_sums_batched_ref(
        jops.flatten_params_batched(jnew.params), jround + 1,
        bits=jfed.lsh_bits))
    pbits = ops.unpack_bits(pnew.codes, jfed.lsh_bits).numpy()
    jbits = np.asarray(jops.unpack_bits(jnew.codes, jfed.lsh_bits))
    near = np.abs(sums) <= 1e-3
    assert np.array_equal(pbits[~near], jbits[~near])
    return int(near.sum())


# ---------------------------------------------------------------------------
# A.0.1: whole rounds under the Table-3 flags
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [dict(use_rank=False), dict(gamma=0.0),
                                   dict(alpha=1.0)],
                         ids=["no-rank", "gamma0", "alpha1"])
def test_round_under_table3_flags_matches_jax(tiny_fed, flags):
    """Two rounds (round 0 with all scores 0, then a ranked one) of the
    port's `make_wpfed_round` against the JAX one under an ablation flag,
    the JAX minibatch indices injected."""
    jfed, pfed, pmc, apply_fn, pdata, jstate = _setup(tiny_fed, **flags)
    jround = jax.jit(jax_make_round(tiny_fed["apply_fn"], tiny_fed["opt"],
                                    jfed))
    pround = P.make_wpfed_round(apply_fn, adam(pfed.lr), pfed)
    n_local = pdata["x_train"].shape[1]
    near = 0
    for _ in range(2):
        pstate = _port_state(jstate, pmc)
        _, _, rng_upd = jax.random.split(jstate.rng, 3)
        jnew, jm = jround(jstate, tiny_fed["data"])
        pnew, pm = pround(pstate, pdata, batch_idx=_update_batch_idx(
            rng_upd, jfed, n_local))
        near += _assert_round_equal(pnew, pm, jnew, jm, pmc, jfed,
                                    int(jstate.round))
        jstate = jnew
    print(f"{flags}: {near} code bits with |JAX sum| <= 1e-3")


# ---------------------------------------------------------------------------
# A.0.2: one reselection period (global round + gossip epoch)
# ---------------------------------------------------------------------------
def test_wpfed_period_matches_jax(tiny_fed):
    """G=2: the global round, then a gossip epoch against its cached
    selection, each with the JAX draws injected. The port carries its own
    state from the global round into the epoch."""
    jfed, pfed, pmc, apply_fn, pdata, jstate = _setup(tiny_fed)
    jprog = jax_wpfed_program(tiny_fed["apply_fn"], tiny_fed["opt"], jfed)
    pprog = P.wpfed_program(apply_fn, adam(pfed.lr), pfed)
    n_local = pdata["x_train"].shape[1]
    data = tiny_fed["data"]
    pstate = _port_state(jstate, pmc)
    _, _, rng_upd = jax.random.split(jstate.rng, 3)
    j1, jsel, jm = jax.jit(jprog.global_round)(jstate, data)
    p1, psel, pm = pprog.global_round(
        pstate, pdata, batch_idx=_update_batch_idx(rng_upd, jfed, n_local))
    near = _assert_round_equal(p1, pm, j1, jm, pmc, jfed, 0)
    _, rng_upd = jax.random.split(j1.rng)
    j2, _, jm2 = jax.jit(jprog.gossip_round)(j1, data, jsel)
    p2, psel2, pm2 = pprog.gossip_round(
        p1, pdata, psel, batch_idx=_update_batch_idx(rng_upd, jfed, n_local))
    assert psel2 is psel and p2.round == int(j2.round) == 2
    # the epoch publishes nothing: codes, rankings, commitments frozen
    assert torch.equal(p2.codes, p1.codes)
    assert torch.equal(p2.rankings, p1.rankings)
    _assert_round_equal(p2, pm2, j2, jm2, pmc, jfed, None)
    print(f"period: {near} code bits with |JAX sum| <= 1e-3")


# ---------------------------------------------------------------------------
# A.0.1: select_partners at the smallest federations
# ---------------------------------------------------------------------------
PATHS = {"oneshot": dict(backend="oracle", tiling="oneshot"),
         "tiled": dict(backend="oracle", tiling="tiled"),
         "ann": dict(backend="ann")}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("m", [2, 3])
def test_select_partners_at_tiny_m_with_all_ties(m, path):
    """All codes equal and all scores zero: every weight ties, so the ids
    are decided by position alone, on every path (ANN: one bucket, and 2
    prefix bits with 1 probe)."""
    w, n = 4, 3
    codes = np.full((m, w), 0x9E3779B9, np.uint32)
    scores = np.zeros(m, np.float32)
    for pb, probes in ((0, 0), (2, 1)) if path == "ann" else ((10, 8),):
        kw = dict(num_clients=m, num_neighbors=n, lsh_bits=w * 32,
                  ann_prefix_bits=pb, ann_probes=probes)
        jfed = jcfg.FedConfig(**kw)
        ji, jm = jax.jit(lambda c, s: jneighbor.select_partners(
            c, s, jfed, seed=1, **PATHS[path]))(jnp.asarray(codes),
                                                jnp.asarray(scores))
        pi, pm = neighbor.select_partners(
            _t(codes.view(np.int32)), _t(scores), pcfg.FedConfig(**kw),
            seed=1, **PATHS[path])
        assert pi.shape == (m, m - 1)
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        assert np.array_equal(pm.numpy(), np.asarray(jm))


# ---------------------------------------------------------------------------
# A.0.1: serve for two more dense families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "qwen1.5-32b"])
def test_serve_matches_jax_more_families(arch):
    """The reduced config of each, on the JAX package's weights: the same
    generated tokens as the JAX `serve`."""
    kw = dict(batch=2, prompt_len=16, max_new=6, seed=0)
    want = jax_serve(arch, **kw)["generated"]
    cfg = configs.get_config(arch).reduced()
    jparams = jtf.init_params(jconfigs.get_config(arch).reduced(),
                              jax.random.PRNGKey(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    got = serve(arch, device="cpu", params=params, **kw)
    assert np.array_equal(got["generated"], want)


# ---------------------------------------------------------------------------
# A.0.3: the unfused §3.5 references
# ---------------------------------------------------------------------------
def _exchange_inputs(m, n, r, c, seed, sel_p=0.7):
    rs = np.random.RandomState(seed)
    own = (rs.randn(m, r, c) * 3).astype(np.float32)
    nb = (rs.randn(m, n, r, c) * 3).astype(np.float32)
    y = rs.randint(0, c, (m, r)).astype(np.int32)
    sel = rs.rand(m, n) < sel_p
    return own, nb, y, sel


@pytest.mark.parametrize("case", ["random", "ties", "none_selected",
                                  "one_selected"])
def test_unfused_references_match_jax(case):
    """`kl_divergence`, `lsh_verification_mask`,
    `aggregate_neighbor_outputs` and `public_ref_logits` per client
    against the JAX functions."""
    own, nb, _, sel = _exchange_inputs(5, 6, 4, 7, seed=3)
    if case == "ties":                  # duplicated neighbours: equal KLs
        nb[:, 3] = nb[:, 1]
        nb[:, 5] = nb[:, 1]
        sel[:] = True
    elif case == "none_selected":
        sel[:] = False
    elif case == "one_selected":
        sel[:] = False
        sel[:, 2] = True
    for i in range(own.shape[0]):
        jkl = jax.vmap(lambda q: jverify.kl_divergence(
            jnp.asarray(own[i]), q))(jnp.asarray(nb[i]))
        pkl = verify.kl_divergence(_t(own[i])[None], _t(nb[i]))
        _close(pkl.numpy(), jkl, rtol=1e-6, atol=1e-6)
        jmask = jverify.lsh_verification_mask(
            jnp.asarray(own[i]), jnp.asarray(nb[i]), jnp.asarray(sel[i]))
        pmask = verify.lsh_verification_mask(_t(own[i]), _t(nb[i]),
                                             _t(sel[i]))
        assert np.array_equal(pmask.numpy(), np.asarray(jmask))
        jagg, jhas = jdistill.aggregate_neighbor_outputs(
            jnp.asarray(nb[i]), jmask)
        pagg, phas = distill.aggregate_neighbor_outputs(_t(nb[i]), pmask)
        _close(pagg.numpy(), jagg, rtol=1e-6, atol=1e-6)
        assert bool(phas) == bool(jhas)
    web = _t(nb)
    assert exchange.public_ref_logits(web) is web
    assert np.array_equal(np.asarray(jexchange.public_ref_logits(
        jnp.asarray(nb))), nb)


@pytest.mark.parametrize("tiling", ["oneshot", "tiled"])
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_fused_exchange_matches_unfused_composition(tiling, lsh_verification):
    """The port's `all_in_one_exchange` (plain versions on the CPU) against
    the three unfused calls per client: Eq. 3 CE per neighbour, the §3.5
    mask (or sel_mask without verification), the masked mean."""
    m, n, r, c = 6, 5, 8, 10
    own, nb, y, sel = _exchange_inputs(m, n, r, c, seed=11)
    fed = pcfg.FedConfig(num_clients=m, num_neighbors=n,
                         lsh_verification=lsh_verification)
    res = exchange.all_in_one_exchange(_t(own), _t(nb), _t(y), _t(sel), fed,
                                       backend="oracle", tiling=tiling)
    for i in range(m):
        l_ij = torch.stack([distill.cross_entropy(_t(nb[i, j]), _t(y[i]))
                            for j in range(n)])
        valid = (verify.lsh_verification_mask(_t(own[i]), _t(nb[i]),
                                              _t(sel[i]))
                 if lsh_verification else _t(sel[i]))
        agg, has = distill.aggregate_neighbor_outputs(_t(nb[i]), valid)
        _close(res.l_ij[i].numpy(), l_ij.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.equal(res.valid_mask[i], valid)
        _close(res.target_ref[i].numpy(), agg.numpy(), rtol=1e-6, atol=1e-6)
        assert bool(res.has_target[i]) == bool(has)
