"""The port's baselines (SILO, FedMD, ProxyFL, KD-PDFL; WPFed §4.2,
Table 2) and the program registry held against the JAX package on the
CPU: each method's global round and gossip epoch from the same state,
with the JAX draws injected (minibatch indices through `batch_idx`,
ProxyFL's peers through `peer_ids`).

Tolerances: params and `mean_loss` rtol 1e-4, atol 1e-6 (as
`test_round_matches_jax`); cached ids exact, except KD-PDFL rows where
two of the JAX KLs that decide the top-N lie within `KL_TIE` of each
other (counted and printed; such a row's client, and in the epoch every
client that distils from it, is left out of the params comparison,
since its target may rightly differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.core.baselines as jbaselines
import repro.core.rounds as jrounds
from repro.core import init_state as jax_init_state
from repro.core import verify as jverify

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import baselines, rounds
from repro_torch.core import protocol as P
from repro_torch.models.client import init_client_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam
from test_torch_protocol import (_close, _np, _port_state, _t,
                                 _update_batch_idx, program_apply)

METHODS = ("silo", "fedmd", "proxyfl", "kdpdfl")
KL_TIE = 1e-5


@pytest.fixture(scope="module")
def ctx(tiny_fed):
    f = dict(tiny_fed)
    f["pfed"] = pcfg.FedConfig(**dataclasses.asdict(f["fed"]))
    f["pmc"] = pcfg.ClientModelConfig(**dataclasses.asdict(f["mcfg"]))
    f["papply"] = program_apply(f["pmc"])
    f["pdata"] = {k: _t(v) for k, v in f["data"].items()}
    f["shared"] = np.array(f["data"]["x_ref"][0])
    f["jstate0"] = jax_init_state(f["apply_fn"], f["init_fn"], f["opt"],
                                  f["fed"], jax.random.PRNGKey(0))
    return f


def _programs(ctx, method):
    kw = {"shared_ref_x": ctx["shared"]} if method == "fedmd" else {}
    jprog = jrounds.make_program(method, ctx["apply_fn"], ctx["opt"],
                                 ctx["fed"],
                                 **({"shared_ref_x": jnp.asarray(
                                     ctx["shared"])} if kw else {}))
    pprog = rounds.make_program(method, ctx["papply"],
                                adam(ctx["pfed"].lr), ctx["pfed"], **kw)
    return jprog, pprog


def _kdpdfl_tie_rows(ctx, jstate, n):
    """Rows whose sorted JAX KLs (the first n + 1) hold a gap below
    KL_TIE: the top-N order there rests on float rounding."""
    m = ctx["fed"].num_clients
    apply_fn = ctx["apply_fn"]

    @jax.jit
    def kl_matrix(params, x_ref):                 # as kdpdfl_program's
        y_all = jax.vmap(jax.vmap(apply_fn, in_axes=(0, None)))(
            jax.tree.map(lambda p: jnp.broadcast_to(p[None], (m,) + p.shape),
                         params), x_ref)
        own = jax.vmap(apply_fn)(params, x_ref)
        return jax.vmap(lambda o, ys: jax.vmap(
            lambda y: jverify.kl_divergence(o, y))(ys))(own, y_all)

    kls = np.asarray(kl_matrix(jstate.params, ctx["data"]["x_ref"]))
    kls = np.where(np.eye(m, dtype=bool), np.inf, kls)
    head = np.sort(kls, axis=1)[:, :n + 1]
    return (np.diff(head, axis=1) < KL_TIE).any(axis=1)


def _compare_params(pstate, jstate, pmc, rows):
    want = params_from_jax(pmc, _np(jstate.params))
    for k, v in want.items():
        _close(pstate.params[k][rows].numpy(), v[rows].numpy())


@pytest.mark.parametrize("method", METHODS)
def test_baseline_period_matches_jax(ctx, method):
    """The global round, then a gossip epoch on its cache; the port
    carries its own state and cache from the one into the other."""
    fed, data, pdata = ctx["fed"], ctx["data"], ctx["pdata"]
    m, n_local = fed.num_clients, pdata["x_train"].shape[1]
    jprog, pprog = _programs(ctx, method)
    jstate = ctx["jstate0"]
    split = 3 if method == "proxyfl" else 2
    rng_upd = jax.random.split(jstate.rng, split)[-1]
    j1, jcache, jm = jax.jit(jprog.global_round)(jstate, data)
    kw = {"peer_ids": _t(jcache).long()} if method == "proxyfl" else {}
    p1, pcache, pm = pprog.global_round(
        _port_state(jstate, ctx["pmc"]), pdata,
        batch_idx=_update_batch_idx(rng_upd, fed, n_local), **kw)
    assert p1.round == int(j1.round) == 1
    ok = np.ones(m, bool)
    if method == "kdpdfl":
        n = min(fed.num_neighbors, m - 1)
        ties = _kdpdfl_tie_rows(ctx, jstate, n)
        print(f"kdpdfl: {int(ties.sum())} of {m} rows with a KL near-tie "
              f"(gap < {KL_TIE})")
        ok = ~ties
        assert np.array_equal(pcache.numpy()[ok], np.asarray(jcache)[ok])
    elif method == "proxyfl":
        assert torch.equal(pcache, _t(jcache).long())
    else:
        assert pcache == () and jcache == ()
    _compare_params(p1, j1, ctx["pmc"], ok)
    if ok.all():
        _close(float(pm["mean_loss"]), float(jm["mean_loss"]))
    assert set(pm) == set(jm) == {"mean_loss"}

    _, rng_upd = jax.random.split(j1.rng)
    j2, jcache2, jm2 = jax.jit(jprog.gossip_round)(j1, data, jcache)
    p2, pcache2, pm2 = pprog.gossip_round(
        p1, pdata, pcache, batch_idx=_update_batch_idx(rng_upd, fed, n_local))
    assert p2.round == int(j2.round) == 2
    if method in ("proxyfl", "kdpdfl"):
        assert pcache2 is pcache                   # the cache is reused
        ok = ok & ok[pcache.numpy()].all(axis=1)
    _compare_params(p2, j2, ctx["pmc"], ok)
    if ok.all():
        _close(float(pm2["mean_loss"]), float(jm2["mean_loss"]))


def test_make_program_registry_matches_jax(ctx):
    assert rounds.PROGRAMS == jrounds.PROGRAMS
    assert set(baselines.BASELINES) == set(jbaselines.BASELINES)
    assert set(baselines.BASELINE_PROGRAMS) == \
        set(jbaselines.BASELINE_PROGRAMS)
    for name in METHODS:
        kw = {"shared_ref_x": ctx["shared"]} if name == "fedmd" else {}
        prog = rounds.make_program(name, ctx["papply"], adam(1e-2),
                                   ctx["pfed"], **kw)
        assert prog.name == name and prog.gossip_round is not None
    with pytest.raises(KeyError) as jerr:
        jrounds.make_program("fedavg", None, None, ctx["fed"])
    with pytest.raises(KeyError) as perr:
        rounds.make_program("fedavg", None, None, ctx["pfed"])
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(TypeError):                 # fedmd needs its set
        rounds.make_program("fedmd", ctx["papply"], adam(1e-2), ctx["pfed"])


@pytest.mark.parametrize("method", METHODS)
def test_baseline_runs_a_gossip_schedule_with_its_own_draws(ctx, method):
    """Three rounds under Schedule(2) on the port's own draws: finite
    losses, the round index advancing, and (ProxyFL, KD-PDFL) the
    epoch's selection taken from the global round's cache. The same seed
    gives the same run."""
    pfed = ctx["pfed"]
    _, prog = _programs(ctx, method)
    runs = []
    for _ in range(2):
        state = P.init_state(lambda g: init_client_model(ctx["pmc"], g),
                             adam(pfed.lr), pfed, seed=3)
        state, hist = rounds.run_rounds(
            prog, state, ctx["pdata"], rounds=3,
            schedule=rounds.resolve_schedule("gossip", 2))
        assert state.round == 3 and [h["round"] for h in hist] == [0, 1, 2]
        assert all(np.isfinite(h["mean_loss"]) for h in hist)
        runs.append([h["mean_loss"] for h in hist])
    assert runs[0] == runs[1]


def test_proxyfl_peer_draw():
    """Distinct peers of all M clients, self included, seeded by the
    generator; more peers than clients is refused."""
    g = P.round_generator(0, 0, P.PICK_STREAM)
    ids = baselines.draw_peers(6, 3, g)
    assert ids.shape == (6, 3)
    assert all(len(set(r)) == 3 and all(0 <= j < 6 for j in r)
               for r in ids.tolist())
    again = baselines.draw_peers(6, 3, P.round_generator(0, 0, P.PICK_STREAM))
    assert torch.equal(ids, again)
    full = baselines.draw_peers(6, 6, P.round_generator(1, 0, P.PICK_STREAM))
    assert sorted(full[0].tolist()) == list(range(6))  # self drawn too
    with pytest.raises(ValueError, match="num_peers"):
        baselines.draw_peers(3, 4, g)
