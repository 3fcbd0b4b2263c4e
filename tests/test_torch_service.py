"""The port's continuous federation service held against the JAX package
(`repro.service`) on the CPU, and its own kill/resume and serving.

Inputs: the `tiny_fed` federation (6 MLP clients, N=3), its JAX state
carried into the port by `models.convert.service_state_from_jax`, the JAX
round's minibatch indices injected through `batch_idx`. Tolerances:

* exact: selection ids (where selected, and every rank on the plain
  versions against `lax.top_k`), sel_mask, valid_mask, Eq. 7 scores,
  rankings, commitments, active, code_age;
* Eq. 8 staleness discount and the scores it scales: within 1 ulp of
  `jnp.exp` (the two packages' CPU exp differ by an ulp at some ages);
  selection ids exact on top of it;
* params after a round: rtol 1e-4, atol 1e-6 (the round tolerance of
  `tests/test_torch_protocol.py`);
* served logits: rtol 1e-5, atol 1e-6 (the client-model tolerance).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs.paper_models as jcfg
from repro.core import init_state as jax_init_state
from repro.core.neighbor import select_partners as jax_select_partners
from repro.core.protocol import exchange_phase as jax_exchange_phase
from repro.core.protocol import select_phase as jax_select_phase
from repro.core.protocol import update_phase as jax_update_phase
from repro.kernels import ref as jref
from repro import service as jsvc

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import protocol as P
from repro_torch.core.neighbor import select_partners
from repro_torch.kernels import ref
from repro_torch.models.client import init_client_model
from repro_torch.models.convert import params_from_jax, service_state_from_jax
from repro_torch.optim import adam
from repro_torch.service import (ChurnEvent, PersonalizedServer,
                                 ServiceConfig, apply_events,
                                 init_service_state, join, leave,
                                 parse_events, participation_mask,
                                 resume_service, run_service,
                                 service_program, staleness_discount)
from repro_torch.service.membership import validate_events
from repro_torch.tree import tree_leaves
from test_torch_protocol import (_close, _np, _t, _update_batch_idx,
                                 program_apply)

PATHS = {"oracle": dict(selection_backend="oracle"),
         "oneshot": dict(selection_tiling="oneshot"),
         "tiled": dict(selection_tiling="tiled"),
         "ann": dict(selection_backend="ann", ann_prefix_bits=2,
                     ann_probes=1)}


@pytest.fixture(scope="module")
def env(tiny_fed):
    """Both sides of one federation: the JAX service state (gossip
    budgets 3,1,2,3,2,3 over periods of 3) and its port copy."""
    jfed, jmc = tiny_fed["fed"], tiny_fed["mcfg"]
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(jmc))
    svc = jsvc.ServiceConfig(reselect_every=3, keep_last_k=2)
    jstate = jsvc.init_service_state(
        jax_init_state(tiny_fed["apply_fn"], tiny_fed["init_fn"],
                       tiny_fed["opt"], jfed, jax.random.PRNGKey(0)),
        svc, gossip_counts=[3, 1, 2, 3, 2, 3])
    pdata = {k: _t(v) for k, v in tiny_fed["data"].items()}
    return {**tiny_fed, "pfed": pfed, "pmc": pmc, "svc": svc,
            "psvc": ServiceConfig(**dataclasses.asdict(svc)),
            "jstate": jstate, "pdata": pdata,
            "papply": program_apply(pmc)}


def to_port(js, pmc):
    """A JAX ServiceState -> the port's, through the numpy carry-over."""
    return service_state_from_jax(pmc, dict(
        params=_np(js.fed.params), opt_state=_np(js.fed.opt_state),
        codes=np.asarray(js.fed.codes), rankings=np.asarray(js.fed.rankings),
        commitments=np.asarray(js.fed.commitments),
        active=np.asarray(js.active), code_age=np.asarray(js.code_age),
        gossip_count=np.asarray(js.gossip_count),
        period_start=int(js.period_start), round=int(js.fed.round)))


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def ranked_state(env):
    """The JAX service state after one global round (reveals to score),
    computed once per module."""
    if "ranked" not in env:
        program = jsvc.service_program(env["apply_fn"], env["opt"],
                                       env["fed"], env["svc"])
        env["ranked"] = jax.jit(program.global_round)(
            env["jstate"], env["data"])[0]
    return env["ranked"]


def _codes_scores(m, words, seed):
    rs = np.random.RandomState(seed)
    codes = rs.randint(0, 2 ** 32, (m, words), dtype=np.uint32)
    scores = (rs.rand(m).astype(np.float32) + 0.5)
    return codes, scores


# ---------------------------------------------------------------------------
# selection under churn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("gone", [(4,), (0, 2, 3, 5), (0, 1, 2, 4, 5)],
                         ids=["one-leaver", "two-survivors", "one-survivor"])
def test_select_partners_active_matches_jax(env, path, gone):
    """Every id and the mask equal the JAX function's, masked ranks
    included, on the oracle, one-shot, tiled and ANN paths; a departed
    client is in no row's selection."""
    jfed = dataclasses.replace(env["fed"], **PATHS[path])
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    m = jfed.num_clients
    codes, scores = _codes_scores(m, jfed.lsh_bits // 32, len(gone))
    active = np.ones(m, bool)
    active[list(gone)] = False
    jids, jmask = jax_select_partners(jnp.asarray(codes),
                                      jnp.asarray(scores), jfed,
                                      active=jnp.asarray(active), seed=3)
    pids, pmask = select_partners(_t(codes.view(np.int32)), _t(scores), pfed,
                                  active=_t(active), seed=3)
    assert np.array_equal(pmask.numpy(), np.asarray(jmask))
    assert np.array_equal(pids.numpy(), np.asarray(jids))
    chosen = pids.numpy()[pmask.numpy()]
    assert not set(chosen.tolist()) & set(gone)
    n = min(jfed.num_neighbors, m - 1)
    for i in np.nonzero(active)[0]:
        assert pmask.numpy()[i].sum() == min(n, int(active.sum()) - 1)


def test_select_partners_active_requires_use_rank(env):
    fed = dataclasses.replace(env["pfed"], use_rank=False)
    m = fed.num_clients
    with pytest.raises(ValueError, match="use_rank"):
        select_partners(torch.zeros((m, 4), dtype=torch.int32),
                        torch.ones(m), fed,
                        active=torch.ones(m, dtype=torch.bool))


@pytest.mark.parametrize("m,n,words", [(6, 3, 4), (10, 9, 8), (33, 12, 8)])
@pytest.mark.parametrize("gone_frac", [0.2, 0.6])
def test_plain_selection_masked_ranks_equal_top_k(m, n, words, gone_frac):
    """The port's plain versions (one-shot, tiled, the kernels' split
    order) give the JAX `fused_select_ref`'s (`lax.top_k`'s) ids on
    every rank under churn: masked ranks hold the row and the departed
    clients in ascending id. Finite weights within rtol 1e-6 (the Eq. 8
    tables are each package's exp)."""
    codes, scores = _codes_scores(m, words, m)
    rs = np.random.RandomState(n)
    scores[rs.rand(m) < gone_frac] = -np.inf
    bits = words * 32
    pc, ps = _t(codes.view(np.int32)), _t(scores)
    lut = ref.selection_lut(words, bits, 1.0)
    jtop_i, jtop_w = jref.fused_select_ref(
        jnp.asarray(codes), jnp.asarray(scores), bits=bits, gamma=1.0,
        num_neighbors=n)
    for ids, top_w in (
            ref.fused_select_ref(pc, ps, lut, num_neighbors=n),
            ref.fused_select_tiled_ref(pc, ps, lut, num_neighbors=n,
                                       block_m=4, block_k=8),
            ref.fused_select_split_ref(pc, ps, lut, num_neighbors=n, rows=32,
                                       splits=3, split_len=-(-m // 3),
                                       block_k=8)):
        assert np.array_equal(ids.numpy(), np.asarray(jtop_i))
        assert np.array_equal(np.isfinite(top_w.numpy()),
                              np.isfinite(np.asarray(jtop_w)))
        fin = np.isfinite(top_w.numpy())
        np.testing.assert_allclose(top_w.numpy()[fin],
                                   np.asarray(jtop_w)[fin], rtol=1e-6)


@pytest.mark.parametrize("gone_frac", [0.3, 0.7])
def test_plain_ann_masked_ranks_equal_jax(gone_frac):
    """`ann_select_ref` on the same candidates with -inf score columns
    gives the JAX `ann_select_ref`'s ids on every rank (0 where the
    weight is not finite); weights within rtol 1e-6 (each package's Eq. 8
    table)."""
    from repro.core import ann as jann
    from repro_torch.core import ann
    m, n, words = 6, 3, 8          # tiny_fed's shape: shares JAX compiles
    codes, scores = _codes_scores(m, words, 11)
    scores[np.random.RandomState(1).rand(m) < gone_frac] = -np.inf
    pc, ps = _t(codes.view(np.int32)), _t(scores)
    cand = ann.ann_candidates(pc, ps, seed=2, prefix_bits=2, probes=1,
                              num_neighbors=n)
    jcand = jann.ann_candidates(jnp.asarray(codes), jnp.asarray(scores),
                                seed=2, prefix_bits=2, probes=1,
                                num_neighbors=n)
    assert np.array_equal(cand.ids.numpy(), np.asarray(jcand.ids))
    lut = ref.selection_lut(words, words * 32, 1.0)
    pi, pw = ref.ann_select_ref(pc, ps, cand.ids, lut, num_neighbors=n)
    ji, jw = jref.ann_select_ref(jnp.asarray(codes), jnp.asarray(scores),
                                 jcand.ids, bits=words * 32, gamma=1.0,
                                 num_neighbors=n)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert (pi.numpy()[~np.isfinite(pw.numpy())] == 0).all()
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("lam", [0.1, 0.5, 0.55, 1.0, 2.0])
def test_staleness_discount_within_one_ulp_of_jax(lam):
    ages = np.arange(0, 40, dtype=np.int32)
    want = np.asarray(jsvc.staleness_discount(jnp.asarray(ages), lam))
    got = staleness_discount(_t(ages), lam).numpy()
    assert got.dtype == np.float32 and ulps(got, want) <= 1
    assert got[0] == 1.0 and np.all(np.diff(got) < 0)


@pytest.mark.parametrize("path", ["oracle", "tiled", "ann"])
def test_select_phase_stale_joiner_and_leaver_match_jax(env, path):
    """Client 5 re-joined two periods stale, client 3 left: reporter
    mask, discounted scores and the selection equal the JAX
    select_phase's; 5 is selectable, 3 is not."""
    jfed = dataclasses.replace(env["fed"], num_neighbors=5, **PATHS[path])
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    # a ranked state: the reveals of one JAX round (N=3), then client 5
    # re-joins two periods stale and client 3 leaves
    js = ranked_state(env)
    js = jsvc.join(jsvc.leave(js, 5), 5)._replace(
        code_age=js.code_age.at[5].set(2),
        active=js.active.at[3].set(False))
    ps = to_port(js, env["pmc"])
    lam = env["svc"].staleness_lambda
    jsel = jax_select_phase(js.fed, jfed, active=js.active,
                            score_scale=jsvc.staleness_discount(
                                js.code_age, lam))
    psel = P.select_phase(ps.fed, pfed, active=ps.active,
                          score_scale=staleness_discount(ps.code_age, lam))
    assert np.array_equal(psel.reporter_mask.numpy(),
                          np.asarray(jsel.reporter_mask))
    assert ulps(psel.scores.numpy(), jsel.scores) <= 1
    assert np.array_equal(psel.sel_mask.numpy(), np.asarray(jsel.sel_mask))
    mask = psel.sel_mask.numpy()
    assert np.array_equal(psel.ids.numpy()[mask], np.asarray(jsel.ids)[mask])
    chosen = psel.ids.numpy()[mask]
    assert 5 in chosen and 3 not in chosen


@pytest.mark.parametrize("survivors", [(0, 2), (3,)])
def test_few_survivors_degrade_like_jax(env, survivors):
    """Two survivors select exactly each other; a single survivor has no
    valid slot (the exchange's has_target=False path) and a whole period
    still runs on the port."""
    m = env["fed"].num_clients
    active = jnp.zeros((m,), bool).at[jnp.asarray(survivors)].set(True)
    js = env["jstate"]._replace(active=active)
    ps = to_port(js, env["pmc"])
    jsel = jax_select_phase(js.fed, env["fed"], active=js.active)
    psel = P.select_phase(ps.fed, env["pfed"], active=ps.active)
    jex = jax_exchange_phase(env["apply_fn"], env["fed"], js.fed.params,
                             env["data"], jsel)
    pex = P.exchange_phase(env["papply"], env["pfed"], ps.fed.params,
                           env["pdata"], psel)
    assert np.array_equal(psel.sel_mask.numpy(), np.asarray(jsel.sel_mask))
    assert np.array_equal(psel.ids.numpy(), np.asarray(jsel.ids))
    assert np.array_equal(pex.valid_mask.numpy(), np.asarray(jex.valid_mask))
    assert np.array_equal(pex.has_target.numpy(), np.asarray(jex.has_target))
    mask = psel.sel_mask.numpy()
    if len(survivors) == 2:
        a, b = survivors
        assert mask[a].sum() == mask[b].sum() == 1
        assert psel.ids.numpy()[a][mask[a]][0] == b
    else:
        assert mask[survivors[0]].sum() == 0
        assert not pex.has_target.numpy()[survivors[0]]
        program = service_program(env["papply"], adam(env["pfed"].lr),
                                  env["pfed"], env["psvc"])
        from repro_torch.core.rounds import make_segment_fn
        final, metrics = make_segment_fn(program, 3)(ps, env["pdata"])
        assert final.fed.round == ps.fed.round + 3 and len(metrics) == 3
        assert all(np.isfinite(float(m["mean_loss"])) for m in metrics)


def test_update_phase_participate_matches_jax(env):
    """Non-participants' params and optimizer state come back bitwise
    unchanged on both sides; participants agree within the round
    tolerance."""
    js, jfed, pfed = env["jstate"], env["fed"], env["pfed"]
    ps = to_port(js, env["pmc"])
    part = np.array([True, False, True, True, False, True])
    jsel = jax_select_phase(js.fed, jfed)
    jex = jax_exchange_phase(env["apply_fn"], jfed, js.fed.params,
                             env["data"], jsel)
    rng = jax.random.PRNGKey(7)
    jp, jo, _ = jax_update_phase(env["apply_fn"], env["opt"], jfed,
                                 js.fed.params, js.fed.opt_state,
                                 env["data"], jex, rng,
                                 participate=jnp.asarray(part))
    psel = P.select_phase(ps.fed, pfed)
    pex = P.exchange_phase(env["papply"], pfed, ps.fed.params,
                           env["pdata"], psel)
    n_local = env["data"]["x_train"].shape[1]
    pp, po, _ = P.update_phase(env["papply"], adam(pfed.lr), pfed,
                               ps.fed.params, ps.fed.opt_state,
                               env["pdata"], pex,
                               batch_idx=_update_batch_idx(rng, jfed,
                                                           n_local),
                               participate=_t(part))
    for k, v in params_from_jax(env["pmc"], _np(jp)).items():
        _close(pp[k].numpy(), v.numpy())
        assert torch.equal(pp[k][~_t(part)], ps.fed.params[k][~_t(part)])
    assert np.array_equal(po["step"].numpy(), np.asarray(jo["step"]))
    assert po["step"].tolist() == [3, 0, 3, 3, 0, 3]   # 3 local steps
    for k, v in ps.fed.opt_state["m"].items():
        assert torch.equal(po["m"][k][~_t(part)], v[~_t(part)])


# ---------------------------------------------------------------------------
# three service rounds against the JAX service program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref_mode", ["personal", "public"])
def test_service_rounds_match_jax(env, ref_mode):
    """One global round and two gossip epochs of the service program, with
    heterogeneous gossip budgets (3,1,2,3,2,3), client 4 departed and
    client 1 a stale re-joiner (code_age 2). The port starts every round
    from the JAX state (converted) and the JAX round's minibatches."""
    jfed = dataclasses.replace(env["fed"], ref_mode=ref_mode,
                               dedupe_rankings=jcfg.recommended_dedupe(
                                   ref_mode))
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    jprog = jsvc.service_program(env["apply_fn"], env["opt"], jfed,
                                 env["svc"])
    pprog = service_program(env["papply"], adam(pfed.lr), pfed, env["psvc"])
    jg, jgo = jax.jit(jprog.global_round), jax.jit(jprog.gossip_round)
    js = jsvc.leave(env["jstate"], 4)._replace(
        code_age=env["jstate"].code_age.at[1].set(2))
    n_local = env["data"]["x_train"].shape[1]
    jsel = psel = None
    for r in range(3):
        ps = to_port(js, env["pmc"])
        if r == 0:
            _, _, rng_upd = jax.random.split(js.fed.rng, 3)
            jnew, jsel, jm = jg(js, env["data"])
            pnew, psel, pm = pprog.global_round(
                ps, env["pdata"],
                batch_idx=_update_batch_idx(rng_upd, jfed, n_local))
            mask = psel.sel_mask.numpy()
            assert np.array_equal(mask, np.asarray(jsel.sel_mask))
            assert np.array_equal(psel.ids.numpy()[mask],
                                  np.asarray(jsel.ids)[mask])
            assert 4 not in psel.ids.numpy()[mask]
            assert ulps(psel.scores.numpy(), jsel.scores) <= 1
        else:
            _, rng_upd = jax.random.split(js.fed.rng)
            jnew, _, jm = jgo(js, env["data"], jsel)
            pnew, _, pm = pprog.gossip_round(
                ps, env["pdata"], psel,
                batch_idx=_update_batch_idx(rng_upd, jfed, n_local))
        assert np.array_equal(pm["valid_mask"].numpy(),
                              np.asarray(jm["valid_mask"]))
        assert np.array_equal(pnew.fed.rankings.numpy(),
                              np.asarray(jnew.fed.rankings))
        assert np.array_equal(pnew.fed.commitments.numpy().astype(np.uint32),
                              np.asarray(jnew.fed.commitments))
        assert np.array_equal(pnew.active.numpy(), np.asarray(jnew.active))
        assert np.array_equal(pnew.code_age.numpy(),
                              np.asarray(jnew.code_age))
        assert pnew.period_start == int(jnew.period_start)
        assert pnew.fed.round == int(jnew.fed.round)
        for k, v in params_from_jax(env["pmc"], _np(jnew.fed.params)).items():
            _close(pnew.fed.params[k].numpy(), v.numpy())
        for k in ("active_frac", "participation_frac", "mean_code_age",
                  "honest_reporter_frac", "valid_neighbor_frac",
                  "mean_loss", "mean_ref_loss", "mean_neighbor_loss"):
            _close(float(pm[k]), float(jm[k]))
        js = jnew
    # the departed client's slot stayed frozen through all three rounds
    assert js.fed.round == 3 and int(js.code_age[4]) == 1


# ---------------------------------------------------------------------------
# membership plumbing
# ---------------------------------------------------------------------------
def test_churn_event_plumbing_matches_jax(env):
    spec = "1:leave:4,2:join:4,2:leave:0"
    assert parse_events(spec) == [tuple(e) for e in jsvc.parse_events(spec)]
    with pytest.raises(ValueError, match="period:kind:client"):
        parse_events("1:leave")
    with pytest.raises(ValueError, match="unknown churn event kind"):
        validate_events([ChurnEvent(0, "quit", 1)], 6)
    with pytest.raises(ValueError, match="outside"):
        validate_events([ChurnEvent(0, "leave", 6)], 6)
    ps = to_port(env["jstate"], env["pmc"])
    js = env["jstate"]
    for period in range(3):
        ps = apply_events(ps, parse_events(spec), period)
        js = jsvc.apply_events(js, jsvc.parse_events(spec), period)
        assert ps.active.tolist() == np.asarray(js.active).tolist()
    assert leave(leave(ps, 2), 2).active.tolist() == \
        leave(ps, 2).active.tolist()
    assert join(ps, 0).active[0]
    for epoch in range(3):
        assert participation_mask(ps, epoch).tolist() == np.asarray(
            jsvc.participation_mask(js, epoch)).tolist()


def test_service_config_and_init_validation(env):
    for kw, msg in ((dict(reselect_every=0), "reselect_every"),
                    (dict(staleness_lambda=-1.0), "staleness_lambda"),
                    (dict(checkpoint_every=0), "checkpoint_every"),
                    (dict(keep_last_k=0), "keep_last_k")):
        with pytest.raises(ValueError, match=msg):
            ServiceConfig(**kw)
    fs = to_port(env["jstate"], env["pmc"]).fed
    st = init_service_state(fs, env["psvc"], gossip_counts=[9, 0, 2, 3, 1, 2])
    assert st.gossip_count.tolist() == [3, 1, 2, 3, 1, 2]
    assert st.period_start == 0 and st.active.all()
    with pytest.raises(ValueError, match="active mask shape"):
        init_service_state(fs, env["psvc"], active=[True] * 5)
    with pytest.raises(ValueError, match="use_rank"):
        service_program(env["papply"], adam(1e-2), dataclasses.replace(
            env["pfed"], use_rank=False), env["psvc"])


# ---------------------------------------------------------------------------
# kill / resume with churn (port only)
# ---------------------------------------------------------------------------
def _port_env(env):
    pfed = env["pfed"]
    state = init_service_state(
        P.init_state(lambda g: init_client_model(env["pmc"], g),
                     adam(pfed.lr), pfed, seed=2), env["psvc"],
        gossip_counts=[3, 1, 2, 3, 2, 3])
    return (env["papply"], adam(pfed.lr), pfed, env["psvc"]), state


def _same_state(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _no_seconds(hist):
    return [{k: v for k, v in h.items() if k != "seconds"} for h in hist]


def test_kill_resume_bitwise_with_churn(env, tmp_path):
    """Three churned periods straight through against killed after two
    and resumed from disk: equal rounds (all but wall seconds), a
    bitwise-equal final state, payload-equal ledgers that verify, and
    the tap seeing every round in order."""
    args, state = _port_env(env)
    events = [ChurnEvent(1, "leave", 4), ChurnEvent(2, "join", 4)]
    taps = []
    s_a, chain_a, hist_a = run_service(
        *args, state, env["pdata"], periods=3, events=events,
        ckpt_dir=str(tmp_path / "a"), metrics_tap=taps.append)
    assert chain_a.verify_chain() and len(hist_a) == 9
    assert [t["round"] for t in taps] == list(range(9))
    assert [t["mean_loss"] for t in taps] == [h["mean_loss"] for h in hist_a]
    fracs = [h["active_frac"] for h in hist_a]
    assert fracs[0] == 1.0 and abs(fracs[3] - 5 / 6) < 1e-6 \
        and fracs[6] == 1.0
    ck = str(tmp_path / "b")
    run_service(*args, state, env["pdata"], periods=2, events=events,
                ckpt_dir=ck)
    s_r, chain_r, p0 = resume_service(ck, state)
    assert p0 == 2 and chain_r.verify_chain()
    s_c, chain_c, tail = run_service(*args, s_r, env["pdata"], periods=3,
                                     events=events, chain=chain_r,
                                     ckpt_dir=ck, start_period=p0)
    assert _no_seconds(tail) == _no_seconds(hist_a[6:])
    _same_state(s_a, s_c)
    assert [b.payload for b in chain_a.blocks] == \
        [b.payload for b in chain_c.blocks]
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == \
        ["step_00000001.npz", "step_00000002.npz"]
    # the template was not written to
    _same_state(state, _port_env(env)[1])


def test_resume_refuses_tampered_chain_and_missing_checkpoint(env, tmp_path):
    from repro_torch.core.chain import load_chain
    args, state = _port_env(env)
    ck = str(tmp_path / "c")
    run_service(*args, state, env["pdata"], periods=1, ckpt_dir=ck)
    chain = load_chain(os.path.join(ck, "chain.json"))
    chain.blocks[1].payload["round"] = 999
    with open(os.path.join(ck, "chain.json"), "w") as fh:
        fh.write(chain.to_json())
    with pytest.warns(UserWarning, match="verify_chain"):
        with pytest.raises(ValueError, match="verify_chain"):
            resume_service(ck, state)
    with pytest.raises(FileNotFoundError):
        resume_service(str(tmp_path / "nope"), state)


# ---------------------------------------------------------------------------
# the serving front
# ---------------------------------------------------------------------------
def test_personalized_server_matches_jax_server(env):
    js = env["jstate"]
    ps = to_port(js, env["pmc"])
    jserver = jsvc.PersonalizedServer(env["apply_fn"], js.fed.params,
                                      batch_buckets=(4, 8))
    pserver = PersonalizedServer(env["papply"], ps.fed.params, max_batch=4)
    x = env["data"]["x_test"]
    for i, cid in enumerate([3, 0, 5, 3, 1, 2]):  # cross-client, dup ids
        jserver.submit(cid, x[cid, i])
        pserver.submit(cid, _t(x[cid, i]))
    jgot, pgot = jserver.flush(), pserver.flush()
    assert len(pgot) == 6
    for a, b in zip(pgot, jgot):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    stats = pserver.throughput()
    assert set(stats) == set(jserver.throughput())
    assert stats["requests"] == 6 and stats["batches"] == 2
    assert stats["padded_slots"] == 0.0
    pserver.update_params({k: v * 0.5 for k, v in ps.fed.params.items()})
    pserver.submit(2, _t(x[2, 5]))
    assert not np.allclose(pserver.flush()[0], pgot[-1])
    with pytest.raises(ValueError, match="client axis"):
        pserver.update_params({k: torch.cat([v, v]) for k, v in
                               ps.fed.params.items()})
    with pytest.raises(ValueError, match="client_id"):
        pserver.submit(99, _t(x[0, 0]))
