"""The port's attacks and threat models (WPFed §3.6, §4.7, §4.8; Figs.
4-5) held against the JAX package on the CPU.

The JAX package draws the fresh parameters of "corrupt" from its PRNG
key; the tests inject that draw (`corrupt_params(fresh=)`, or through the
`init_fn` the port calls once per client in order), so both packages
attack with the same numbers. Minibatch indices and ProxyFL's peers are
injected as in `test_torch_baselines.py`. Tolerances: codes, rankings,
ids, masks, commitments and the attack transforms' outputs exact; params
and `mean_loss` rtol 1e-4, atol 1e-6; the threat telemetry within 1e-6.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.core.adversary as jadv
import repro.core.attacks as jattacks
import repro.core.rounds as jrounds
from repro.core import evaluate as jax_evaluate
from repro.core import init_state as jax_init_state
from repro.core import verify as jverify
from repro.kernels import ops as jops
from repro.kernels import ref as jref

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import adversary, attacks, rounds, verify
from repro_torch.core import protocol as P
from repro_torch.kernels import ops
from repro_torch.launch import fed as launch_fed
from repro_torch.models.client import init_client_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam
from test_torch_protocol import (_close, _np, _port_state, _t,
                                 _update_batch_idx, program_apply)

TELEMETRY = ("attacker_admission_rate", "rank_score_honest",
             "rank_score_attacker")


@pytest.fixture(scope="module")
def ctx(tiny_fed):
    f = dict(tiny_fed)
    f["pfed"] = pcfg.FedConfig(**dataclasses.asdict(f["fed"]))
    f["pmc"] = pcfg.ClientModelConfig(**dataclasses.asdict(f["mcfg"]))
    f["papply"] = program_apply(f["pmc"])
    f["pdata"] = {k: _t(v) for k, v in f["data"].items()}
    f["jstate0"] = jax_init_state(f["apply_fn"], f["init_fn"], f["opt"],
                                  f["fed"], jax.random.PRNGKey(0))
    f["jmask"] = jnp.arange(f["fed"].num_clients) >= 4      # last 2 of 6
    f["pmask"] = torch.arange(f["fed"].num_clients) >= 4
    return f


def _jax_fresh(ctx, key):
    """JAX's `corrupt_params` draw for `key`, in the port's layout."""
    m = ctx["fed"].num_clients
    fresh = jax.vmap(ctx["init_fn"])(jax.random.split(key, m))
    return params_from_jax(ctx["pmc"], _np(fresh))


class Injected:
    """An `init_fn` for the port's "corrupt" that hands out a stacked draw
    one client per call, in order (the port calls it M times)."""

    def __init__(self):
        self.queue = []

    def load(self, fresh):
        m = next(iter(fresh.values())).shape[0]
        self.queue = [P.client(fresh, i) for i in range(m)]

    def __call__(self, generator):
        return self.queue.pop(0)


# ---------------------------------------------------------------------------
# validation: the same errors as the JAX package
# ---------------------------------------------------------------------------
_INIT = lambda k: {"w": jnp.zeros((2,))}      # noqa: E731


@pytest.mark.parametrize("call,match", [
    (("resolve_attack", "dos"), "unknown attack"),
    (("resolve_attack", "corrupt"), "init_fn"),
    (("resolve_attack", "poison"), "init_fn"),
    (("resolve_attack", "forge_codes"), "target_id"),
    (("resolve_attack", "corrupt", dict(init_fn=_INIT, every=0)), "every"),
    (("resolve_attack", "corrupt", dict(init_fn=_INIT, start_round=-1)),
     "start_round"),
    (("resolve_threat", "byzantine", dict(num_clients=6)), "unknown threat"),
    (("resolve_threat", "poison", dict(num_clients=6)), "init_fn"),
    (("attacker_mask_tail", 8, 0.0), "attacker_frac"),
    (("attacker_mask_tail", 8, 1.0), "attacker_frac"),
    (("threat_model", [], "mask"), "at least one"),
    (("threat_model", ["not an attack"], "mask"), "resolve_attack"),
    (("threat_model", ["lie"], "int"), "bool"),
    (("threat_model", ["lie"], "2d"), "1-D"),
])
def test_validation_errors_match_jax(call, match):
    name, *args = call
    kw = args.pop() if args and isinstance(args[-1], dict) else {}
    errs = []
    for mod, arr in ((jadv, jnp), (adversary, torch)):
        a = list(args)
        if name == "threat_model":
            lie = mod.resolve_attack("lie_in_reveal")
            a[0] = [lie if x == "lie" else (lambda s: s) for x in a[0]]
            a[1] = {"mask": arr.arange(6) >= 4, "int": arr.arange(6),
                    "2d": arr.zeros((2, 3), dtype=bool)}[a[1]]
        with pytest.raises((ValueError, TypeError), match=match) as e:
            getattr(mod, name)(*a, **kw)
        errs.append((e.type, str(e.value).split(", got")[0]))
    assert errs[0] == errs[1]


def test_presets_and_defaults_match_jax(ctx):
    assert adversary.ATTACKS == jadv.ATTACKS
    assert adversary.THREATS == jadv.THREATS
    for name in ("poison", "lie_in_reveal", "corrupt", "forge_codes"):
        kw = dict(init_fn=_INIT, target_id=0)
        a = jadv.resolve_attack(name, **kw)
        b = adversary.resolve_attack(name, **kw)
        assert (a.name, a.start_round, a.every) == \
            (b.name, b.start_round, b.every)
    for m, frac in ((8, 0.25), (6, 0.34), (10, 0.5)):
        assert adversary.attacker_mask_tail(m, frac).tolist() == \
            jadv.attacker_mask_tail(m, frac).tolist()
    for name in adversary.THREATS:
        kw = dict(num_clients=6, attacker_frac=0.34, start_round=2)
        j = jadv.resolve_threat(name, init_fn=ctx["init_fn"], **kw)
        p = adversary.resolve_threat(name, init_fn=lambda g: None, **kw)
        assert [(a.name, a.start_round, a.every) for a in p.attacks] == \
            [(a.name, a.start_round, a.every) for a in j.attacks]
        assert p.attacker_mask.tolist() == j.attacker_mask.tolist()
        assert p.name == j.name and p.seed == 0
    tm = adversary.threat_model([adversary.resolve_attack("lie_in_reveal")],
                                ctx["pmask"], seed=5, name="liars")
    assert tm.name == "liars" and tm.seed == 5 and len(tm.attacks) == 1


def test_attack_active_matches_jax():
    r = np.arange(14)
    for start, every in ((0, 1), (3, 2), (1, 4), (50, 3)):
        want = np.asarray(jattacks.attack_active(jnp.asarray(r), start,
                                                 every))
        assert [attacks.attack_active(int(i), start, every) for i in r] == \
            want.tolist()
        assert attacks.attack_active(torch.from_numpy(r), start,
                                     every).tolist() == want.tolist()


# ---------------------------------------------------------------------------
# the transforms on the same state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", ["forge", "lie", "lie_width1", "corrupt",
                                    "poison"])
def test_attack_transform_matches_jax(ctx, attack):
    jstate, pmc = ctx["jstate0"], ctx["pmc"]
    jmask, pmask = ctx["jmask"], ctx["pmask"]
    rs = np.random.RandomState(4)
    if attack.startswith("lie"):
        n = 1 if attack == "lie_width1" else 3
        ranks = rs.randint(-1, 6, (6, n)).astype(np.int32)
        jstate = jstate._replace(rankings=jnp.asarray(ranks))
        commits = jverify.fnv1a_commit(jnp.asarray(ranks), 0)
        j = jattacks.lie_in_reveal(jstate, jmask)
        p = attacks.lie_in_reveal(_port_state(jstate, pmc), pmask)
        assert np.array_equal(p.rankings.numpy(), np.asarray(j.rankings))
        flagged = verify.verify_rankings_fnv(
            p.rankings, _t(np.asarray(commits).astype(np.int64)))
        assert flagged.tolist() == (~pmask).tolist()  # exactly the liars
        return
    if attack == "forge":
        j = jattacks.forge_lsh_codes(jstate, jmask, 1)
        p = attacks.forge_lsh_codes(_port_state(jstate, pmc), pmask, 1)
        assert np.array_equal(p.codes.numpy().view(np.uint32),
                              np.asarray(j.codes))
        assert (p.codes[4:] == p.codes[1]).all()
        return
    key = jax.random.PRNGKey(9)
    fresh = _jax_fresh(ctx, key)
    poison = jax.jit(lambda s, r: jattacks.poison_step(
        s, jmask, ctx["init_fn"], key, r, start_round=1, every=2))
    for r in ((0,) if attack == "corrupt" else (0, 1, 2, 3)):
        if attack == "corrupt":
            j = jattacks.corrupt_params(jstate, jmask, ctx["init_fn"], key)
            p = attacks.corrupt_params(_port_state(jstate, pmc), pmask,
                                       fresh=fresh)
        else:
            j = poison(jstate, jnp.asarray(r))
            p = attacks.poison_step(_port_state(jstate, pmc), pmask, None,
                                    None, r, start_round=1, every=2,
                                    fresh=fresh)
        for k, v in params_from_jax(pmc, _np(j.params)).items():
            assert torch.equal(p.params[k], v), (r, k)
        changed = not torch.equal(p.params["w.0"],
                                  _port_state(jstate, pmc).params["w.0"])
        assert changed == (attack == "corrupt" or r in (1, 3))


# ---------------------------------------------------------------------------
# instrumented rounds against the JAX instrumented rounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,threat", [
    ("wpfed", "lsh_cheat"), ("wpfed", "poison"), ("wpfed", "lie_in_reveal"),
    ("silo", "lsh_cheat"), ("proxyfl", "lsh_cheat")])
def test_instrumented_round_matches_jax(ctx, method, threat):
    """`instrument_program` over WPFed under each threat, and over a
    baseline without a selection stage (SILO: no telemetry) and one with
    a cache and injected draws (ProxyFL), the threat attacking
    from round 0 (forged codes tie every attacker with the target in
    WPFed's selection): two global rounds under lsh_cheat (the second
    ranked), one otherwise. The JAX draws of "corrupt" for each round are
    injected."""
    fed, data, pdata, pmc = ctx["fed"], ctx["data"], ctx["pdata"], ctx["pmc"]
    m, n_local = fed.num_clients, pdata["x_train"].shape[1]
    key = jax.random.PRNGKey(7)
    inject = Injected()
    kw = dict(num_clients=m, attacker_frac=0.34, start_round=0,
              every=1 if threat == "poison" else None)
    jtm = jadv.resolve_threat(threat, init_fn=ctx["init_fn"], key=key, **kw)
    ptm = adversary.resolve_threat(threat, init_fn=inject, seed=7, **kw)
    extra = ({"shared_ref_x": np.array(data["x_ref"][0])}
             if method == "fedmd" else {})
    jprog = jadv.instrument_program(jrounds.make_program(
        method, ctx["apply_fn"], ctx["opt"], fed,
        **{k: jnp.asarray(v) for k, v in extra.items()}), jtm)
    pprog = adversary.instrument_program(rounds.make_program(
        method, ctx["papply"], adam(fed.lr), ctx["pfed"], **extra), ptm)
    assert pprog.name == jprog.name == f"{method}+{threat}"
    jglobal = jax.jit(jprog.global_round)
    jstate = ctx["jstate0"]
    for r in range(2 if (method, threat) == ("wpfed", "lsh_cheat") else 1):
        inject.load(_jax_fresh(ctx, jadv.attack_key(key, 0, r)))
        split = 2 if method in ("silo", "fedmd", "kdpdfl") else 3
        rng_upd = jax.random.split(jstate.rng, split)[-1]
        jnew, jcache, jm = jglobal(jstate, data)
        pkw = {"peer_ids": _t(jcache).long()} if method == "proxyfl" else {}
        pnew, pcache, pm = pprog.global_round(
            _port_state(jstate, pmc), pdata,
            batch_idx=_update_batch_idx(rng_upd, fed, n_local), **pkw)
        assert inject.queue == [] or threat == "lie_in_reveal"
        for k, v in params_from_jax(pmc, _np(jnew.params)).items():
            _close(pnew.params[k].numpy(), v.numpy())
        _close(float(pm["mean_loss"]), float(jm["mean_loss"]))
        if method != "wpfed":
            assert not set(TELEMETRY) & (set(pm) | set(jm))
        else:
            for k in ("neighbor_ids", "valid_mask", "ranking_scores"):
                assert np.array_equal(pm[k].numpy(), np.asarray(jm[k])), k
            assert np.array_equal(pnew.rankings.numpy(),
                                  np.asarray(jnew.rankings))
            assert np.array_equal(pnew.commitments.numpy().astype(np.uint32),
                                  np.asarray(jnew.commitments))
            for k in TELEMETRY + ("honest_reporter_frac",
                                  "valid_neighbor_frac"):
                _close(float(pm[k]), float(jm[k]), rtol=0, atol=1e-6)
            sums = np.asarray(jref.lsh_project_sums_batched_ref(
                jops.flatten_params_batched(jnew.params), r + 1,
                bits=fed.lsh_bits))
            near = np.abs(sums) <= 1e-3
            pbits = ops.unpack_bits(pnew.codes, fed.lsh_bits).numpy()
            jbits = np.asarray(jops.unpack_bits(jnew.codes, fed.lsh_bits))
            assert np.array_equal(pbits[~near], jbits[~near])
            print(f"{threat} round {r}: {int(near.sum())} code bits with "
                  "|JAX sum| <= 1e-3")
        jstate = jnew


# ---------------------------------------------------------------------------
# end to end on the port's own draws
# ---------------------------------------------------------------------------
def test_attacks_fire_inside_gossip_epochs(ctx):
    """A marker attack (rankings += 1) at start_round=1, every=2 fires at
    epochs 1 and 3 of a 4-round period: WPFed's epochs never rewrite the
    rankings, so the final state shows exactly the two firings."""
    pfed = ctx["pfed"]
    marker = adversary.Attack(
        "marker", lambda s, mask, r, g: s._replace(rankings=s.rankings + 1),
        start_round=1, every=2)
    tm = adversary.threat_model([marker], ctx["pmask"], name="marker")
    prog = P.wpfed_program(ctx["papply"], adam(pfed.lr), pfed)
    st0 = P.init_state(lambda g: init_client_model(ctx["pmc"], g),
                       adam(pfed.lr), pfed, seed=2)
    clean, _, _ = prog.global_round(st0, ctx["pdata"])
    st, _ = rounds.run_rounds(adversary.instrument_program(prog, tm), st0,
                              ctx["pdata"], rounds=4,
                              schedule=rounds.Schedule(4))
    assert st.round == 4
    assert torch.equal(st.rankings, clean.rankings + 2)


@pytest.mark.parametrize("threat,backend", [("lsh_cheat", "ann"),
                                            ("lie_in_reveal", "oracle"),
                                            ("poison", "oracle")])
def test_threat_telemetry_end_to_end(ctx, threat, backend):
    """Two rounds on the port's own draws: lsh_cheat selecting through the
    ANN path keeps its admission telemetry in [0, 1]; the §3.6 check flags
    exactly the 2 liars of 6; a poisoned run keeps finite telemetry."""
    pfed = dataclasses.replace(ctx["pfed"], selection_backend=backend,
                               ann_prefix_bits=3, ann_probes=2)
    init_fn = lambda g: init_client_model(ctx["pmc"], g)  # noqa: E731
    tm = adversary.resolve_threat(threat, num_clients=6, attacker_frac=0.34,
                                  init_fn=init_fn, seed=1, start_round=0,
                                  every=1)
    prog = adversary.instrument_program(
        P.wpfed_program(ctx["papply"], adam(pfed.lr), pfed), tm)
    st = P.init_state(init_fn, adam(pfed.lr), pfed, seed=1)
    _, hist = rounds.run_rounds(prog, st, ctx["pdata"], rounds=2)
    for h in hist:
        assert 0.0 <= h["attacker_admission_rate"] <= 1.0
        assert np.isfinite(h["rank_score_honest"])
        assert np.isfinite(h["rank_score_attacker"])
        frac = 4 / 6 if threat == "lie_in_reveal" else 1.0
        assert abs(h["honest_reporter_frac"] - frac) < 1e-6


def test_evaluate_honest_mask_matches_jax(ctx):
    jstate = ctx["jstate0"]
    pstate = _port_state(jstate, ctx["pmc"])
    for mask in (None, np.array([1, 1, 0, 1, 0, 0], np.float32),
                 np.zeros(6, np.float32)):
        j = jax_evaluate(ctx["apply_fn"], jstate, ctx["data"],
                         honest_mask=None if mask is None
                         else jnp.asarray(mask))
        p = P.evaluate(ctx["papply"], pstate, ctx["pdata"],
                       honest_mask=None if mask is None else _t(mask))
        _close(p["per_client_acc"].numpy(), j["per_client_acc"], rtol=0)
        _close(float(p["mean_acc"]), float(j["mean_acc"]), rtol=0)
    bool_mask = P.evaluate(ctx["papply"], pstate, ctx["pdata"],
                           honest_mask=~ctx["pmask"])["mean_acc"]
    want = P.evaluate(ctx["papply"], pstate, ctx["pdata"])["per_client_acc"]
    assert float(bool_mask) == pytest.approx(float(want[:4].mean()))


def test_attack_flags_on_the_cpu(capsys):
    """`--attack*` through the launcher's CLI with `--device cpu`: the
    liars are flagged in every round (`run_federation(attack="lsh_cheat")`
    on the CPU runs in `test_torch_isolation.py`)."""
    launch_fed.main(["--device", "cpu", "--dataset", "aecg", "--clients",
                     "4", "--rounds", "2", "--attack", "lie_in_reveal",
                     "--attack-frac", "0.5", "--attack-start", "0"])
    out = capsys.readouterr().out
    hist = json.loads(out[out.index("[\n"):])
    assert [h["honest_reporter_frac"] for h in hist] == [0.5, 0.5]
    assert all(0.0 <= h["acc"] <= 1.0 for h in hist)
