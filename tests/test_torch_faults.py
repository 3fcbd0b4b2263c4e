"""The port's fault layer, bulletin-board transport and ledger
persistence: held against the JAX package where both compute the same
thing (fault verdicts, counters, checksums, block payloads, chain.json),
and on their own for the service's degraded-mode properties (kill/resume
under faults and a crash, snapshot fallback, ledger rollback refusal,
fork recovery, fault-free no-op, straggler == churn). Every comparison
is exact. The service runs use 6 MLP clients, N=3, periods of 2 rounds;
the transport's backoff sleep is turned off where retries fire.
"""
import dataclasses
import os
import types
import warnings

import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.core import chain as jchain
from repro.core import faults as jfaults
from repro.service import transport as jtransport

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import protocol as P
from repro_torch.core.chain import Blockchain, load_chain, save_chain
from repro_torch.core.faults import (FaultPlan, fault_scalars, fault_u01,
                                     leading_failures, parse_fault_spec,
                                     period_faults)
from repro_torch.models.client import init_client_model
from repro_torch.optim import adam
from repro_torch.service import (BulletinTransport, ChurnEvent, CrashInjected,
                                 LedgerRollbackError, RetryPolicy,
                                 ServiceConfig, TransportError,
                                 checkpoint_num_clients, init_service_state,
                                 mask_stragglers, resume_service, run_service)
from repro_torch.service.transport import (announcement_checksum,
                                           divergent_view, recover_chain,
                                           rollback_view, write_fork_view)
from repro_torch.tree import tree_leaves
from test_torch_protocol import _t, program_apply

SPEC = ("seed={seed},drop=0.2,delay=0.2,duplicate=0.3,corrupt=0.2,"
        "straggle=0.3,publish_fail=0.4,fetch_fail=0.4,crash=2,fork=1")
NO_SLEEP = dict(retry=RetryPolicy(), sleep=lambda s: None)


@pytest.fixture(scope="module")
def svc_env(tiny_fed):
    """The port's service on `tiny_fed`: (apply, opt, fed, svc), a fresh
    state from seed 0 and the data as tensors."""
    pfed = pcfg.FedConfig(**dataclasses.asdict(tiny_fed["fed"]))
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(tiny_fed["mcfg"]))
    svc = ServiceConfig(reselect_every=2, keep_last_k=2)
    state = init_service_state(
        P.init_state(lambda g: init_client_model(pmc, g), adam(pfed.lr),
                     pfed, seed=0), svc)
    args = (program_apply(pmc), adam(pfed.lr), pfed, svc)
    data = {k: _t(v) for k, v in tiny_fed["data"].items()}
    return {"svc": svc, "state": state, "args": args, "data": data,
            "fed": pfed}


def _fake_state(m=6, words=4, n=3, seed=0):
    """The state surface `collect` reads, in each package's types."""
    rs = np.random.RandomState(seed)
    codes = rs.randint(0, 2 ** 32, (m, words), dtype=np.uint32)
    rankings = rs.randint(-1, m, (m, n)).astype(np.int32)
    jst = types.SimpleNamespace(fed=types.SimpleNamespace(
        codes=codes, rankings=rankings))
    pst = types.SimpleNamespace(fed=types.SimpleNamespace(
        codes=_t(codes.view(np.int32)), rankings=_t(rankings)))
    return jst, pst


def _same_state(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _no_seconds(hist):
    return [{k: v for k, v in h.items() if k != "seconds"} for h in hist]


def _payloads(chain):
    return [b.payload for b in chain.blocks]


# ---------------------------------------------------------------------------
# fault verdicts and counters against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("clients", [1, 6, 37])
def test_period_faults_and_scalars_match_jax(seed, clients):
    """Every verdict, counter and straggler mask over periods 0-5 equals
    the JAX package's, bit for bit."""
    spec = SPEC.format(seed=seed)
    plan, jplan = parse_fault_spec(spec), jfaults.parse_fault_spec(spec)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    rs = np.random.RandomState(seed + clients)
    for period in range(6):
        a = period_faults(plan, period, clients, 5)
        b = jfaults.period_faults(jplan, period, clients, 5)
        for f in ("stragglers", "drop", "delay", "duplicate", "corrupt"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.publish_failures, a.fetch_failures, a.crash) == \
            (b.publish_failures, b.fetch_failures, b.crash)
        assert a.any_delivery_fault() == b.any_delivery_fault()
        announcing = rs.rand(clients) < 0.7
        assert fault_scalars(a, announcing) == \
            jfaults.fault_scalars(b, announcing)
        xp = BulletinTransport(Blockchain(), plan=plan)
        jxp = jtransport.BulletinTransport(jchain.Blockchain(), plan=jplan)
        assert np.array_equal(xp.straggler_mask(period, announcing),
                              jxp.straggler_mask(period, announcing))
        assert xp.trace.events == jxp.trace.events
    for kind in jfaults.FAULT_KINDS:
        assert fault_u01(seed, kind, 3, 2, 1) == \
            jfaults.fault_u01(seed, kind, 3, 2, 1)
        if kind in ("publish_fail", "fetch_fail"):
            assert leading_failures(plan, kind, 4, 5) == \
                jfaults.leading_failures(jplan, kind, 4, 5)


def test_plan_validation_and_spec_parsing():
    with pytest.raises(ValueError, match="outside"):
        FaultPlan(drop=1.5)
    with pytest.raises(ValueError, match="crash_periods"):
        FaultPlan(crash_periods=(-1,))
    plan = parse_fault_spec("seed=7, drop=0.1, straggle=0.2, "
                            "publish_fail=0.3, crash=2, crash=5, fork=1")
    assert plan == FaultPlan(seed=7, drop=0.1, straggle=0.2,
                             publish_fail=0.3, crash_periods=(2, 5),
                             fork_at=1)
    assert plan.eventually_delivering()
    assert not FaultPlan(drop=1.0).eventually_delivering()
    with pytest.raises(ValueError, match="unknown fault spec key"):
        parse_fault_spec("dorp=0.1")
    with pytest.raises(ValueError, match="key=value"):
        parse_fault_spec("drop")
    # drop wins over corrupt / delay / duplicate
    pf = period_faults(FaultPlan(seed=1, drop=1.0, delay=1.0, duplicate=1.0,
                                 corrupt=1.0), 0, 8, 5)
    assert pf.drop.all() and not (pf.corrupt | pf.delay | pf.duplicate).any()


# ---------------------------------------------------------------------------
# the announcement link against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan_seed", [None, 2, 5])
def test_collect_publish_payloads_match_jax(plan_seed):
    """Checksums, delivery verdicts, the trace and the published block's
    payload equal the JAX transport's on the same announcements (blocks
    differ only by their wall-clock timestamps and hence hashes)."""
    jst, pst = _fake_state(seed=plan_seed or 0)
    announcing = np.array([True, True, False, True, True, True])
    plan = jplan = None
    if plan_seed is not None:
        spec = SPEC.format(seed=plan_seed)
        plan, jplan = parse_fault_spec(spec), jfaults.parse_fault_spec(spec)
    xp = BulletinTransport(Blockchain(), plan=plan, **NO_SLEEP)
    jxp = jtransport.BulletinTransport(
        jchain.Blockchain(), plan=jplan, retry=jtransport.RetryPolicy(),
        sleep=lambda s: None)
    for period in range(3):
        got = xp.collect(period, announcing, pst)
        want = jxp.collect(period, announcing, jst)
        assert got[0] == want[0] and got[1] == want[1]
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(got[3], want[3])
        for e in got[0].values():
            assert e["sum"] == announcement_checksum(e) == \
                jtransport.announcement_checksum(e)
        try:
            blk = xp.publish(period, 2 * period, got[0], got[1])
        except TransportError:
            with pytest.raises(jtransport.TransportError):
                jxp.publish(period, 2 * period, want[0], want[1])
            continue
        jblk = jxp.publish(period, 2 * period, want[0], want[1])
        assert blk.payload == jblk.payload
        assert xp.fetch(period, 2 * period) is blk
        assert jxp.fetch(period, 2 * period) is jblk
    assert xp.trace.events == jxp.trace.events


def test_chain_json_loads_and_verifies_across_packages(tmp_path):
    """A chain.json saved by either package loads and verifies in the
    other with the same hashes; a tampered one fails verification."""
    for make, load_other in ((Blockchain, jchain.load_chain),
                             (jchain.Blockchain, load_chain)):
        chain = make()
        chain.publish_round(0, {0: {"lsh": "ab", "commit": "cd"}},
                            reveals={0: [1, 2]})
        chain.publish_round(3, {1: {"lsh": "ef", "commit": "01"}})
        path = str(tmp_path / f"{make.__module__}.json")
        (save_chain if make is Blockchain else jchain.save_chain)(path, chain)
        loaded = load_other(path)
        assert loaded.verify_chain()
        assert [b.hash for b in loaded.blocks] == \
            [b.hash for b in chain.blocks]
        assert loaded.head_round() == chain.head_round() == 3
        assert loaded.round_block(3).payload == chain.round_block(3).payload
        assert loaded.to_json() == chain.to_json()
        loaded.blocks[1].payload["reveals"]["0"] = [9, 9]
        assert not loaded.verify_chain()
    chain = Blockchain()
    assert chain.head_round() == -1 and chain.round_block(0) is None
    chain.publish_round(0, {})
    chain.publish_round(3, {})
    assert rollback_view(chain, 1).head_round() == 0
    with pytest.raises(ValueError, match="drop_last"):
        rollback_view(chain, 3)


# ---------------------------------------------------------------------------
# retry and the link's failure modes (port only)
# ---------------------------------------------------------------------------
def test_retry_backoff_exhaustion_and_idempotent_publish():
    rp = RetryPolicy(max_attempts=5, base_delay_s=0.02, max_delay_s=0.1,
                     jitter=0.25)
    assert rp.delay_s(0, 0.5) == pytest.approx(0.02)
    assert rp.delay_s(4, 0.5) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=2.0)
    seed = next(s for s in range(200) if 1 <= leading_failures(
        FaultPlan(seed=s, publish_fail=0.6), "publish_fail", 0, 5) <= 3)
    plan = FaultPlan(seed=seed, publish_fail=0.6)
    sleeps = []
    xp = BulletinTransport(Blockchain(), plan=plan, sleep=sleeps.append)
    xp.publish(0, 0, {0: {"lsh": "ab", "commit": "cd", "sum": "ef"}},
               {0: [1]})
    assert len(sleeps) == leading_failures(plan, "publish_fail", 0, 5) \
        == xp.trace.counters["publish_fail"]
    with pytest.raises(TransportError, match="publish of round 0"):
        BulletinTransport(Blockchain(), plan=FaultPlan(publish_fail=1.0),
                          sleep=lambda s: None).publish(0, 0, {}, {})
    ok = BulletinTransport(Blockchain())
    b1 = ok.publish(0, 0, {}, {})
    assert ok.publish(1, 0, {}, {}) is b1 and len(ok.chain.blocks) == 2
    with pytest.raises(TransportError, match="missing from the ledger"):
        ok.fetch(1, 7)


@pytest.mark.parametrize("kind", ["drop", "corrupt", "delay", "duplicate"])
def test_link_fault_semantics(kind):
    _, st = _fake_state()
    xp = BulletinTransport(Blockchain(), plan=FaultPlan(seed=2, **{kind: 1.0}))
    ann, _, failed, delayed = xp.collect(0, np.ones(6, bool), st)
    if kind in ("drop", "corrupt"):
        assert ann == {} and failed.all() and not delayed.any()
    else:
        assert sorted(ann) == list(range(6)) and not failed.any()
        assert delayed.all() == (kind == "delay")
    assert xp.trace.counters[kind] == 6
    ann, _, failed, _ = xp.collect(1, np.zeros(6, bool), st)
    assert ann == {} and not failed.any()


# ---------------------------------------------------------------------------
# degraded-mode service properties (port only)
# ---------------------------------------------------------------------------
def test_straggler_round_bit_identical_to_churn_round(svc_env):
    state, data = svc_env["state"], svc_env["data"]
    m = svc_env["fed"].num_clients
    seed = next(s for s in range(200) if 0 < period_faults(
        FaultPlan(seed=s, straggle=0.4), 0, m, 5).stragglers.sum() < m)
    plan = FaultPlan(seed=seed, straggle=0.4)
    strag = period_faults(plan, 0, m, 5).stragglers
    s_f, chain_f, hist_f = run_service(*svc_env["args"], state, data,
                                       periods=1, faults=plan)
    events = [ChurnEvent(0, "leave", int(i)) for i in np.nonzero(strag)[0]]
    s_c, chain_c, hist_c = run_service(*svc_env["args"], state, data,
                                       periods=1, events=events)
    assert np.array_equal(s_f.active.numpy(), s_c.active.numpy() | strag)
    _same_state(s_f._replace(active=s_c.active), s_c)
    assert _payloads(chain_f) == _payloads(chain_c)
    assert set(map(int, chain_f.round_block(0).payload["announcements"])) \
        == set(np.nonzero(~strag)[0].tolist())
    for hf, hc in zip(_no_seconds(hist_f), _no_seconds(hist_c)):
        assert all(hf[k] == hc[k] for k in hc)
    assert hist_f[-1]["fault_stragglers"] == float(strag.sum())


def test_fault_free_plan_is_bitwise_noop(svc_env):
    state, data = svc_env["state"], svc_env["data"]
    s_a, chain_a, hist_a = run_service(*svc_env["args"], state, data,
                                       periods=1)
    s_b, chain_b, hist_b = run_service(*svc_env["args"], state, data,
                                       periods=1, faults=FaultPlan(seed=9))
    _same_state(s_a, s_b)
    assert _payloads(chain_a) == _payloads(chain_b)
    for ha, hb in zip(_no_seconds(hist_a), _no_seconds(hist_b)):
        assert all(ha[k] == hb[k] for k in ha)
    assert hist_b[-1]["degraded_round"] == 0.0
    assert "degraded_round" not in hist_a[-1]


@pytest.mark.parametrize("kind", ["corrupt", "delay"])
def test_failed_delivery_reverts_and_delay_ages(svc_env, kind):
    """corrupt=1: the board keeps every client's last codes, so the state
    reverts to them and ages one period, while params still trained;
    delay=1: fresh codes land but age to 1."""
    state, data = svc_env["state"], svc_env["data"]
    s_f, chain_f, hist = run_service(*svc_env["args"], state, data,
                                     periods=1,
                                     faults=FaultPlan(seed=5, **{kind: 1.0}))
    blk = chain_f.round_block(0)
    same_codes = torch.equal(s_f.fed.codes, state.fed.codes)
    if kind == "corrupt":
        assert blk.payload["announcements"] == {} and same_codes
        assert torch.equal(s_f.fed.rankings, state.fed.rankings)
        assert hist[-1]["fault_corrupt"] == 6.0
    else:
        assert sorted(map(int, blk.payload["announcements"])) == \
            list(range(6)) and not same_codes
        assert hist[-1]["fault_delayed"] == 6.0
    assert s_f.code_age.tolist() == [1] * 6
    assert hist[-1]["degraded_round"] == 1.0
    assert not torch.equal(tree_leaves(s_f.fed.params)[0],
                           tree_leaves(state.fed.params)[0])


def test_crash_then_resume_bitwise_under_a_fault_plan(svc_env, tmp_path):
    """A plan with every fault kind, a crash at period 2 and a fork view
    after period 1: the crashed run resumed from disk equals the
    uninterrupted run of the same plan in state, rounds, the tapped
    counters and ledger payloads."""
    state, data = svc_env["state"], svc_env["data"]
    plan = parse_fault_spec(SPEC.format(seed=7))
    events = [ChurnEvent(1, "leave", 4), ChurnEvent(2, "join", 4)]
    ck = str(tmp_path / "crash")
    xp = lambda chain=None: BulletinTransport(  # noqa: E731
        chain if chain is not None else Blockchain(), plan=plan, **NO_SLEEP)
    with pytest.raises(CrashInjected, match="period 2"):
        run_service(*svc_env["args"], state, data, periods=3, events=events,
                    ckpt_dir=ck, transport=xp())
    assert os.path.exists(os.path.join(ck, "chain.fork0.json"))
    s_r, chain_r, p0 = resume_service(ck, state)
    assert p0 == 2 and chain_r.head_round() == 2
    assert checkpoint_num_clients(ck) == 6
    taps_k, taps_u = [], []
    s_k, chain_k, hist_k = run_service(
        *svc_env["args"], s_r, data, periods=3, events=events, ckpt_dir=ck,
        start_period=p0, transport=xp(chain_r), metrics_tap=taps_k.append)
    s_u, chain_u, hist_u = run_service(
        *svc_env["args"], state, data, periods=3, events=events,
        transport=BulletinTransport(Blockchain(), plan=dataclasses.replace(
            plan, crash_periods=()), **NO_SLEEP), metrics_tap=taps_u.append)
    _same_state(s_k, s_u)
    assert _payloads(chain_k) == _payloads(chain_u)
    assert _no_seconds(hist_k) == _no_seconds(hist_u[4:])
    assert _no_seconds(taps_k) == _no_seconds(taps_u[4:])
    assert "fault_dropped" in taps_k[0] and chain_k.verify_chain()


def test_truncated_checkpoint_falls_back_with_warning(svc_env, tmp_path):
    state, data = svc_env["state"], svc_env["data"]
    ck = str(tmp_path / "trunc")
    run_service(*svc_env["args"], state, data, periods=2, ckpt_dir=ck)
    newest = os.path.join(ck, "step_00000001.npz")
    blob = open(newest, "rb").read()
    with open(newest, "wb") as fh:          # a crash mid-write
        fh.write(blob[:len(blob) // 3])
    with pytest.warns(UserWarning, match="falling back"):
        s_r, chain_r, p0 = resume_service(ck, state)
    assert p0 == 1
    s_c, chain_c, _ = run_service(*svc_env["args"], s_r, data, periods=2,
                                  chain=chain_r, ckpt_dir=ck,
                                  start_period=p0)
    s_u, chain_u, _ = run_service(*svc_env["args"], state, data, periods=2)
    _same_state(s_c, s_u)
    assert _payloads(chain_c) == _payloads(chain_u)


def test_every_checkpoint_corrupt_raises(svc_env, tmp_path):
    state, data = svc_env["state"], svc_env["data"]
    ck = str(tmp_path / "allbad")
    run_service(*svc_env["args"], state, data, periods=2, ckpt_dir=ck)
    for f in os.listdir(ck):
        if f.endswith(".npz"):
            with open(os.path.join(ck, f), "wb") as fh:
                fh.write(b"not a zipfile")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="failed to load"):
            resume_service(ck, state)


def test_rolled_back_ledger_raises_and_longest_fork_wins(svc_env, tmp_path):
    state, data = svc_env["state"], svc_env["data"]
    ck = str(tmp_path / "rb")
    _, chain, _ = run_service(*svc_env["args"], state, data, periods=2,
                              ckpt_dir=ck)
    rolled = rollback_view(chain, 1)
    assert rolled.verify_chain()
    save_chain(os.path.join(ck, "chain.json"), rolled)
    with pytest.raises(LedgerRollbackError, match="behind the"):
        resume_service(ck, state)
    # the full history survives only as a fork view: recovery takes it
    write_fork_view(ck, chain, idx=1)
    s_r, chain_r, p0 = resume_service(ck, state)
    assert p0 == 2 and chain_r.head_round() == chain.head_round()
    # a same-length divergent fork never beats the canonical file
    save_chain(os.path.join(ck, "chain.json"), chain)
    write_fork_view(ck, divergent_view(chain, 1), idx=1)
    assert "fork" not in recover_chain(ck).blocks[-1].payload
    # an unreadable canonical file falls back to a valid fork
    with open(os.path.join(ck, "chain.json"), "w") as fh:
        fh.write("{corrupt")
    with pytest.warns(UserWarning, match="unreadable"):
        assert recover_chain(ck).verify_chain()


def test_mask_stragglers_is_churn_masking(svc_env):
    state = svc_env["state"]
    strag = np.array([False, True, False, False, True, False])
    masked = mask_stragglers(state, strag)
    assert masked.active.tolist() == (~strag).tolist()
    _same_state(state._replace(active=masked.active), masked)


def test_service_cli_kill_resume_and_serve_on_cpu(tmp_path, capsys):
    """The CLI on the CPU: a faulted service that crashes, its resume,
    and the federated server reading the checkpoint."""
    from repro_torch.launch import fed, serve
    ck = str(tmp_path / "cli")
    argv = ["--device", "cpu", "--service", "--dataset", "aecg",
            "--clients", "4", "--periods", "2", "--churn", "1:leave:2",
            "--faults", "seed=7,drop=0.3,crash=1", "--ckpt-dir", ck]
    with pytest.raises(CrashInjected):
        fed.main(argv)
    fed.main(argv + ["--resume"])
    assert checkpoint_num_clients(ck) == 4
    res = serve.serve_personalized("aecg", ckpt_dir=ck, requests=12,
                                   device="cpu", log=None)
    assert res["num_models"] == 3 and 2 not in res["client_ids"]
    assert res["logits"].shape == (12, 2) and res["requests"] == 12.0
    with pytest.raises(ValueError, match="another client model"):
        serve.main(["--device", "cpu", "--federated", "--ckpt-dir", ck])
    if not torch.cuda.is_available():    # without --device: the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fed.main(argv[2:])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--federated", "--dataset", "aecg"])
