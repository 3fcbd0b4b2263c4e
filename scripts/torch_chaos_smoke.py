"""Chaos soak of the port's hardened federation service (the counterpart
of `scripts/chaos_smoke.py`), at fixture scale.

Runs the `torch_service_smoke` fixture federation under a seeded
FaultPlan with every fault kind active (drop, delay, duplicate, corrupt,
stragglers, flaky publish / fetch, a scheduled crash-restart and a
forked ledger view) and asserts the degraded-mode invariants:

  A. fault-free reference run (hardened transport, no plan);
  F. the full fault plan minus the crash, straight through;
  F2. the same plan again: fault traces, state and metrics reproduce
      bit for bit (the rounds' wall seconds left out);
  K. the same plan with the crash: the service dies mid-period, the
     newest snapshot is truncated (a crash mid-write), the canonical
     ledger is replaced by a rolled-back view (the true history
     surviving only as chain.fork1.json). Resume must fall back to the
     previous retained snapshot, recover the longest valid ledger view,
     replay the lost periods (re-publishes dedupe against the recovered
     chain) and land bitwise equal to F.

Acceptance: every fault kind fired at least once; the faulted run's
final accuracy is within ACC_TOLERANCE of the fault-free run's;
kill/resume stays bitwise; the same seed gives identical traces.

    PYTHONPATH=src python scripts/torch_chaos_smoke.py
    PYTHONPATH=src python scripts/torch_chaos_smoke.py --device cpu

Runs on the CUDA device unless `--device` names another. Prints, and
`main` returns, the run's numbers as JSON.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_service_smoke import (build, no_wall,  # noqa: E402 (the fixture)
                                 same_state)

from repro_torch.core import evaluate, init_state  # noqa: E402
from repro_torch.core.chain import Blockchain, save_chain  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.service import (BulletinTransport,  # noqa: E402
                                 CrashInjected, ServiceConfig,
                                 init_service_state, resume_service,
                                 run_service)
from repro_torch.service.transport import (recover_chain,  # noqa: E402
                                           rollback_view, write_fork_view)

PERIODS = 4
CRASH_PERIOD = 2
ACC_TOLERANCE = 0.25

# every fault kind active, rates tuned so a 6-client x 4-period run
# exercises each at least once while staying eventually delivering
PLAN = FaultPlan(seed=21, drop=0.12, delay=0.12, duplicate=0.18,
                 corrupt=0.12, straggle=0.18, publish_fail=0.3,
                 fetch_fail=0.2, crash_periods=(CRASH_PERIOD,),
                 fork_at=1)
FAULT_KINDS = ("drop", "delay", "duplicate", "corrupt", "straggle",
               "publish_fail", "fetch_fail")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fed, apply_fn, init_fn, opt, data = build(device=dev)
    svc = ServiceConfig(reselect_every=3, keep_last_k=2)
    assert PLAN.eventually_delivering(), "soak plan must converge"
    plan_nc = dataclasses.replace(PLAN, crash_periods=())

    def fresh():
        return init_service_state(init_state(init_fn, opt, fed, 0), svc)

    def eval_fn(st, d):
        return {"acc": evaluate(
            apply_fn, st.fed, d,
            honest_mask=st.active.to(torch.float32))["mean_acc"]}

    def soak(state, *, plan, ckpt_dir, chain=None, start_period=0):
        """One service run through an explicit transport (so its fault
        trace can be read back)."""
        xp = BulletinTransport(chain if chain is not None
                               else Blockchain(), plan=plan)
        result = run_service(
            apply_fn, opt, fed, svc, state, data, periods=PERIODS,
            ckpt_dir=ckpt_dir, start_period=start_period,
            eval_fn=eval_fn, transport=xp)
        return result, xp

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("a", "f", "f2", "k")}

        # A: fault-free reference (hardened transport, no plan)
        (s_a, chain_a, hist_a), _ = soak(fresh(), plan=None,
                                         ckpt_dir=dirs["a"])
        acc_a = hist_a[-1]["acc"]

        # F: every fault kind, no crash: the uninterrupted chaos run
        (s_f, chain_f, hist_f), xp_f = soak(fresh(), plan=plan_nc,
                                            ckpt_dir=dirs["f"])
        acc_f = hist_f[-1]["acc"]
        fired = xp_f.trace.snapshot()
        for kind in FAULT_KINDS:
            assert fired.get(kind, 0) > 0, \
                f"fault kind {kind!r} never fired (trace: {fired}): " \
                f"retune PLAN rates/seed"
        degraded = sum(h.get("degraded_round", 0) for h in hist_f)
        assert degraded > 0, "no degraded rounds under the chaos plan"
        assert abs(acc_f - acc_a) < ACC_TOLERANCE, \
            f"chaos acceptance diverged: fault-free {acc_a:.3f} vs " \
            f"faulted {acc_f:.3f} (tolerance {ACC_TOLERANCE})"
        assert chain_f.verify_chain(), "faulted ledger broken"

        # F2: the same plan reproduces the identical fault trace and the
        # identical run, bit for bit
        (s_f2, chain_f2, hist_f2), xp_f2 = soak(fresh(), plan=plan_nc,
                                                ckpt_dir=dirs["f2"])
        assert xp_f2.trace.events == xp_f.trace.events, \
            "same FaultPlan seed produced a different fault trace"
        assert no_wall(hist_f2) == no_wall(hist_f), \
            "same plan, different metrics"
        assert same_state(s_f, s_f2), "same plan, different final state"

        # K: crash + truncated snapshot + forked ledger, full recovery
        try:
            run_service(apply_fn, opt, fed, svc, fresh(), data,
                        periods=PERIODS, ckpt_dir=dirs["k"],
                        eval_fn=eval_fn, faults=PLAN)
            raise AssertionError("scheduled crash never fired")
        except CrashInjected as e:
            assert e.period == CRASH_PERIOD
        # sabotage 1: the newest snapshot (period 1) truncates as if the
        # process died mid-write
        snaps = sorted(f for f in os.listdir(dirs["k"])
                       if f.endswith(".npz"))
        newest = os.path.join(dirs["k"], snaps[-1])
        with open(newest, "rb") as fh:
            blob = fh.read()
        with open(newest, "wb") as fh:
            fh.write(blob[:len(blob) // 3])
        # sabotage 2: the canonical ledger rolls back one block; the true
        # history survives only as a fork view
        true_chain = recover_chain(dirs["k"])
        save_chain(os.path.join(dirs["k"], "chain.json"),
                   rollback_view(true_chain, 1))
        write_fork_view(dirs["k"], true_chain, idx=1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s_r, chain_r, p0 = resume_service(dirs["k"], fresh())
        assert any("falling back" in str(w.message) for w in caught), \
            "truncated-snapshot fallback did not warn"
        assert p0 == 1, \
            f"expected fallback resume at period 1 (period-0 snapshot), " \
            f"got {p0}"
        assert chain_r.head_round() == true_chain.head_round(), \
            "fork recovery did not pick the longest valid view"
        # replay the lost periods; the replay of period 2 is the same
        # with or without the scheduled crash (fault hashes do not read
        # crash_periods), so replay without it to finish
        s_k, chain_k, hist_k = run_service(
            apply_fn, opt, fed, svc, s_r, data, periods=PERIODS,
            chain=chain_r, ckpt_dir=dirs["k"], start_period=p0,
            eval_fn=eval_fn, faults=plan_nc)
        # bitwise equivalence with the uninterrupted faulted run
        assert same_state(s_k, s_f), \
            "crash/fork-recovered state not bitwise equal to the " \
            "uninterrupted faulted run"
        assert [b.payload for b in chain_k.blocks] == \
            [b.payload for b in chain_f.blocks], \
            "recovered ledger recorded different protocol content"
        tail = hist_f[-len(hist_k):]
        assert no_wall(hist_k) == no_wall(tail), \
            "resumed metrics diverged under faults"

        result = {
            "acc_fault_free": round(float(acc_a), 4),
            "acc_faulted": round(float(acc_f), 4),
            "fault_trace": fired,
            "degraded_rounds": int(degraded),
            "crash_period": CRASH_PERIOD,
            "resume_period": p0,
            "wall_s": round(time.time() - t0, 1),
        }
        print(json.dumps(result, indent=1))
        print("chaos smoke OK: all fault kinds fired, acceptance within "
              f"{ACC_TOLERANCE} of fault-free, kill/resume bitwise, fork "
              "recovered, trace reproduced")
    return result


if __name__ == "__main__":
    main()
