"""The continuous federation driver. Counterpart of
`repro/service/driver.py`.

Each reselection period is one `core.rounds.make_segment_fn` segment (the
global round, then L-1 gossip epochs); per-round scalars stream to an
optional `metrics_tap` as each round ends. Between periods the host loop
runs: churn events apply (`membership.apply_events`), the period's
announcements publish to the host `Blockchain` through the hardened
`transport.BulletinTransport`, and the whole ServiceState checkpoints
through `checkpoint.store` (with retention), so a killed service resumes
bit for bit (`resume_service`).

The service round program wraps the WPFed phases with the membership
masks:

  global round   §3.6 verification restricted to active reporters,
                 Eq. 8 scores discounted by exp(-lambda * code_age) and
                 forced to -inf for departed clients, updates and
                 announcements applied to active clients only (inactive
                 slots keep frozen codes / rankings / params and age one
                 period).
  gossip epoch   exchange + update against the cached SelectResult; client
                 i trains only in the first G_i - 1 gossip epochs of the
                 period (its gossip budget).

Every period has the same length; the round axis is unbounded.

Faults and degraded rounds: with a `core.faults.FaultPlan`, stragglers
mask out of the segment through the same masking that join and leave use,
failed deliveries revert to last-known-good codes after the segment
(`membership.merge_delivery`), and the period's fault counters ride on
each tapped round and on the period's last history entry. Random draws
derive from (seed, round, stream) (`protocol.round_generator`), so a
resumed run draws what the uninterrupted one drew.
"""
from __future__ import annotations

import os
import time
import warnings
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.analysis.privacy import sink
from repro_torch.checkpoint import store
from repro_torch.configs.paper_models import FedConfig
from repro_torch.core.chain import Blockchain, save_chain
from repro_torch.core.faults import FaultPlan, fault_scalars
from repro_torch.core.protocol import (SELECT_STREAM, UPDATE_STREAM, FedState,
                                       _round_metrics, announce_phase,
                                       exchange_phase, round_generator,
                                       select_phase, update_phase)
from repro_torch.core.rounds import (RoundProgram, extract_history,
                                     make_segment_fn)
from repro_torch.service.membership import (ChurnEvent, ServiceConfig,
                                            ServiceState, apply_events,
                                            mask_stragglers, merge_delivery,
                                            participation_mask,
                                            staleness_discount,
                                            validate_events)
from repro_torch.service.transport import (CHAIN_FILE, BulletinTransport,
                                           recover_chain, rollback_view,
                                           write_fork_view)
from repro_torch.tree import tree_map


class CrashInjected(RuntimeError):
    """A FaultPlan-scheduled crash fired: the driver dies after the
    period's segment but before any durable effect (publish,
    checkpoint). Resume from the last checkpoint to continue."""

    def __init__(self, period: int):
        super().__init__(
            f"fault-injected crash at period {period} (resume from the "
            f"last checkpoint to continue)")
        self.period = period


# ---------------------------------------------------------------------------
# the service round program
# ---------------------------------------------------------------------------
def _service_metrics(sel, exch, train_metrics, state: ServiceState,
                     participate) -> Dict:
    """The engine's per-round metrics plus the membership telemetry,
    the same keys in the global round and every gossip epoch."""
    base = _round_metrics(sel, exch, train_metrics, state.fed.round)
    base["active_frac"] = state.active.to(torch.float32).mean()
    base["participation_frac"] = participate.to(torch.float32).mean()
    base["mean_code_age"] = state.code_age.to(torch.float32).mean()
    return base


def service_program(apply_fn: Callable, optimizer, fed: FedConfig,
                    svc: ServiceConfig) -> RoundProgram:
    """WPFed as a churn-tolerant program over ServiceState.

    Departed clients keep their padded slot, and their frozen params
    still evaluate inside exchanges that never read them. The masks
    guarantee:

      * a departed client's Eq. 8 weight is -inf, so it never enters any
        peer's top-N, and its stale rankings stop counting as Eq. 7
        evidence;
      * a stale re-joiner is selectable, at a score discounted by
        exp(-staleness_lambda * code_age);
      * only participants' params / optimizer state advance;
      * only active clients announce; everyone else's codes, rankings,
        commitments carry over frozen and their code_age grows.

    Both rounds accept `batch_idx` (see `protocol.update_phase`)."""
    if not fed.use_rank:
        raise ValueError(
            "the service requires use_rank=True: departed clients are "
            "excluded through the Eq. 8 score column (membership.py)")

    def global_round(state: ServiceState, data, batch_idx=None):
        st = state.fed
        a = state.active
        with record_function("wpfed.select"):
            sel = select_phase(
                st, fed, generator=round_generator(st.seed, st.round,
                                                   SELECT_STREAM),
                active=a, score_scale=staleness_discount(
                    state.code_age, svc.staleness_lambda))
        with record_function("wpfed.exchange"):
            exch = exchange_phase(apply_fn, fed, st.params, data, sel)
        with record_function("wpfed.update"):
            params, opt_state, train_metrics = update_phase(
                apply_fn, optimizer, fed, st.params, st.opt_state, data,
                exch, round_generator(st.seed, st.round, UPDATE_STREAM),
                batch_idx=batch_idx, participate=a)
        with record_function("wpfed.announce"):
            ann = announce_phase(fed, params, sel, exch, st.round)
            # these merged fields are what transport.collect reads onto
            # the host ledger and what checkpoints as chain.json: the
            # service's disclosure point (repro_torch.analysis.taint)
            codes, rankings, commitments = sink("ledger-publish", (
                torch.where(a[:, None], ann.codes, st.codes),
                torch.where(a[:, None], ann.rankings, st.rankings),
                torch.where(a, ann.commitments, st.commitments)))
            new_fed = FedState(params, opt_state, codes, rankings,
                               commitments, st.seed, st.round + 1)
        metrics = _service_metrics(sel, exch, train_metrics, state, a)
        new_state = ServiceState(
            new_fed, a, torch.where(a, 0, state.code_age + 1).to(
                torch.int32), state.gossip_count, st.round)
        return new_state, sel, metrics

    def gossip_round(state: ServiceState, data, sel, batch_idx=None):
        st = state.fed
        # 0-based gossip epoch within the period (the round counter is
        # already past the period's global round)
        part = participation_mask(state, st.round - state.period_start - 1)
        with record_function("wpfed.exchange"):
            exch = exchange_phase(apply_fn, fed, st.params, data, sel)
        with record_function("wpfed.update"):
            params, opt_state, train_metrics = update_phase(
                apply_fn, optimizer, fed, st.params, st.opt_state, data,
                exch, round_generator(st.seed, st.round, UPDATE_STREAM),
                batch_idx=batch_idx, participate=part)
        metrics = _service_metrics(sel, exch, train_metrics, state, part)
        return (state._replace(fed=st._replace(
            params=params, opt_state=opt_state, round=st.round + 1)),
            sel, metrics)

    return RoundProgram("wpfed-service", global_round, gossip_round)


# ---------------------------------------------------------------------------
# durable state
# ---------------------------------------------------------------------------
def checkpoint_service(ckpt_dir: str, period: int, state: ServiceState,
                       chain: Blockchain, *, keep_last_k: int) -> str:
    """One durable snapshot: the whole ServiceState as step_<period>.npz
    (the last k retained) and the ledger as chain.json, everything
    `resume_service` needs."""
    path = store.save(ckpt_dir, period, state, keep_last_k=keep_last_k)
    save_chain(os.path.join(ckpt_dir, CHAIN_FILE), chain)
    return path


def checkpoint_num_clients(ckpt_dir: str) -> int:
    """Client-axis size M of the latest snapshot, read from its stored
    active mask without a template, so a serving front can build a
    template of the right shape before `resume_service`."""
    period = store.latest_step(ckpt_dir)
    if period is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    with np.load(os.path.join(ckpt_dir, f"step_{period:08d}.npz")) as z:
        return int(z["a:active"].shape[0])


def checkpoint_param_names(ckpt_dir: str):
    """The client-model parameter names of the latest snapshot (None if
    it cannot be read: `resume_service` then falls back), so a serving
    front can check it builds the model the service trained."""
    period = store.latest_step(ckpt_dir)
    if period is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    prefix = "a:fed/a:params/d:"
    try:
        with np.load(os.path.join(ckpt_dir, f"step_{period:08d}.npz")) as z:
            return {k[len(prefix):] for k in z.files if k.startswith(prefix)}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def _clone(leaf):
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def resume_service(ckpt_dir: str, like: ServiceState
                   ) -> Tuple[ServiceState, Blockchain, int]:
    """Restore (state, chain, next_period), crash-safely.

    `like` is a template ServiceState of the run being resumed (rebuild it
    with init_service_state); it is not modified: each snapshot restores
    into a copy of it, on its devices.

    Degraded starts this survives: a truncated or corrupt newest snapshot
    falls back (with a warning) to the previous retained one; a tampered
    or missing chain.json falls back to a valid chain.fork*.json view,
    the longest valid one (`transport.recover_chain`). It refuses: no
    ledger view verifying at all (ValueError), and a ledger that verifies
    but sits behind the snapshot's round counter (LedgerRollbackError)."""
    retained = store.steps(ckpt_dir)
    if not retained:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    state, period = None, -1
    for step in reversed(retained):
        try:
            state = store.restore(ckpt_dir, step, tree_map(_clone, like))
            period = step
            break
        except Exception as e:  # any unreadable snapshot: fall back
            warnings.warn(
                f"checkpoint step_{step:08d}.npz unreadable ({e}); "
                f"falling back to the previous retained snapshot")
    if state is None:
        raise ValueError(
            f"every retained checkpoint under {ckpt_dir!r} failed to "
            f"load ({len(retained)} tried) — no snapshot to resume from")
    # the chain must cover the period that produced this snapshot
    chain = recover_chain(ckpt_dir, min_round=state.period_start)
    return state, chain, period + 1


# ---------------------------------------------------------------------------
# the continuous driver
# ---------------------------------------------------------------------------
def run_service(apply_fn: Callable, optimizer, fed: FedConfig,
                svc: ServiceConfig, state: ServiceState, data, *,
                periods: int, events: Sequence[ChurnEvent] = (),
                chain: Optional[Blockchain] = None,
                ckpt_dir: Optional[str] = None, start_period: int = 0,
                eval_fn: Optional[Callable] = None,
                metrics_tap: Optional[Callable] = None,
                log: Optional[Callable] = None,
                faults: Optional[FaultPlan] = None,
                transport: Optional[BulletinTransport] = None
                ) -> Tuple[ServiceState, Blockchain, List[Dict]]:
    """Drive reselection periods `start_period .. periods-1`.

    Per period: apply churn events -> mask this period's stragglers
    (fault plans only) -> run one segment of svc.reselect_every rounds ->
    reconcile announcement delivery and publish through the transport
    (checksums, bounded retry, read-back fetch) -> checkpoint (every
    svc.checkpoint_every periods, the last svc.keep_last_k kept).
    `metrics_tap(scalars)` receives each round's scalars as the round
    ends, with the period's fault counters (`core.faults.fault_scalars`)
    under a fault plan. The history has one entry per round
    (`core.rounds.extract_history`: scalars, the per-client lists,
    "seconds" and "round"), the fault counters attached to each period's
    last entry.

    `faults=FaultPlan(...)` turns on deterministic fault injection
    (shorthand for transport=BulletinTransport(chain, plan=faults)); pass
    `transport=` to control the retry policy or the sleep. A scheduled
    crash period raises CrashInjected after the segment, before publish
    and checkpoint, except at `start_period` itself, so a resume that
    lands on the crash period replays it.

    Restart: rebuild (fed, svc, template, data, events) from the same
    configuration, `state, chain, p0 = resume_service(ckpt_dir,
    template)`, and call run_service again with start_period=p0: the
    rounds equal the uninterrupted run's, fault plans included."""
    events = validate_events(events, fed.num_clients)
    chain = chain if chain is not None else Blockchain()
    if transport is None:
        transport = BulletinTransport(chain, plan=faults)
    elif faults is not None and transport.plan is not faults:
        raise ValueError("pass either faults= or a transport= carrying "
                         "its own plan, not both")
    chain = transport.chain
    program = service_program(apply_fn, optimizer, fed, svc)
    length = svc.reselect_every

    # the period's fault counters, rewritten before each segment and read
    # by the tap as its rounds end
    fault_cell: Dict[str, float] = {}
    tap = metrics_tap
    if metrics_tap is not None and transport.plan is not None:
        def tap(scalars):
            metrics_tap({**scalars, **fault_cell})
    seg_fn = make_segment_fn(program, length, eval_fn=eval_fn,
                             metrics_tap=tap)
    history: List[Dict] = []
    for period in range(start_period, periods):
        state = apply_events(state, events, period)
        base_active = state.active
        pf = transport.period_faults(period, fed.num_clients)
        scalars = None
        if pf is not None:
            announcing = base_active.cpu().numpy()  # analysis: host-ok faults
            scalars = fault_scalars(pf, announcing)
            fault_cell.clear()
            fault_cell.update(scalars)
            stragglers = transport.straggler_mask(period, announcing)
            if stragglers.any():
                # a degraded round: partial announcements, by the same
                # masking churn uses (equal to those clients leaving for
                # one period)
                state = mask_stragglers(state, stragglers)
            pre = (state.fed.codes, state.fed.rankings,
                   state.fed.commitments, state.code_age)
        seg_active = state.active.cpu().numpy()  # analysis: host-ok report
        r0 = period * length
        t0 = time.perf_counter()
        state, metrics = seg_fn(state, data, r0)
        dt = time.perf_counter() - t0
        if pf is not None and pf.crash and period != start_period:
            raise CrashInjected(period)
        ann, reveals, failed, delayed = transport.collect(period, seg_active,
                                                          state)
        if pf is not None:
            state = state._replace(active=base_active)
            if failed.any() or delayed.any():
                state = merge_delivery(state, *pre, failed=failed,
                                       delayed=delayed)
        transport.publish(period, r0, ann, reveals)
        transport.fetch(period, r0)  # read-back verification
        entries = extract_history(metrics, r0, length)
        if scalars is not None:
            entries[-1].update(scalars)
        history.extend(entries)
        if ckpt_dir is not None and \
                (period + 1 - start_period) % svc.checkpoint_every == 0:
            checkpoint_service(ckpt_dir, period, state, chain,
                               keep_last_k=svc.keep_last_k)
            if transport.plan is not None and \
                    transport.plan.fork_at == period:
                # a competing rolled-back ledger view appears next to
                # chain.json; resume must arbitrate
                write_fork_view(ckpt_dir, rollback_view(chain, 1))
        if log is not None:
            last = history[-1]
            parts = [f"{k} {last[k]:.4f}" for k in ("acc", "mean_loss")
                     if k in last]
            degraded = " DEGRADED" if scalars and \
                scalars.get("degraded_round") else ""
            log(f"period {period:3d} (rounds {r0}..{r0 + length - 1}) "
                + " ".join(parts)
                + f" active {last['active_frac']:.2f}"
                + f" ({dt:.1f}s){degraded}")
    return state, chain, history
