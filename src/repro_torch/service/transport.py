"""The bulletin-board link with its failure modes.
Counterpart of `repro/service/transport.py`.

`BulletinTransport` is where network reality enters, and where the
protocol survives it:

  * every announcement carries a checksum; a corrupted delivery is
    rejected board-side and the sender's last-known-good codes stand;
  * publish and fetch run under bounded retry with exponential backoff
    and deterministic jitter (`RetryPolicy`); exhaustion raises
    `TransportError` rather than silently losing a round;
  * duplicate deliveries dedupe (same bytes, same block);
  * resume recovers the longest valid ledger view across `chain.json`
    and any `chain.fork*.json` competitors (`recover_chain`), and refuses
    with `LedgerRollbackError` when even the best view is behind the
    checkpoint's round counter.

Fault injection (`plan=FaultPlan(...)`) reads the same verdicts as the
driver's degraded-round bookkeeping (`core.faults.period_faults`), so the
counters the driver reports and the faults applied cannot diverge. With
`plan=None` the transport is the fault-free path: the same checksums and
retry envelope, no injected fault. Everything here runs on the host.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.chain import (Block, Blockchain, load_chain, lsh_code_hex,
                              save_chain, sha256_commit)
from repro_torch.core.faults import (FaultPlan, FaultTrace, PeriodFaults,
                               fault_u01, leading_failures, period_faults)

CHAIN_FILE = "chain.json"
FORK_PATTERN = "chain.fork*.json"


class TransportError(RuntimeError):
    """The bulletin-board link stayed down past the retry budget."""


class LedgerRollbackError(ValueError):
    """The best recoverable ledger view verifies but is BEHIND the
    checkpoint's round counter — a silent-rollback / fork symptom, not
    a degraded start. Resume refuses."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and bounded jitter.

    Attempt k (0-based) that fails waits
    `min(base * 2^k, max) * (1 + jitter * (2u - 1))` where u is a
    deterministic [0,1) draw from the plan's "backoff" stream — so a
    replayed FaultPlan replays its exact retry timing too."""
    max_attempts: int = 5
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s, got "
                f"{self.base_delay_s}, {self.max_delay_s}")

    def delay_s(self, attempt: int, u01: float) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        return d * (1.0 + self.jitter * (2.0 * u01 - 1.0))


def announcement_checksum(entry: Dict[str, str]) -> str:
    """End-to-end checksum over the announcement wire bytes (lsh hex +
    commitment hex). Travels WITH the entry; the board recomputes it on
    receipt and rejects a mismatch — corruption in transit can degrade
    a round but never poison the ledger."""
    h = hashlib.sha256()
    h.update(entry["lsh"].encode())
    h.update(b"|")
    h.update(entry["commit"].encode())
    return h.hexdigest()[:16]


def _corrupt_hex(hexstr: str, u01: float) -> str:
    """Flip one nibble of a hex string at a u01-chosen position — the
    injected 'bytes damaged in transit' fault (checksum catches it)."""
    pos = min(int(u01 * len(hexstr)), len(hexstr) - 1)
    nibble = int(hexstr[pos], 16) ^ 0x1
    return hexstr[:pos] + format(nibble, "x") + hexstr[pos + 1:]


class BulletinTransport:
    """The client <-> bulletin-board link, with its failure modes.

    `plan=None` (production): faithful delivery under the same checksum
    + retry envelope. `plan=FaultPlan(...)`: deterministic fault
    injection on every operation, recorded into `self.trace`.
    `sleep` is injectable so unit tests retry without wall-clock cost.
    """

    def __init__(self, chain: Blockchain, *,
                 plan: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.chain = chain
        self.plan = plan
        self.retry = retry if retry is not None else RetryPolicy()
        self.sleep = sleep if sleep is not None else time.sleep
        self.trace = FaultTrace()

    # -- fault verdicts ----------------------------------------------------
    def period_faults(self, period: int,
                      num_clients: int) -> Optional[PeriodFaults]:
        if self.plan is None:
            return None
        return period_faults(self.plan, period, num_clients,
                             self.retry.max_attempts)

    def straggler_mask(self, period: int, active) -> np.ndarray:
        """(M,) bool — active clients that miss this period's deadline
        (recorded into the trace). The driver masks them inactive for
        the segment, which is EXACTLY the churn-leave path — the
        masking-equivalence invariant tests/test_faults.py pins."""
        active = np.asarray(active, bool)
        pf = self.period_faults(period, active.shape[0])
        if pf is None:
            return np.zeros(active.shape, bool)
        strag = pf.stragglers & active
        for i in np.nonzero(strag)[0]:
            self.trace.record(period, "straggle", int(i))
        return strag

    # -- the announcement path ---------------------------------------------
    def collect(self, period: int, announcing, state
                ) -> Tuple[Dict[int, Dict[str, str]], Dict[int, List[int]],
                           np.ndarray, np.ndarray]:
        """Pull the period's announcements off the device and deliver
        them across the (possibly faulty) link. `state` is a
        ServiceState (its fed.codes and fed.rankings are read).

        Returns (announcements, reveals, failed, delayed):
          * `announcements[i]` = {"lsh", "commit", "sum"} for every
            client whose announcement actually LANDED intact;
          * `failed` (M,) bool — dropped in transit or rejected by the
            board's checksum: the board keeps the client's last block,
            so the driver must revert that client's in-graph
            codes/rankings/commitments to last-known-good and age them
            (`membership.merge_delivery`);
          * `delayed` (M,) bool — landed intact but past the selection
            deadline: fresh on the board, but next period's Eq. 8
            weight sees `code_age >= 1`.
        Duplicate deliveries are byte-identical and dedupe to one
        entry (counted in the trace, no state effect)."""
        announcing = np.asarray(announcing, bool)
        codes = state.fed.codes.cpu()  # analysis: host-ok the board's copy
        rankings = state.fed.rankings.tolist()  # analysis: host-ok reveals
        m = announcing.shape[0]
        pf = self.period_faults(period, m)
        failed = np.zeros(m, bool)
        delayed = np.zeros(m, bool)
        announcements: Dict[int, Dict[str, str]] = {}
        reveals: Dict[int, List[int]] = {}
        for i in range(m):
            if not announcing[i]:
                continue
            entry = {"lsh": lsh_code_hex(codes[i]),
                     "commit": sha256_commit(rankings[i])}
            entry["sum"] = announcement_checksum(entry)
            if pf is not None:
                if pf.drop[i]:
                    failed[i] = True
                    self.trace.record(period, "drop", i)
                    continue
                if pf.corrupt[i]:
                    wire = dict(entry)
                    wire["lsh"] = _corrupt_hex(
                        wire["lsh"], fault_u01(self.plan.seed, "corrupt",
                                               period, client=i, attempt=1))
                    if announcement_checksum(wire) != wire["sum"]:
                        # board-side rejection: the damaged bytes never
                        # enter the ledger
                        failed[i] = True
                        self.trace.record(period, "corrupt", i)
                        continue
                    entry = wire  # (unreachable for a 1-nibble flip)
                if pf.delay[i]:
                    delayed[i] = True
                    self.trace.record(period, "delay", i)
                if pf.duplicate[i]:
                    # the second, byte-identical copy dedupes to nothing
                    self.trace.record(period, "duplicate", i)
            announcements[i] = entry
            reveals[i] = rankings[i]
        return announcements, reveals, failed, delayed

    def _with_retry(self, period: int, kind: str, stream: int,
                    fn: Callable[[], Any], what: str) -> Any:
        failures = 0
        if self.plan is not None:
            failures = leading_failures(self.plan, kind, period,
                                        self.retry.max_attempts)
        for attempt in range(self.retry.max_attempts):
            if attempt < failures:
                self.trace.record(period, kind)
                self.sleep(self.retry.delay_s(attempt, fault_u01(
                    self.plan.seed, "backoff", period, client=stream,
                    attempt=attempt)))
                continue
            return fn()
        raise TransportError(
            f"{what} failed after {self.retry.max_attempts} attempts "
            f"(period {period}) — bulletin board unreachable")

    def publish(self, period: int, round_idx: int,
                announcements: Dict[int, Dict[str, str]],
                reveals: Dict[int, List[int]]) -> Block:
        """Publish one period's block, idempotently (a replayed period
        after crash-restart finds its block already on chain and reuses
        it) and under bounded retry."""
        existing = self.chain.round_block(round_idx)
        if existing is not None:
            return existing
        return self._with_retry(
            period, "publish_fail", 0,
            lambda: self.chain.publish_round(round_idx, announcements,
                                             reveals=reveals),
            what=f"publish of round {round_idx}")

    def fetch(self, period: int, round_idx: int) -> Block:
        """Read-back verification: re-fetch the just-published block
        (under retry) so a publish that claimed success but didn't land
        is caught the same period, not at resume."""
        blk = self._with_retry(
            period, "fetch_fail", 1,
            lambda: self.chain.round_block(round_idx),
            what=f"fetch of round {round_idx}")
        if blk is None:
            raise TransportError(
                f"round {round_idx} missing from the ledger on "
                f"read-back (period {period})")
        return blk


# ---------------------------------------------------------------------------
# forked ledger views + longest-valid-chain recovery
# ---------------------------------------------------------------------------
def rollback_view(chain: Blockchain, drop_last: int = 1) -> Blockchain:
    """A VALID but shorter view of `chain` — what a rolled-back or
    lagging replica of the bulletin board would serve. verify_chain
    passes (nothing is tampered); only length distinguishes it."""
    if not 0 <= drop_last < len(chain.blocks):
        raise ValueError(
            f"drop_last must be in [0, {len(chain.blocks)}), "
            f"got {drop_last}")
    view = Blockchain.__new__(Blockchain)
    view.blocks = list(chain.blocks[:len(chain.blocks) - drop_last])
    return view


def divergent_view(chain: Blockchain, drop_last: int = 1) -> Blockchain:
    """A VALID same-length fork: the last `drop_last` blocks re-made
    with marked payloads and correctly re-chained hashes. Recovery must
    NOT prefer it over the canonical chain.json (ties go to
    chain.json)."""
    view = rollback_view(chain, drop_last)
    for b in chain.blocks[len(chain.blocks) - drop_last:]:
        payload = dict(b.payload)
        payload["fork"] = True
        blk = Block(b.index, view.blocks[-1].hash, payload,
                    timestamp=b.timestamp)
        blk.hash = blk.compute_hash()
        view.blocks.append(blk)
    return view


def write_fork_view(ckpt_dir: str, view: Blockchain, idx: int = 0) -> str:
    """Persist a competing ledger view next to chain.json (the file
    layout `recover_chain` arbitrates over)."""
    return save_chain(
        os.path.join(ckpt_dir, f"chain.fork{idx}.json"), view)


def recover_chain(ckpt_dir: str, *,
                  min_round: Optional[int] = None) -> Blockchain:
    """Longest-valid-chain recovery over every ledger view in
    `ckpt_dir` (chain.json plus chain.fork*.json).

    Unparseable or tampered views are skipped with a warning; among the
    views that pass `verify_chain`, the strictly longest wins and
    chain.json wins ties. No valid view at all -> ValueError. A valid
    winner whose head round is behind `min_round` (the checkpoint's
    round counter) -> LedgerRollbackError: the ledger silently lost
    history, which resume must surface, not paper over."""
    candidates = [os.path.join(ckpt_dir, CHAIN_FILE)]
    candidates += sorted(glob.glob(os.path.join(ckpt_dir, FORK_PATTERN)))
    best: Optional[Blockchain] = None
    best_path = ""
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            view = load_chain(path)
        except Exception as e:
            warnings.warn(f"ledger view {os.path.basename(path)} "
                          f"unreadable ({e}); skipping")
            continue
        if not view.verify_chain():
            warnings.warn(f"ledger view {os.path.basename(path)} fails "
                          f"verify_chain; skipping")
            continue
        if best is None or len(view.blocks) > len(best.blocks):
            best, best_path = view, path
    if best is None:
        raise ValueError(
            f"no ledger view under {ckpt_dir!r} passes verify_chain "
            f"(checked {[os.path.basename(c) for c in candidates]})")
    if min_round is not None and best.head_round() < min_round:
        raise LedgerRollbackError(
            f"recovered ledger ({os.path.basename(best_path)}) verifies "
            f"but its head round {best.head_round()} is behind the "
            f"checkpoint's round counter {min_round} — silent rollback "
            f"or fork. Refusing to resume: restore the full ledger, or "
            f"resume from an older checkpoint whose round counter the "
            f"ledger covers.")
    return best
