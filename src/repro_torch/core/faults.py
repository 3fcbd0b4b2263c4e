"""Deterministic fault injection for the federation service.
Counterpart of `repro/core/faults.py`, whose verdicts it equals bit for
bit (pure host numpy and Python integers; nothing here touches a device).

A `FaultPlan` is a typed description of the fault regime: per-kind rates
on the client <-> bulletin-board link plus scheduled crash and fork
events. It holds no mutable state and draws on no global RNG: every
fault decision is a pure function of `(plan.seed, kind, period, client,
attempt)` through a splitmix64 counter hash (`fault_u01`), so the same
plan replays the same faults in the original process, in a resumed one
and in a test. `period_faults` precomputes one period's verdicts (who
straggles, whose announcement drops / delays / duplicates / corrupts,
how many publish / fetch attempts fail) before the period runs; the
driver's counters and the transport read the same verdicts, so they
cannot diverge. A `FaultTrace` records what a transport injected.

The injection site is `repro_torch.service.transport.BulletinTransport`:
faults model the link, never the protocol's tensor math.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# fault kinds, in hash-stream order (the index salts the counter hash,
# so every kind draws from an independent deterministic stream)
FAULT_KINDS = ("drop", "delay", "duplicate", "corrupt", "straggle",
               "publish_fail", "fetch_fail", "backoff")
_KIND_INDEX = {k: i for i, k in enumerate(FAULT_KINDS)}

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(x: int) -> int:
    """One splitmix64 output step (pure int math, host-side)."""
    x = (x + _GOLDEN) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


def fault_u01(seed: int, kind: str, period: int, client: int = 0,
              attempt: int = 0) -> float:
    """Uniform [0, 1) draw, a pure function of its arguments.

    This is the ONLY randomness source in the fault layer: replaying a
    plan replays its faults exactly (kill/resume included)."""
    h = seed & _MASK64
    for word in (_KIND_INDEX[kind], period, client, attempt):
        h = _splitmix64(h ^ ((word + 1) * _GOLDEN & _MASK64))
    return h / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded fault regime for a service run.

    Rates are per-period, per-client probabilities on the client ->
    bulletin-board link (publish_fail / fetch_fail are per ATTEMPT on
    the board itself). `crash_periods` kills the driver mid-period
    (after the period's rounds, before any durable effect) at each
    listed period; `fork_at >= 0` writes a competing rolled-back
    ledger view next to chain.json after that period's checkpoint.

    A plan is "eventually delivering" when every rate is < 1: each
    client's announcement lands with probability 1 in the limit, and
    bounded retry eventually clears every publish/fetch. Rate = 1.0 is
    legal (unit tests force faults with it) but fail-stop."""
    seed: int = 0
    drop: float = 0.0          # announcement lost in transit
    delay: float = 0.0         # lands after the selection deadline
    duplicate: float = 0.0     # delivered twice (board must dedupe)
    corrupt: float = 0.0       # bytes flipped in transit (checksum)
    straggle: float = 0.0      # client misses the round deadline
    publish_fail: float = 0.0  # one publish attempt fails
    fetch_fail: float = 0.0    # one fetch attempt fails
    crash_periods: Tuple[int, ...] = ()
    fork_at: int = -1

    def __post_init__(self):
        for name in ("drop", "delay", "duplicate", "corrupt", "straggle",
                     "publish_fail", "fetch_fail"):
            rate = getattr(self, name)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"fault rate {name}={rate} outside [0, 1]")
        if any(p < 0 for p in self.crash_periods):
            raise ValueError(
                f"crash_periods must be >= 0, got {self.crash_periods}")

    def eventually_delivering(self) -> bool:
        return all(getattr(self, n) < 1.0
                   for n in ("drop", "delay", "corrupt", "straggle",
                             "publish_fail", "fetch_fail"))


class PeriodFaults:
    """One period's complete, precomputed fault verdicts (computed
    before the period's rounds run, applied after)."""

    def __init__(self, stragglers, drop, delay, duplicate, corrupt,
                 publish_failures: int, fetch_failures: int,
                 crash: bool):
        self.stragglers = stragglers  # (M,) bool — miss the deadline
        self.drop = drop              # (M,) bool — announcement lost
        self.delay = delay            # (M,) bool — lands late (stale)
        self.duplicate = duplicate    # (M,) bool — delivered twice
        self.corrupt = corrupt        # (M,) bool — bytes flipped
        self.publish_failures = publish_failures  # leading bad attempts
        self.fetch_failures = fetch_failures
        self.crash = crash            # kill the driver this period

    def any_delivery_fault(self) -> bool:
        return bool(self.drop.any() or self.delay.any()
                    or self.duplicate.any() or self.corrupt.any())


def leading_failures(plan: FaultPlan, kind: str, period: int,
                     max_attempts: int) -> int:
    """How many attempts fail before the first success (capped —
    `max_attempts` failures means the retry budget exhausts)."""
    n = 0
    rate = getattr(plan, kind)
    while n < max_attempts and \
            fault_u01(plan.seed, kind, period, attempt=n) < rate:
        n += 1
    return n


def period_faults(plan: FaultPlan, period: int, num_clients: int,
                  max_attempts: int) -> PeriodFaults:
    """All of one period's fault verdicts, reproducibly.

    Per client the in-flight faults are mutually exclusive with
    precedence drop > corrupt > delay (a dropped announcement cannot
    also be corrupted); duplication is orthogonal (a delivered copy may
    arrive twice). Stragglers are decided first and independently — a
    straggling client announces nothing, so its link faults are moot."""
    def draw(kind):
        rate = getattr(plan, kind)
        return np.array([fault_u01(plan.seed, kind, period, client=i)
                         < rate for i in range(num_clients)], dtype=bool)

    straggle = draw("straggle")
    drop = draw("drop")
    corrupt = draw("corrupt") & ~drop
    delay = draw("delay") & ~drop & ~corrupt
    duplicate = draw("duplicate") & ~drop & ~corrupt
    return PeriodFaults(
        stragglers=straggle, drop=drop, delay=delay, duplicate=duplicate,
        corrupt=corrupt,
        publish_failures=leading_failures(plan, "publish_fail", period,
                                          max_attempts),
        fetch_failures=leading_failures(plan, "fetch_fail", period,
                                        max_attempts),
        crash=period in plan.crash_periods)


def fault_scalars(pf: PeriodFaults, announcing) -> Dict[str, float]:
    """The period's fault counters as flat scalars: what the driver
    passes to its metrics tap with each round and attaches to the
    period's last history entry. Link faults count
    only on ANNOUNCING clients: a fault verdict on an inactive or
    straggling slot injects nothing."""
    announcing = np.asarray(announcing, bool)
    return {
        "fault_stragglers": float(np.sum(pf.stragglers & announcing)),
        "fault_dropped": float(np.sum(pf.drop & announcing
                                      & ~pf.stragglers)),
        "fault_delayed": float(np.sum(pf.delay & announcing
                                      & ~pf.stragglers)),
        "fault_corrupt": float(np.sum(pf.corrupt & announcing
                                      & ~pf.stragglers)),
        "fault_duplicates": float(np.sum(pf.duplicate & announcing
                                         & ~pf.stragglers)),
        "fault_publish_retries": float(pf.publish_failures),
        "fault_fetch_retries": float(pf.fetch_failures),
        "degraded_round": float(
            bool((pf.stragglers & announcing).any()
                 or ((pf.drop | pf.delay | pf.corrupt) & announcing
                     & ~pf.stragglers).any()
                 or pf.publish_failures or pf.fetch_failures)),
    }


class FaultTrace:
    """Append-only record of the faults a transport actually injected.

    `events` is the reproducibility artifact: two runs of the same
    FaultPlan must produce identical event lists
    (tests/test_torch_faults.py)."""

    def __init__(self):
        self.events: List[Tuple[int, str, int]] = []
        self.counters: Dict[str, int] = {}

    def record(self, period: int, kind: str, who: int = -1) -> None:
        self.events.append((period, kind, who))
        self.counters[kind] = self.counters.get(kind, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)


_SPEC_RATES = ("drop", "delay", "duplicate", "corrupt", "straggle",
               "publish_fail", "fetch_fail")


def parse_fault_spec(spec: str) -> FaultPlan:
    """Parse the CLI fault spec, e.g.
    "seed=7,drop=0.1,straggle=0.2,publish_fail=0.3,crash=2,fork=1"
    -> FaultPlan(seed=7, drop=0.1, ..., crash_periods=(2,), fork_at=1).
    `crash` may repeat for multiple scheduled crash-restarts."""
    kwargs: Dict[str, object] = {}
    crashes: List[int] = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            raise ValueError(f"bad fault spec item {item!r} (want key=value)")
        key, _, value = item.partition("=")
        key = key.strip()
        if key == "seed":
            kwargs["seed"] = int(value)
        elif key == "crash":
            crashes.append(int(value))
        elif key == "fork":
            kwargs["fork_at"] = int(value)
        elif key in _SPEC_RATES:
            kwargs[key] = float(value)
        else:
            raise ValueError(
                f"unknown fault spec key {key!r} (expected seed, "
                f"crash, fork, or one of {_SPEC_RATES})")
    if crashes:
        kwargs["crash_periods"] = tuple(crashes)
    return FaultPlan(**kwargs)
