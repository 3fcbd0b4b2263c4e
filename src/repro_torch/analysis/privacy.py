"""Declassifier and sink registries of the privacy-taint check.
Counterpart of `repro/analysis/privacy.py`.

The paper's trust-free claim is a dataflow property: the only values
that ever leave a client are LSH codes (Eq. 5-6), rank reveals and
scores (Eq. 7), commitments (Eq. 9-10), logits on the exchanged
reference set, scalar round telemetry and a client's own served logits,
never raw parameters, optimizer state or private batches.
`repro_torch.analysis.taint` checks that property on the protocol's
entry points as they run; this module is the annotation surface the
protocol code declares it with:

  * `@declassifier(...)` marks a function whose OUTPUT is releasable,
    with the paper equation it implements and a recorded justification.
    At runtime the wrapper returns `fn`'s output itself. While the
    checker runs (`tracing()` active) it returns each tensor leaf of the
    output as a fresh clone that carries no labels: labels are keyed by
    storage, so clearing an identity's output in place would clear its
    input's too.
  * `sink(name, value)` marks a disclosure point, a value about to cross
    the trust boundary (announcement fields the ledger publishes, metric
    taps, serving responses). It returns `value` itself; while the
    checker runs it reports a `taint-sink` finding for each tensor leaf
    that carries a private label.

The registries are filled when the protocol modules are imported,
inspected by the checker and restorable for fixtures
(`capture_declassifiers`). This module imports only the standard
library, so `core.lsh`, `core.chain`, `core.rounds` and the others can
import it without a cycle; the checker's machinery
(`repro_torch.analysis.taint`) is imported only while it runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List

# sink name -> what crosses the trust boundary there (the table `sink()`
# validates against), the JAX package's four rows
SINKS: Dict[str, str] = {
    "chain-announcement": "Announcement fields (codes, rankings, "
                          "commitments) consumed by Blockchain."
                          "publish_round and the §3.6 reveals",
    "ledger-publish": "the merged per-period state fields the service "
                      "publisher reads onto the host ledger and the "
                      "checkpointed chain JSON",
    "metrics-tap": "per-round scalar metrics streamed to the host "
                   "through the ordered io_callback tap",
    "serving-response": "logits returned to a client by the "
                        "PersonalizedServer forward",
}

# declassifier name -> entry; filled when the protocol modules are imported
DECLASSIFIERS: Dict[str, "DeclassifierEntry"] = {}

# the checker's flag: list-wrapped so `tracing()` mutates it in place
_ACTIVE = [False]


@dataclasses.dataclass(frozen=True)
class DeclassifierEntry:
    name: str
    module: str
    qualname: str
    paper_eq: str        # the equation/section whose disclosure this is
    justification: str   # why releasing this value is trust-free


def declassifier(*, name: str, paper_eq: str, justification: str):
    """Register `fn` as a declassifier; its output is releasable.

    The wrapper returns `fn`'s output unchanged at runtime. While the
    checker runs, every tensor leaf of the output comes back as a clone
    without labels (`taint.declassify_value`)."""
    if not justification.strip():
        raise ValueError(f"declassifier({name!r}) needs a justification")

    def deco(fn: Callable) -> Callable:
        if name in DECLASSIFIERS and \
                DECLASSIFIERS[name].qualname != fn.__qualname__:
            raise ValueError(f"declassifier name {name!r} already "
                             f"registered by "
                             f"{DECLASSIFIERS[name].qualname}")
        DECLASSIFIERS[name] = DeclassifierEntry(
            name=name, module=fn.__module__, qualname=fn.__qualname__,
            paper_eq=paper_eq, justification=justification)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if _ACTIVE[0]:
                from repro_torch.analysis.taint import declassify_value
                return declassify_value(out, name)
            return out

        return wrapper

    return deco


def sink(name: str, value):
    """Mark `value` as reaching the disclosure sink `name`; returns it.

    Always validates the name against SINKS (a misspelt sink would
    otherwise skip the check); checks the labels only while the checker
    runs."""
    if name not in SINKS:
        raise ValueError(f"unknown sink: {name!r} "
                         f"(expected one of {tuple(sorted(SINKS))})")
    if _ACTIVE[0]:
        from repro_torch.analysis.taint import sink_value
        sink_value(value, name)
    return value


@contextlib.contextmanager
def tracing():
    """The checker's scope: declassifiers clone and sinks check inside.
    Eager PyTorch caches no traces, so nothing is cleared on the way in
    or out (the JAX package drops its trace caches here)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = True
    try:
        yield
    finally:
        _ACTIVE[0] = prev


class capture_declassifiers:
    """Context manager: record declassifiers registered while active
    (fixture isolation, as `registry.capture_registrations`)."""

    def __enter__(self) -> List[DeclassifierEntry]:
        self._before = set(DECLASSIFIERS)
        self._new: List[DeclassifierEntry] = []
        return self._new

    def __exit__(self, *exc):
        for k in set(DECLASSIFIERS) - self._before:
            self._new.append(DECLASSIFIERS.pop(k))
        return False
