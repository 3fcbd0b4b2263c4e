"""Round-program engine: one schedule API for the sync WPFed round and
gossip epochs. Counterpart of `repro/core/rounds.py`.

A federation method is a `RoundProgram`: `global_round(state, data) ->
(state, cache, metrics)` and `gossip_round(state, data, cache) -> same`.
`Schedule(reselect_every=G)` runs one global round then G-1 gossip
epochs per reselection period; `run_rounds` drives the rounds eagerly
(PyTorch has no whole-segment compile to amortise) and calls
`on_reselect(start_round, state)` once per period, which is where the
host `Blockchain` publishes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function


class RoundProgram(NamedTuple):
    """A federation method as a (global round, gossip epoch) pair."""
    name: str
    global_round: Callable  # (state, data) -> (state, cache, metrics)
    gossip_round: Optional[Callable] = None  # (state, data, cache) -> same


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Run the global round every `reselect_every` rounds, gossip epochs
    in between. 1 == the paper's fully synchronous protocol."""
    reselect_every: int = 1

    def __post_init__(self):
        if self.reselect_every < 1:
            raise ValueError(
                f"reselect_every must be >= 1, got {self.reselect_every}")

    def segments(self, rounds: int):
        """Yield (start_round, length) per reselection period."""
        r0 = 0
        while r0 < rounds:
            yield r0, min(self.reselect_every, rounds - r0)
            r0 += self.reselect_every


SCHEDULES = ("sync", "gossip")


def resolve_schedule(name: str = "sync", reselect_every: int = 0) -> Schedule:
    """"sync" -> Schedule(1) (an explicit reselect_every other than 0/1 is
    an error); "gossip" -> Schedule(reselect_every or 4)."""
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown schedule: {name!r} (expected one of {SCHEDULES})")
    if name == "sync":
        if reselect_every not in (0, 1):
            raise ValueError(
                "schedule 'sync' re-selects every round; pass "
                "schedule='gossip' to use reselect_every="
                f"{reselect_every}")
        return Schedule(1)
    return Schedule(reselect_every or 4)


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """One round's metrics as plain Python: numbers for scalars, nested
    lists for the per-client tensors (neighbour ids, valid mask, ranking
    scores)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = v.item() if v.ndim == 0 else v.tolist()
        out[k] = v
    return out


def run_rounds(program: RoundProgram, state, data, *, rounds: int,
               schedule: Optional[Schedule] = None,
               eval_fn: Optional[Callable] = None,
               on_reselect: Optional[Callable] = None,
               log: Optional[Callable] = None
               ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Drive `rounds` federation rounds under `schedule`.

    Returns (final_state, history): one dict per round with every metric
    (`host_metrics`), `eval_fn(state, data)`'s outputs, the absolute
    "round" index and "seconds", the wall time of the round's body (the
    device synchronised before the clock is read; evaluation excluded),
    which runs in a profiler span named "wpfed.round.<index>".
    """
    schedule = schedule or Schedule()
    if schedule.reselect_every > 1 and program.gossip_round is None:
        raise ValueError(f"program {program.name!r} has no gossip_round; "
                         "only Schedule(reselect_every=1) can run it")
    history: List[Dict[str, Any]] = []
    for r0, length in schedule.segments(rounds):
        cache = None
        for k in range(length):
            t0 = time.perf_counter()
            with record_function(f"wpfed.round.{r0 + k}"):
                if k == 0:
                    state, cache, metrics = program.global_round(state, data)
                else:
                    state, cache, metrics = program.gossip_round(
                        state, data, cache)
                _synchronize(state.codes.device)
            seconds = time.perf_counter() - t0
            if eval_fn is not None:
                metrics = {**metrics, **eval_fn(state, data)}
            entry = host_metrics(metrics)
            entry["round"] = r0 + k
            entry["seconds"] = seconds
            history.append(entry)
            if log is not None:
                parts = [f"{n} {entry[n]:.4f}" for n in ("acc", "mean_loss")
                         if n in entry]
                log(f"round {entry['round']:3d} " + " ".join(parts)
                    + f" ({seconds:.3f}s)")
        if on_reselect is not None:
            on_reselect(r0, state)
    return state, history


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
