"""Round-program engine: one schedule API for the sync WPFed round,
gossip epochs and the baselines. Counterpart of `repro/core/rounds.py`.

A federation method is a `RoundProgram`: `global_round(state, data) ->
(state, cache, metrics)` and `gossip_round(state, data, cache) -> same`.
`Schedule(reselect_every=G)` runs one global round then G-1 gossip
epochs per reselection period. `make_segment_fn` is one period as a host
loop (PyTorch has no whole-segment compile to amortise), `extract_history`
turns its per-round metrics into plain Python, and `run_rounds` drives
the periods and calls `on_reselect(start_round, state)` once per period,
which is where the host `Blockchain` publishes; the continuous service
(`repro_torch.service.driver`) drives the same segments. `make_program`
builds every method by name.

This module imports no `repro_torch.core` sibling at module level:
`core.protocol` and `core.baselines` import `RoundProgram` from here, and
`make_program` resolves them by function-level imports.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.analysis.privacy import declassifier, sink


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
PROGRAMS = ("wpfed", "silo", "fedmd", "proxyfl", "kdpdfl")


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


def program_round(program: RoundProgram) -> Callable:
    """Adapt a program's global round to the classic `round_fn(state,
    data, **kw) -> (state, metrics)` (keywords such as `batch_idx` pass
    through to the global round)."""

    def round_fn(state, data, **kw):
        state, _cache, metrics = program.global_round(state, data, **kw)
        return state, metrics

    return round_fn


def make_program(method: str, apply_fn, optimizer, fed,
                 **kwargs) -> RoundProgram:
    """Build the round program of `method` (one of PROGRAMS). `fedmd`
    requires shared_ref_x=...; `proxyfl` accepts num_peers=."""
    from repro_torch.core import baselines, protocol
    makers = {"wpfed": protocol.wpfed_program,
              **baselines.BASELINE_PROGRAMS}
    if method not in makers:
        raise KeyError(
            f"unknown method: {method!r} (expected one of {PROGRAMS})")
    return makers[method](apply_fn, optimizer, fed, **kwargs)


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """One round's metrics as plain Python: numbers for scalars, nested
    lists for the per-client tensors (neighbour ids, valid mask, ranking
    scores)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = v.tolist()  # analysis: host-ok the history, after the segment
        out[k] = v
    return out


@declassifier(
    name="round-telemetry", paper_eq="§4 (reported per-round metrics)",
    justification="federation-level scalar aggregates only (means and "
                  "fractions over the client axis) — the declassifier "
                  "refuses any non-scalar leaf, so no per-client vector "
                  "or model-derived array can ride this channel")
def release_round_telemetry(scalars: Dict[str, Any]) -> Dict[str, Any]:
    """The ONLY gate through which round metrics may reach the host tap.

    Raises on any leaf that is not 0-d: the justification above is
    enforced by the code, not left to care at each call site."""
    for k, v in scalars.items():
        if getattr(v, "ndim", None) != 0:
            raise ValueError(
                f"round-telemetry releases scalars only; {k!r} has "
                f"shape {getattr(v, 'shape', None)!r}")
    return scalars


def _scalars(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The scalar entries of one round's metrics as Python numbers. The
    0-d tensors are declassified and then marked as the tap's disclosure
    before any is read, the order of the JAX segment before its
    io_callback; per-client tensors stay on the device."""
    released = sink("metrics-tap", release_round_telemetry(
        {k: v for k, v in metrics.items()
         if isinstance(v, torch.Tensor) and v.ndim == 0}))
    out = {}
    for k, v in metrics.items():
        if k in released:
            out[k] = released[k].item()  # analysis: host-ok released telemetry
        elif isinstance(v, (int, float)):
            out[k] = v
    return out


def make_segment_fn(program: RoundProgram, length: int, *,
                    eval_fn: Optional[Callable] = None,
                    metrics_tap: Optional[Callable] = None) -> Callable:
    """One reselection period of `length` rounds: the global round, then
    length-1 gossip epochs against its cache. Returns
    segment_fn(state, data, r0=0) -> (state, metrics), `metrics` a list
    of one dict per round: the round's metrics, `eval_fn(state, data)`'s
    outputs and "seconds", the wall time of the round's body (the device
    synchronised before the clock is read; evaluation excluded), which
    runs in a profiler span named "wpfed.round.<r0 + i>".
    `metrics_tap(scalars)` (a host function) receives each round's scalar
    metrics as Python numbers as soon as the round ends: the service's
    live progress stream, the counterpart of the JAX segment's ordered
    io_callback."""
    if length < 1:
        raise ValueError(f"segment length must be >= 1, got {length}")
    if length > 1 and program.gossip_round is None:
        raise ValueError(f"program {program.name!r} has no gossip_round; "
                         "only Schedule(reselect_every=1) can run it")

    def seg_fn(state, data, r0: int = 0):
        cache, out = None, []
        for k in range(length):
            t0 = time.perf_counter()
            with record_function(f"wpfed.round.{r0 + k}"):
                if k == 0:
                    state, cache, m = program.global_round(state, data)
                else:
                    state, cache, m = program.gossip_round(state, data,
                                                           cache)
                _synchronize(_device_of(state))
            m = {**m, "seconds": time.perf_counter() - t0}
            if eval_fn is not None:
                m = {**m, **eval_fn(state, data)}
            if metrics_tap is not None:
                metrics_tap(_scalars(m))
            out.append(m)
        return state, out

    return seg_fn


def extract_history(metrics: List[Dict[str, Any]], r0: int,
                    length: int) -> List[Dict[str, Any]]:
    """A segment's per-round metrics -> one plain-Python dict per round
    (`host_metrics`: numbers for scalars, nested lists for the per-client
    tensors), with the absolute "round" index r0 + i."""
    history = []
    for i in range(length):
        entry = host_metrics(metrics[i])
        entry["round"] = r0 + i
        history.append(entry)
    return history


def run_rounds(program: RoundProgram, state, data, *, rounds: int,
               schedule: Optional[Schedule] = None,
               eval_fn: Optional[Callable] = None,
               on_reselect: Optional[Callable] = None,
               log: Optional[Callable] = None
               ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Drive `rounds` federation rounds under `schedule`, one
    `make_segment_fn` segment per reselection period.

    Returns (final_state, history): one dict per round with every metric
    (`extract_history`), `eval_fn(state, data)`'s outputs, the absolute
    "round" index and "seconds" (see `make_segment_fn`).
    """
    schedule = schedule or Schedule()
    if schedule.reselect_every > 1 and program.gossip_round is None:
        raise ValueError(f"program {program.name!r} has no gossip_round; "
                         "only Schedule(reselect_every=1) can run it")
    history: List[Dict[str, Any]] = []
    for r0, length in schedule.segments(rounds):
        state, metrics = make_segment_fn(program, length, eval_fn=eval_fn)(
            state, data, r0)
        entries = extract_history(metrics, r0, length)
        history.extend(entries)
        if log is not None:
            for entry in entries:
                parts = [f"{n} {entry[n]:.4f}" for n in ("acc", "mean_loss")
                         if n in entry]
                log(f"round {entry['round']:3d} " + " ".join(parts)
                    + f" ({entry['seconds']:.3f}s)")
        if on_reselect is not None:
            on_reselect(r0, state)
    return state, history


def _device_of(state) -> torch.device:
    """The device of a round state: a FedState's codes, or those of the
    FedState it wraps (the service's ServiceState)."""
    codes = getattr(state, "codes", None)
    if codes is None:
        codes = state.fed.codes
    return codes.device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # analysis: host-ok round wall time
