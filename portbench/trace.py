"""Reductions from a `torch.profiler` trace (Chrome trace JSON) of a
stretch of whole rounds.

Device activity is attributed to the layer that launched it: each
kernel, memcpy or memset carries the correlation id of the runtime or
driver call that launched it, and that call's host timestamp falls in
one of the round's phase spans (`wpfed.select`, `wpfed.exchange`,
`wpfed.update`, `wpfed.announce`, recorded by `core/protocol.py`) or
in the harness's own `portbench.publish`. The device's own clock never
decides the phase: an asynchronous launch runs later than its span.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PHASES = ("wpfed.select", "wpfed.exchange", "wpfed.update",
          "wpfed.announce", "portbench.publish")
STRETCH = "portbench.stretch"
NAME_CHARS = 160          # a kernel's name in the breakdown, cut


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _union(intervals))


class Trace:
    """Device events, their launches, and the host spans of one stretch
    (timestamps in microseconds, one clock)."""

    def __init__(self, events: Iterable[Dict]):
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch_ts: Dict[int, float] = {}
        spans: List[Tuple[float, float, str]] = []
        self.stretch: Optional[Tuple[float, float]] = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, dur, name, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch_ts[corr] = ts
            elif cat == "user_annotation":
                if name == STRETCH:
                    self.stretch = (ts, ts + dur)
                elif name in PHASES:
                    spans.append((ts, ts + dur, name))
        self.device.sort()
        spans.sort()
        self._spans = spans
        self._starts = [s[0] for s in spans]
        if self.stretch is None and self.device:
            self.stretch = (self.device[0][0],
                            max(t + d for t, d, _, _ in self.device))

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
        return cls(raw.get("traceEvents", raw) if isinstance(raw, dict)
                   else raw)

    def span_at(self, ts: float) -> str:
        """The phase span that holds host time `ts`, or "other"."""
        i = bisect.bisect_right(self._starts, ts) - 1
        if i >= 0 and self._spans[i][0] <= ts <= self._spans[i][1]:
            return self._spans[i][2]
        return "other"

    def phase_of(self, corr: Optional[int]) -> str:
        ts = self.launch_ts.get(corr) if corr is not None else None
        return "unlaunched" if ts is None else self.span_at(ts)

    def in_stretch(self):
        if self.stretch is None:
            return []
        a, b = self.stretch
        return [e for e in self.device if a <= e[0] <= b]

    def device_us(self, phases: Iterable[str]) -> float:
        """Device busy time of the work launched inside `phases`: the
        union of those events' intervals (kernels of one phase that
        overlap on several streams count once), microseconds."""
        want = set(phases)
        return _union_us([(t, t + d) for t, d, _, c in self.in_stretch()
                          if self.phase_of(c) in want])

    def by_phase(self) -> Dict[str, float]:
        """Busy microseconds of each phase's launches (`device_us`)."""
        phases = {self.phase_of(c) for _, _, _, c in self.in_stretch()}
        return {p: self.device_us([p]) for p in sorted(phases)}

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the stretch."""
        if self.stretch is None:
            return []
        a, b = self.stretch
        return _union([(max(t, a), min(t + d, b)) for t, d, _, _ in
                       self.device])

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def wall_us(self) -> float:
        return self.stretch[1] - self.stretch[0] if self.stretch else 0.0

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest idle stretches of the device, each named by the
        phase span the host was in when it began; seconds."""
        if self.stretch is None:
            return []
        a, b = self.stretch
        edges = [a]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(b)
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [(self.span_at(t0), g / 1e6) for g, t0 in gaps[:top]]

    def top_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """Device operations by total time, seconds."""
        tot: Dict[str, float] = {}
        for _, d, name, _ in self.in_stretch():
            tot[name[:NAME_CHARS]] = tot.get(name[:NAME_CHARS], 0.0) + d
        return [(n, t / 1e6) for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
