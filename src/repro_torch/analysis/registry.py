"""Kernel-contract registry: one entry per hand-written CUDA kernel.
Counterpart of `repro/analysis/registry.py`.

Every wrapper in `repro_torch.kernels` that launches a `CudaKernel`
registers itself with `@kernel_contract(...)`. An entry records what
`repro_torch.analysis.kernel_contracts` checks:

  * `kernel`      the `CudaKernel` the wrapper launches (its name is the
                  entry's name);
  * `stands_for`  the JAX contract it ports (`repro.analysis.registry`
                  names: lsh_batched, lsh_single, selection_oneshot,
                  selection_tiled, selection_ann, exchange_oneshot,
                  exchange_streamed, hamming, flash_attention);
  * `twin`        its plain version's name in `kernels/ref.py`, and
                  `twin_call(args, kwargs)`, the twin on the wrapper's
                  arguments (the same device);
  * `exactness`   "exact" (every output equal) or "tolerance" (integer
                  and bool outputs equal, floats within `rtol` / `atol`),
                  and `near_ties`, the documented near-tie exception of
                  the outputs derived from it;
  * `helpers`     the other C functions its source exports for it (the
                  shared-memory mirrors, launch queries), and
                  `estimators`: (C helper, Python function, arguments at
                  a point) triples that must agree on the card;
  * `points`      shapes: `points[0]` is the representative launch,
                  every point an estimator shape; `make_args(point)`
                  builds seeded CPU inputs (args, kwargs).

The decorator returns a thin wrapper: with the taint check off it calls
the wrapper and returns its output; while the check runs
(`privacy.tracing()`) it gives the outputs the union of the tensor
inputs' labels (`taint.kernel_value`), because the mode that propagates
labels cannot see inside a ctypes launch.

This module imports only the standard library (and `privacy`, which does
too), so the kernel modules register at import time without a cycle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import privacy

EXACTNESS_CLASSES = ("exact", "tolerance")

# name -> KernelEntry; filled when the kernel modules are imported
REGISTRY: Dict[str, "KernelEntry"] = {}


@dataclasses.dataclass(frozen=True)
class Estimator:
    """A Python shared-memory function and its C mirror: `args(point)`
    gives both the same integer arguments."""
    symbol: str
    fn: Callable
    args: Callable


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str
    fn: Callable              # the undecorated wrapper
    kernel: Any               # build.CudaKernel
    module: str
    stands_for: str
    twin: str
    twin_call: Optional[Callable]   # (args, kwargs) -> outputs
    exactness: str
    rtol: float
    atol: float
    near_ties: str
    helpers: Tuple[str, ...]
    estimators: Tuple[Estimator, ...]
    points: Tuple[dict, ...]
    make_args: Callable       # point -> (args, kwargs), CPU tensors


def kernel_contract(*, kernel, stands_for: str, twin: str,
                    exactness: str, points: Sequence[dict],
                    make_args: Callable, twin_call: Optional[Callable] = None,
                    rtol: float = 0.0, atol: float = 0.0,
                    near_ties: str = "", helpers: Sequence[str] = (),
                    estimators: Sequence[Estimator] = ()):
    """Register a kernel wrapper's contract; see the module docstring."""
    if exactness not in EXACTNESS_CLASSES:
        raise ValueError(f"unknown exactness: {exactness!r} "
                         f"(expected one of {EXACTNESS_CLASSES})")
    if not points:
        raise ValueError(f"kernel_contract({kernel.name!r}) needs points=")

    def deco(fn):
        REGISTRY[kernel.name] = KernelEntry(
            name=kernel.name, fn=fn, kernel=kernel, module=fn.__module__,
            stands_for=stands_for, twin=twin, twin_call=twin_call,
            exactness=exactness, rtol=rtol, atol=atol, near_ties=near_ties,
            helpers=tuple(helpers), estimators=tuple(estimators),
            points=tuple(points), make_args=make_args)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if privacy._ACTIVE[0]:
                from repro_torch.analysis.taint import kernel_value
                return kernel_value(out, (args, kwargs), kernel.name)
            return out

        return wrapper

    return deco


class capture_registrations:
    """Context manager: record entries registered while it is active
    (fixture modules checked in isolation from the HEAD registry)."""

    def __enter__(self) -> List[KernelEntry]:
        self._before = set(REGISTRY)
        self._new: List[KernelEntry] = []
        return self._new

    def __exit__(self, *exc):
        for k in set(REGISTRY) - self._before:
            self._new.append(REGISTRY.pop(k))
        return False
