"""Backend and tiling resolution for the port's kernel-backed subsystems.

The port's own resolver (the JAX package's models TPU VMEM, which does
not carry over). `FedConfig`'s strings keep their meaning:

  "kernel" -> the hand-written CUDA kernel; needs a CUDA device,
  "oracle" -> the kernel's plain PyTorch version (`kernels/ref.py`),
  "auto"   -> kernel on a CUDA device, oracle on the CPU.

Selection also accepts "ann", the LSH-bucket candidate index
(`core/ann.py`), through `resolve_selection`: explicit "ann" at any M,
and "auto" past both `ANN_AUTO_MIN_M` clients and an exact-to-ANN FLOP
ratio of `ANN_AUTO_MIN_RATIO`, the JAX package's rule and values, so
both packages pick the same partners. The exchange has no ANN form, so
plain `resolve` rejects "ann".

Tiling:

  "oneshot" -> the one-block-per-row selection and one-block-per-client
               exchange, which hold a whole row / client in shared memory,
  "tiled"   -> the column-tiled selection and the streamed exchange,
               whose shared memory does not grow with M or C,
  "auto"    -> oneshot while the one-shot kernel's shared memory
               (`selection_oneshot_smem_bytes`,
               `exchange_oneshot_smem_bytes`) fits one H100 block's
               `MAX_SHARED_BYTES`, tiled beyond it.

The budget is the H100's on every device, so a CPU run and a card run
resolve the same regime at the same shapes (the streamed exchange agrees
with the one-shot exchange only within tolerance). Rejection messages
keep the JAX package's shape: field, value, accepted set.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import exchange, selection
from repro_torch.kernels.build import MAX_SHARED_BYTES

BACKENDS = ("auto", "kernel", "oracle")
TILINGS = ("auto", "oneshot", "tiled")
SELECTION_BACKENDS = BACKENDS + ("ann",)

# "auto" hands selection to the ANN path only past both thresholds
ANN_AUTO_MIN_M = 4096
ANN_AUTO_MIN_RATIO = 4.0


def _reject(field: str, value, accepted) -> ValueError:
    return ValueError(
        f"unknown {field}: {value!r} (expected one of {tuple(accepted)})")


def resolve(backend: str, device) -> str:
    """Validate `backend` for tensors on `device`: "kernel" or "oracle"."""
    dev = torch.device(device)
    if backend not in BACKENDS:
        raise _reject("backend", backend, BACKENDS)
    if backend == "auto":
        return "kernel" if dev.type == "cuda" else "oracle"
    if backend == "kernel" and dev.type != "cuda":
        raise ValueError("backend 'kernel' launches CUDA kernels and needs "
                         f"a CUDA device, got {dev}")
    return backend


def selection_flops(m: int, bits_tot: int) -> float:
    """Exact selection prices every pair: 2 * M^2 * bits per round."""
    return 2.0 * m * m * bits_tot


def ann_selection_flops(m: int, bits_tot: int, k: int) -> float:
    """ANN selection prices only the K candidates of each client
    (`ann.candidate_count`): 2 * M * K * bits."""
    return 2.0 * m * k * bits_tot


def resolve_selection(backend: str, m: int, *, exact_flops: float,
                      ann_flops: float, device) -> str:
    """Resolve a selection backend to "ann", "kernel" or "oracle".
    "ann" is explicit at any M; "auto" takes it once
    m >= ANN_AUTO_MIN_M and exact_flops >= ANN_AUTO_MIN_RATIO *
    ann_flops, and below either threshold resolves as `resolve` does."""
    if backend == "ann":
        return "ann"
    if backend == "auto":
        if m >= ANN_AUTO_MIN_M and \
                exact_flops >= ANN_AUTO_MIN_RATIO * ann_flops:
            return "ann"
        return resolve("auto", device)
    if backend not in ("kernel", "oracle"):
        raise _reject("selection backend", backend, SELECTION_BACKENDS)
    return resolve(backend, device)


# the one-shot kernels' shared memory per block, from their wrappers
selection_oneshot_smem_bytes = selection.oneshot_smem_bytes   # (m)
exchange_oneshot_smem_bytes = exchange.oneshot_smem_bytes     # (n, r)


def resolve_tiling(tiling: str, est_oneshot_bytes: int, *,
                   budget_bytes: int = None) -> str:
    """Validate and resolve a tiling string to "oneshot" or "tiled".
    "auto" compares the one-shot kernel's shared-memory estimate with
    the budget (default MAX_SHARED_BYTES, one H100 block's)."""
    if tiling == "auto":
        budget = MAX_SHARED_BYTES if budget_bytes is None else budget_bytes
        return "oneshot" if est_oneshot_bytes <= budget else "tiled"
    if tiling not in ("oneshot", "tiled"):
        raise _reject("tiling", tiling, TILINGS)
    return tiling
