"""Backend and tiling resolution for the port's kernel-backed subsystems.

The port's own resolver (the JAX package's models TPU VMEM, which does
not carry over). `FedConfig`'s strings keep their meaning:

  "kernel" -> the hand-written CUDA kernel; needs a CUDA device,
  "oracle" -> the kernel's plain PyTorch version (`kernels/ref.py`),
  "auto"   -> kernel on a CUDA device, oracle on the CPU.

Tiling: "oneshot" is the kernels this package has; "auto" resolves to
it; "tiled" (the streaming kernels) is not ported yet and raises. The
rejection message keeps the JAX package's shape: field, value, accepted
set.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "kernel", "oracle")
TILINGS = ("auto", "oneshot", "tiled")


def _reject(field: str, value, accepted) -> ValueError:
    return ValueError(
        f"unknown {field}: {value!r} (expected one of {tuple(accepted)})")


def resolve(backend: str, device) -> str:
    """Validate `backend` for tensors on `device`: "kernel" or "oracle"."""
    dev = torch.device(device)
    if backend == "ann":
        raise NotImplementedError(
            "the 'ann' selection backend is not ported yet")
    if backend not in BACKENDS:
        raise _reject("backend", backend, BACKENDS)
    if backend == "auto":
        return "kernel" if dev.type == "cuda" else "oracle"
    if backend == "kernel" and dev.type != "cuda":
        raise ValueError("backend 'kernel' launches CUDA kernels and needs "
                         f"a CUDA device, got {dev}")
    return backend


def resolve_tiling(tiling: str) -> str:
    """Validate `tiling`: "oneshot" is the only regime ported so far."""
    if tiling not in TILINGS:
        raise _reject("tiling", tiling, TILINGS)
    if tiling == "tiled":
        raise NotImplementedError(
            "tiling 'tiled' (the streaming selection and exchange kernels) "
            "is not ported yet")
    return "oneshot"
