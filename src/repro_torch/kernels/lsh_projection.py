"""LSH projection (WPFed Eq. 5): wrappers of the batched and the
single-client CUDA kernels.

Replaces the TPU kernel `repro/kernels/lsh_projection.py:
lsh_project_sums_batched` (`_lsh_batched_kernel`). The kernel
(`csrc/lsh_projection.cu`) regenerates the +-1 projection matrix in
registers from the hash of (parameter index, bit, seed), so R's bytes are
never moved; it is bound on the H100 by its 2*M*P*bits f32 operations
(plus the hash, shared across the client rows each thread holds), and
reduces its per-split partial sums in a fixed order so the codes do not
change from run to run.

`lsh_project_sums` replaces the TPU kernel
`repro/kernels/lsh_projection.py:lsh_project_sums` (`_lsh_kernel`), the
code one client computes from its own model: the same source built
with one row per block, exported as its own entry point; its sums equal
the batched kernel's row bit for bit.

Each wrapper takes its plain version (`ref.lsh_project_sums_batched_ref`,
`ref.lsh_project_sums_ref`) for CPU tensors only; for a CUDA tensor it
launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.ops import CHUNK, MASK32

KERNEL = CudaKernel(
    "lsh_projection", "lsh_projection.cu", "lsh_project_sums_batched",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])


SINGLE_KERNEL = CudaKernel(
    "lsh_single", "lsh_projection.cu", "lsh_project_sums",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
     ctypes.c_void_p, ctypes.c_void_p])


def _check(x: torch.Tensor, ndim: int, bits: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {ndim}-D float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    p = x.shape[-1]
    if p % CHUNK or bits % 32 or bits <= 0 or x.numel() == 0:
        raise ValueError(f"need P % {CHUNK} == 0, bits % 32 == 0 and a "
                         f"non-empty x; got {tuple(x.shape)}, bits={bits}")


def lsh_project_sums(x: torch.Tensor, seed: int, *,
                     bits: int = 256) -> torch.Tensor:
    """(P,) f32, P % CHUNK == 0 -> (bits,) f32: one client's sums."""
    if x.device.type == "cpu":
        return ref.lsh_project_sums_ref(x, seed, bits=bits)
    _check(x, 1, bits)
    p = x.shape[0]
    partial = torch.empty((p // CHUNK, bits), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((bits,), dtype=torch.float32, device=x.device)
    SINGLE_KERNEL.launch(x.device, x.data_ptr(), p, bits,
                         int(seed) & MASK32, partial.data_ptr(),
                         out.data_ptr())
    return out


def lsh_project_sums_batched(x: torch.Tensor, seed: int, *,
                             bits: int = 256) -> torch.Tensor:
    """(M, P) f32, P % CHUNK == 0 -> (M, bits) f32 projection sums."""
    if x.device.type == "cpu":
        return ref.lsh_project_sums_batched_ref(x, seed, bits=bits)
    _check(x, 2, bits)
    m, p = x.shape
    partial = torch.empty((p // CHUNK, m, bits), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((m, bits), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.device, x.data_ptr(), m, p, bits, int(seed) & MASK32,
                  partial.data_ptr(), out.data_ptr())
    return out
