"""Batched LSH projection (WPFed Eq. 5): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/lsh_projection.py:
lsh_project_sums_batched` (`_lsh_batched_kernel`). The kernel
(`csrc/lsh_projection.cu`) regenerates the +-1 projection matrix in
registers from the hash of (parameter index, bit, seed), so R's bytes are
never moved; it is bound on the H100 by its 2*M*P*bits f32 operations
(plus the hash, shared across the client rows each thread holds), and
reduces its per-split partial sums in a fixed order so the codes do not
change from run to run. The wrapper takes the plain version
(`ref.lsh_project_sums_batched_ref`) for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
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


def lsh_project_sums_batched(x: torch.Tensor, seed: int, *,
                             bits: int = 256) -> torch.Tensor:
    """(M, P) f32, P % CHUNK == 0 -> (M, bits) f32 projection sums."""
    if x.device.type == "cpu":
        return ref.lsh_project_sums_batched_ref(x, seed, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, p = x.shape
    if p % CHUNK or bits % 32 or bits <= 0 or m == 0:
        raise ValueError(f"need P % {CHUNK} == 0, bits % 32 == 0 and M > 0; "
                         f"got P={p}, bits={bits}, M={m}")
    partial = torch.empty((p // CHUNK, m, bits), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((m, bits), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.device, x.data_ptr(), m, p, bits, int(seed) & MASK32,
                  partial.data_ptr(), out.data_ptr())
    return out
