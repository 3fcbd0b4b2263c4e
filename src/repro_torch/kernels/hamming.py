"""All-pairs Hamming distance (WPFed Eq. 6): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/hamming.py:hamming_all_pairs`
(`_hamming_kernel`). The kernel (`csrc/hamming.cu`) computes 32 x 32
output tiles per block from both tiles' codes in shared memory (XOR +
`__popc`) and stores coalesced int32 rows; it takes any M, N and W (the
TPU wrapper's lane padding does not carry over). Its bound on the H100
is the M*N*4 output bytes or the 3*M*N*W integer operations. Only the
unfused Eq. 6-8 composition (`core.lsh.distance_matrix`) reaches it: the
round selects through the fused kernels. The wrapper takes the plain
version (`ref.hamming_all_pairs_ref`) for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel(
    "hamming", "hamming.cu", "hamming_all_pairs",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])


def hamming_all_pairs(codes_a: torch.Tensor,
                      codes_b: torch.Tensor) -> torch.Tensor:
    """(M, W) x (N, W) int32 packed codes -> (M, N) int32 distances."""
    if codes_a.device.type == "cpu":
        return ref.hamming_all_pairs_ref(codes_a, codes_b)
    if codes_a.device.type != "cuda" or codes_b.device != codes_a.device:
        raise ValueError(f"unsupported devices {codes_a.device} / "
                         f"{codes_b.device}")
    if codes_a.dtype != torch.int32 or codes_b.dtype != torch.int32 or \
            codes_a.ndim != 2 or codes_b.ndim != 2 or \
            codes_a.shape[1] != codes_b.shape[1]:
        raise ValueError("codes must be (M, W) and (N, W) int32, got "
                         f"{codes_a.dtype} {tuple(codes_a.shape)} / "
                         f"{codes_b.dtype} {tuple(codes_b.shape)}")
    (m, w), n = codes_a.shape, codes_b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=codes_a.device)
    if m == 0 or n == 0:
        return out
    if w == 0:
        return out.zero_()
    a, b = codes_a.contiguous(), codes_b.contiguous()
    KERNEL.launch(a.device, a.data_ptr(), b.data_ptr(), m, n, w,
                  out.data_ptr())
    return out
