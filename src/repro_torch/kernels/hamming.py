"""All-pairs Hamming distance (WPFed Eq. 6): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/hamming.py:hamming_all_pairs`
(`_hamming_kernel`); it takes any M, N and W (the TPU wrapper's lane
padding does not carry over). The C entry point (`csrc/hamming.cu`)
picks one of two paths by M*N (`launch_path`): up to 4,096 outputs (the
federation's M = 10) one thread per output reads both codes as uint4 and
keeps XOR + `__popc` in registers, with no shared memory and no barrier;
above, 64 x 64 output tiles per block, codes staged word-major in shared
memory over the live rows and words only, a 4 x 4 register tile per
thread and int4 stores. Its bound on the H100 is the M*N*4 output bytes
or the M*N*W popcounts (16 per SM per clock). Only the unfused Eq. 6-8
composition (`core.lsh.distance_matrix`) reaches it: the round selects
through the fused kernels. The wrapper takes the plain version
(`ref.hamming_all_pairs_ref`) for CPU and `meta` tensors only
(`build.PLAIN_DEVICES`); for a CUDA tensor it launches the kernel or raises.
It registers with `analysis.registry.kernel_contract` (class "exact").
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.registry import kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import PLAIN_DEVICES, CudaKernel

KERNEL = CudaKernel(
    "hamming", "hamming.cu", "hamming_all_pairs",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])


def launch_path(m: int, n: int) -> str:
    """"small" or "tiled": the path the kernel's C entry point takes for
    M x N outputs (asks the built library, so it needs nvcc)."""
    path = KERNEL.helper("hamming_path", [ctypes.c_int, ctypes.c_int])
    return ("small", "tiled")[path(m, n)]


def _contract_args(point: dict):
    """Seeded CPU codes of a contract point (every uint32 pattern)."""
    g = torch.Generator().manual_seed(0)
    w = point["bits"] // 32

    def codes(rows):
        return torch.randint(-2 ** 31, 2 ** 31, (rows, w), generator=g,
                             dtype=torch.int64).to(torch.int32)

    return (codes(point["m"]), codes(point["n"])), {}


@kernel_contract(
    kernel=KERNEL, stands_for="hamming", twin="hamming_all_pairs_ref",
    exactness="exact", helpers=("hamming_path",),
    points=({"m": 16, "n": 24, "bits": 256},), make_args=_contract_args)
def hamming_all_pairs(codes_a: torch.Tensor,
                      codes_b: torch.Tensor) -> torch.Tensor:
    """(M, W) x (N, W) int32 packed codes -> (M, N) int32 distances."""
    if codes_a.device.type in PLAIN_DEVICES:
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
