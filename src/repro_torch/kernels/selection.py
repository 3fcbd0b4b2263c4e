"""Fused peer selection (WPFed Eq. 6-8 + top-N): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/selection.py:fused_select`
(`_select_kernel`). The kernel (`csrc/selection.cu`) runs one block per
client row: XOR + popcount distances, weights gathered from the
wrapper's exp table (so they equal the plain version's bit for bit),
self at -inf, then top-N by first-max knockout with ascending-id ties.
Its bound on the H100 at the main path's M=10 is launch latency; it
keeps each row's weights in shared memory so no (M, M) array is
written. The wrapper takes the plain version (`ref.fused_select_ref`)
for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_SHARED_BYTES, CudaKernel

KERNEL = CudaKernel(
    "selection", "selection.cu", "fused_select",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])


def fused_select(codes: torch.Tensor, scores: torch.Tensor, *, bits: int,
                 gamma: float, num_neighbors: int, use_lsh: bool = True,
                 use_rank: bool = True):
    """codes (M, W) int32 (uint32 patterns), scores (M,) f32 ->
    (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1)."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    nsel = min(num_neighbors, m - 1)
    if codes.device.type == "cpu":
        return ref.fused_select_ref(codes, scores, lut,
                                    num_neighbors=num_neighbors,
                                    use_lsh=use_lsh, use_rank=use_rank)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.dtype != torch.int32 or scores.dtype != torch.float32:
        raise ValueError("codes must be int32 and scores float32, got "
                         f"{codes.dtype} / {scores.dtype}")
    if scores.shape != (m,) or scores.device != codes.device:
        raise ValueError("scores must be (M,) on the codes' device")
    if m * 5 > MAX_SHARED_BYTES:              # a weight and a flag per column
        raise ValueError(f"M={m} exceeds the one-shot kernel's shared "
                         "memory; the tiled selection is not ported yet")
    if nsel <= 0:
        return (torch.zeros((m, 0), dtype=torch.int32, device=codes.device),
                torch.zeros((m, 0), dtype=torch.float32, device=codes.device))
    codes, scores = codes.contiguous(), scores.contiguous()
    ids = torch.empty((m, nsel), dtype=torch.int32, device=codes.device)
    top_w = torch.empty((m, nsel), dtype=torch.float32, device=codes.device)
    KERNEL.launch(codes.device, codes.data_ptr(), scores.data_ptr(),
                  lut.data_ptr(), m, w, nsel, int(use_lsh), int(use_rank),
                  ids.data_ptr(), top_w.data_ptr())
    return ids, top_w
