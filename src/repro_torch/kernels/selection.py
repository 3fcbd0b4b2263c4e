"""Fused peer selection (WPFed Eq. 6-8 + top-N): wrappers of the one-shot
and the column-tiled CUDA kernels.

Replaces the TPU kernel `repro/kernels/selection.py:fused_select`
(`_select_kernel`). The kernel (`csrc/selection.cu`) runs one block per
client row: XOR + popcount distances, weights gathered from the
wrapper's exp table (so they equal the plain version's bit for bit),
self at -inf, then top-N by first-max knockout with ascending-id ties.
Its bound on the H100 at the main path's M=10 is launch latency; it
keeps each row's weights in shared memory so no (M, M) array is
written. Past M = MAX_SHARED_BYTES / 5 = 46,489 clients that row no
longer fits one block's shared memory.

`fused_select_tiled` replaces the TPU kernel
`repro/kernels/selection.py:fused_select_tiled` (`_select_tiled_kernel`)
with `csrc/selection_tiled.cu`: one thread per row, column tiles of
codes staged in shared memory, a running top-N per row; shared memory
does not grow with M. Its bound is the 3*M*M*W integer operations.

`fused_select_ann` replaces the TPU kernel
`repro/kernels/selection.py:fused_select_ann` (`_select_ann_kernel`)
with `csrc/selection_ann.cu`: Eq. 6-8 only on each row's K candidate
ids from `core/ann.py`, one warp per row, candidate codes gathered by id
inside the kernel (the TPU wrapper's (M, K, W) gather is not carried
over), ties by candidate position. Its bound is 3*M*K*W integer
operations or the M*K*4 bytes of candidate ids.

Each wrapper takes its plain version (`ref.fused_select_ref`,
`ref.fused_select_tiled_ref`, `ref.ann_select_ref`) for CPU tensors
only; for a CUDA tensor it launches its kernel or raises.
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


def oneshot_smem_bytes(m: int) -> int:
    """Shared memory of one `csrc/selection.cu` block: a weight and a
    taken flag per column."""
    return 5 * m


def _launch(kernel: CudaKernel, codes: torch.Tensor, scores: torch.Tensor,
            lut: torch.Tensor, nsel: int, use_lsh: bool, use_rank: bool,
            cand_ids: torch.Tensor = None):
    """Launch a selection kernel on CUDA tensors after the checks all
    three kernels share (`cand_ids` only for the ANN kernel); (ids
    (M, nsel) int32, top_w (M, nsel) f32)."""
    m, w = codes.shape
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.dtype != torch.int32 or scores.dtype != torch.float32:
        raise ValueError("codes must be int32 and scores float32, got "
                         f"{codes.dtype} / {scores.dtype}")
    if scores.shape != (m,) or scores.device != codes.device:
        raise ValueError("scores must be (M,) on the codes' device")
    if nsel <= 0:
        return (torch.zeros((m, 0), dtype=torch.int32, device=codes.device),
                torch.zeros((m, 0), dtype=torch.float32, device=codes.device))
    codes, scores = codes.contiguous(), scores.contiguous()
    ids = torch.empty((m, nsel), dtype=torch.int32, device=codes.device)
    top_w = torch.empty((m, nsel), dtype=torch.float32, device=codes.device)
    args = (codes.data_ptr(), scores.data_ptr(), lut.data_ptr(), m, w)
    if cand_ids is not None:
        cand_ids = cand_ids.contiguous()
        args = args[:3] + (cand_ids.data_ptr(), m, w, cand_ids.shape[1])
    kernel.launch(codes.device, *args, nsel, int(use_lsh), int(use_rank),
                  ids.data_ptr(), top_w.data_ptr())
    return ids, top_w


def fused_select(codes: torch.Tensor, scores: torch.Tensor, *, bits: int,
                 gamma: float, num_neighbors: int, use_lsh: bool = True,
                 use_rank: bool = True):
    """codes (M, W) int32 (uint32 patterns), scores (M,) f32 ->
    (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1)."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type == "cpu":
        return ref.fused_select_ref(codes, scores, lut,
                                    num_neighbors=num_neighbors,
                                    use_lsh=use_lsh, use_rank=use_rank)
    if oneshot_smem_bytes(m) > MAX_SHARED_BYTES:
        raise ValueError(f"M={m} exceeds the one-shot kernel's shared "
                         "memory; select with tiling=\"tiled\" or \"auto\" "
                         "(the column-tiled kernel)")
    return _launch(KERNEL, codes, scores, lut, min(num_neighbors, m - 1),
                   use_lsh, use_rank)


TILED_KERNEL = CudaKernel(
    "selection_tiled", "selection_tiled.cu", "fused_select_tiled",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])
TILED_MAX_NEIGHBORS = 128   # running top-N slots per row in shared memory
TILED_MAX_WORDS = 32        # code words (1024 bits) per row


def fused_select_tiled(codes: torch.Tensor, scores: torch.Tensor, *,
                       bits: int, gamma: float, num_neighbors: int,
                       use_lsh: bool = True, use_rank: bool = True):
    """`fused_select`'s contract through the column-tiled kernel, for any
    M: codes (M, W) int32, scores (M,) f32 -> (ids (M, N) int32,
    top_w (M, N) f32), N = min(num_neighbors, M-1) <= TILED_MAX_NEIGHBORS.
    Bit-equal to `fused_select` and to the plain versions."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type == "cpu":
        return ref.fused_select_tiled_ref(codes, scores, lut,
                                          num_neighbors=num_neighbors,
                                          use_lsh=use_lsh, use_rank=use_rank)
    nsel = min(num_neighbors, m - 1)
    if nsel > TILED_MAX_NEIGHBORS or w > TILED_MAX_WORDS:
        raise ValueError(f"N={nsel}, W={w}: the tiled selection kernel takes "
                         f"N <= {TILED_MAX_NEIGHBORS} and codes of at most "
                         f"{TILED_MAX_WORDS * 32} bits")
    return _launch(TILED_KERNEL, codes, scores, lut, nsel, use_lsh, use_rank)


ANN_KERNEL = CudaKernel(
    "selection_ann", "selection_ann.cu", "fused_select_ann",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def fused_select_ann(codes: torch.Tensor, scores: torch.Tensor,
                     cand_ids: torch.Tensor, *, bits: int, gamma: float,
                     num_neighbors: int, use_lsh: bool = True,
                     use_rank: bool = True):
    """Eq. 6-8 + top-N on candidate sets: codes (M, W) int32, scores (M,)
    f32, cand_ids (M, K) int32 ids in [0, M] (M marks an invalid slot) ->
    (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1) <=
    TILED_MAX_NEIGHBORS and <= K. Slots with no finite weight get id 0
    and weight -inf. Bit-equal to `ref.ann_select_ref`."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type == "cpu":
        return ref.ann_select_ref(codes, scores, cand_ids, lut,
                                  num_neighbors=num_neighbors,
                                  use_lsh=use_lsh, use_rank=use_rank)
    nsel = min(num_neighbors, m - 1)
    k = cand_ids.shape[1] if cand_ids.ndim == 2 else 0
    if cand_ids.dtype != torch.int32 or cand_ids.shape != (m, k) or \
            cand_ids.device != codes.device:
        raise ValueError("cand_ids must be (M, K) int32 on the codes' "
                         f"device, got {cand_ids.dtype} "
                         f"{tuple(cand_ids.shape)}")
    if nsel > TILED_MAX_NEIGHBORS or w > TILED_MAX_WORDS or nsel > k:
        raise ValueError(f"N={nsel}, W={w}, K={k}: the ANN selection kernel "
                         f"takes N <= {TILED_MAX_NEIGHBORS}, N <= K and "
                         f"codes of at most {TILED_MAX_WORDS * 32} bits")
    return _launch(ANN_KERNEL, codes, scores, lut, nsel, use_lsh, use_rank,
                   cand_ids)
