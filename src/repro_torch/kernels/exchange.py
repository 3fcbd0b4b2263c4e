"""Fused all-in-one exchange (WPFed Eq. 3 + §3.5 + target): wrappers of the
one-shot and the streamed CUDA kernels.

Replaces the TPU kernel `repro/kernels/exchange.py:fused_exchange`
(`_exchange_kernel`). The kernel (`csrc/exchange.cu`) runs one block per
client: one shared neighbour log-softmax per row feeds the Eq. 3 label
NLL and the §3.5 KL, the upper-half mask is the stable counting rank,
and the masked target mean follows in the same launch. It is bound on
the H100 by the bytes of the logit web it reads once; at the main path's
shapes that is under a microsecond and the launch dominates. It takes
N <= 512 and (2R + 2NR + 2N) * 4 bytes of shared memory per client.

`fused_exchange_streamed` replaces the TPU kernel
`repro/kernels/exchange.py:fused_exchange_streamed`
(`_streamed_stats_kernel` + `_target_kernel`) with
`csrc/exchange_streamed.cu`: per-row online statistics on a grid over
(client, neighbour, R block), then the means and the mask per client,
then the target over (client, R*C tiles); nothing bounds N, R or C but
device memory. Bound by bytes; it reads the neighbour logits twice.

Each wrapper takes its plain version (`ref.all_in_one_exchange_ref`,
`ref.streamed_exchange_ref`) for CPU tensors only; for a CUDA tensor it
launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_SHARED_BYTES, CudaKernel

KERNEL = CudaKernel(
    "exchange", "exchange.cu", "fused_exchange",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
MAX_THREADS = 512           # the kernel's block; one thread per neighbour slot


def oneshot_smem_bytes(n: int, r: int) -> int:
    """Shared memory of one `csrc/exchange.cu` block: own-row max and
    LSE, per-(n, r) NLL and KL, per-neighbour KL mean and mask. Above
    the block's MAX_THREADS (one per neighbour slot) the kernel cannot
    run at all: reported as one byte over MAX_SHARED_BYTES."""
    if n > MAX_THREADS:
        return MAX_SHARED_BYTES + 1
    return 4 * (2 * r + 2 * n * r + 2 * n)


def _checked(own_logits, neighbor_logits, y_ref, sel_mask):
    """Raise on what the kernels do not take; the inputs as the kernels
    read them (f32 / int32, contiguous) and the outputs to fill:
    l_ij (M, N) f32, valid (M, N) int32, target (M, R, C) f32 and a
    per-client int32."""
    dev = neighbor_logits.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m, n, r, c = neighbor_logits.shape
    if own_logits.shape != (m, r, c) or y_ref.shape != (m, r) \
            or sel_mask.shape != (m, n):
        raise ValueError("shape mismatch: own (M, R, C), neighbour "
                         "(M, N, R, C), y_ref (M, R), sel (M, N)")
    if any(t.device != dev for t in (own_logits, y_ref, sel_mask)):
        raise ValueError("all exchange inputs must be on one device")
    inputs = (own_logits.to(torch.float32).contiguous(),
              neighbor_logits.to(torch.float32).contiguous(),
              y_ref.to(torch.int32).contiguous(),
              sel_mask.to(torch.int32).contiguous())
    outputs = (torch.empty((m, n), dtype=torch.float32, device=dev),
               torch.empty((m, n), dtype=torch.int32, device=dev),
               torch.empty((m, r, c), dtype=torch.float32, device=dev),
               torch.empty((m,), dtype=torch.int32, device=dev))
    return inputs, outputs


def fused_exchange(own_logits: torch.Tensor, neighbor_logits: torch.Tensor,
                   y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                   lsh_verification: bool = True):
    """own (M, R, C), neighbour (M, N, R, C), y_ref (M, R), sel (M, N) ->
    (l_ij (M, N) f32, valid (M, N) bool, target (M, R, C) f32,
    has_target (M,) bool)."""
    if neighbor_logits.device.type == "cpu":
        return ref.all_in_one_exchange_ref(own_logits, neighbor_logits,
                                           y_ref, sel_mask,
                                           lsh_verification=lsh_verification)
    (own, nb, y, sel), (l_ij, valid, target, has) = _checked(
        own_logits, neighbor_logits, y_ref, sel_mask)
    m, n, r, c = nb.shape
    if oneshot_smem_bytes(n, r) > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, R={r} exceed the one-shot kernel; "
                         "exchange with tiling=\"tiled\" or \"auto\" (the "
                         "streamed kernel)")
    if m == 0 or n == 0:
        return (l_ij, valid.bool(), target.zero_(), has.zero_().bool())
    KERNEL.launch(nb.device, own.data_ptr(), nb.data_ptr(), y.data_ptr(),
                  sel.data_ptr(), m, n, r, c, int(lsh_verification),
                  l_ij.data_ptr(), valid.data_ptr(), target.data_ptr(),
                  has.data_ptr())
    return l_ij, valid.bool(), target, has.bool()


STREAMED_KERNEL = CudaKernel(
    "exchange_streamed", "exchange_streamed.cu", "fused_exchange_streamed",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def fused_exchange_streamed(own_logits: torch.Tensor,
                            neighbor_logits: torch.Tensor,
                            y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                            lsh_verification: bool = True):
    """`fused_exchange`'s contract through the streamed kernel, at any
    N, R, C: own (M, R, C), neighbour (M, N, R, C), y_ref (M, R),
    sel (M, N) -> (l_ij (M, N) f32, valid (M, N) bool, target (M, R, C)
    f32, has_target (M,) bool). l_ij and target agree with the plain
    versions within f32 rounding; valid and has_target are equal."""
    if neighbor_logits.device.type == "cpu":
        return ref.streamed_exchange_ref(own_logits, neighbor_logits, y_ref,
                                         sel_mask,
                                         lsh_verification=lsh_verification)
    (own, nb, y, sel), (l_ij, valid, target, count) = _checked(
        own_logits, neighbor_logits, y_ref, sel_mask)
    m, n, r, c = nb.shape
    if min(m, n, r, c) == 0:
        return (l_ij, valid.bool(), target.zero_(), count.zero_().bool())
    # scratch: freed on return, but the caching allocator reuses a block
    # only in order on this stream, after the kernels that read it
    nll_s = torch.empty((m, n, r), dtype=torch.float32, device=nb.device)
    kl_s = torch.empty((m, n, r), dtype=torch.float32, device=nb.device)
    klm_s = torch.empty((m, n), dtype=torch.float32, device=nb.device)
    STREAMED_KERNEL.launch(
        nb.device, own.data_ptr(), nb.data_ptr(), y.data_ptr(),
        sel.data_ptr(), m, n, r, c, int(lsh_verification), nll_s.data_ptr(),
        kl_s.data_ptr(), klm_s.data_ptr(), l_ij.data_ptr(), valid.data_ptr(),
        target.data_ptr(), count.data_ptr())
    return l_ij, valid.bool(), target, count > 0
