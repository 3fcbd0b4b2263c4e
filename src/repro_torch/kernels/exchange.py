"""Fused all-in-one exchange (WPFed Eq. 3 + §3.5 + target): wrapper of the
CUDA kernel.

Replaces the TPU kernel `repro/kernels/exchange.py:fused_exchange`
(`_exchange_kernel`). The kernel (`csrc/exchange.cu`) runs one block per
client: one shared neighbour log-softmax per row feeds the Eq. 3 label
NLL and the §3.5 KL, the upper-half mask is the stable counting rank,
and the masked target mean follows in the same launch. It is bound on
the H100 by the bytes of the logit web it reads once; at the main path's
shapes that is under a microsecond and the launch dominates. The wrapper
takes the plain version (`ref.all_in_one_exchange_ref`) for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.
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


def fused_exchange(own_logits: torch.Tensor, neighbor_logits: torch.Tensor,
                   y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                   lsh_verification: bool = True):
    """own (M, R, C), neighbour (M, N, R, C), y_ref (M, R), sel (M, N) ->
    (l_ij (M, N) f32, valid (M, N) bool, target (M, R, C) f32,
    has_target (M,) bool)."""
    dev = neighbor_logits.device
    if dev.type == "cpu":
        return ref.all_in_one_exchange_ref(own_logits, neighbor_logits,
                                           y_ref, sel_mask,
                                           lsh_verification=lsh_verification)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m, n, r, c = neighbor_logits.shape
    if own_logits.shape != (m, r, c) or y_ref.shape != (m, r) \
            or sel_mask.shape != (m, n):
        raise ValueError("shape mismatch: own (M, R, C), neighbour "
                         "(M, N, R, C), y_ref (M, R), sel (M, N)")
    if any(t.device != dev for t in (own_logits, y_ref, sel_mask)):
        raise ValueError("all exchange inputs must be on one device")
    smem = (2 * r + 2 * n * r + 2 * n) * 4
    if n > MAX_THREADS or smem > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, R={r} exceed the one-shot kernel; the "
                         "streamed exchange is not ported yet")
    own = own_logits.to(torch.float32).contiguous()
    nb = neighbor_logits.to(torch.float32).contiguous()
    y = y_ref.to(torch.int32).contiguous()
    sel = sel_mask.to(torch.int32).contiguous()
    l_ij = torch.empty((m, n), dtype=torch.float32, device=dev)
    valid = torch.empty((m, n), dtype=torch.int32, device=dev)
    target = torch.empty((m, r, c), dtype=torch.float32, device=dev)
    has = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return (l_ij, valid.bool(), target.zero_(), has.zero_().bool())
    KERNEL.launch(dev, own.data_ptr(), nb.data_ptr(), y.data_ptr(),
                  sel.data_ptr(), m, n, r, c, int(lsh_verification),
                  l_ij.data_ptr(), valid.data_ptr(), target.data_ptr(),
                  has.data_ptr())
    return l_ij, valid.bool(), target, has.bool()
