"""Plain PyTorch versions of the port's kernels.

Counterpart of `repro/kernels/ref.py`. Each function computes what its
CUDA kernel computes, with ordinary tensor operations. The CPU tests
hold these against the JAX oracles; `chip_smoke.py` holds each CUDA
kernel against its plain version on the card; the wrappers in
`kernels/{lsh_projection,selection,exchange}.py` call them for CPU
tensors only.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ops import popcount_u32, rademacher_block

# Rows of the Rademacher matrix generated per step: bounds the int64
# hash temporaries at ~BLOCK_P * bits * 8 bytes each.
BLOCK_P = 65536


def lsh_project_sums_batched_ref(x2d: torch.Tensor, seed: int, *,
                                 bits: int = 256) -> torch.Tensor:
    """(M, P) f32 -> (M, bits) f32 Eq. 5 projection sums x @ R with R the
    on-the-fly +-1 matrix. R is generated BLOCK_P rows at a time and the
    partial products accumulate in f32, so sums agree with the JAX
    oracle's single dot to f32 rounding, not bitwise; the packed codes
    agree except on sums within rounding of zero."""
    m, p = x2d.shape
    x = x2d.to(torch.float32)
    out = torch.zeros((m, bits), dtype=torch.float32, device=x.device)
    for p0 in range(0, p, BLOCK_P):
        blk = min(BLOCK_P, p - p0)
        r = rademacher_block(p0, blk, bits, seed, device=x.device)
        out = out + x[:, p0:p0 + blk] @ r
    return out


@functools.lru_cache(maxsize=16)
def selection_lut(words: int, bits: int, gamma: float,
                  device=None) -> torch.Tensor:
    """The (W*32 + 1)-entry Eq. 8 table exp(-gamma * d / bits), d the
    integer Hamming distance (DESIGN.md §4). Built on the CPU in f32 and
    moved to `device`, so the CUDA kernel and the plain version gather
    from identical entries on every device. Cached (callers must not
    write to it): a round would otherwise rebuild and copy it."""
    dmax = words * 32
    table = torch.exp(-gamma * (torch.arange(dmax + 1, dtype=torch.float32)
                                / float(bits)))
    return table.to(device)


def hamming_all_pairs_ref(codes_a: torch.Tensor,
                          codes_b: torch.Tensor) -> torch.Tensor:
    """(M, W) x (N, W) packed codes -> (M, N) int32 Hamming distances."""
    x = codes_a[:, None, :] ^ codes_b[None, :, :]
    return popcount_u32(x).sum(-1, dtype=torch.int32)


def fused_select_ref(codes: torch.Tensor, scores: torch.Tensor,
                     lut: torch.Tensor, *, num_neighbors: int,
                     use_lsh: bool = True, use_rank: bool = True):
    """Eq. 6-8 + top-N: codes (M, W) int32, scores (M,) f32, lut from
    `selection_lut` -> (ids (M, N) int32, top_w (M, N) f32).

    Ties break by ascending id, as `jax.lax.top_k` does: a stable
    descending sort keeps equal weights in column order (`torch.topk`
    does not). At round 0 every Eq. 7 score is 0, so every weight ties
    and the order is decided by the tie-breaking alone."""
    m = codes.shape[0]
    nsel = min(num_neighbors, m - 1)
    if use_rank:
        w = scores.to(torch.float32)[None, :].expand(m, m)
    else:
        w = torch.ones((m, m), dtype=torch.float32, device=codes.device)
    if use_lsh:
        d = hamming_all_pairs_ref(codes, codes)
        w = w * lut[d.to(torch.int64)]
    eye = torch.eye(m, dtype=torch.bool, device=codes.device)
    w = torch.where(eye, torch.tensor(-torch.inf, device=codes.device), w)
    top_w, top_i = torch.sort(w, dim=1, descending=True, stable=True)
    return top_i[:, :nsel].to(torch.int32), top_w[:, :nsel]


def upper_half_mask(kl_mean: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """§3.5 keep filter: the upper half of the selected slots by output
    similarity, in counting-rank form rank(n) = #{k: kl_k < kl_n} +
    #{k < n: kl_k == kl_n} (the stable-argsort rank)."""
    n = kl_mean.shape[-1]
    kls = torch.where(sel, kl_mean, torch.tensor(torch.inf,
                                                 device=kl_mean.device))
    keep = (sel.to(torch.int32).sum(-1, keepdim=True) + 1) // 2
    lt = kls[:, :, None] < kls[:, None, :]
    eq = kls[:, :, None] == kls[:, None, :]
    idx = torch.arange(n, device=kl_mean.device)
    first = idx[:, None] < idx[None, :]
    rank_of = (lt | (eq & first)).to(torch.int32).sum(1)
    return (rank_of < keep) & sel


def all_in_one_exchange_ref(own_logits: torch.Tensor,
                            neighbor_logits: torch.Tensor,
                            y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                            lsh_verification: bool = True):
    """WPFed Eq. 3 + §3.5 + the distillation-target mean over one shared
    neighbour log-softmax. own (M, R, C) f32, neighbour (M, N, R, C) f32,
    y_ref (M, R) int, sel_mask (M, N) bool -> (l_ij (M, N) f32,
    valid (M, N) bool, target (M, R, C) f32, has_target (M,) bool)."""
    own = own_logits.to(torch.float32)
    nb = neighbor_logits.to(torch.float32)
    sel = sel_mask.to(torch.bool)
    logp_nb = torch.log_softmax(nb, dim=-1)
    y = y_ref.to(torch.int64)[:, None, :, None].expand(
        -1, nb.shape[1], -1, 1)
    l_ij = (-torch.gather(logp_nb, -1, y)[..., 0]).mean(-1)
    if lsh_verification:
        logp_own = torch.log_softmax(own, dim=-1)
        kl = (logp_own.exp()[:, None] * (logp_own[:, None] - logp_nb)).sum(-1)
        valid = upper_half_mask(kl.mean(-1), sel)
    else:
        valid = sel
    w = valid.to(torch.float32)
    denom = w.sum(-1).clamp(min=1.0)
    target = torch.einsum("mn,mnrc->mrc", w, nb) / denom[:, None, None]
    return l_ij, valid, target, w.sum(-1) > 0
