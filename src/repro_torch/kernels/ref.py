"""Plain PyTorch versions of the port's kernels.

Counterpart of `repro/kernels/ref.py`. Each function computes what its
CUDA kernel computes, with ordinary tensor operations. The CPU tests
hold these against the JAX oracles; `chip_smoke.py` holds each CUDA
kernel against its plain version on the card; the wrappers in
`kernels/{lsh_projection,selection,exchange,hamming,flash_attention}.py`
call them for CPU tensors only.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ops import popcount_u32, rademacher_block

# Rows of the Rademacher matrix generated per step: bounds the int64
# hash temporaries at ~BLOCK_P * bits * 8 bytes each.
BLOCK_P = 65536
# Rows per step of the Hamming and ANN plain versions: bounds their
# (rows, N or K, W) XOR temporaries (a few hundred MB at M=65,536).
BLOCK_ROWS = 1024


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


def lsh_project_sums_ref(x: torch.Tensor, seed: int, *,
                         bits: int = 256) -> torch.Tensor:
    """(P,) f32 -> (bits,) f32: one client's Eq. 5 sums, the (1, P) case
    of `lsh_project_sums_batched_ref`."""
    return lsh_project_sums_batched_ref(x[None], seed, bits=bits)[0]


def lsh_project_sums_split_order(x2d: torch.Tensor, seed: int, *,
                                 bits: int = 256,
                                 chunk: int) -> torch.Tensor:
    """(M, P) f32 -> (M, bits) f32 Eq. 5 sums in the LSH kernels' exact
    order: P cut into P / chunk splits, one f32 chain per split from 0 in
    increasing p, then the splits added in order from 0. Since R = +-1,
    x * r is exact and `acc + x * r` rounds as the kernel's
    fmaf(r, x, acc) does, so this equals the CUDA kernels bit for bit.
    Used by the tests and `chip_smoke.py` only; it holds a (S, M, bits)
    accumulator and all of R at once."""
    m, p = x2d.shape
    s = p // chunk
    x = x2d.to(torch.float32).reshape(m, s, chunk)
    r = rademacher_block(0, p, bits, seed, device=x.device).reshape(
        s, chunk, bits)
    acc = torch.zeros((s, m, bits), dtype=torch.float32, device=x.device)
    for i in range(chunk):
        acc = acc + x[:, :, i].T[:, :, None] * r[:, i][:, None, :]
    out = torch.zeros((m, bits), dtype=torch.float32, device=x.device)
    for k in range(s):
        out = out + acc[k]
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
    """(M, W) x (N, W) packed codes -> (M, N) int32 Hamming distances,
    BLOCK_ROWS rows at a time."""
    out = torch.empty((codes_a.shape[0], codes_b.shape[0]),
                      dtype=torch.int32, device=codes_a.device)
    for r0 in range(0, codes_a.shape[0], BLOCK_ROWS):
        x = codes_a[r0:r0 + BLOCK_ROWS, None, :] ^ codes_b[None, :, :]
        out[r0:r0 + BLOCK_ROWS] = popcount_u32(x).sum(-1, dtype=torch.int32)
    return out


def _eq8_weights(codes: torch.Tensor, scores: torch.Tensor,
                 lut: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 use_lsh: bool, use_rank: bool) -> torch.Tensor:
    """Eq. 8 weights w_ij = s_j * lut[d_ij] (Table-3 switches) of the
    `rows` x `cols` client ids, self at -inf."""
    dev = codes.device
    if use_rank:
        w = scores.to(torch.float32)[cols][None, :].expand(len(rows), -1)
    else:
        w = torch.ones((len(rows), len(cols)), device=dev)
    if use_lsh:
        d = hamming_all_pairs_ref(codes[rows], codes[cols])
        w = w * lut[d.to(torch.int64)]
    return torch.where(rows[:, None] == cols[None, :],
                       torch.tensor(-torch.inf, device=dev), w)


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
    ids = torch.arange(m, device=codes.device)
    w = _eq8_weights(codes, scores, lut, ids, ids, use_lsh, use_rank)
    top_w, top_i = torch.sort(w, dim=1, descending=True, stable=True)
    return top_i[:, :nsel].to(torch.int32), top_w[:, :nsel]


def fused_select_tiled_ref(codes: torch.Tensor, scores: torch.Tensor,
                           lut: torch.Tensor, *, num_neighbors: int,
                           use_lsh: bool = True, use_rank: bool = True,
                           block_m: int = 128, block_k: int = 512):
    """`fused_select_ref`'s contract, walked as the column-tiled kernel
    walks it: (block_m, block_k) weight tiles, each merged into a running
    top-N per row. The running candidates go first in the merge; they
    come from earlier tiles, so their ids are smaller, and the stable
    descending sort keeps ascending-id ties across tiles. Bit-equal to
    `fused_select_ref` (same elementwise weights, exact merge) while
    holding O(block_m * block_k) weights, never the (M, M) matrix."""
    m = codes.shape[0]
    nsel = max(min(num_neighbors, m - 1), 0)
    dev = codes.device
    ids = torch.zeros((m, nsel), dtype=torch.int64, device=dev)
    top_w = torch.zeros((m, nsel), dtype=torch.float32, device=dev)
    for r0 in range(0, m if nsel else 0, block_m):
        rows = torch.arange(r0, min(r0 + block_m, m), device=dev)
        run_w = torch.empty((len(rows), 0), device=dev)
        run_i = torch.empty((len(rows), 0), dtype=torch.int64, device=dev)
        for c0 in range(0, m, block_k):
            cols = torch.arange(c0, min(c0 + block_k, m), device=dev)
            w = _eq8_weights(codes, scores, lut, rows, cols, use_lsh,
                             use_rank)
            cand_i = torch.cat([run_i, cols.expand(len(rows), -1)], dim=1)
            run_w, order = torch.sort(torch.cat([run_w, w], dim=1), dim=1,
                                      descending=True, stable=True)
            run_w, order = run_w[:, :nsel], order[:, :nsel]
            run_i = torch.gather(cand_i, 1, order)
        ids[rows], top_w[rows] = run_i, run_w
    return ids.to(torch.int32), top_w


def ann_select_ref(codes: torch.Tensor, scores: torch.Tensor,
                   cand_ids: torch.Tensor, lut: torch.Tensor, *,
                   num_neighbors: int, use_lsh: bool = True,
                   use_rank: bool = True, block_m: int = BLOCK_ROWS):
    """Eq. 6-8 + top-N on (M, K) candidate sets (`core.ann`, sentinel id
    M in invalid slots): codes (M, W) int32, scores (M,) f32, cand_ids
    (M, K) int32, lut from `selection_lut` -> (ids (M, N) int32, top_w
    (M, N) f32). Self and the sentinel weigh -inf; ties break by
    candidate position (a stable descending sort, as `lax.top_k`);
    slots with no finite weight get id 0. Rows go `block_m` at a time,
    so the (rows, K, W) gather stays small. Equal bit for bit to the JAX
    package's `ann_select_ref` on the same candidates."""
    m, w = codes.shape
    nsel = min(num_neighbors, m - 1)
    dev = codes.device
    if nsel <= 0:
        return (torch.zeros((m, 0), dtype=torch.int32, device=dev),
                torch.zeros((m, 0), dtype=torch.float32, device=dev))
    codes_pad = torch.cat([codes, codes.new_zeros((1, w))])
    scores_pad = torch.cat([scores.to(torch.float32),
                            torch.zeros((1,), device=dev)])
    ids = torch.empty((m, nsel), dtype=torch.int32, device=dev)
    top_w = torch.empty((m, nsel), dtype=torch.float32, device=dev)
    ninf = torch.tensor(-torch.inf, device=dev)
    for r0 in range(0, m, block_m):
        r1 = min(r0 + block_m, m)
        cand = cand_ids[r0:r1].to(torch.int64)
        if use_rank:
            wt = scores_pad[cand]
        else:
            wt = torch.ones(cand.shape, device=dev)
        if use_lsh:
            x = codes[r0:r1, None, :] ^ codes_pad[cand]
            d = popcount_u32(x).sum(-1, dtype=torch.int32)
            wt = wt * lut[d.to(torch.int64)]
        row = torch.arange(r0, r1, device=dev)[:, None]
        wt = torch.where((cand == row) | (cand >= m), ninf, wt)
        tw, pos = torch.sort(wt, dim=1, descending=True, stable=True)
        tw, pos = tw[:, :nsel], pos[:, :nsel]
        sel = torch.gather(cand, 1, pos)
        ids[r0:r1] = torch.where(torch.isfinite(tw), sel, 0).to(torch.int32)
        top_w[r0:r1] = tw
    return ids, top_w


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


def wrap_labels(y_ref: torch.Tensor, c: int):
    """Labels as the JAX package's `jnp.take_along_axis` reads them (fill
    mode): one in [-C, 0) wraps to y + C; any other outside [0, C) reads
    NaN. Returns (labels in [0, C) as int64, the (M, R) mask of labels
    that read NaN)."""
    y = y_ref.to(torch.int64)
    y = torch.where(y < 0, y + c, y)
    bad = (y < 0) | (y >= c)
    return torch.where(bad, 0, y), bad


def all_in_one_exchange_ref(own_logits: torch.Tensor,
                            neighbor_logits: torch.Tensor,
                            y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                            lsh_verification: bool = True):
    """WPFed Eq. 3 + §3.5 + the distillation-target mean over one shared
    neighbour log-softmax. own (M, R, C) f32, neighbour (M, N, R, C) f32,
    y_ref (M, R) int, sel_mask (M, N) bool -> (l_ij (M, N) f32,
    valid (M, N) bool, target (M, R, C) f32, has_target (M,) bool).
    A label outside [0, C) reads as `wrap_labels` says: a client with
    one that reads NaN gets NaN l_ij for every neighbour."""
    own = own_logits.to(torch.float32)
    nb = neighbor_logits.to(torch.float32)
    sel = sel_mask.to(torch.bool)
    logp_nb = torch.log_softmax(nb, dim=-1)
    y, bad = wrap_labels(y_ref, nb.shape[-1])
    y = y[:, None, :, None].expand(-1, nb.shape[1], -1, 1)
    nll = -torch.gather(logp_nb, -1, y)[..., 0]
    nll = torch.where(bad[:, None, :], torch.nan, nll)
    l_ij = nll.mean(-1)
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


def streamed_tiles(r: int, c: int, block_r: int = 8, block_c: int = 512):
    """Clamp the (BR, BC) tile to the (8, 128)-padded problem so small
    shapes run as a single tile; returns (br, pr, bc, pc). The port's
    copy of `repro/kernels/exchange.py:streamed_tiles`."""
    br = min(block_r, r + (-r) % 8)
    bc = min(block_c, c + (-c) % 128)
    return br, (-r) % br, bc, (-c) % bc


def streamed_exchange_ref(own_logits: torch.Tensor,
                          neighbor_logits: torch.Tensor,
                          y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                          lsh_verification: bool = True, block_r: int = 8,
                          block_c: int = 512):
    """Streaming twin of `all_in_one_exchange_ref` (the port's copy of
    `repro/kernels/ref.py:streamed_exchange_ref`): walks (BR, BC) tiles
    of R and C with the online max / sum-exp of each own and neighbour
    row, the label-logit gather and the §3.5 KL cross term
    b = sum_c exp(x_own - m_own) * (x_own - x_nb), so that
    KL = b / a_own - lse_own + lse_nb, without a full-C temporary. Agrees
    with `all_in_one_exchange_ref` within f32 tolerance (the online
    softmax reorders the C reduction); the mask flips only on exact KL
    ties."""
    m, n, r, c = neighbor_logits.shape
    dev = neighbor_logits.device
    br, pr, bc, pc = streamed_tiles(r, c, block_r, block_c)
    own_p = torch.nn.functional.pad(own_logits.to(torch.float32),
                                    (0, pc, 0, pr))
    nb_p = torch.nn.functional.pad(neighbor_logits.to(torch.float32),
                                   (0, pc, 0, pr))
    y_p = torch.nn.functional.pad(y_ref.to(torch.int32), (0, pr))
    nr, nc = (r + pr) // br, (c + pc) // bc
    ninf = torch.tensor(-torch.inf, device=dev)

    l_acc = torch.zeros((m, n), device=dev)
    kl_acc = torch.zeros((m, n), device=dev)
    for ri in range(nr):
        rs = slice(ri * br, (ri + 1) * br)
        m_nb = torch.full((m, n, br), -torch.inf, device=dev)
        a_nb = torch.zeros((m, n, br), device=dev)
        g_nb = torch.zeros((m, n, br), device=dev)
        b_x = torch.zeros((m, n, br), device=dev)
        m_own = torch.full((m, br), -torch.inf, device=dev)
        a_own = torch.zeros((m, br), device=dev)
        y_t = y_p[:, rs]
        for ci in range(nc):
            cs = slice(ci * bc, (ci + 1) * bc)
            xo, xn = own_p[:, rs, cs], nb_p[:, :, rs, cs]
            col = ci * bc + torch.arange(bc, dtype=torch.int32, device=dev)
            cvalid = col < c
            xo_m = torch.where(cvalid, xo, ninf)
            xn_m = torch.where(cvalid, xn, ninf)
            mo_new = torch.maximum(m_own, xo_m.amax(-1))
            co = torch.exp(m_own - mo_new)
            po = torch.exp(xo_m - mo_new[..., None])
            a_own = a_own * co + po.sum(-1)
            mn_new = torch.maximum(m_nb, xn_m.amax(-1))
            cn = torch.exp(m_nb - mn_new)
            a_nb = a_nb * cn + torch.exp(xn_m - mn_new[..., None]).sum(-1)
            b_x = (b_x * co[:, None]
                   + (po[:, None] * (xo[:, None] - xn)).sum(-1))
            match = col[None, None, :] == y_t[:, :, None]
            g_nb = g_nb + torch.where(match[:, None], xn, 0.0).sum(-1)
            m_own, m_nb = mo_new, mn_new
        lse_nb = m_nb + torch.log(a_nb)
        lse_own = m_own + torch.log(a_own)
        rvalid = (ri * br + torch.arange(br, device=dev)) < r
        l_acc = l_acc + torch.where(rvalid, lse_nb - g_nb, 0.0).sum(-1)
        kl_r = b_x / a_own[:, None] - lse_own[:, None] + lse_nb
        kl_acc = kl_acc + torch.where(rvalid, kl_r, 0.0).sum(-1)

    l_ij = l_acc / float(r)
    sel = sel_mask.to(torch.bool)
    valid = upper_half_mask(kl_acc / float(r), sel) if lsh_verification \
        else sel
    w = valid.to(torch.float32)
    denom = w.sum(-1).clamp(min=1.0)
    target = (torch.einsum("mn,mnrc->mrc", w, nb_p)
              / denom[:, None, None])[:, :r, :c]
    return l_ij, valid, target, w.sum(-1) > 0


NEG_INF = -1e30     # the masked score of the TPU kernel and the model


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float = 0.0) -> torch.Tensor:
    """Naive softmax attention, the function `flash_attention` computes:
    q (N, Sq, dh), k/v (N, Sk, dh) f32 or bf16 -> (N, Sq, dh) in q's
    dtype, computed in f32. `scale` 0 means dh**-0.5; the causal mask is
    aligned top-left (query i sees keys j <= i, both counted from 0) and
    a masked score is -1e30, as in `repro/kernels/ref.py`."""
    dh = q.shape[-1]
    scale = scale or dh ** -0.5
    s = torch.einsum("nqd,nkd->nqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        i = torch.arange(sq, device=s.device)[:, None]
        j = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(i < j, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nqk,nkd->nqd", p,
                        v.to(torch.float32)).to(q.dtype)
