"""The phases of one WPFed round (Algorithm 1), plainly.

  select    §3.6 reveal check (FNV-1a commitments), Eq. 7 scores, Eq. 8
            weights s_j * exp(-gamma d_ij / b) over every pair or over the
            LSH-bucket candidates, top-N with ascending-id ties
  exchange  reference-set forwards, Eq. 3 losses l_ij, the §3.5 filter
            (the lower-KL half of the selected), distillation targets
  update    local Adam steps on alpha * CE + (1 - alpha) * MSE-to-target
  announce  Eq. 5 codes (sign of a +-1 projection, the sums in f64),
            rankings by ascending l_ij, commitments

The random streams, the +-1 projection matrix and the bucket
permutation are functions of the federation seed and the round index,
so they are written out here as the protocol defines them (splitmix64
mixing, the multiplicative counter hash). Frozen from the port's plain
versions (`kernels/ref.py`, `core/ann.py`, `core/ranking.py`,
`core/distill.py`, `optim/optimizers.py`), with the client models of
`reference/models.py`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from portbench.reference import models

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
K1, K2, K3 = 2654435761, 40503, 2246822519
CHUNK = 2048            # the flattened parameter vector's padding
UPDATE_STREAM = 1
ANN_AUTO_MIN_M, ANN_AUTO_MIN_RATIO = 4096, 4.0
MAX_PREFIX_BITS = 16
PROJ_ROWS = 65536


# ---------------------------------------------------------------------------
# seeds, hashes, bits
# ---------------------------------------------------------------------------
def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def round_generator(seed: int, round_idx: int, stream: int) -> torch.Generator:
    """The CPU generator of one (seed, round, stream): the parts mixed by
    splitmix64 steps, the high 32 bits as the seed."""
    h = 0
    for part in (seed, round_idx, stream):
        h = _splitmix64(h ^ (part & MASK64))
    g = torch.Generator()
    g.manual_seed(h >> 32)
    return g


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Bits set in uint32 patterns held in int32/int64 -> int64."""
    v = v.to(torch.int64) & MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return mul32(v, 0x01010101) >> 24


def fnv1a(rankings: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """FNV-1a over the 4 little-endian bytes of each ranking entry,
    uint32 wraparound: (M, N) -> (M,) int64 in [0, 2^32)."""
    r = rankings.to(torch.int64) & MASK32
    h = torch.full(r.shape[:-1], 2166136261 ^ (salt & MASK32),
                   dtype=torch.int64, device=r.device)
    for idx in range(r.shape[-1]):
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((r[..., idx] >> shift) & 0xFF)) * 16777619) & MASK32
    return h


def rademacher(i0: int, rows: int, bits: int, seed: int, device):
    """Rows i0 .. i0+rows of the +-1 Eq. 5 matrix: bit j of parameter i
    is bit 9 of h = (i*K1) ^ (j*K2 + seed*K3), h ^= h >> 15, h *= K3,
    h ^= h >> 13 (uint32)."""
    i = (torch.arange(rows, dtype=torch.int64, device=device) + i0) & MASK32
    j = torch.arange(bits, dtype=torch.int64, device=device)
    cj = (j * K2 + ((int(seed) & MASK32) * K3 & MASK32)) & MASK32
    h = mul32(i, K1)[:, None] ^ cj[None, :]
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    h = h ^ (h >> 13)
    return 1.0 - 2.0 * ((h >> 9) & 1).to(torch.float64)


def leaf_key(name: str):
    return tuple(int(s) if s.isdigit() else s for s in name.split("."))


def flatten(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{name: (M, ...)} -> (M, P) f64, leaves sorted by `leaf_key` (the
    JAX tree order), P padded with zeros to a CHUNK multiple."""
    names = sorted(params, key=leaf_key)
    m = params[names[0]].shape[0]
    flat = torch.cat([params[k].reshape(m, -1).to(torch.float64)
                      for k in names], 1)
    return torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % CHUNK))


def lsh_sums(params: Dict[str, torch.Tensor], seed: int, bits: int):
    """Eq. 5 projection sums (M, bits) in f64 and each client's parameter
    norm (M,) f64."""
    x = flatten(params)
    out = torch.zeros((x.shape[0], bits), dtype=torch.float64,
                      device=x.device)
    for p0 in range(0, x.shape[1], PROJ_ROWS):
        n = min(PROJ_ROWS, x.shape[1] - p0)
        out += x[:, p0:p0 + n] @ rademacher(p0, n, bits, seed, x.device)
    return out, x.norm(dim=1)


def unpack(codes: torch.Tensor) -> torch.Tensor:
    """(M, W) int32 -> (M, W*32) bool."""
    v = codes.to(torch.int64) & MASK32
    return (((v[..., None] >> torch.arange(32, device=v.device)) & 1) > 0
            ).reshape(codes.shape[0], -1)


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------
def dedupe_reporters(rankings: torch.Tensor, reporter: torch.Tensor):
    """Keep the first reporter of each distinct ranking vector."""
    m = rankings.shape[0]
    keep = reporter.clone()
    idx = torch.arange(m, device=rankings.device)
    for r0 in range(0, m, 512):
        same = (rankings[r0:r0 + 512, None, :] == rankings[None]).all(-1)
        earlier = idx[None, :] < idx[r0:r0 + 512, None]
        keep[r0:r0 + 512] &= ~(same & earlier & reporter[None]).any(1)
    return keep


def ranking_scores(rankings, reporter, m: int, top_k: int, dedupe: bool):
    """Eq. 7: s_j = #{reporters with j in their top K} / #{with j at
    all}, 0 for clients never ranked. f32 counts (exact integers). The
    rankings of non-reporters count as empty, and with `dedupe` only the
    first of equal ranking vectors (after that masking) counts."""
    r = torch.where(reporter[:, None], rankings, -1).to(torch.int64)
    if dedupe:
        keep = dedupe_reporters(r, torch.ones_like(reporter))
        r = torch.where(keep[:, None], r, -1)
    ok = r >= 0
    ids = torch.where(ok, r, 0)
    appears = torch.zeros((m,), dtype=torch.float32, device=r.device)
    appears.index_add_(0, ids[ok], torch.ones_like(ids[ok],
                                                   dtype=torch.float32))
    top = ok[:, :top_k]
    in_top = torch.zeros((m,), dtype=torch.float32, device=r.device)
    in_top.index_add_(0, ids[:, :top_k][top],
                      torch.ones_like(ids[:, :top_k][top],
                                      dtype=torch.float32))
    return in_top / appears.clamp(min=1.0)


def lut(bits_tot: int, bits: int, gamma: float, device) -> torch.Tensor:
    """exp(-gamma d / bits) for d = 0 .. bits_tot, built in f32 on the CPU."""
    d = torch.arange(bits_tot + 1, dtype=torch.float32)
    return torch.exp(-gamma * (d / float(bits))).to(device)


def _top_n(w: torch.Tensor, cand: torch.Tensor, n: int):
    tw, pos = torch.sort(w, dim=1, descending=True, stable=True)
    return torch.gather(cand, 1, pos[:, :n]), tw[:, :n]


def select_exact(codes, scores, table, n: int, rows: int = 512):
    """Eq. 8 over every pair, self at -inf, top-N ascending-id ties."""
    m = codes.shape[0]
    ids, tw = [], []
    cols = torch.arange(m, device=codes.device)
    for r0 in range(0, m, rows):
        r = torch.arange(r0, min(r0 + rows, m), device=codes.device)
        d = popcount(codes[r][:, None, :] ^ codes[None]).sum(-1)
        w = scores[None, :] * table[d]
        w = torch.where(r[:, None] == cols[None], -torch.inf, w)
        i, t = _top_n(w, cols.expand(len(r), -1), n)
        ids.append(i)
        tw.append(t)
    return torch.cat(ids).to(torch.int32), torch.cat(tw)


def ann_route(m: int, bits_tot: int, prefix_bits: int, probes: int,
              n: int) -> bool:
    """The protocol's rule for "auto": the candidate index from
    ANN_AUTO_MIN_M clients on, where exact Eq. 8 costs at least
    ANN_AUTO_MIN_RATIO times the candidates' (2 M^2 b against 2 M K b)."""
    k = candidate_count(m, prefix_bits, probes, n, bits_tot)
    return m >= ANN_AUTO_MIN_M and m * m >= ANN_AUTO_MIN_RATIO * m * k


def _eff_prefix(prefix_bits: int, bits_tot: int) -> int:
    return max(0, min(prefix_bits, bits_tot, MAX_PREFIX_BITS))


def bucket_cap(m: int, pb: int, n: int) -> int:
    return min(m, max(n + 1, 4 * (-(-m // (1 << pb)))))


def teaser_count(m: int, n: int) -> int:
    return min(m, max(2 * n, 16))


def candidate_count(m, prefix_bits, probes, n, bits_tot) -> int:
    pb = _eff_prefix(prefix_bits, bits_tot)
    return ((max(0, min(probes, pb)) + 1) * bucket_cap(m, pb, n)
            + teaser_count(m, n))


def ann_candidates(codes, scores, round_idx: int, prefix_bits: int,
                   probes: int, n: int) -> torch.Tensor:
    """(M, K) candidate ids (sentinel M): the home bucket of a seeded
    `prefix_bits`-bit prefix, single-bit-flip probes, then the global
    top scores (ties to the lower id) not already in a probed bucket's
    row. Buckets hold at most `bucket_cap` clients, ascending id."""
    m, w = codes.shape
    dev = codes.device
    pb = _eff_prefix(prefix_bits, w * 32)
    cap = bucket_cap(m, pb, n)
    # the prefix: a seeded permutation of the bit positions (host, stable)
    i = torch.arange(w * 32, dtype=torch.int64)
    sk = ((int(round_idx) & MASK32) * K3) & MASK32
    h = mul32(i, K1) ^ ((mul32(i, K2) + sk) & MASK32)
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    h = h ^ (h >> 13)
    bit_idx = torch.sort(h, stable=True).indices[:pb].to(dev)
    bits = unpack(codes)[:, bit_idx].to(torch.int64)         # (M, pb)
    bucket = (bits << torch.arange(pb, device=dev)).sum(1)
    # the table: each bucket's first `cap` clients by id
    order = torch.sort(bucket, stable=True).indices
    sb = bucket[order]
    rank_sorted = torch.arange(m, device=dev) - torch.searchsorted(sb, sb)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    table = torch.full(((1 << pb) * cap + 1,), m, dtype=torch.int64,
                       device=dev)
    table[torch.where(rank_sorted < cap, sb * cap + rank_sorted,
                      (1 << pb) * cap)] = order
    table = table[:-1].reshape(1 << pb, cap)
    masks = torch.tensor([0] + [1 << t for t in range(min(probes, pb))],
                         device=dev)
    probed = bucket[:, None] ^ masks[None]                    # (M, P+1)
    body = table[probed].reshape(m, -1)
    top = torch.sort(scores, descending=True,
                     stable=True).indices[:teaser_count(m, n)]
    in_probe = (bucket[top][None, :, None] == probed[:, None, :]).any(-1)
    dup = in_probe & (rank[top] < cap)[None]
    return torch.cat([body, torch.where(dup, m, top[None])], 1)


def select_ann(codes, scores, table, n: int, cand: torch.Tensor,
               rows: int = 1024):
    """Eq. 8 on the candidates only; self and the sentinel at -inf;
    ties by candidate position; an empty slot takes id 0."""
    m = codes.shape[0]
    codes_pad = torch.cat([codes, codes.new_zeros((1, codes.shape[1]))])
    scores_pad = torch.cat([scores, scores.new_zeros((1,))])
    ids, tw = [], []
    for r0 in range(0, m, rows):
        c = cand[r0:r0 + rows]
        r = torch.arange(r0, r0 + c.shape[0], device=codes.device)[:, None]
        d = popcount(codes[r0:r0 + rows, None, :] ^ codes_pad[c]).sum(-1)
        w = scores_pad[c] * table[d]
        w = torch.where((c == r) | (c >= m), -torch.inf, w)
        i, t = _top_n(w, c, n)
        ids.append(torch.where(torch.isfinite(t), i, 0))
        tw.append(t)
    return torch.cat(ids).to(torch.int32), torch.cat(tw)


# ---------------------------------------------------------------------------
# exchange
# ---------------------------------------------------------------------------
class Exchange(NamedTuple):
    l_ij: torch.Tensor     # (M, N) f32 Eq. 3 CE of neighbour j on X_i^ref
    kl: torch.Tensor       # (M, N) f32 mean KL(own || neighbour)
    web: torch.Tensor      # (M, N, R, C) neighbour logits on X_i^ref


def gather_params(params, ids: torch.Tensor):
    return {k: v[ids] for k, v in params.items()}


@torch.no_grad()
def exchange(kind: str, params, data, ids: torch.Tensor, ref_mode: str,
             rows: int) -> Exchange:
    """Own and neighbour logits on the reference sets, `rows` clients'
    web at a time (personal: neighbour ids[i, s] on client i's set;
    public: every client on client 0's set, then a gather)."""
    m, n = ids.shape
    ids = ids.to(torch.int64)
    if ref_mode == "public":
        x0 = data["x_ref"][0]
        own = torch.cat([models.forward(
            kind, {k: v[c:c + rows] for k, v in params.items()},
            x0.expand(min(rows, m - c), *x0.shape))
            for c in range(0, m, rows)])
        web = own[ids]
        y = data["y_ref"][0].expand(m, -1)
    else:
        own, web = [], []
        for c in range(0, m, rows):
            part = {k: v[c:c + rows] for k, v in params.items()}
            x = data["x_ref"][c:c + rows]
            g = x.shape[0]
            own.append(models.forward(kind, part, x))
            nb = gather_params(params, ids[c:c + rows].reshape(-1))
            xs = x[:, None].expand(g, n, *x.shape[1:]).reshape(
                g * n, *x.shape[1:])
            web.append(models.forward(kind, nb, xs).reshape(
                g, n, *own[-1].shape[1:]))
        own, web = torch.cat(own), torch.cat(web)
        y = data["y_ref"]
    logp_nb = torch.log_softmax(web, -1)
    lab = y.to(torch.int64)[:, None, :, None].expand(-1, n, -1, 1)
    l_ij = -torch.gather(logp_nb, -1, lab)[..., 0].mean(-1)
    logp_own = torch.log_softmax(own, -1)[:, None]
    kl = (logp_own.exp() * (logp_own - logp_nb)).sum(-1).mean(-1)
    return Exchange(l_ij, kl, web)


def upper_half(kl: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """§3.5: of the selected slots, the (n + 1) // 2 smallest KLs (ties
    by slot)."""
    keyed = torch.where(sel, kl, torch.inf)
    keep = (sel.sum(-1, keepdim=True) + 1) // 2
    rank_of = torch.argsort(torch.argsort(keyed, -1, stable=True), -1)
    return (rank_of < keep) & sel


def targets(web: torch.Tensor, valid: torch.Tensor):
    """Mean of the valid neighbours' logits (M, R, C) and has_target."""
    w = valid.to(torch.float32)
    t = torch.einsum("mn,mnrc->mrc", w, web) / w.sum(-1).clamp(
        min=1.0)[:, None, None]
    return t, w.sum(-1) > 0


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------
def _ce(logits, labels):
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[
        ..., 0].mean(-1)


def local_update(kind: str, proto: Dict, params, m_state, v_state,
                 step: int, x_train, y_train, x_ref, target, has_target,
                 batch_idx: torch.Tensor, rows: int):
    """`local_steps` Adam steps per client (f32 moments, eps after the
    square root of the bias-corrected v) on alpha * CE(minibatch) +
    (1 - alpha) * mean((f(X_ref) - target)^2) (0 without a target),
    `rows` clients at a time; each client's loss depends on its own
    params alone, so one backward of the sum gives every gradient.
    Returns new params, m, v and the last step's (loss, CE, MSE) (M, 3)."""
    alpha, lr = proto["alpha"], proto["lr"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = x_train.shape[0]
    out_p = {k: torch.empty_like(v) for k, v in params.items()}
    out_m = {k: torch.empty_like(v) for k, v in m_state.items()}
    out_v = {k: torch.empty_like(v) for k, v in v_state.items()}
    losses = torch.empty((m, 3), device=x_train.device)
    for c0 in range(0, m, rows):
        sl = slice(c0, c0 + rows)
        p = {k: v[sl].clone() for k, v in params.items()}
        mo = {k: v[sl].clone() for k, v in m_state.items()}
        vo = {k: v[sl].clone() for k, v in v_state.items()}
        g = p[next(iter(p))].shape[0]
        gi = torch.arange(g, device=x_train.device)[:, None]
        for s in range(proto["local_steps"]):
            idx = batch_idx[sl, s]
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            l_loc = _ce(models.forward(kind, leaves, x_train[sl][gi, idx]),
                        y_train[sl][gi, idx])
            own = models.forward(kind, leaves, x_ref[sl])
            l_ref = torch.square(own - target[sl]).mean((-2, -1))
            l_ref = torch.where(has_target[sl], l_ref, torch.zeros_like(l_ref))
            loss = alpha * l_loc + (1 - alpha) * l_ref
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
            t = torch.tensor(float(step + s + 1), device=x_train.device)
            c1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
            c2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
            with torch.no_grad():
                for (k, w), gr in zip(leaves.items(), grads):
                    mo[k] = b1 * mo[k] + (1 - b1) * gr
                    vo[k] = b2 * vo[k] + (1 - b2) * gr * gr
                    u = lr * (mo[k] / c1) / (torch.sqrt(vo[k] / c2) + eps)
                    p[k] = w.detach() - u
        for k in p:
            out_p[k][sl], out_m[k][sl], out_v[k][sl] = p[k], mo[k], vo[k]
        losses[sl] = torch.stack([loss, l_loc, l_ref], 1).detach()
    return out_p, out_m, out_v, losses


def draw_batches(seed: int, round_idx: int, m: int, steps: int, n_local: int,
                 mb: int) -> torch.Tensor:
    """The round's minibatch indices (M, steps, mb), one CPU draw."""
    return torch.randint(0, n_local, (m, steps, mb),
                         generator=round_generator(seed, round_idx,
                                                   UPDATE_STREAM))


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.to(torch.float64).norm()) for k, v in tree.items()}


def slot_of(ids: torch.Tensor, ranking: torch.Tensor) -> torch.Tensor:
    """For each ranking entry, the slot of `ids` that holds it (-1 for a
    -1 entry or an id not in the row)."""
    hit = ranking.to(torch.int64)[:, :, None] == ids.to(torch.int64)[:, None]
    hit &= (ranking >= 0)[:, :, None]
    return torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1), -1)

