"""LSH codes as an ANN index: sub-quadratic partner selection.
Counterpart of `repro/core/ann.py`.

The exact selection prices every pair, O(M^2 * bits) per round. The
published codes already encode proximity (Eq. 5-6), so they drive a
bucketed candidate index:

  1. Prefix bucketing: a per-round seeded permutation of the code's bit
     positions picks `prefix_bits` bits; clients sharing that prefix
     share a bucket (B = 2^prefix_bits buckets).
  2. Multi-probe: each client also probes the buckets reached by
     flipping one prefix bit at a time (up to `probes` flips).
  3. Score teaser: every candidate set also holds the global top
     `teaser_count` ranking scores, since a highly ranked client can
     out-weigh a near one in Eq. 8.

The exact Eq. 6-8 weights then run only on the (M, K) candidate sets
(`kernels.selection.fused_select_ann`). Buckets are a padded (B, cap)
table; overflow past `cap` is dropped from the candidate side only.
Invalid slots hold the sentinel id M. The permutation seed is the
round index, as for the LSH projection, so every peer can recompute the
bucketing from public information.

Plain tensor code on the codes' device, equal to the JAX package's
candidates exactly (ids, buckets, counts, dropped): the uint32 hash runs
in int64 through `ops.mul32`, and every sort is stable, as `jnp.argsort`
and `lax.top_k` break ties by the lower index. With `prefix_bits=0`
there is one bucket of capacity M, so the candidates are every client
in ascending id order and the ANN path equals the exact one bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ops import MASK32, mul32

# the counter-hash constants of the LSH projection
K1 = 2654435761
K2 = 40503
K3 = 2246822519

MAX_PREFIX_BITS = 16        # 2^16 buckets bounds the table


class AnnCandidates(NamedTuple):
    """The candidate layout of one round of ANN selection."""
    ids: torch.Tensor       # (M, K) int32 candidate ids; invalid = M
    bucket: torch.Tensor    # (M,) int32 bucket id per client
    counts: torch.Tensor    # (B,) int32 bucket occupancy (before the cap)
    dropped: torch.Tensor   # () int32 clients beyond cap (candidate side)


def effective_prefix_bits(prefix_bits: int, bits_tot: int) -> int:
    """At most the code's bits and MAX_PREFIX_BITS."""
    return max(0, min(prefix_bits, bits_tot, MAX_PREFIX_BITS))


def effective_probes(probes: int, prefix_bits: int) -> int:
    """Single-bit probes flip each prefix bit at most once."""
    return max(0, min(probes, prefix_bits))


def bucket_cap(m: int, prefix_bits: int, num_neighbors: int) -> int:
    """Per-bucket capacity: 4x the uniform occupancy, at least N+1, at
    most M (prefix_bits=0 gives M: the one-bucket exact fallback)."""
    n_buckets = 1 << effective_prefix_bits(prefix_bits, 1 << 30)
    uniform = -(-m // n_buckets)
    return min(m, max(num_neighbors + 1, 4 * uniform))


def teaser_count(m: int, num_neighbors: int) -> int:
    """Size of the global top-score candidate tile."""
    return min(m, max(2 * num_neighbors, 16))


def candidate_count(m: int, prefix_bits: int, probes: int,
                    num_neighbors: int, bits_tot: int = 1 << 30) -> int:
    """K: (probes + 1) bucket tiles of `cap` plus the score teaser."""
    pb = effective_prefix_bits(prefix_bits, bits_tot)
    np_ = effective_probes(probes, pb)
    return ((np_ + 1) * bucket_cap(m, pb, num_neighbors)
            + teaser_count(m, num_neighbors))


def prefix_bit_indices(bits_tot: int, prefix_bits: int, seed,
                       device=None) -> torch.Tensor:
    """Seeded permutation of the code's bit positions; the first
    `prefix_bits` form the bucket prefix. (prefix_bits,) int32; ties of
    the hash break by bit index (stable sort)."""
    i = torch.arange(bits_tot, dtype=torch.int64, device=device)
    sk = ((int(seed) & MASK32) * K3) & MASK32
    h = mul32(i, K1) ^ ((mul32(i, K2) + sk) & MASK32)
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    h = h ^ (h >> 13)
    order = torch.sort(h, stable=True).indices
    return order[:prefix_bits].to(torch.int32)


def bucket_ids(codes: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    """The prefix bits of packed codes (M, W) int32 -> (M,) int32 bucket
    ids in [0, 2^prefix_bits)."""
    m = codes.shape[0]
    pb = bit_idx.shape[0]
    if pb == 0:
        return torch.zeros((m,), dtype=torch.int32, device=codes.device)
    idx = bit_idx.to(torch.int64)
    words = codes.to(torch.int64)[:, idx // 32] & MASK32      # (M, pb)
    bits = (words >> (idx % 32)) & 1
    weights = 1 << torch.arange(pb, dtype=torch.int64, device=codes.device)
    return (bits * weights).sum(1).to(torch.int32)


def probe_masks(prefix_bits: int, probes: int, device=None) -> torch.Tensor:
    """XOR masks: the home bucket, then single-bit flips of prefix bit
    0, 1, ...; the probed buckets are pairwise distinct."""
    np_ = effective_probes(probes, prefix_bits)
    return torch.tensor([0] + [1 << t for t in range(np_)],
                        dtype=torch.int32, device=device)


def build_bucket_table(bucket: torch.Tensor, m: int, n_buckets: int,
                       cap: int):
    """Padded (B, cap) table of client ids per bucket, ids ascending
    within a bucket (stable sort). Returns (table (B, cap) int32 padded
    with M, counts (B,) int32 occupancy, rank (M,) int32 position of
    each client in its bucket; rank >= cap: dropped as a candidate)."""
    dev = bucket.device
    bucket = bucket.to(torch.int64)
    order = torch.sort(bucket, stable=True).indices
    sb = bucket[order]
    first = torch.searchsorted(sb, sb, right=False)
    rank_sorted = torch.arange(m, dtype=torch.int64, device=dev) - first
    slot = sb * cap + rank_sorted
    dump = n_buckets * cap                     # overflow goes here
    flat = torch.full((dump + 1,), m, dtype=torch.int64, device=dev)
    flat[torch.where(rank_sorted < cap, slot, dump)] = order
    table = flat[:-1].reshape(n_buckets, cap).to(torch.int32)
    counts = torch.bincount(bucket, minlength=n_buckets).to(torch.int32)
    rank = torch.zeros((m,), dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    return table, counts, rank.to(torch.int32)


def ann_candidates(codes: torch.Tensor, scores: torch.Tensor, *, seed,
                   prefix_bits: int, probes: int,
                   num_neighbors: int) -> AnnCandidates:
    """One round of candidate generation: seeded prefix buckets,
    multi-probe and the score teaser -> (M, K) candidate ids, sentinel M
    in every invalid slot (bucket padding, teaser duplicates). Valid ids
    in a row are pairwise distinct; self ids stay in (the selection
    masks them)."""
    m, w = codes.shape
    dev = codes.device
    pb = effective_prefix_bits(prefix_bits, w * 32)
    n_buckets = 1 << pb
    cap = bucket_cap(m, pb, num_neighbors)
    masks = probe_masks(pb, probes, device=dev)

    bit_idx = prefix_bit_indices(w * 32, pb, seed, device=dev)
    bucket = bucket_ids(codes, bit_idx)
    table, counts, rank = build_bucket_table(bucket, m, n_buckets, cap)

    probed = bucket[:, None] ^ masks[None, :]                # (M, P+1)
    cand = table[probed.to(torch.int64)].reshape(m, -1)      # (M, (P+1)cap)

    # the teaser: top scores, ties by the lower id as lax.top_k breaks them
    # (torch.topk promises no order; round-0 scores all tie)
    top_ids = torch.sort(scores.to(torch.float32), descending=True,
                         stable=True).indices[:teaser_count(m, num_neighbors)]
    tb = bucket[top_ids]                                     # (T,)
    in_probe = (tb[None, :, None] == probed[:, None, :]).any(-1)
    dup = in_probe & (rank[top_ids] < cap)[None, :]          # already in
    teaser = torch.where(dup, torch.tensor(m, dtype=torch.int32, device=dev),
                         top_ids.to(torch.int32)[None, :])
    ids = torch.cat([cand, teaser], dim=1)
    dropped = (counts - cap).clamp(min=0).sum().to(torch.int32)
    return AnnCandidates(ids, bucket, counts, dropped)


def occupancy_stats(c: AnnCandidates) -> dict:
    """Host-side candidate accounting: K, buckets, occupancy, drops."""
    counts = c.counts.cpu()
    nonempty = counts[counts > 0].to(torch.float64)
    return {
        "k": int(c.ids.shape[1]),
        "buckets": int(counts.numel()),
        "nonempty_buckets": int(nonempty.numel()),
        "mean_occupancy": round(float(nonempty.mean()), 2)
        if nonempty.numel() else 0.0,
        "max_occupancy": int(counts.max()) if counts.numel() else 0,
        "dropped_candidates": int(c.dropped),
    }
