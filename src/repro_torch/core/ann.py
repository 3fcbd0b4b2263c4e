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

The exact Eq. 6-8 weights then run only on the candidate sets: one
list per non-empty bucket (`bucket_candidates`, the route's
`kernels.selection.fused_select_ann_grouped`), or each client's row of
it, the (M, K) ids of `ann_candidates`
(`kernels.selection.fused_select_ann`, which runs the same kernel one
slot a row: `per_row_slots`). Buckets are a padded (B, cap)
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


class AnnBucketCandidates(NamedTuple):
    """`AnnCandidates` with one candidate list per non-empty bucket."""
    lists: torch.Tensor     # (S, K) int32 one list per slot; invalid = M
    bucket: torch.Tensor    # (M,) int32 bucket id per client
    slot: torch.Tensor      # (M,) int32 slot (list row) per client
    order: torch.Tensor     # (M,) int32 clients sorted stably by bucket
    starts: torch.Tensor    # (S+1,) int32 offsets of each slot's clients
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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on `device`; to a CUDA device through pinned
    memory, so the copy does not wait for the device's stream."""
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefix_bit_indices(bits_tot: int, prefix_bits: int, seed,
                       device=None) -> torch.Tensor:
    """Seeded permutation of the code's bit positions; the first
    `prefix_bits` form the bucket prefix. (prefix_bits,) int32; ties of
    the hash break by bit index (stable sort). Computed on the host (a
    function of the seed and the width alone) and copied to `device`."""
    i = torch.arange(bits_tot, dtype=torch.int64)
    sk = ((int(seed) & MASK32) * K3) & MASK32
    h = mul32(i, K1) ^ ((mul32(i, K2) + sk) & MASK32)
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    h = h ^ (h >> 13)
    order = torch.sort(h, stable=True).indices
    return to_device(order[:prefix_bits].to(torch.int32), device)


def bucket_ids(codes: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    """The prefix bits of packed codes (M, W) int32 -> (M,) int32 bucket
    ids in [0, 2^prefix_bits)."""
    m = codes.shape[0]
    pb = bit_idx.shape[0]
    if pb == 0:
        return torch.zeros((m,), dtype=torch.int32, device=codes.device)
    # int32 throughout: an arithmetic shift keeps bit b in place
    bits = (codes[:, bit_idx // 32] >> (bit_idx % 32)) & 1      # (M, pb)
    shifts = torch.arange(pb, dtype=torch.int32, device=codes.device)
    return (bits << shifts).sum(1, dtype=torch.int32)


def probe_masks(prefix_bits: int, probes: int, device=None) -> torch.Tensor:
    """XOR masks: the home bucket, then single-bit flips of prefix bit
    0, 1, ...; the probed buckets are pairwise distinct."""
    np_ = effective_probes(probes, prefix_bits)
    return to_device(torch.tensor([0] + [1 << t for t in range(np_)],
                                  dtype=torch.int32), device)


def build_bucket_table(bucket: torch.Tensor, m: int, n_buckets: int,
                       cap: int):
    """Padded (B, cap) table of client ids per bucket, ids ascending
    within a bucket (stable sort). Returns (table (B, cap) int32 padded
    with M, counts (B,) int32 occupancy, rank (M,) int32 position of
    each client in its bucket; rank >= cap: dropped as a candidate)."""
    return _bucket_table(bucket, m, n_buckets, cap)[:3]


def _bucket_table(bucket: torch.Tensor, m: int, n_buckets: int, cap: int):
    """`build_bucket_table`, and the clients sorted stably by bucket
    (int64). Sizes come from the arguments alone (counts by `index_add_`,
    not `bincount`, which reads the largest bucket back to the host)."""
    dev = bucket.device
    order = torch.sort(bucket, stable=True).indices
    sb = bucket[order]
    first = torch.searchsorted(sb, sb, right=False)
    rank_sorted = torch.arange(m, dtype=torch.int64, device=dev) - first
    slot = sb * cap + rank_sorted
    dump = n_buckets * cap                     # overflow goes here
    flat = torch.full((dump + 1,), m, dtype=torch.int64, device=dev)
    flat[torch.where(rank_sorted < cap, slot, dump)] = order
    table = flat[:-1].reshape(n_buckets, cap).to(torch.int32)
    counts = torch.zeros((n_buckets,), dtype=torch.int32,
                         device=dev).index_add_(0, bucket,
                                                torch.ones_like(bucket))
    rank = torch.zeros((m,), dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    return table, counts, rank.to(torch.int32), order


def ann_candidates(codes: torch.Tensor, scores: torch.Tensor, *, seed,
                   prefix_bits: int, probes: int,
                   num_neighbors: int) -> AnnCandidates:
    """One round of candidate generation: seeded prefix buckets,
    multi-probe and the score teaser -> (M, K) candidate ids, sentinel M
    in every invalid slot (bucket padding, teaser duplicates). Valid ids
    in a row are pairwise distinct; self ids stay in (the selection
    masks them). Each client's row of `bucket_candidates`' lists."""
    c = bucket_candidates(codes, scores, seed=seed, prefix_bits=prefix_bits,
                          probes=probes, num_neighbors=num_neighbors)
    return AnnCandidates(c.lists[c.slot.long()], c.bucket, c.counts,
                         c.dropped)


def bucket_candidates(codes: torch.Tensor, scores: torch.Tensor, *, seed,
                      prefix_bits: int, probes: int,
                      num_neighbors: int) -> AnnBucketCandidates:
    """The candidates of one round in per-bucket form. A client's
    candidate list depends only on its bucket (the probed buckets, the
    table rows they read, and the teaser's duplicate mask are functions
    of the bucket), so each non-empty bucket gets one list, and
    `lists[slot]` is `ann_candidates(...).ids`. The slots number the
    non-empty buckets in ascending bucket order; S = min(2^prefix_bits,
    M) rows, those past the count all sentinel M. Plain tensor code with
    every size taken from the arguments, so nothing waits for the device
    between the codes and the kernel."""
    m, w = codes.shape
    dev = codes.device
    pb = effective_prefix_bits(prefix_bits, w * 32)
    n_buckets = 1 << pb
    n_slots = min(n_buckets, m)
    cap = bucket_cap(m, pb, num_neighbors)
    masks = probe_masks(pb, probes, device=dev)

    bit_idx = prefix_bit_indices(w * 32, pb, seed, device=dev)
    bucket = bucket_ids(codes, bit_idx)
    table, counts, rank, order = _bucket_table(bucket, m, n_buckets, cap)

    # slot of each bucket (the non-empty ones before it), bucket of each slot
    nonempty = counts > 0
    slot_of = torch.cumsum(nonempty, 0) - 1                   # (B,) int64
    idx = torch.arange(n_buckets, dtype=torch.int64, device=dev)
    slot_bucket = torch.zeros((n_slots + 1,), dtype=torch.int64, device=dev)
    slot_bucket[torch.where(nonempty, slot_of, n_slots)] = idx
    slot_bucket = slot_bucket[:n_slots]
    live = torch.arange(n_slots, device=dev) <= slot_of[-1]   # (S,)

    probed = slot_bucket[:, None] ^ masks[None, :]
    body = table[probed].reshape(n_slots, -1)                 # (S, (P+1)cap)
    # the teaser: top scores, ties by the lower id as lax.top_k breaks them
    # (torch.topk promises no order; round-0 scores all tie); a client
    # already in a probed bucket's table row is a sentinel
    top_ids = torch.sort(scores.to(torch.float32), descending=True,
                         stable=True).indices[:teaser_count(m, num_neighbors)]
    tb = bucket[top_ids].to(torch.int64)                      # (T,)
    in_probe = (tb[None, :, None] == probed[:, None, :]).any(-1)
    dup = in_probe & (rank[top_ids] < cap)[None, :]
    teaser = torch.where(dup, m, top_ids.to(torch.int32)[None, :])
    lists = torch.where(live[:, None], torch.cat([body, teaser], dim=1), m)
    per_slot = torch.where(live, counts[slot_bucket], 0)
    starts = torch.cat([per_slot.new_zeros((1,)), torch.cumsum(per_slot, 0)])
    dropped = (counts - cap).clamp(min=0).sum().to(torch.int32)
    return AnnBucketCandidates(
        lists, bucket, slot_of[bucket].to(torch.int32),
        order.to(torch.int32), starts.to(torch.int32), counts, dropped)


def per_row_slots(cand_ids: torch.Tensor, m: int) -> AnnBucketCandidates:
    """Arbitrary (M, K) per-row candidate ids (sentinel M) in per-bucket
    form, one slot a row: `lists` is `cand_ids` itself (no copy), client
    i alone in slot i (`slot = order = arange(M)`, `starts =
    arange(M + 1)`), as if each row were a bucket of its own (`bucket =
    arange(M)`, `counts` ones, nothing dropped). So `lists[slot]` is
    `cand_ids`, and the grouped kernel and its plain version run the
    per-row contract. Every size comes from the arguments, so nothing is
    read back from the device."""
    dev = cand_ids.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    return AnnBucketCandidates(
        cand_ids, idx, idx, idx,
        torch.arange(m + 1, dtype=torch.int32, device=dev),
        torch.ones((m,), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))


def occupancy_stats(c: AnnCandidates) -> dict:
    """Host-side candidate accounting: K, buckets, occupancy, drops."""
    counts = c.counts.tolist()  # analysis: host-ok occupancy report
    dropped = c.dropped.item()  # analysis: host-ok occupancy report
    nonempty = [n for n in counts if n > 0]
    return {
        "k": int(c.ids.shape[1]),
        "buckets": len(counts),
        "nonempty_buckets": len(nonempty),
        "mean_occupancy": round(sum(nonempty) / len(nonempty), 2)
        if nonempty else 0.0,
        "max_occupancy": max(counts) if counts else 0,
        "dropped_candidates": dropped,
    }
