"""Personalized neighbour selection (WPFed §3.4, Eq. 6-8).
Counterpart of `repro/core/neighbor.py`.

`select_partners` is the protocol's entry point: published LSH codes +
crowd-sourced ranking scores -> per-client top-N partner ids, through the
fused selection kernels ("kernel") or their plain versions ("oracle"),
one-shot or column-tiled as `backends.resolve_tiling` decides from the
one-shot kernel's shared memory (the tiled kernel is bit-equal to it),
or through the LSH-bucket candidate index ("ann", `core/ann.py`), which
`backends.resolve_selection` also picks for "auto" in large federations.
The unfused pieces (`selection_weights`, `select_neighbors`) stay the
semantic reference of the fused paths.
Table-3 ablations:
  use_lsh=False  -> w_ij = s_j            ("w/o LSH")
  use_rank=False -> w_ij = exp(-gamma d)  ("w/o Rank")
  both False     -> uniform random selection ("w/o LSH & Rank"), drawn
                    from a torch.Generator, never through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ann, backends
from repro_torch.kernels import ref, selection


def selection_weights(scores: torch.Tensor, dist_norm: torch.Tensor,
                      gamma: float, *, use_lsh: bool = True,
                      use_rank: bool = True,
                      generator: torch.Generator = None) -> torch.Tensor:
    """Eq. 8 unfused: scores (M,) f32, dist_norm (M, M) f32 in [0, 1] ->
    (M, M) f32, self at -inf. With both switches off the weights are
    uniform draws from `generator` (on its device, then moved)."""
    m = dist_norm.shape[0]
    dev = dist_norm.device
    if use_rank:
        w = scores.to(torch.float32)[None, :].expand(m, m)
    else:
        w = torch.ones((m, m), device=dev)
    if use_lsh:
        w = w * torch.exp(-gamma * dist_norm)
    if not use_rank and not use_lsh:
        if generator is None:
            raise ValueError("random selection needs a torch.Generator")
        w = torch.rand((m, m), generator=generator).to(dev)
    return torch.where(torch.eye(m, dtype=torch.bool, device=dev),
                       torch.tensor(-torch.inf, device=dev), w)


def select_neighbors(weights: torch.Tensor, num_neighbors: int):
    """Top-N per row with ascending-id ties. (M, M) -> ids (M, N) int32,
    mask (M, N) bool (finite weights)."""
    n = min(num_neighbors, weights.shape[1] - 1)
    top_w, top_i = torch.sort(weights, dim=1, descending=True, stable=True)
    return top_i[:, :n].to(torch.int32), torch.isfinite(top_w[:, :n])


def select_partners(codes: torch.Tensor, scores: torch.Tensor, fed, *,
                    generator: torch.Generator = None, backend: str = None,
                    tiling: str = None, seed: int = 0):
    """Eq. 6-8 + top-N: codes (M, W) int32, scores (M,) f32 -> (ids
    (M, N) int32, sel_mask (M, N) bool). `generator` is consumed only by
    the random ablation (use_lsh=False, use_rank=False). `backend` /
    `tiling` override fed.selection_backend / fed.selection_tiling.
    `seed` (the round index, from `protocol.select_phase`) seeds the ANN
    bucket permutation; the exact paths ignore it."""
    m = codes.shape[0]
    n = min(fed.num_neighbors, m - 1)
    if not fed.use_lsh and not fed.use_rank:
        w = selection_weights(scores, torch.zeros((m, m), device=codes.device),
                              fed.gamma, use_lsh=False, use_rank=False,
                              generator=generator)
        return select_neighbors(w, n)
    bits_tot = codes.shape[1] * 32
    k = ann.candidate_count(m, fed.ann_prefix_bits, fed.ann_probes, n,
                            bits_tot)
    resolved = backends.resolve_selection(
        backend or fed.selection_backend, m,
        exact_flops=backends.selection_flops(m, bits_tot),
        ann_flops=backends.ann_selection_flops(m, bits_tot, k),
        device=codes.device)
    kw = dict(num_neighbors=n, use_lsh=fed.use_lsh, use_rank=fed.use_rank)
    if resolved == "ann":
        # the tiling string stays validated; the ANN kernel has one layout
        backends.resolve_tiling(tiling or fed.selection_tiling, 0)
        cand = ann.ann_candidates(codes, scores, seed=seed,
                                  prefix_bits=fed.ann_prefix_bits,
                                  probes=fed.ann_probes, num_neighbors=n)
        ids, top_w = selection.fused_select_ann(
            codes, scores, cand.ids, bits=fed.lsh_bits, gamma=fed.gamma,
            **kw)
        return ids, torch.isfinite(top_w)
    tiled = backends.resolve_tiling(
        tiling or fed.selection_tiling,
        backends.selection_oneshot_smem_bytes(m)) == "tiled"
    if resolved == "kernel":
        fn = selection.fused_select_tiled if tiled else selection.fused_select
        ids, top_w = fn(codes, scores, bits=fed.lsh_bits, gamma=fed.gamma,
                        **kw)
    else:
        lut = ref.selection_lut(codes.shape[1], fed.lsh_bits, fed.gamma,
                                device=codes.device)
        fn = ref.fused_select_tiled_ref if tiled else ref.fused_select_ref
        ids, top_w = fn(codes, scores, lut, **kw)
    return ids, torch.isfinite(top_w)
