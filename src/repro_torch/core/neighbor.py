"""Personalized neighbour selection (WPFed §3.4, Eq. 6-8).
Counterpart of `repro/core/neighbor.py`.

`select_partners` is the protocol's entry point: published LSH codes +
crowd-sourced ranking scores -> per-client top-N partner ids, through the
fused selection kernels ("kernel") or their plain versions ("oracle"),
one-shot or column-tiled as `backends.resolve_tiling` decides from the
one-shot kernel's shared memory (the tiled kernel is bit-equal to it).
Table-3 ablations:
  use_lsh=False  -> w_ij = s_j            ("w/o LSH")
  use_rank=False -> w_ij = exp(-gamma d)  ("w/o Rank")
  both False     -> uniform random selection ("w/o LSH & Rank"), drawn
                    from a torch.Generator, never through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import backends
from repro_torch.kernels import ref, selection


def select_neighbors(weights: torch.Tensor, num_neighbors: int):
    """Top-N per row with ascending-id ties. (M, M) -> ids (M, N) int32,
    mask (M, N) bool (finite weights)."""
    n = min(num_neighbors, weights.shape[1] - 1)
    top_w, top_i = torch.sort(weights, dim=1, descending=True, stable=True)
    return top_i[:, :n].to(torch.int32), torch.isfinite(top_w[:, :n])


def select_partners(codes: torch.Tensor, scores: torch.Tensor, fed, *,
                    generator: torch.Generator = None, backend: str = None,
                    tiling: str = None):
    """Eq. 6-8 + top-N: codes (M, W) int32, scores (M,) f32 -> (ids
    (M, N) int32, sel_mask (M, N) bool). `generator` is consumed only by
    the random ablation (use_lsh=False, use_rank=False). `backend` /
    `tiling` override fed.selection_backend / fed.selection_tiling."""
    m = codes.shape[0]
    n = min(fed.num_neighbors, m - 1)
    if not fed.use_lsh and not fed.use_rank:
        if generator is None:
            raise ValueError("random selection needs a torch.Generator")
        w = torch.rand((m, m), generator=generator).to(codes.device)
        w = torch.where(torch.eye(m, dtype=torch.bool, device=codes.device),
                        torch.tensor(-torch.inf, device=codes.device), w)
        return select_neighbors(w, n)
    resolved = backends.resolve(backend or fed.selection_backend,
                                codes.device)
    tiled = backends.resolve_tiling(
        tiling or fed.selection_tiling,
        backends.selection_oneshot_smem_bytes(m)) == "tiled"
    kw = dict(num_neighbors=n, use_lsh=fed.use_lsh, use_rank=fed.use_rank)
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
