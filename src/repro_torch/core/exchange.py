"""All-in-one reference-set exchange (WPFed Eq. 3 + §3.5 + Alg. 1's
distillation target). Counterpart of `repro/core/exchange.py`.

One exchange of reference-set logits (1) transfers knowledge (the
distillation target), (2) evaluates model quality (the per-neighbour CE
losses behind the Eq. 7 rankings) and (3) verifies similarity (§3.5's
output-KL upper-half filter), through the fused exchange kernels
("kernel") or their plain versions ("oracle"), one-shot or streamed as
`backends.resolve_tiling` decides from the one-shot kernel's shared
memory (the streamed path agrees with the one-shot one within f32
rounding; the mask flips only on exact KL ties).

The unfused pieces (`distill.cross_entropy`,
`verify.lsh_verification_mask`, `distill.aggregate_neighbor_outputs`)
are the semantic reference the fused paths are held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.privacy import declassifier
from repro_torch.core import backends
from repro_torch.kernels import exchange, ref


@declassifier(
    name="public-ref-logits", paper_eq="Eq. 2-3 (§3.1 logit exchange)",
    justification=("the paper's designated exchange artifact: neighbor "
                   "outputs on the (public or mutually shared) reference "
                   "set — the knowledge-transfer channel the protocol "
                   "defines as releasable in place of raw parameters"))
def public_ref_logits(neighbor_logits: torch.Tensor) -> torch.Tensor:
    """The (M, N, R, C) neighbour-logit web as the exchanged artifact:
    the identity at runtime. `protocol.exchange_phase` routes every web
    through it, so the taint check (`repro_torch.analysis.taint`) treats
    the gathered logits as disclosed by design and checks the rest of
    the round downstream of this one sanctioned release."""
    return neighbor_logits


class ExchangeResult(NamedTuple):
    """Everything one reference-set exchange yields, for all M clients."""
    l_ij: torch.Tensor        # (M, N) f32 — Eq. 3 CE of neighbour j on X_i^ref
    valid_mask: torch.Tensor  # (M, N) bool — §3.5 survivors
    target_ref: torch.Tensor  # (M, R, C) f32 — mean of valid neighbour logits
    has_target: torch.Tensor  # (M,) bool — any neighbour passed


def all_in_one_exchange(own_logits, neighbor_logits, y_ref, sel_mask, fed,
                        *, backend: str = None,
                        tiling: str = None) -> ExchangeResult:
    """own (M, R, C), neighbour (M, N, R, C), y_ref (M, R) int labels,
    sel_mask (M, N) bool; fed supplies lsh_verification,
    exchange_backend and exchange_tiling (overridden by `backend` /
    `tiling`). With lsh_verification off, valid_mask == sel_mask."""
    m, n = sel_mask.shape
    dev = own_logits.device
    if n == 0:                         # degenerate M <= 1 federation
        r, c = own_logits.shape[-2:]
        return ExchangeResult(
            torch.zeros((m, 0), device=dev),
            torch.zeros((m, 0), dtype=torch.bool, device=dev),
            torch.zeros((m, r, c), device=dev),
            torch.zeros((m,), dtype=torch.bool, device=dev))
    r = neighbor_logits.shape[2]
    resolved = backends.resolve(backend or fed.exchange_backend, dev)
    tiled = backends.resolve_tiling(
        tiling or fed.exchange_tiling,
        backends.exchange_oneshot_smem_bytes(n, r)) == "tiled"
    if resolved == "kernel":
        fn = (exchange.fused_exchange_streamed if tiled
              else exchange.fused_exchange)
    else:
        fn = (ref.streamed_exchange_ref if tiled
              else ref.all_in_one_exchange_ref)
    return ExchangeResult(*fn(own_logits, neighbor_logits, y_ref, sel_mask,
                              lsh_verification=fed.lsh_verification))
