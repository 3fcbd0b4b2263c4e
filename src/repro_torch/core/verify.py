"""Trust-free verification (WPFed §3.5, §3.6).
Counterpart of `repro/core/verify.py`.

§3.5: client i compares its own reference-set outputs with each
neighbour's outputs on the same set by KL divergence and drops the
neighbours in the lower half. The round runs this filter inside the
fused exchange (`core.exchange`); `lsh_verification_mask` here is its
plain semantic reference, and KD-PDFL's similarity (`core.baselines`)
uses `kl_divergence`. §3.6: the in-round commit check."""
from __future__ import annotations

import torch

from repro_torch.core.chain import fnv1a_commit


def kl_divergence(logits_p: torch.Tensor, logits_q: torch.Tensor,
                  axis: int = -1) -> torch.Tensor:
    """KL(softmax(p) || softmax(q)), summed over classes, mean over the
    batch (the last axis left)."""
    logp = torch.log_softmax(logits_p, dim=axis)
    logq = torch.log_softmax(logits_q, dim=axis)
    kl = (logp.exp() * (logp - logq)).sum(dim=axis)
    return kl.mean(dim=-1)


def lsh_verification_mask(own_logits: torch.Tensor,
                          neighbor_logits: torch.Tensor,
                          neighbor_mask: torch.Tensor) -> torch.Tensor:
    """§3.5 filter for one client. own (R, C), neighbours (N, R, C),
    neighbor_mask (N,) bool (selected slots) -> (N,) bool, True for the
    neighbours in the upper half by output similarity (the (n+1)//2
    smallest KLs of the n selected; ties by position). Unselected slots
    always fail."""
    kls = kl_divergence(own_logits[None], neighbor_logits)      # (N,)
    kls = torch.where(neighbor_mask, kls, torch.inf)
    keep = (neighbor_mask.sum() + 1) // 2
    order = torch.sort(kls, stable=True).indices
    rank_of = torch.argsort(order)
    return (rank_of < keep) & neighbor_mask


def verify_rankings_fnv(revealed: torch.Tensor, commitments: torch.Tensor,
                        salt: int = 0) -> torch.Tensor:
    """revealed (M, N) int32, commitments (M,) from last round -> (M,)
    bool reporter mask."""
    return fnv1a_commit(revealed, salt) == commitments
