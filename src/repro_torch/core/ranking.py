"""Performance rankings and crowd-sourced ranking scores (WPFed §3.3).
Counterpart of `repro/core/ranking.py`, batched over the client axis.

R_i ranks client i's neighbours by ascending distillation loss l_ij; the
Eq. 7 score is s_j = |{R_k : j in top-K of R_k}| / |{R_k : j in R_k}|.
Rankings are (M, N) int32 id vectors padded with -1.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.privacy import declassifier


@declassifier(
    name="rank-reveal", paper_eq="R_i (§3.3, revealed per §3.6)",
    justification="the revealed ranking is an ORDER over public "
                  "neighbor ids — the underlying distillation losses "
                  "are discarded, only their argsort is disclosed")
def make_ranking(neighbor_ids: torch.Tensor, losses: torch.Tensor,
                 valid_mask: torch.Tensor = None) -> torch.Tensor:
    """Sort each row's ids by ascending loss: (..., N) -> (..., N) int32,
    entries outside `valid_mask` sink to the end as -1. The sort is
    stable, as `jnp.argsort` is, so equal losses keep slot order."""
    losses = losses.to(torch.float32)
    if valid_mask is None:
        valid_mask = torch.ones_like(losses, dtype=torch.bool)
    keyed = torch.where(valid_mask, losses,
                        torch.tensor(torch.inf, device=losses.device))
    order = torch.argsort(keyed, dim=-1, stable=True)
    ranked = torch.gather(neighbor_ids, -1, order)
    ok = torch.gather(valid_mask, -1, order)
    return torch.where(ok, ranked, -1).to(torch.int32)


def dedupe_reporter_mask(rankings: torch.Tensor,
                         reporter_mask: torch.Tensor) -> torch.Tensor:
    """Keep the FIRST unmasked reporter of each distinct ranking vector:
    duplicates carry no independent Eq. 7 evidence."""
    same = (rankings[:, None, :] == rankings[None, :, :]).all(-1)
    m = rankings.shape[0]
    idx = torch.arange(m, device=rankings.device)
    earlier = idx[None, :] < idx[:, None]                     # k < i
    dup = (same & earlier & reporter_mask[None, :]).any(1)
    return reporter_mask & ~dup


@declassifier(
    name="rank-scores", paper_eq="Eq. 7 (§3.3)",
    justification="crowd-sourced tally over already-revealed rankings: "
                  "a count ratio of public votes, computable by every "
                  "peer from the chain alone")
def ranking_scores(rankings: torch.Tensor, num_clients: int, top_k: int,
                   reporter_mask: torch.Tensor = None, *,
                   dedupe: bool = False) -> torch.Tensor:
    """Eq. (7): (M, N) int32 rankings (-1 absent) -> (num_clients,) f32
    scores in [0, 1]; clients never ranked score 0. Rankings of
    reporters outside `reporter_mask` are excluded (§3.6)."""
    m, n = rankings.shape
    if reporter_mask is None:
        reporter_mask = torch.ones((m,), dtype=torch.bool,
                                   device=rankings.device)
    if dedupe:
        reporter_mask = dedupe_reporter_mask(rankings, reporter_mask)
    ids = torch.where(rankings >= 0, rankings, num_clients).to(torch.int64)
    onehot = torch.nn.functional.one_hot(
        ids, num_clients + 1).to(torch.float32)[..., :-1]
    rep = reporter_mask.to(torch.float32)[:, None, None]
    appears = (onehot * rep).sum((0, 1))
    in_topk = (onehot[:, :top_k, :] * rep).sum((0, 1))
    return in_topk / appears.clamp(min=1.0)
