"""P2P knowledge distillation (WPFed §3.1, Eq. 2-4, Alg. 1 l.19).
Counterpart of `repro/core/distill.py`.

    L_i = alpha * CE(f(theta_i, X_loc), Y_loc)
        + (1 - alpha) * || f(theta_i, X_ref) - mean_j Yhat_j ||^2
"""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def aggregate_neighbor_outputs(neighbor_logits: torch.Tensor,
                               valid_mask: torch.Tensor):
    """Mean over the valid neighbours: logits (N, R, C), mask (N,) ->
    (agg (R, C), has_any). With no valid neighbour the mean is zeros and
    has_any False (the local loss alone then drives the update)."""
    w = valid_mask.to(torch.float32)
    agg = torch.einsum("n,nrc->rc", w, neighbor_logits) / w.sum().clamp(
        min=1.0)
    return agg, w.sum() > 0


def combined_loss(apply_fn, params, batch, ref_x, target_ref_logits,
                  has_target, alpha: float):
    """Alg. 1 line 19. batch: {"x", "y"} local minibatch. The target is
    a constant (no gradient flows into the neighbours' outputs)."""
    l_loc = cross_entropy(apply_fn(params, batch["x"]), batch["y"])
    own_ref = apply_fn(params, ref_x)
    l_ref = torch.square(own_ref - target_ref_logits.detach()).mean()
    l_ref = torch.where(has_target, l_ref, torch.zeros_like(l_ref))
    return alpha * l_loc + (1 - alpha) * l_ref, (l_loc, l_ref)
