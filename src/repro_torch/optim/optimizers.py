"""Optimizers with the JAX package's update formulas.
Counterpart of `repro/optim/optimizers.py` (adam, adamw).

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

This is not `torch.optim.Adam`: the update is
u = -(lr * (m / c1) / (sqrt(v / c2) + eps)) exactly as the JAX package
writes it (eps added after the square root of the bias-corrected v),
with f32 moments. Params, grads and moments are {name: tensor} dicts;
nothing is updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]):
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with decoupled weight decay; moments in f32."""
    def init(params):
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def update(grads, state, params):
        step = state["step"] + 1
        f32 = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=f32.device), f32)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=f32.device), f32)
        m = {k: b1 * state["m"][k] + (1 - b1) * g.to(torch.float32)
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(
            g.to(torch.float32)) for k, g in grads.items()}
        updates = {}
        for k in grads:
            u = -(lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps))
            if weight_decay:
                u = u - lr * weight_decay * params[k].to(torch.float32)
            updates[k] = u
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
