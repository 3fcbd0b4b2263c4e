"""Optimizers with the JAX package's update formulas.
Counterpart of `repro/optim/optimizers.py` (sgd, adam, adamw,
clip_by_global_norm).

    opt = adamw(linear_warmup_cosine(3e-4, 10, 100), weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)   # functional
    params = apply_updates(params, updates)
    state = opt.apply(grads, state, params)             # in place

This is not `torch.optim.Adam`: the update is
u = -(lr * (m / c1) / (sqrt(v / c2) + eps)) exactly as the JAX package
writes it (eps added after the square root of the bias-corrected v),
with f32 moments. A learning rate is a float or a schedule
(`optim.schedules`, a callable from the step counter to an f32 lr); a
float stays a Python float, so the federation's `adam(lr)` computes what
it always has. Params, grads and state are pytrees (`repro_torch.tree`):
the client models' {name: tensor} dicts or the transformer's nested
dicts and tuples.

`update` builds new state and update trees, as the JAX package does.
`apply` runs the same per-leaf formula in place: each parameter leaf and
its moments are updated before the next leaf is read, in pieces of at
most 2**26 elements along the leading axis, so a step needs params,
grads and moments plus one piece's temporaries, not whole new trees
(Minitron-4B's f32 training state alone is 67 GB). Both give the same
bits: the pieces are elementwise.

DTensor leaves (the tensor-parallel train step, `sharding.tp`) are
updated through their local shards, since the update is elementwise;
their moments are placed as the params, and the global norm adds each
rank's sums with one all-reduce over "model" (`tp.global_norm`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.sharding import tp
from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]
_PIECE = 1 << 26


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params)
    apply: Callable[[Any, Any, Any], Any]    # in place -> new state


def _lr_at(lr: Schedule, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _pieces(*tensors):
    """Views of same-shaped `tensors` split along dim 0 into pieces of at
    most _PIECE elements."""
    t = tensors[0]
    if t.numel() <= _PIECE:
        yield tensors
        return
    rows = max(1, _PIECE // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in tensors)


@torch.no_grad()
def _apply_leaves(leaf_fn, grads, params, *slots) -> None:
    """p += leaf_fn(g, p, *slot pieces) piece by piece, leaf by leaf (a
    DTensor leaf through its local shards)."""
    for leaves in zip(tree_leaves(grads), tree_leaves(params),
                      *(tree_leaves(t) for t in slots)):
        for gc, pc, *sc in _pieces(*_locals(leaves)):
            pc.add_(leaf_fn(gc, pc, *sc).to(pc.dtype))


def _locals(tensors):
    return [t.to_local() if tp.placed(t) else t for t in tensors]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype) if u is not None else p,
                    params, updates)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX leaf order) of sum(g**2), f32."""
    leaves = tree_leaves(grads)
    if leaves and tp.placed(leaves[0]):
        return tp.global_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most max_norm, norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """`clip_by_global_norm` scaling the grads in place; returns the
    norm."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    for g in _locals(tree_leaves(grads)):
        g.mul_(scale.to(g.dtype))
    return gn


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def leaf(g, mu, lr_t):
        """The update of one leaf; mu (momentum only) updated in place."""
        if momentum:
            mu.mul_(momentum).add_(g)
            return -lr_t * mu
        return -lr_t * g

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = tree_map(torch.clone, state["mu"])
            upd = tree_map(lambda g, m: leaf(g, m, lr_t), grads, mu)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: leaf(g, None, lr_t), grads)
        return upd, {"step": step, "mu": None}

    def apply(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            _apply_leaves(lambda g, p, m: leaf(g, m, lr_t), grads, params,
                          state["mu"])
        else:
            _apply_leaves(lambda g, p: leaf(g, None, lr_t), grads, params)
        return {"step": step, "mu": state["mu"]}

    return Optimizer(init, update, apply)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with decoupled weight decay; moments in f32."""
    def init(params):
        def f32(p):
            if tp.placed(p):
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"step": _step0(params), "m": tree_map(f32, params),
                "v": tree_map(f32, params)}

    def scalars(state):
        step = state["step"] + 1
        f32 = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=f32.device), f32)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=f32.device), f32)
        return step, _lr_at(lr, step), c1, c2

    def leaf(g, p, m, v, lr_t, c1, c2):
        """The AdamW update of one leaf; m and v updated in place."""
        g32 = g.to(torch.float32)
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        u = (m / c1).mul_(lr_t)
        u.div_((v / c2).sqrt_().add_(eps)).neg_()
        if weight_decay:
            u.sub_(lr_t * weight_decay * p.to(torch.float32))
        return u

    def update(grads, state, params):
        step, lr_t, c1, c2 = scalars(state)
        m = tree_map(torch.clone, state["m"])
        v = tree_map(torch.clone, state["v"])
        updates = tree_map(lambda g, p, m_, v_: leaf(g, p, m_, v_, lr_t, c1,
                                                     c2), grads, params, m, v)
        return updates, {"step": step, "m": m, "v": v}

    def apply(grads, state, params):
        step, lr_t, c1, c2 = scalars(state)
        _apply_leaves(lambda g, p, m_, v_: leaf(g, p, m_, v_, lr_t, c1, c2),
                      grads, params, state["m"], state["v"])
        return {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, apply)
