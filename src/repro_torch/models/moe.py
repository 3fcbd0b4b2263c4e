"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
scatter/gather dispatch (the port of `repro/models/moe.py`).

Per call, over the T = B * S flattened tokens:
  1. router logits (T, E) in f32 -> softmax -> the top k experts and
     their renormalised weights. The top k come from a stable descending
     sort, so among equal probabilities the lower expert id wins, as
     `jax.lax.top_k` orders them (`torch.topk` promises no order on ties).
  2. the tokens are cut into G = `_NUM_GROUPS` groups of T / G (G = 1
     when G does not divide T), each dispatched on its own with its own
     capacity C (`set_dispatch_spec`). No launcher sets G > 1, in the JAX
     package or here: the JAX dryrun resets it to None (G = 1); the
     tests hold G > 1 against JAX.
  3. in a group (`_dispatch_ffn`), each slot's position in its expert by
     a stable sort over the (T*k,) assignments (`_position_in_expert`);
     ids outside [0, E_here) (experts another rank owns) and slots past C
     are dropped, in token order, as in the JAX package. Kept slots are
     written into an (E_here*C + 1, D) buffer (the last row takes the
     dropped slots and is discarded; a kept slot's row is unique, so the
     write is a plain index copy, no atomics) and the expert FFNs run as
     batched GEMMs over E_here.
  4. each token sums its k gathered rows in slot order, the JAX
     scatter-add's order (an `index_add_` would add them by atomics in
     no fixed order on the card).

Expert parallelism over the mesh's "model" axis (the JAX package's
shard_map path, which its `set_sharded_impl` switches on) is taken here
by the params: DTensor params placed by `moe_specs` and DTensor
activations (`sharding.tp`) run `_tp_moe`. Each rank of "model" holds its
slice of the weights. With E >= EXPERT_SHARD_MIN it holds E / n experts
and dispatches only to them (global ids shifted by rank * E_here); with
fewer experts it holds every expert's slice of the FFN width and
dispatches every slot. The tokens are the same on every rank of the axis
(`_rank_share` runs inside `tp.local`), and its two sums are stated
placements: the (T, D) output is Partial on "model" and one all-reduce
makes it Replicate, the only collective on activations; the aux values
are Partial on every mesh axis and are all-reduced and averaged over the
whole mesh, JAX's `pmean`. The reductions are differentiable, so the
train step runs through them.

The JAX `set_dispatch_spec` also takes the (G, E, C, D) buffer's
partition spec for its SPMD partitioner; eager PyTorch has none, so the
port's takes only G.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import GATED, _act
from repro_torch.sharding import tp
from repro_torch.tree import P

EXPERT_SHARD_MIN = 16

# The dispatch group count G, set by a launcher (tests and single-card
# runs keep the default).
_NUM_GROUPS = 1


def set_dispatch_spec(num_groups: int = 1):
    global _NUM_GROUPS
    _NUM_GROUPS = max(int(num_groups), 1)


def moe_shapes(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": (d, e)}                # fan-in d: scale d**-0.5
    if cfg.activation in GATED:
        p["wg"] = (e, d, f)
    p["wi"] = (e, d, f)
    p["wo"] = (e, f, d)
    return p


def moe_specs(cfg: ModelConfig):
    """Experts over "model" from EXPERT_SHARD_MIN experts on, else each
    expert's FFN width."""
    if cfg.num_experts >= EXPERT_SHARD_MIN:
        up, down = P("model", None, None), P("model", None, None)
    else:
        up, down = P(None, None, "model"), P(None, "model", None)
    p = {"router": P(None, None), "wi": up, "wo": down}
    if cfg.activation in GATED:
        p["wg"] = up
    return p


def _position_in_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its expert group, via a stable sort:
    sort by expert id -> position = index minus group start (cummax of
    the group-start indices) -> back through the inverse permutation."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n, device=flat_e.device)
    is_start = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - group_start        # the inverse permutation
    return pos


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(num_tokens * cfg.experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(c, cfg.experts_per_token)


def route(cfg: ModelConfig, p, xt: torch.Tensor):
    """xt: (T, D) -> (probs (T, E) f32, top weights (T, k) renormalised,
    top expert ids (T, k))."""
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    topw, topi = w[:, :k], ids[:, :k]
    return probs, topw / topw.sum(-1, keepdim=True), topi


def _dispatch_ffn(cfg: ModelConfig, p, xt: torch.Tensor,
                  e_ids: torch.Tensor, cap: int):
    """Capacity-bounded dispatch and the expert FFNs of ONE group.

    xt: (T, D) tokens; e_ids: (T, k) ids into the E_here = p["wi"].shape[0]
    experts of `p` (a rank's slice under expert parallelism). Ids outside
    [0, E_here) are dropped (other ranks own them). Returns the (E_here*C
    + 1, D) outputs (last row zero), each slot's row `dest` (the last row
    where dropped) and the keep mask; slot j of token t is t * k + j."""
    t, d = xt.shape
    e_here = p["wi"].shape[0]
    k = e_ids.shape[-1]
    flat_e = e_ids.reshape(-1)
    here = (flat_e >= 0) & (flat_e < e_here)
    flat_pos = _position_in_expert(torch.where(here, flat_e, e_here))
    keep = here & (flat_pos < cap)
    dest = torch.where(keep, flat_e * cap + flat_pos, e_here * cap)
    src = torch.arange(t, device=xt.device)[:, None].expand(t, k).reshape(-1)
    buf = torch.zeros((e_here * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((dest,), xt[src])      # the overflow row is dropped
    buf = buf[:-1].reshape(e_here, cap, d)

    h = torch.bmm(buf, p["wi"])
    if cfg.activation in GATED:
        h = _act(GATED[cfg.activation], torch.bmm(buf, p["wg"])) * h
    else:
        h = _act(cfg.activation, h)
    out_buf = torch.cat([torch.bmm(h, p["wo"]).reshape(e_here * cap, d),
                         torch.zeros((1, d), dtype=h.dtype, device=xt.device)])
    return out_buf, dest, keep


def _combine(out_buf, dest, keep, topw, t: int, k: int) -> torch.Tensor:
    """(T, D): each token's k gathered rows times their router weights
    (0 where dropped), added in slot order, as JAX's scatter-add does."""
    gathered = (out_buf[dest] * (topw.reshape(-1, 1).to(out_buf.dtype)
                                 * keep[:, None].to(out_buf.dtype))
                ).reshape(t, k, -1)
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    return out


def _load_balance(cfg: ModelConfig, probs, topi) -> torch.Tensor:
    """Switch-style load-balance term: E * sum(router mass * top-1 share)."""
    e = cfg.num_experts
    me = probs.mean(0)
    ce = (topi[:, :1] == torch.arange(e, device=probs.device)).to(
        torch.float32).mean(0)            # one-hot of the top expert
    return e * torch.sum(me * ce)


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> ((B, S, D), {"load_balance", "dropped_frac"}).

    Dispatch runs in G = `_NUM_GROUPS` independent groups of consecutive
    tokens, each with its own capacity (G = 1 when G does not divide T)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    g = _NUM_GROUPS if t % _NUM_GROUPS == 0 else 1
    tg = t // g
    xt = x.reshape(t, d)
    probs, topw, topi = route(cfg, p, xt)

    cap = _capacity(cfg, tg)
    outs, keeps = [], []
    for i in range(g):
        rows = slice(i * tg, (i + 1) * tg)
        out_buf, dest, keep = _dispatch_ffn(cfg, p, xt[rows], topi[rows],
                                            cap)
        outs.append(_combine(out_buf, dest, keep, topw[rows], tg, k))
        keeps.append(keep)
    out = outs[0] if g == 1 else torch.cat(outs)
    keep = keeps[0] if g == 1 else torch.cat(keeps)
    aux = {"load_balance": _load_balance(cfg, probs, topi),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    return out.reshape(b, s, d), aux


# ===========================================================================
# expert parallelism over the mesh's "model" axis (the JAX shard_map path)
# ===========================================================================
def moe_forward(cfg: ModelConfig, p, x: torch.Tensor):
    """Entry point of the transformer blocks."""
    if tp.placed(x):
        return _tp_moe(cfg, p, x)
    return apply_moe(cfg, p, x)


def _rank_share(cfg: ModelConfig, p, x: torch.Tensor, rank: int):
    """One rank's share of the layer, before any sum over ranks: its
    experts' (or its FFN slice's) contribution to the (T, D) output, and
    [load_balance, kept slots] (f32)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    xt = x.reshape(t, d)
    probs, topw, topi = route(cfg, p, xt)      # global expert ids
    e_here = p["wi"].shape[0]
    local_ids = topi - rank * e_here \
        if cfg.num_experts >= EXPERT_SHARD_MIN else topi
    out_buf, dest, keep = _dispatch_ffn(cfg, p, xt, local_ids,
                                        _capacity(cfg, t))
    out = _combine(out_buf, dest, keep, topw, t, k)
    stats = torch.stack([_load_balance(cfg, probs, topi),
                         keep.to(torch.float32).sum()])
    return out, stats


def _tp_moe(cfg: ModelConfig, p, x):
    """The layer on DTensor activations and params placed by `moe_specs`
    (module docstring): the whole layer's output on every rank of
    "model", and the JAX path's aux values."""
    mesh = x.device_mesh
    split = tp.split(p["wi"])
    rank = tp.model_rank(mesh) if split else 0
    t = math.prod(x.to_local().shape[:2])      # the rank's tokens

    def share(p, x):
        out, stats = _rank_share(cfg, p, x, rank)
        return out.reshape(x.shape).to(x.dtype), stats
    everywhere = tuple(Partial() for _ in x.placements)
    out, stats = tp.local(share, [tp.on_model(x.placements, Partial()
                                              if split else Replicate()),
                                  everywhere], p, x)
    if split:
        out = tp.redistribute(out, x.placements)
    pl = list(everywhere)
    for i in range(mesh.ndim):           # one all-reduce per mesh axis
        pl[i] = Replicate()
        stats = tp.redistribute(stats, pl)
    stats = stats.to_local() / mesh.size()
    e_split = split and cfg.num_experts >= EXPERT_SHARD_MIN
    slots = float(t * cfg.experts_per_token) / (
        tp.model_size(mesh) if e_split else 1)
    return out, {"load_balance": stats[0],
                 "dropped_frac": 1.0 - stats[1] / slots}
