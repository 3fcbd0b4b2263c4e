"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
scatter/gather dispatch (the port of `repro/models/moe.py`, one dispatch
group).

Per call, over the T = B * S flattened tokens:
  1. router logits (T, E) in f32 -> softmax -> the top k experts and
     their renormalised weights. The top k come from a stable descending
     sort, so among equal probabilities the lower expert id wins, as
     `jax.lax.top_k` orders them (`torch.topk` promises no order on ties).
  2. each slot's position in its expert by a stable sort over the (T*k,)
     assignments (`_position_in_expert`); slots past the capacity C are
     dropped, in token order, as in the JAX package.
  3. kept slots are written into an (E*C + 1, D) buffer (the last row
     takes the dropped slots and is discarded; a kept slot's row is
     unique, so the write is a plain index copy, no atomics), the expert
     FFNs run as batched GEMMs over E, and each token sums its k gathered
     rows in slot order, the JAX scatter-add's order (an `index_add_`
     would add them by atomics in no fixed order on the card).

The JAX package's grouped dispatch (`set_dispatch_spec`, `_NUM_GROUPS`
> 1), `_dispatch_ffn` and the shard_map path `apply_moe_sharded` serve
its mesh; they wait for the port's sharding (ROADMAP.md, A.6).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import GATED, _act


def moe_shapes(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": (d, e)}                # fan-in d: scale d**-0.5
    if cfg.activation in GATED:
        p["wg"] = (e, d, f)
    p["wi"] = (e, d, f)
    p["wo"] = (e, f, d)
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


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> ((B, S, D), {"load_balance", "dropped_frac"})."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(t, d)
    probs, topw, topi = route(cfg, p, xt)

    cap = _capacity(cfg, t)
    flat_e = topi.reshape(-1)
    flat_pos = _position_in_expert(flat_e)
    keep = flat_pos < cap
    dest = torch.where(keep, flat_e * cap + flat_pos, e * cap)
    src = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((dest,), xt[src])      # the overflow row is dropped
    buf = buf[:-1].reshape(e, cap, d)

    h = torch.bmm(buf, p["wi"])
    if cfg.activation in GATED:
        h = _act(GATED[cfg.activation], torch.bmm(buf, p["wg"])) * h
    else:
        h = _act(cfg.activation, h)
    out_buf = torch.cat([torch.bmm(h, p["wo"]).reshape(e * cap, d),
                         torch.zeros((1, d), dtype=h.dtype, device=x.device)])

    gathered = (out_buf[dest] * (topw.reshape(-1, 1).to(out_buf.dtype)
                                 * keep[:, None].to(out_buf.dtype))
                ).reshape(t, k, d)
    out = gathered[:, 0]
    for j in range(1, k):                 # slot order, as JAX adds them
        out = out + gathered[:, j]

    # Switch-style load-balance terms
    me = probs.mean(0)                    # router probability mass
    ce = (topi[:, :1] == torch.arange(e, device=x.device)).to(
        torch.float32).mean(0)            # one-hot of the top expert
    aux = {"load_balance": e * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    return out.reshape(b, s, d), aux


def moe_forward(cfg: ModelConfig, p, x: torch.Tensor):
    """Entry point of the transformer blocks."""
    return apply_moe(cfg, p, x)
