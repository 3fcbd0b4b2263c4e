"""Model assembly: init / forward / prefill / decode of the dense
transformer families (the port of `repro/models/transformer.py`).

Depth is ``reps`` repetitions of ``cfg.block_pattern`` plus a ``tail``
for depths not divisible by the pattern length. As in the JAX package,
``params["layers"]`` is a tuple over pattern positions of dicts stacked
on a leading (reps,) axis: JAX layer ``r * len(pattern) + pi`` is slice
``[r]`` of position ``pi``; tail layer ``i`` follows the reps. The port
runs the repetitions as a Python loop over those slices (views, no copy).

This slice covers blocks "A" (global causal) and "L" (sliding window)
with a dense MLP: the dense family. MoE, the recurrent blocks ("R",
"S", "M"), cross-attention ("X", the VLM) and the encoder-decoder raise
`NotImplementedError` (ROADMAP.md, A, next slices: the LM substrate's
`moe` / `rglru` / `xlstm` / enc-dec / VLM modules).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_shapes, embed_tokens, lm_logits,
                                       mlp_shapes, norm_shapes)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice does not port."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE (moe.py)")
    if cfg.is_encdec:
        missing.append("the encoder-decoder (encode_audio)")
    if cfg.vision_tokens:
        missing.append("the vision projector")
    blocks = sorted(set(cfg.block_pattern) - set("AL"))
    if blocks:
        missing.append(f"block types {blocks} (rglru.py / xlstm.py / "
                       "cross-attention)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; see "
            "ROADMAP.md, A, next slices (the LM substrate: moe / rglru / "
            "xlstm / enc-dec / VLM)")


# ===========================================================================
# init
# ===========================================================================
def block_shapes(cfg: ModelConfig, t: str):
    p: Params = {"ln": norm_shapes(cfg), "attn": attn.attn_shapes(cfg)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_shapes(cfg)
        p["mlp"] = mlp_shapes(cfg)
    return p


def param_shapes(cfg: ModelConfig) -> Params:
    """The shape of every parameter (a `torch.Size`), in `init_params`'
    structure."""
    check_supported(cfg)
    pattern = cfg.block_pattern
    reps, tail = cfg.pattern_reps, cfg.pattern_tail

    def leaves(tree, lead=()):
        return {k: leaves(v, lead) if isinstance(v, dict)
                else torch.Size((*lead, *v)) for k, v in tree.items()}

    shapes: Params = {"embed": leaves(embed_shapes(cfg))}
    if reps > 0:
        shapes["layers"] = tuple(leaves(block_shapes(cfg, t), (reps,))
                                 for t in pattern)
    shapes["tail"] = tuple(leaves(block_shapes(cfg, pattern[i]))
                           for i in range(tail))
    shapes["final_norm"] = leaves(norm_shapes(cfg))
    return shapes


def _init_leaf(name: str, shape, gen, dtype):
    if name == "scale":
        return torch.ones(shape, dtype=dtype, device=gen.device)
    if name == "bias" or name in ("bq", "bk", "bv", "bi", "bo"):
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    if name == "tok":
        return dense_init(shape, gen, dtype, scale=1.0)
    if name == "pos":
        return dense_init(shape, gen, dtype, scale=0.02)
    return dense_init(shape, gen, dtype)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random weights drawn from `gen`, on its device: the JAX init's
    distributions (truncated-normal fan-in, embeddings at scale 1, norms
    at 1 and biases at 0), not its numbers."""
    def build(tree, name=""):
        if isinstance(tree, torch.Size):
            return _init_leaf(name, tree, gen, dtype)
        if isinstance(tree, tuple):
            return tuple(build(t) for t in tree)
        return {k: build(v, k) for k, v in tree.items()}
    return build(param_shapes(cfg))


def _layer(tree, r: int):
    """Slice r of a stacked block's params (views); also takes the
    per-rep tuples of `_unbind`."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _unbind(tree):
    """A stacked block's params as per-rep tuples of views, from one
    `unbind` per leaf. Under autograd each leaf's gradient is then one
    stack of the per-rep gradients; indexing the stack once per rep
    would instead add reps zero-padded full-size gradients."""
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}


def _reps(params: Params) -> int:
    if "layers" not in params:
        return 0
    return next(iter(params["layers"][0]["ln"].values())).shape[0]


def _blocks(cfg: ModelConfig, params: Params):
    """(pattern position or None, rep or tail index, block type, block
    params) for every layer in depth order."""
    pattern = cfg.block_pattern
    if "layers" in params:
        for r in range(_reps(params)):
            for pi, t in enumerate(pattern):
                yield pi, r, t, _layer(params["layers"][pi], r)
    for i, bp in enumerate(params.get("tail", ())):
        yield None, i, pattern[i], bp


# ===========================================================================
# full-sequence forward (prefill)
# ===========================================================================
def _block_mode(cfg: ModelConfig, t: str, window_override: int):
    if t == "A" and not window_override:
        return "causal", 0
    return "window", (window_override or cfg.window)


def _apply_block(cfg: ModelConfig, t: str, p, x, *, positions,
                 window_override: int = 0, differentiable: bool = False):
    """Returns (x, (k, v)) of one "A" or "L" block."""
    h = apply_norm(cfg, p["ln"], x)
    mode, win = _block_mode(cfg, t, window_override)
    out, kv = attn.attn_forward(cfg, p["attn"], h, positions=positions,
                                mode=mode, window=win,
                                differentiable=differentiable)
    x = x + out
    if "mlp" in p:
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, kv


def _embed(cfg: ModelConfig, params: Params, tokens):
    b, s = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    if cfg.learned_pos_embed:
        idx = torch.clamp(torch.arange(s, device=tokens.device),
                          max=cfg.learned_pos_embed - 1)
        x = x + params["embed"]["pos"][idx][None]
    return x, positions


def forward(cfg: ModelConfig, params: Params, tokens, extra=None, *,
            window_override: int = 0, remat: str = "none",
            differentiable: bool = False):
    """tokens: (B, S) int -> (logits (B,S,V) f32, aux_loss scalar).

    differentiable: attention by the training route
    (`attention.attn_forward`), which `train.steps.lm_loss` takes; the
    default takes the flash kernel for "causal" and "bidir" on the card.
    remat "block" recomputes each repetition of the block pattern in the
    backward pass (`torch.utils.checkpoint`, non-reentrant), as the JAX
    package's `jax.checkpoint` around its scan body does; the tail layers
    are kept, as there."""
    check_supported(cfg)
    if remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got {remat!r}")
    x, positions = _embed(cfg, params, tokens)
    pattern = cfg.block_pattern
    kw = dict(positions=positions, window_override=window_override,
              differentiable=differentiable)
    stacks = [_unbind(pos) for pos in params.get("layers", ())]

    def rep_body(xc, r):
        for pi, t in enumerate(pattern):
            xc, _ = _apply_block(cfg, t, _layer(stacks[pi], r), xc, **kw)
        return xc

    for r in range(_reps(params)):
        x = checkpoint(rep_body, x, r, use_reentrant=False) \
            if remat == "block" else rep_body(x, r)
    for i, bp in enumerate(params.get("tail", ())):
        x, _ = _apply_block(cfg, pattern[i], bp, x, **kw)
    x = apply_norm(cfg, params["final_norm"], x)
    return (lm_logits(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ===========================================================================
# decode: cache init + single-token step
# ===========================================================================
def _cache_size(cfg, t, cache_len, window_override):
    if t == "L" or window_override:
        return min(window_override or cfg.window, cache_len)
    return cache_len


def _cache_tree(cfg: ModelConfig, params: Params, make):
    """The cache structure: for each pattern position a stacked
    {"kv": {"k", "v"}} (leading reps axis), for each tail layer one;
    `make(t, lead)` builds a {"k", "v"} dict with leading dims `lead`."""
    cache: Params = {}
    pattern = cfg.block_pattern
    if "layers" in params:
        cache["layers"] = tuple({"kv": make(t, (_reps(params),))}
                                for t in pattern)
    cache["tail"] = tuple({"kv": make(pattern[i], ())}
                          for i in range(len(params.get("tail", ()))))
    return cache


def init_cache(cfg: ModelConfig, params: Params, batch: int, cache_len: int,
               dtype=torch.float32, extra=None, *, window_override: int = 0):
    """Build an empty decode cache."""
    check_supported(cfg)
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dev = params["final_norm"]["scale"].device

    def make(t, lead):
        size = _cache_size(cfg, t, cache_len, window_override)
        return {n: torch.zeros((*lead, batch, size, kv, dh), dtype=dtype,
                               device=dev) for n in ("k", "v")}
    return _cache_tree(cfg, params, make)


def _block_cache(cache: Params, pi, i):
    c = cache["layers"][pi] if pi is not None else cache["tail"][i]
    kv = c["kv"]
    if pi is None:
        return kv
    return {"k": kv["k"][i], "v": kv["v"][i]}            # views of rep i


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token,
                pos: int, *, window_override: int = 0):
    """token: (B,) int, pos: int -> (logits (B,V), cache). The cache is
    updated in place and returned."""
    check_supported(cfg)
    x = embed_tokens(cfg, params["embed"], token[:, None])
    if cfg.learned_pos_embed:
        x = x + params["embed"]["pos"][min(pos, cfg.learned_pos_embed - 1)]
    for pi, i, t, bp in _blocks(cfg, params):
        h = apply_norm(cfg, bp["ln"], x)
        mode, win = _block_mode(cfg, t, window_override)
        out, _ = attn.attn_decode(cfg, bp["attn"], h,
                                  _block_cache(cache, pi, i), pos,
                                  mode=mode, window=win)
        x = x + out
        if "mlp" in bp:
            x = x + apply_mlp(cfg, bp["mlp"], apply_norm(cfg, bp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x)[:, 0], cache


# ===========================================================================
# prefill: full forward that also returns a usable decode cache
# ===========================================================================
def prefill(cfg: ModelConfig, params: Params, tokens, extra=None, *,
            window_override: int = 0, cache_len: int = 0):
    """Returns (last-position logits (B,V), cache positioned at pos=S).

    ``cache_len`` (default: S) sizes the full-attention KV caches so the
    subsequent decode steps have room: pass S + max_new_tokens.
    """
    check_supported(cfg)
    b, s = tokens.shape
    full_len = max(cache_len, s)
    x, positions = _embed(cfg, params, tokens)
    dev = x.device

    def make(t, lead):                    # a ring cache always holds win
        size = (window_override or cfg.window) if t == "L" or \
            window_override else full_len
        return {n: torch.zeros((*lead, b, size, cfg.num_kv_heads,
                                cfg.resolved_head_dim), dtype=x.dtype,
                               device=dev) for n in ("k", "v")}
    cache = _cache_tree(cfg, params, make)

    def ring_pack(k, win):
        """The last `win` positions in ring layout (slot = p % win)."""
        if s < win:                       # identity slots + zero tail
            return k
        i = torch.arange(win, device=dev)
        slot_pos = (s - 1) - torch.remainder((s - 1) - i, win)
        return k[:, slot_pos]

    for pi, i, t, bp in _blocks(cfg, params):
        x, (k, v) = _apply_block(cfg, t, bp, x, positions=positions,
                                 window_override=window_override)
        c = _block_cache(cache, pi, i)
        for name, val in (("k", k), ("v", v)):
            if t == "L" or window_override:
                val = ring_pack(val, window_override or cfg.window)
            c[name][:, :val.shape[1]] = val
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x[:, -1:, :])[:, 0], cache
