"""Model assembly: init / forward / prefill / decode for every family of
the transformer zoo (the port of `repro/models/transformer.py`).

Depth is ``reps`` repetitions of ``cfg.block_pattern`` plus a ``tail``
for depths not divisible by the pattern length. As in the JAX package,
``params["layers"]`` is a tuple over pattern positions of dicts stacked
on a leading (reps,) axis: JAX layer ``r * len(pattern) + pi`` is slice
``[r]`` of position ``pi``; tail layer ``i`` follows the reps. The port
runs the repetitions as a Python loop over those slices (views, no copy).

Families:
  dense / moe        "A" / "L" blocks (+ MoE FFN, `moe.py`)
  hybrid             ("R","R","L") RecurrentGemma pattern (`rglru.py`)
  ssm                ("S","M") xLSTM pattern (`xlstm.py`)
  vlm                ("A"x4,"X") with a vision-patch projector (stub tower)
  audio              encoder (bidir "A") + decoder ("A" + cross) - the
                     conv frontend is stubbed: the encoder's input is
                     frame embeddings

Tensor parallelism: with params laid out as DTensors
(`sharding.place_params`), `forward`, `prefill`, `decode_step` and
`init_cache` take the tensor-parallel path of `sharding.tp`. The inputs
are placed here (split on the batch over the batch axes, replicated on
"model"), the positions are made on each rank's rows, and each block's
modules state their own placements and collectives. The decode cache is
laid out by `cache_specs` after `sanitize`; the cache writes run on each
rank's local shards (views of it). The logits come back split on the
vocabulary.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, xlstm
from repro_torch.models.layers import (EMBED_INIT, MLP_INIT, NORM_INIT,
                                       apply_mlp, apply_norm, embed_shapes,
                                       embed_specs, embed_tokens, init_leaves,
                                       lm_logits, mlp_shapes, mlp_specs,
                                       norm_shapes, norm_specs)
from repro_torch.sharding import tp
from repro_torch.tree import P, tree_map

Params = Dict[str, Any]


# ===========================================================================
# init
# ===========================================================================
def _block_parts(cfg: ModelConfig, t: str, decoder: bool):
    """(name, {leaf: shape}, init rules) of each part of a block."""
    norm = (norm_shapes(cfg), NORM_INIT)
    parts = [("ln", *norm)]
    if t in "ALX":
        parts.append(("attn", attn.attn_shapes(cfg), attn.ATTN_INIT))
    elif t == "R":
        parts.append(("rec", rglru.rglru_shapes(cfg), rglru.RGLRU_INIT))
    elif t == "S":
        parts.append(("rec", xlstm.slstm_shapes(cfg), xlstm.SLSTM_INIT))
    elif t == "M":
        parts.append(("rec", xlstm.mlstm_shapes(cfg), xlstm.MLSTM_INIT))
    if decoder and cfg.is_encdec:
        parts += [("ln_x", *norm),
                  ("xattn", attn.attn_shapes(cfg), attn.ATTN_INIT)]
    if cfg.d_ff > 0:
        parts += [("ln2", *norm),
                  ("mlp", moe.moe_shapes(cfg), {}) if cfg.is_moe
                  else ("mlp", mlp_shapes(cfg), MLP_INIT)]
    return parts


def block_shapes(cfg: ModelConfig, t: str, *, decoder: bool = False):
    return {name: shapes for name, shapes, _ in _block_parts(cfg, t, decoder)}


def block_specs(cfg: ModelConfig, t: str, *, decoder: bool = False):
    """The partition specs of one block's params (`block_shapes`' tree)."""
    p: Params = {"ln": norm_specs(cfg)}
    if t in "ALX":
        p["attn"] = attn.attn_specs(cfg)
    elif t == "R":
        p["rec"] = rglru.rglru_specs(cfg)
    elif t == "S":
        p["rec"] = xlstm.slstm_specs(cfg)
    elif t == "M":
        p["rec"] = xlstm.mlstm_specs(cfg)
    if decoder and cfg.is_encdec:
        p["ln_x"] = norm_specs(cfg)
        p["xattn"] = attn.attn_specs(cfg)
    if cfg.d_ff > 0:
        p["ln2"] = norm_specs(cfg)
        p["mlp"] = moe.moe_specs(cfg) if cfg.is_moe else mlp_specs(cfg)
    return p


def _add_layer_dim(spec_tree):
    """Specs of a stacked block: its (reps,) axis is not sharded."""
    return tree_map(lambda s: P(None, *s), spec_tree)


def param_specs(cfg: ModelConfig) -> Params:
    """The partition spec of every parameter, in `param_shapes`' tree."""
    pattern = cfg.block_pattern
    reps, tail = cfg.pattern_reps, cfg.pattern_tail
    decoder = cfg.is_encdec
    specs: Params = {"embed": embed_specs(cfg)}
    if reps > 0:
        specs["layers"] = tuple(
            _add_layer_dim(block_specs(cfg, t, decoder=decoder))
            for t in pattern)
    specs["tail"] = tuple(block_specs(cfg, pattern[i], decoder=decoder)
                          for i in range(tail))
    specs["final_norm"] = norm_specs(cfg)
    if cfg.is_encdec:
        specs["encoder"] = {
            "pos": P(None, None),
            "layers": (_add_layer_dim(block_specs(cfg, "A")),),
            "final_norm": norm_specs(cfg)}
    if cfg.vision_tokens:
        specs["vision_proj"] = P(None, "model")
    return specs


def _param_tree(cfg: ModelConfig, make) -> Params:
    """The params' structure, each part's leaves from `make(shapes, rules,
    lead)` (`lead`: the stacked dims)."""
    pattern = cfg.block_pattern
    reps, tail = cfg.pattern_reps, cfg.pattern_tail
    decoder = cfg.is_encdec

    def block(t, lead, decoder):
        return {name: make(shapes, rules, lead)
                for name, shapes, rules in _block_parts(cfg, t, decoder)}

    tree: Params = {"embed": make(embed_shapes(cfg), EMBED_INIT, ())}
    if reps > 0:
        tree["layers"] = tuple(block(t, (reps,), decoder) for t in pattern)
    tree["tail"] = tuple(block(pattern[i], (), decoder)
                         for i in range(tail))
    tree["final_norm"] = make(norm_shapes(cfg), NORM_INIT, ())
    if cfg.is_encdec:
        tree["encoder"] = {
            "pos": make({"pos": (cfg.encoder_seq_len, cfg.d_model)},
                        EMBED_INIT, ())["pos"],
            "layers": (block("A", (cfg.encoder_layers,), False),),
            "final_norm": make(norm_shapes(cfg), NORM_INIT, ())}
    if cfg.vision_tokens:
        tree["vision_proj"] = make(
            {"w": (cfg.vision_dim or cfg.d_model, cfg.d_model)}, {}, ())["w"]
    return tree


def param_shapes(cfg: ModelConfig) -> Params:
    """The shape of every parameter (a `torch.Size`), in `init_params`'
    structure."""
    return _param_tree(cfg, lambda shapes, rules, lead: {
        k: torch.Size((*lead, *s)) for k, s in shapes.items()})


def meta_params(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """Params on the `meta` device: shapes and dtypes, no storage (the
    dryrun's counting and its FLOP count run on these)."""
    return _param_tree(cfg, lambda shapes, rules, lead: {
        k: torch.empty((*lead, *s), dtype=dtype, device="meta")
        for k, s in shapes.items()})


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random weights drawn from `gen`, on its device: the JAX init's
    distributions (truncated-normal fan-in, each module's own rules for
    the rest: embeddings at scale 1, norms at 1, biases at 0, RG-LRU's
    `lam` uniform in [0.9, 0.999), mLSTM's `w_if` at 0.01), not its
    numbers."""
    return _param_tree(cfg, lambda shapes, rules, lead: init_leaves(
        shapes, gen, dtype, lead, rules))


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


def _reps(layers) -> int:
    return next(iter(layers[0]["ln"].values())).shape[0] if layers else 0


def _blocks(cfg: ModelConfig, params: Params):
    """(pattern position or None, rep or tail index, block type, block
    params) for every layer in depth order."""
    pattern = cfg.block_pattern
    layers = params.get("layers", ())
    for r in range(_reps(layers)):
        for pi, t in enumerate(pattern):
            yield pi, r, t, _layer(layers[pi], r)
    for i, bp in enumerate(params.get("tail", ())):
        yield None, i, pattern[i], bp


# ===========================================================================
# full-sequence forward (train / prefill)
# ===========================================================================
def _block_mode(cfg: ModelConfig, t: str, window_override: int):
    if t == "A" and not window_override:
        return "causal", 0
    return "window", (window_override or cfg.window)


def _apply_block(cfg: ModelConfig, t: str, p, x, *, positions, context,
                 window_override: int = 0, differentiable: bool = False):
    """Returns (x, MoE load-balance loss or None, the block's decode
    cache entries: "kv" (k, v) for "A"/"L" and "X", "state" for "R"/"S"/
    "M", "cross" (k, v) in the encoder-decoder's decoder)."""
    h = apply_norm(cfg, p["ln"], x)
    kw = dict(positions=positions, differentiable=differentiable)
    entries = {}
    if t in "AL":
        mode, win = _block_mode(cfg, t, window_override)
        if cfg.is_encdec and t == "A" and context is None:
            mode = "bidir"                                 # encoder block
        out, entries["kv"] = attn.attn_forward(cfg, p["attn"], h, mode=mode,
                                               window=win, **kw)
    elif t == "X":
        out, entries["kv"] = attn.attn_forward(cfg, p["attn"], h,
                                               mode="cross", context=context,
                                               **kw)
    elif t == "R":
        out, entries["state"] = rglru.rglru_forward(cfg, p["rec"], h)
    elif t == "S":
        out, entries["state"] = xlstm.slstm_forward(cfg, p["rec"], h)
    else:
        out, entries["state"] = xlstm.mlstm_forward(cfg, p["rec"], h)
    x = x + out
    if "xattn" in p and context is not None:               # enc-dec decoder
        hx = apply_norm(cfg, p["ln_x"], x)
        out, entries["cross"] = attn.attn_forward(
            cfg, p["xattn"], hx, mode="cross", context=context, **kw)
        x = x + out
    aux = None
    if "mlp" in p:
        h2 = apply_norm(cfg, p["ln2"], x)
        if cfg.is_moe:
            out, moe_aux = moe.moe_forward(cfg, p["mlp"], h2)
            aux = moe_aux["load_balance"]
        else:
            out = apply_mlp(cfg, p["mlp"], h2)
        x = x + out
    return x, aux, entries


def _run_stack(cfg: ModelConfig, params, x, *, positions, context, pattern,
               window_override=0, remat: str = "none",
               differentiable: bool = False):
    """The repetitions, then the tail -> (x, summed MoE aux loss)."""
    if remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got {remat!r}")
    kw = dict(positions=positions, context=context,
              window_override=window_override, differentiable=differentiable)
    stacks = [_unbind(pos) for pos in params.get("layers", ())]

    def rep_body(xc, r):
        auxes = []
        for pi, t in enumerate(pattern):
            xc, aux, _ = _apply_block(cfg, t, _layer(stacks[pi], r), xc,
                                      **kw)
            if aux is not None:
                auxes.append(aux)
        return xc, auxes

    auxes = []
    for r in range(_reps(params.get("layers", ()))):
        x, aux_r = checkpoint(rep_body, x, r, use_reentrant=False) \
            if remat == "block" else rep_body(x, r)
        auxes += aux_r
    for i, bp in enumerate(params.get("tail", ())):
        x, aux, _ = _apply_block(cfg, pattern[i], bp, x, **kw)
        if aux is not None:
            auxes.append(aux)
    return x, sum(auxes, torch.zeros((), dtype=torch.float32,
                                     device=x.device))


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def _placed_positions(rows, s: int):
    """Positions (B, s) of DTensor `rows` (B, ...), made on each rank's
    rows and placed as they are."""
    return tp.local(lambda r: _positions(r.shape[0], s, r.device),
                    rows.placements, rows)


def _mesh(params):
    """The mesh of placed params, or None."""
    w = params["final_norm"]["scale"]
    return w.device_mesh if tp.placed(w) else None


def _place_inputs(params, tokens, extra):
    """Inputs held whole by every rank, placed for placed params (split
    on the batch, replicated on "model"); as given otherwise."""
    mesh = _mesh(params)
    if mesh is None:
        return tokens, extra

    def place(t):
        return t if tp.placed(t) else tp.place_batch(t, mesh)
    if extra:
        extra = {k: place(v) for k, v in extra.items()}
    return (None if tokens is None else place(tokens)), extra


def _local(tree):
    """Each DTensor of `tree` as its local shard (a view)."""
    return tree_map(lambda a: a.to_local() if tp.placed(a) else a, tree)


def _place_cache(cfg: ModelConfig, params: Params, cache: Params) -> Params:
    """A cache built whole on every rank, laid out by `cache_specs` after
    `sanitize` for placed params (each rank keeps its shard); as given
    otherwise."""
    mesh = _mesh(params)
    if mesh is None:
        return cache
    from repro_torch.sharding import rules
    return rules.place(cache, mesh, rules.sanitize(
        rules.cache_specs(cfg, mesh), cache, mesh))


def encode_audio(cfg: ModelConfig, params: Params, frames, *,
                 differentiable: bool = False):
    """Stubbed-frontend encoder: frames (B, T, D) -> (B, T, D), through
    bidirectional "A" blocks (the flash kernel on the card)."""
    enc = params["encoder"]
    b, t = frames.shape[:2]
    if tp.placed(frames):
        x = tp.local(lambda f, pos: f + pos[None, :t, :], frames.placements,
                     frames, enc["pos"])
        positions = _placed_positions(frames, t)
    else:
        x = frames + enc["pos"][None, :t, :]
        positions = _positions(b, t, x.device)
    x, _ = _run_stack(cfg, {"layers": enc["layers"]}, x,
                      positions=positions, context=None,
                      pattern=("A",), differentiable=differentiable)
    return apply_norm(cfg, enc["final_norm"], x)


def _context_from_extra(cfg: ModelConfig, params: Params, extra, *,
                        differentiable: bool = False):
    if cfg.is_encdec:
        return encode_audio(cfg, params, extra["audio"],
                            differentiable=differentiable)
    if cfg.vision_tokens:
        if tp.placed(extra["vision"]):   # K/V projections read every column
            return tp.gather(tp.col(extra["vision"], params["vision_proj"]))
        return extra["vision"] @ params["vision_proj"]
    return None


def _embed(cfg: ModelConfig, params: Params, tokens):
    b, s = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)

    def add_pos(x, pos):
        idx = torch.clamp(torch.arange(s, device=x.device),
                          max=cfg.learned_pos_embed - 1)
        return x + pos[idx][None]
    if tp.placed(tokens):
        if cfg.learned_pos_embed:
            x = tp.local(add_pos, x.placements, x, params["embed"]["pos"])
        return x, _placed_positions(tokens, s)
    if cfg.learned_pos_embed:
        x = add_pos(x, params["embed"]["pos"])
    return x, _positions(b, s, tokens.device)


def forward(cfg: ModelConfig, params: Params, tokens, extra=None, *,
            window_override: int = 0, remat: str = "none",
            differentiable: bool = False):
    """tokens: (B, S) int -> (logits (B,S,V) f32, aux_loss scalar: the
    MoE load-balance terms summed over layers, 0 without MoE).

    extra: {"audio": (B, T, D)} frames for the encoder-decoder,
    {"vision": (B, T, vision_dim)} patches for the VLM.
    differentiable: attention by the training route
    (`attention.attn_forward`), which `train.steps.lm_loss` takes; the
    default takes the flash kernel for "causal" and "bidir" on the card.
    remat "block" recomputes each repetition of the block pattern in the
    backward pass (`torch.utils.checkpoint`, non-reentrant), as the JAX
    package's `jax.checkpoint` around its scan body does; the tail layers
    and the encoder are kept, as there. Placed params take the
    tensor-parallel path (module docstring); the logits are then split on
    the vocabulary and the aux loss is a plain tensor, the same on every
    rank."""
    tokens, extra = _place_inputs(params, tokens, extra)
    x, positions = _embed(cfg, params, tokens)
    context = _context_from_extra(cfg, params, extra,
                                  differentiable=differentiable)
    x, aux = _run_stack(cfg, params, x, positions=positions, context=context,
                        pattern=cfg.block_pattern,
                        window_override=window_override, remat=remat,
                        differentiable=differentiable)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x), aux


# ===========================================================================
# decode: cache init + single-token step
# ===========================================================================
def _cache_size(cfg, t, cache_len, window_override):
    if t == "L" or window_override:
        return min(window_override or cfg.window, cache_len)
    return cache_len


def _empty_cache(cfg: ModelConfig, params: Params, batch: int, sizes, dtype,
                 context_len: int):
    """The JAX cache's structure, zeros (the recurrent states at their
    start): for each pattern position a dict stacked on (reps,), for each
    tail layer one. A block's entries: "kv" {"k", "v"} for "A"/"L" (none
    in an encoder-decoder without context) of `sizes(t)` slots, "kv" the
    context's K/V for "X", "state" for "R"/"S"/"M", and "cross" the
    context's K/V in the encoder-decoder's decoder."""
    dev = params["final_norm"]["scale"].device
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    has_ctx = context_len > 0

    def kv(lead, n):
        return {k: torch.zeros((*lead, batch, n, kvh, dh), dtype=dtype,
                               device=dev) for k in ("k", "v")}

    def lead_of(tree, lead):
        return tree_map(lambda a: a.expand(*lead, *a.shape).clone(), tree)

    def block(t, bp, lead):
        c: Params = {}
        if t in "AL" and not (cfg.is_encdec and not has_ctx):
            c["kv"] = kv(lead, sizes(t))
        elif t == "X":
            c["kv"] = kv(lead, context_len)
        elif t == "R":
            c["state"] = lead_of(rglru.init_rglru_state(cfg, batch, dtype,
                                                        dev), lead)
        elif t == "S":
            c["state"] = lead_of(xlstm.init_slstm_state(cfg, batch, dev),
                                 lead)
        elif t == "M":
            c["state"] = lead_of(xlstm.init_mlstm_state(cfg, batch, dev),
                                 lead)
        if "xattn" in bp and has_ctx:
            c["cross"] = kv(lead, context_len)
        return c

    pattern = cfg.block_pattern
    layers = params.get("layers", ())
    cache: Params = {}
    if layers:
        cache["layers"] = tuple(block(t, layers[pi], (_reps(layers),))
                                for pi, t in enumerate(pattern))
    cache["tail"] = tuple(block(pattern[i], bp, ())
                          for i, bp in enumerate(params.get("tail", ())))
    return cache


def _block_cache(cache: Params, pi, i):
    """One layer's cache entries: views of rep i for a pattern position."""
    if pi is None:
        return cache["tail"][i]
    return tree_map(lambda a: a[i], cache["layers"][pi])


def _write(dst, src) -> None:
    """Copy a tree of tensors into a tree of views of the same shapes."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def init_cache(cfg: ModelConfig, params: Params, batch: int, cache_len: int,
               dtype=torch.float32, extra=None, *, window_override: int = 0):
    """Build an empty decode cache (cross-attention K/V precomputed from
    `extra`); laid out by `cache_specs` for placed params."""
    if extra:
        _, extra = _place_inputs(params, None, extra)
    context = _context_from_extra(cfg, params, extra)
    cache = _place_cache(cfg, params, _empty_cache(
        cfg, params, batch,
        lambda t: _cache_size(cfg, t, cache_len, window_override), dtype,
        0 if context is None else context.shape[1]))
    if context is not None:
        local = _local(cache)
        for pi, i, t, bp in _blocks(cfg, params):
            c = _block_cache(local, pi, i)
            if t == "X":
                _write(c["kv"], _local(attn.cross_kv(cfg, bp["attn"],
                                                     context)))
            if "cross" in c:
                _write(c["cross"], _local(attn.cross_kv(cfg, bp["xattn"],
                                                        context)))
    return cache


def _block_decode(cfg, t, p, x, c, pos, window_override):
    """One layer's decode step; `c` (views) is updated in place."""
    h = apply_norm(cfg, p["ln"], x)
    if t in "AL":
        mode, win = _block_mode(cfg, t, window_override)
        out, _ = attn.attn_decode(cfg, p["attn"], h, c["kv"], pos,
                                  mode=mode, window=win)
    elif t == "X":
        out, _ = attn.attn_decode(cfg, p["attn"], h, c["kv"], pos,
                                  mode="cross")
    else:
        step = {"R": rglru.rglru_decode, "S": xlstm.slstm_decode,
                "M": xlstm.mlstm_decode}[t]
        out, state = step(cfg, p["rec"], h, c["state"])
        if state is not c["state"]:       # the placed path writes in place
            _write(c["state"], state)
    x = x + out
    if "cross" in c:
        hx = apply_norm(cfg, p["ln_x"], x)
        out, _ = attn.attn_decode(cfg, p["xattn"], hx, c["cross"], pos,
                                  mode="cross")
        x = x + out
    if "mlp" in p:
        h2 = apply_norm(cfg, p["ln2"], x)
        out = moe.moe_forward(cfg, p["mlp"], h2)[0] if cfg.is_moe \
            else apply_mlp(cfg, p["mlp"], h2)
        x = x + out
    return x


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token,
                pos: int, *, window_override: int = 0):
    """token: (B,) int, pos: int -> (logits (B,V), cache). The cache is
    updated in place and returned (for placed params, the placed cache
    of `init_cache` / `prefill`, written through its local shards)."""
    tokens, _ = _place_inputs(params, token[:, None], None)
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.learned_pos_embed:
        row = min(pos, cfg.learned_pos_embed - 1)
        if tp.placed(x):
            x = tp.local(lambda x, p: x + p[row], x.placements, x,
                         params["embed"]["pos"])
        else:
            x = x + params["embed"]["pos"][row]
    local = _local(cache)
    for pi, i, t, bp in _blocks(cfg, params):
        x = _block_decode(cfg, t, bp, x, _block_cache(local, pi, i), pos,
                          window_override)
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
    tokens, extra = _place_inputs(params, tokens, extra)
    b, s = tokens.shape
    full_len = max(cache_len, s)
    x, positions = _embed(cfg, params, tokens)
    context = _context_from_extra(cfg, params, extra)
    dev = x.device

    def ring(t):                          # a ring cache always holds win
        return t == "L" or bool(window_override)
    cache = _place_cache(cfg, params, _empty_cache(
        cfg, params, b,
        lambda t: (window_override or cfg.window) if ring(t) else full_len,
        x.dtype, 0 if context is None else context.shape[1]))
    local = _local(cache)

    def ring_pack(k, win):
        """The last `win` positions in ring layout (slot = p % win)."""
        if s < win:                       # identity slots + zero tail
            return k
        i = torch.arange(win, device=dev)
        slot_pos = (s - 1) - torch.remainder((s - 1) - i, win)
        return k[:, slot_pos]

    for pi, i, t, bp in _blocks(cfg, params):
        x, _, entries = _apply_block(cfg, t, bp, x, positions=positions,
                                     context=context,
                                     window_override=window_override)
        c = _block_cache(local, pi, i)
        for name, val in _local(entries).items():
            if name == "state":
                _write(c["state"], val)
            elif name in c:       # an enc-dec without context keeps no K/V
                if name == "kv" and t in "AL" and ring(t):
                    val = [ring_pack(a, window_override or cfg.window)
                           for a in val]
                for slot, a in zip(("k", "v"), val):
                    c[name][slot][:, :a.shape[1]] = a
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x[:, -1:, :])[:, 0], cache
