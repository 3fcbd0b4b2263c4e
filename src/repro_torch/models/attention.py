"""GQA attention: global-causal / sliding-window / bidirectional / cross,
with full-sequence (prefill) and single-token (decode) paths (the port of
`repro/models/attention.py`).

KV caches are dicts of tensors. Sliding-window decode uses a ring buffer
of size ``window``: slot ``p % window`` holds position ``p``; keys are
stored RoPE'd at their true position so relative attention is exact.
Decode writes the new token's K/V into the cache in place (the JAX
package returns a new cache) and returns the same dict.

Routing of `attn_forward` by `set_attn_impl`:

| impl      | "causal", "bidir"   | "window"                   | "cross" |
| --------- | ------------------- | -------------------------- | ------- |
| "auto"    | gqa_flash_attention | naive; chunked past 2048^2 | naive   |
| "chunked" | gqa_flash_attention | `_chunked_attn`            | naive   |
| "naive"   | `_naive_attn`       | `_naive_attn`              | naive   |

With `differentiable=True` (the training route, which `train.steps.
lm_loss` passes down) "causal" and "bidir" follow the "window" column,
as the JAX package's `attn_forward` routes every mode: the flash kernel
has no backward, in the JAX package or here.

Masks are applied with `masked_fill` and a Python scalar: a scalar
tensor built on the card would be a host-to-device copy that
synchronises the stream once per layer.

`ops.gqa_flash_attention` is the CUDA flash-attention kernel on the card
(its plain version on the CPU). It computes the same function as the
JAX model's `_naive_attn` / `_chunked_attn` for "causal" and "bidir"
(`tests/test_kernels.py` holds the JAX kernel equal to the model's
causal attention), which the JAX package computes outside its Pallas
kernel. The kernel never builds the S^2 scores, so "auto" needs no
threshold there. It has no window, so "window" stays plain, and so does
decode attention, which the JAX package also computes outside Pallas.

On DTensor activations (`sharding.tp`) every function follows the head
rule of `tp.head_plan`: the projections are column-parallel, gathered
to Replicate where "model" does not divide their heads; the head
reshape, RoPE, the cache writes and the attention core (flash on the
rank's heads) run on local shards with the rank's head counts
(`HeadPlan.cfg`), and `wo` is row-parallel with one all-reduce. The
decode cache follows `cache_specs`: split on its K/V heads where "model"
divides them, replicated where `sanitize` drops the axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, zeros
from repro_torch.sharding import tp
from repro_torch.tree import P

NEG_INF = -1e30


def attn_shapes(cfg: ModelConfig):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
         "wo": (h * dh, d)}
    if cfg.qkv_bias:
        p["bq"] = (h * dh,)
        p["bk"] = (kv * dh,)
        p["bv"] = (kv * dh,)
    return p


def attn_specs(cfg: ModelConfig):
    """Heads sharded over "model" (the projections' head columns)."""
    p = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qkv_bias:
        p["bq"] = P("model")
        p["bk"] = P("model")
        p["bv"] = P("model")
    return p


def attn_cache_specs(cfg: ModelConfig, batch_axes):
    """A KV cache {"k", "v"} of (B, S, kv heads, dh): batch over
    `batch_axes`, heads over "model"."""
    s = P(batch_axes, None, "model", None)
    return {"k": s, "v": s}


ATTN_INIT = {"bq": zeros(), "bk": zeros(), "bv": zeros()}


def _project_q(cfg, p, x):
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(*x.shape[:2], h, dh)


def _project_kv(cfg, p, x):
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(*x.shape[:2], kv, dh),
            v.reshape(*x.shape[:2], kv, dh))


def _gqa_scores(cfg, q, k):
    """q: (B,Sq,H,dh)  k: (B,Sk,KV,dh) -> scores (B,KV,G,Sq,Sk) in f32."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    g = h // kv
    q = q.reshape(q.shape[0], q.shape[1], kv, g, q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32))
    return scores * (cfg.resolved_head_dim ** -0.5)


def _flat_ctx(cfg, ctx, v_dtype):
    """(B, S, H, dh) (or (B, S, KV, G, dh)) context -> (B, S, H * dh) in
    the values' dtype, wo's input."""
    return ctx.reshape(*ctx.shape[:2], cfg.num_heads
                       * cfg.resolved_head_dim).to(v_dtype)


def _gqa_ctx(probs, v):
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))


# Global attention implementation policy (see the module docstring).
_ATTN_IMPL = "auto"
_CHUNK_Q = 1024
_CHUNK_K = 1024
_AUTO_THRESHOLD = 2048 * 2048


def set_attn_impl(impl: str):
    global _ATTN_IMPL
    assert impl in ("auto", "naive", "chunked")
    _ATTN_IMPL = impl


def get_attn_impl() -> str:
    return _ATTN_IMPL


def _mask(sq, sk, mode, window, device, q0=0, k0=0):
    i = q0 + torch.arange(sq, device=device)[:, None]
    j = k0 + torch.arange(sk, device=device)[None, :]
    mask = i >= j
    if mode == "window":
        mask &= (i - j) < window
    return mask


def _naive_attn(cfg, q, k, v, mode, window):
    scores = _gqa_scores(cfg, q, k)                       # (B,KV,G,Sq,Sk)
    sq, sk = scores.shape[-2], scores.shape[-1]
    if mode in ("causal", "window"):
        scores = scores.masked_fill(
            ~_mask(sq, sk, mode, window, scores.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_ctx(probs, v)


def _chunked_attn(cfg, q, k, v, mode, window):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with
    an online softmax for each query chunk. Peak live memory is
    O(B * KV * G * CHUNK_Q * CHUNK_K) instead of O(B * KV * G * Sq * Sk).
    Falls back to `_naive_attn` when the lengths do not divide."""
    h, kv_heads = cfg.num_heads, cfg.num_kv_heads
    g = h // kv_heads
    dh = cfg.resolved_head_dim
    b, sq = q.shape[0], q.shape[1]
    sk = k.shape[1]
    cq = min(_CHUNK_Q, sq)
    ck = min(_CHUNK_K, sk)
    if sq % cq or sk % ck:
        return _naive_attn(cfg, q, k, v, mode, window)
    scale = dh ** -0.5
    dev = q.device
    qf = q.reshape(b, sq, kv_heads, g, dh).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = []
    for q0 in range(0, sq, cq):
        q_blk = qf[:, q0:q0 + cq]
        acc = torch.zeros((b, kv_heads, g, cq, dh), device=dev)
        l = torch.zeros((b, kv_heads, g, cq), device=dev)
        m = torch.full((b, kv_heads, g, cq), NEG_INF, device=dev)
        for k0 in range(0, sk, ck):
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk,
                             kf[:, k0:k0 + ck]) * scale
            if mode in ("causal", "window"):
                s = s.masked_fill(
                    ~_mask(cq, ck, mode, window, dev, q0, k0), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            pexp = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", pexp, vf[:, k0:k0 + ck])
            m = m_new
        out.append(acc / torch.clamp(l, min=1e-30)[..., None])
    ctx = torch.cat(out, dim=3)                            # (b,kv,g,sq,dh)
    return ctx.reshape(b, h, sq, dh).movedim(1, 2)


def _flash_attn(q, k, v, mode):
    """"causal" / "bidir" through `ops.gqa_flash_attention`."""
    return ops.gqa_flash_attention(q, k, v, causal=mode == "causal")


def _attend(cfg, q, k, v, mode, window, differentiable):
    """The attention core by the routing table of the module docstring:
    (B, S, H * dh) context in the values' dtype."""
    sq, sk = q.shape[1], k.shape[1]
    if _ATTN_IMPL != "naive" and mode in ("causal", "bidir") \
            and not differentiable:
        ctx = _flash_attn(q, k, v, mode)
    elif (mode == "window" or differentiable) and (
            _ATTN_IMPL == "chunked"
            or (_ATTN_IMPL == "auto" and sq * sk > _AUTO_THRESHOLD)):
        ctx = _chunked_attn(cfg, q, k, v, mode, window)
    else:
        ctx = _naive_attn(cfg, q, k, v, mode, window)
    return _flat_ctx(cfg, ctx, v.dtype)


def attn_forward(cfg: ModelConfig, p, x, *, positions, mode: str,
                 context=None, window: int = 0,
                 differentiable: bool = False):
    """Full-sequence attention.

    mode: "causal" | "window" | "bidir" | "cross".
    context: (B, Tc, D) for cross-attention.
    differentiable: the training route, as the JAX package computes
    every mode (`_naive_attn`, `_chunked_attn` past 2048^2 under
    "auto"), which autograd differentiates; the flash kernel has no
    backward and is never taken.
    Returns (out, (k, v)) so prefill can build the cache.
    """
    src = context if mode == "cross" else x
    if tp.placed(x):
        return _tp_attn_forward(cfg, p, x, src, positions, mode, window,
                                differentiable)
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, src)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if mode != "cross":
            k = apply_rope(k, positions, cfg.rope_theta)
    ctx = _attend(cfg, q, k, v, mode, window, differentiable)
    return ctx @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# the tensor-parallel path (`sharding.tp`)
# ---------------------------------------------------------------------------
def _split_heads(t, dh: int):
    """(B, S, n * dh) -> (B, S, n, dh)."""
    return t.reshape(*t.shape[:2], t.shape[-1] // dh, dh)


def _tp_q(p, x, plan):
    """The column-parallel query projection (B, S, H * dh), gathered
    where the head rule needs every query head."""
    q = tp.col(x, p["wq"], p.get("bq"))
    return q if plan.q_split else tp.gather(q)


def _tp_kv(p, src, plan):
    """The column-parallel key and value projections (B, Sk, KV * dh),
    gathered where the head rule needs every K/V head."""
    k = tp.col(src, p["wk"], p.get("bk"))
    v = tp.col(src, p["wv"], p.get("bv"))
    return (k, v) if plan.kv_split else (tp.gather(k), tp.gather(v))


def _tp_heads(cfg, plan, q, k, v, positions, rope_k: bool):
    """The head reshape and RoPE on each rank's columns -> q (B, S, H', dh)
    and k, v (B, Sk, KV', dh) with the rank's heads (every K/V head where
    they are gathered: the cache keeps them all). q and k, v go through
    separate local calls, so each input's gradient placement follows
    from its own outputs (`tp.local`)."""
    dh = cfg.resolved_head_dim

    def heads(t, pos, rope):
        t = _split_heads(t, dh)
        return apply_rope(t, pos, cfg.rope_theta) if cfg.rope and rope \
            else t
    kp = tp.heads_placement(k, plan.kv_split)
    q = tp.local(lambda q, pos: heads(q, pos, True),
                 tp.heads_placement(q, plan.q_split), q, positions)
    k, v = tp.local(lambda k, v, pos: (heads(k, pos, rope_k),
                                       heads(v, pos, False)),
                    [kp, kp], k, v, positions)
    return q, k, v


def _tp_attn_forward(cfg, p, x, src, positions, mode, window,
                     differentiable):
    plan = tp.head_plan(cfg, p["wq"], p["wk"])
    q, k, v = _tp_heads(cfg, plan, _tp_q(p, x, plan), *_tp_kv(p, src, plan),
                        positions, mode != "cross")
    lcfg = plan.cfg(cfg)

    def core(q, k, v):
        return _attend(lcfg, q, plan.take_kv(k), plan.take_kv(v), mode,
                       window, differentiable)
    # (B, S, H' * dh): split on its heads' columns where the query heads
    # are, else whole on every rank (row() then chunks it locally)
    ctx = tp.local(core, tp.heads_placement(x, plan.q_split), q, k, v)
    return tp.row(ctx, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                    device=None):
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, cache_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, kv, dh), dtype=dtype,
                             device=device)}


def _ring_slot_positions(pos: int, cache_len: int, device=None):
    """Position stored at each ring slot after writing token ``pos``.

    slot i holds p = pos - ((pos - i) mod W); p < 0 means empty.
    """
    i = torch.arange(cache_len, device=device)
    return pos - torch.remainder(pos - i, cache_len)


def attn_decode(cfg: ModelConfig, p, x, cache, pos: int, *, mode: str,
                window: int = 0):
    """One-token decode. x: (B, 1, D). pos: int (current index).

    mode "causal": cache slot i holds position i (cache_len >= pos+1).
    mode "window": ring buffer, slot = pos % window.
    mode "cross": cache holds precomputed context k/v; no write.
    Returns (out, cache), the cache updated in place. On the
    tensor-parallel path `cache` holds the rank's local shards (plain
    tensors, views of the placed cache).
    """
    if tp.placed(x):
        return _tp_attn_decode(cfg, p, x, cache, pos, mode), cache
    q = _project_q(cfg, p, x)
    kv_new = None if mode == "cross" else _project_kv(cfg, p, x)
    ctx = _decode_ctx(cfg, q, kv_new, cache, pos, mode)
    return ctx @ p["wo"], cache


def _decode_ctx(cfg, q, kv_new, cache, pos, mode, take=lambda t: t):
    """The decode step's attention from the projected q (B, 1, H, dh) and,
    but in "cross", the new token's k, v (B, 1, KV, dh): RoPE at `pos`,
    the cache write (in place), the masked softmax over the cache's K/V
    heads that `take` keeps -> (B, 1, H * dh) context."""
    b = q.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)

    if mode == "cross":
        k, v = take(cache["k"]), take(cache["v"])
        probs = torch.softmax(_gqa_scores(cfg, q, k), dim=-1)
        return _flat_ctx(cfg, _gqa_ctx(probs, v), v.dtype)

    k_new, v_new = kv_new                                 # (B,1,KV,dh)
    if cfg.rope:
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    cache_len = cache["k"].shape[1]
    slot = pos % cache_len if mode == "window" else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    scores = _gqa_scores(cfg, q, take(cache["k"]))        # (B,KV,G,1,Sc)
    if mode == "window":
        valid = _ring_slot_positions(pos, cache_len, q.device) >= 0
    else:
        valid = torch.arange(cache_len, device=q.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    v = take(cache["v"])
    return _flat_ctx(cfg, _gqa_ctx(probs, v), v.dtype)


def _tp_attn_decode(cfg, p, x, cache, pos, mode):
    plan = tp.head_plan(cfg, p["wq"], p["wk"])
    lcfg, dh = plan.cfg(cfg), cfg.resolved_head_dim
    kv = () if mode == "cross" else _tp_kv(p, x, plan)

    def step(cache, q, *kv):
        return _decode_ctx(lcfg, _split_heads(q, dh), tuple(
            _split_heads(t, dh) for t in kv) or None, cache, pos, mode,
            plan.take_kv)
    ctx = tp.local(step, tp.heads_placement(x, plan.q_split), cache,
                   _tp_q(p, x, plan), *kv)
    return tp.row(ctx, p["wo"])


def cross_kv(cfg: ModelConfig, p, context):
    """Precompute cross-attention k/v from a context once per request (on
    the tensor-parallel path, the K/V heads of the rank's cache)."""
    if tp.placed(context):
        plan = tp.head_plan(cfg, p["wq"], p["wk"])
        k, v = _tp_kv(p, context, plan)
        kp = tp.heads_placement(k, plan.kv_split)
        dh = cfg.resolved_head_dim
        k, v = tp.local(lambda k, v: (_split_heads(k, dh),
                                      _split_heads(v, dh)), [kp, kp], k, v)
        return {"k": k, "v": v}
    k, v = _project_kv(cfg, p, context)
    return {"k": k, "v": v}
