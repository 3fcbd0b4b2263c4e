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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, zeros
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


def _out_proj(cfg, p, ctx, v_dtype, out_shape):
    """(B, S, H, dh) f32 context -> (B, S, D) through wo."""
    ctx = ctx.reshape(*out_shape[:2], cfg.num_heads * cfg.resolved_head_dim)
    return ctx.to(v_dtype) @ p["wo"]


def _gqa_out(cfg, p, probs, v, out_shape):
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return _out_proj(cfg, p, ctx, v.dtype, out_shape)


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


def _naive_attn(cfg, p, q, k, v, mode, window, out_shape):
    scores = _gqa_scores(cfg, q, k)                       # (B,KV,G,Sq,Sk)
    sq, sk = scores.shape[-2], scores.shape[-1]
    if mode in ("causal", "window"):
        scores = scores.masked_fill(
            ~_mask(sq, sk, mode, window, scores.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(cfg, p, probs, v, out_shape)


def _chunked_attn(cfg, p, q, k, v, mode, window, out_shape):
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
        return _naive_attn(cfg, p, q, k, v, mode, window, out_shape)
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
    ctx = ctx.reshape(b, h, sq, dh).movedim(1, 2)
    return _out_proj(cfg, p, ctx, v.dtype, out_shape)


def _flash_attn(cfg, p, q, k, v, mode, out_shape):
    """"causal" / "bidir" through `ops.gqa_flash_attention`."""
    ctx = ops.gqa_flash_attention(q, k, v, causal=mode == "causal")
    return _out_proj(cfg, p, ctx, v.dtype, out_shape)


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
    q = _project_q(cfg, p, x)
    src = context if mode == "cross" else x
    k, v = _project_kv(cfg, p, src)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if mode != "cross":
            k = apply_rope(k, positions, cfg.rope_theta)

    sq, sk = q.shape[1], k.shape[1]
    if _ATTN_IMPL != "naive" and mode in ("causal", "bidir") \
            and not differentiable:
        out = _flash_attn(cfg, p, q, k, v, mode, x.shape)
    elif (mode == "window" or differentiable) and (
            _ATTN_IMPL == "chunked"
            or (_ATTN_IMPL == "auto" and sq * sk > _AUTO_THRESHOLD)):
        out = _chunked_attn(cfg, p, q, k, v, mode, window, x.shape)
    else:
        out = _naive_attn(cfg, p, q, k, v, mode, window, x.shape)
    return out, (k, v)


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
    Returns (out, cache), the cache updated in place.
    """
    b = x.shape[0]
    q = _project_q(cfg, p, x)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)

    if mode == "cross":
        k, v = cache["k"], cache["v"]
        probs = torch.softmax(_gqa_scores(cfg, q, k), dim=-1)
        return _gqa_out(cfg, p, probs, v, x.shape), cache

    k_new, v_new = _project_kv(cfg, p, x)                 # (B,1,KV,dh)
    if cfg.rope:
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    cache_len = cache["k"].shape[1]
    slot = pos % cache_len if mode == "window" else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    scores = _gqa_scores(cfg, q, cache["k"])              # (B,KV,G,1,Sc)
    if mode == "window":
        valid = _ring_slot_positions(pos, cache_len, x.device) >= 0
    else:
        valid = torch.arange(cache_len, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(cfg, p, probs, cache["v"], x.shape), cache


def cross_kv(cfg: ModelConfig, p, context):
    """Precompute cross-attention k/v from a context once per request."""
    k, v = _project_kv(cfg, p, context)
    return {"k": k, "v": v}
