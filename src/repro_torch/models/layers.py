"""Shared layer primitives of the transformer zoo: norms, activations,
MLPs, embeddings, RoPE and the fan-in init (the port of
`repro/models/layers.py`).

Parameters keep the JAX package's names and (in, out) layouts, so a
projection is `x @ w` and weights carry across without a transpose.

Each function also takes the tensor-parallel path (`sharding.tp`): on
DTensor activations, norms run on the replicated stream, the MLP is
column-parallel `wi` / `wg` then row-parallel `wo` (one all-reduce), the
embedding a masked lookup in each rank's vocabulary rows (one
all-reduce), and the LM head leaves the logits split on the vocabulary,
as the JAX package's out-shardings do. RoPE runs inside the attention's
local computation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import tp
from repro_torch.tree import P


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(shape, gen: torch.Generator, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times `scale` or
    fan_in**-0.5 (fan_in = shape[-2], or shape[-1] for a vector). Drawn
    from `gen` on its device; matches the JAX init in distribution."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def normal(scale: float):
    """Init rule: `dense_init` at a fixed `scale`."""
    return lambda shape, gen, dtype: dense_init(shape, gen, dtype, scale)


def zeros(dtype=None):
    """Init rule: zeros, in `dtype` whatever the params' dtype (or in
    theirs)."""
    return lambda shape, gen, dt: torch.zeros(shape, dtype=dtype or dt,
                                              device=gen.device)


def ones(shape, gen, dtype):
    return torch.ones(shape, dtype=dtype, device=gen.device)


def uniform(low: float, high: float):
    """Init rule: uniform in [low, high), in f32 whatever the params'
    dtype."""
    def init(shape, gen, dtype):
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        return t.uniform_(low, high, generator=gen)
    return init


def init_leaves(shapes, gen: torch.Generator, dtype, lead=(), rules=None):
    """{name: shape} -> {name: tensor of shape (*lead, *shape)} drawn from
    `gen` on its device: by `rules[name]` (one of the rules above) where
    the module names one, else `dense_init` at fan_in**-0.5. A stacked
    leaf (lead = (reps,)) is drawn whole; its fan-in is still shape[-2],
    so every leaf the default draws is a matrix."""
    rules = rules or {}
    return {name: rules.get(name, dense_init)((*lead, *shape), gen, dtype)
            for name, shape in shapes.items()}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_shapes(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}
    return {"scale": (cfg.d_model,)}


def norm_specs(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return {"scale": P(None), "bias": P(None)}
    return {"scale": P(None)}


NORM_INIT = {"scale": ones, "bias": zeros()}


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    if tp.placed(x):
        return tp.local(lambda p, x: apply_norm(cfg, p, x, eps),
                        x.placements, p, x)
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------
def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default
    if name == "relu2":
        r = torch.relu(x)
        return r * r
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


GATED = {"swiglu": "silu", "geglu": "gelu"}


def mlp_shapes(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.activation in GATED:
        p["wg"] = (d, f)
    p["wi"] = (d, f)
    p["wo"] = (f, d)
    if cfg.mlp_bias:
        p["bi"] = (f,)
        p["bo"] = (d,)
    return p


def mlp_specs(cfg: ModelConfig):
    """Tensor parallelism over "model": the FFN width is sharded."""
    p = {}
    if cfg.activation in GATED:
        p["wg"] = P(None, "model")
    p["wi"] = P(None, "model")
    p["wo"] = P("model", None)
    if cfg.mlp_bias:
        p["bi"] = P("model")
        p["bo"] = P(None)
    return p


MLP_INIT = {"bi": zeros(), "bo": zeros()}


def _mlp_hidden(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.activation in GATED:
        return _act(GATED[cfg.activation], x @ p["wg"]) * h
    return _act(cfg.activation, h)


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if tp.placed(x):
        up = {k: p[k] for k in ("wi", "wg", "bi") if k in p}
        h = tp.local(lambda up, x: _mlp_hidden(cfg, up, x),
                     tp.col_out(x, p["wi"]), up, x)
        return tp.row(h, p["wo"], p.get("bo"))
    out = _mlp_hidden(cfg, p, x) @ p["wo"]
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def embed_shapes(cfg: ModelConfig):
    p = {"tok": (cfg.vocab_size, cfg.d_model)}
    if cfg.learned_pos_embed:
        p["pos"] = (cfg.learned_pos_embed, cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return p


def embed_specs(cfg: ModelConfig):
    p = {"tok": P("model", None)}
    if cfg.learned_pos_embed:
        p["pos"] = P(None, None)
    if not cfg.tie_embeddings:
        p["lm_head"] = P(None, "model")
    return p


EMBED_INIT = {"tok": normal(1.0), "pos": normal(0.02)}


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    if tp.placed(tokens):
        return tp.embed(p["tok"], tokens)
    return p["tok"][tokens]


def lm_logits(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if tp.placed(x):
        w = p["tok"] if cfg.tie_embeddings else p["lm_head"]
        return tp.local(lambda x, w: lm_logits(cfg, {
            "tok" if cfg.tie_embeddings else "lm_head": w}, x),
            tp.col_out(x, w), x, w)
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ w).to(torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) int. The split-halves form:
    [x1 cos - x2 sin, x1 sin + x2 cos] with x1, x2 the halves of dh."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
