"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427; the port of
`repro/models/rglru.py`).

Block: x -> [linear_x -> causal depthwise conv1d -> RG-LRU] * gelu(linear_gate)
         -> linear_out

RG-LRU recurrence (real-gated linear recurrent unit):
    r_t = sigmoid(u_t W_ra + b_ra)            # recurrence gate
    i_t = sigmoid(u_t W_rx + b_rx)            # input gate
    log a_t = -c * softplus(Lambda) * r_t     # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The prefill runs the linear recurrence as a log-depth inclusive scan
over time (`_linear_scan`: Hillis-Steele doubling, ceil(log2 S) steps of
whole-tensor work, where the JAX package runs `lax.associative_scan`);
a loop over S steps would cost S steps of host time per layer. Decode is
the one-step recurrence on the (h, conv window) state.

On DTensor activations (`sharding.tp`) the block is split on its
recurrence width W over "model" (`rglru_specs`): `w_in` and `w_gate` are
column-parallel, the conv and the scan run on each rank's channels, the
gates' (W, W) products read every channel of u (one all-gather of u)
and give the rank's columns, and `w_out` is row-parallel (one
all-reduce). The state keeps the rank's channels (`rglru_state_specs`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import uniform, zeros
from repro_torch.sharding import tp
from repro_torch.tree import P

_C = 8.0


def rglru_shapes(cfg: ModelConfig):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {"w_in": (d, w), "w_gate": (d, w),
            "conv_w": (cfg.conv1d_width, w), "conv_b": (w,),
            "w_ra": (w, w), "b_ra": (w,), "w_rx": (w, w), "b_rx": (w,),
            "lam": (w,), "w_out": (w, d)}


def rglru_specs(cfg: ModelConfig):
    """The recurrence width W sharded over "model"."""
    return {"w_in": P(None, "model"), "w_gate": P(None, "model"),
            "conv_w": P(None, "model"), "conv_b": P("model"),
            "w_ra": P(None, "model"), "b_ra": P("model"),
            "w_rx": P(None, "model"), "b_rx": P("model"),
            "lam": P("model"), "w_out": P("model", None)}


# conv_w (cw, W) has fan-in cw, so the default draw is JAX's cw**-0.5
RGLRU_INIT = {"conv_b": zeros(), "b_ra": zeros(), "b_rx": zeros(),
              "lam": uniform(0.9, 0.999)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _conv1d_causal(u, w, b):
    """Depthwise causal conv. u: (B,S,W), w: (cw,W): tap j reads u_{t-j}
    with weight w[j]."""
    cw, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    out = torch.zeros_like(u)
    for j in range(cw):
        out = out + pad[:, j:j + s, :] * w[cw - 1 - j]
    return out + b


def _gates(p, u, u_all=None):
    """(a, gated input) of channels u; the gate products read `u_all`
    (every channel, where u holds a rank's share of them), else u."""
    u_all = u if u_all is None else u_all
    r = torch.sigmoid(u_all @ p["w_ra"] + p["b_ra"])
    i = torch.sigmoid(u_all @ p["w_rx"] + p["b_rx"])
    log_a = -_C * F.softplus(p["lam"].to(torch.float32)) \
        * r.to(torch.float32)
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i.to(torch.float32) * u.to(torch.float32))
    return a, gated_in


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1:
    after the step of offset d, (a_t, b_t) composes the 2d steps ending
    at t (the associative combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 +
    b2))."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


_GATE_KEYS = ("w_ra", "b_ra", "w_rx", "b_rx", "lam")


def _per_row(raw, p):
    """Placements of a (B, W) tensor beside (B, S, W) `raw`: W split as
    `w_in`'s columns are."""
    return tp.on_model(raw.placements,
                       Shard(1) if tp.split(p["w_in"]) else Replicate())


def _tp_forward(cfg, p, x):
    raw = tp.col(x, p["w_in"])                            # (B,S,W) split
    gate = tp.col(x, p["w_gate"])
    u = tp.local(_conv1d_causal, raw.placements, raw, p["conv_w"],
                 p["conv_b"])
    u_all = tp.gather(u)         # the gates' (W, W) products mix channels
    gp = {k: p[k] for k in _GATE_KEYS}
    cw = cfg.conv1d_width

    def body(raw, u, u_all, gate, gp):
        a, gin = _gates(gp, u, u_all)
        h = _linear_scan(a, gin).to(x.dtype)
        return (h * _gelu(gate), h[:, -1].to(torch.float32),
                raw[:, max(raw.shape[1] - (cw - 1), 0):, :])
    pl3 = raw.placements
    y, h_last, conv = tp.local(body, [pl3, _per_row(raw, p), pl3], raw, u,
                               u_all, gate, gp)
    return tp.row(y, p["w_out"]), {"h": h_last, "conv": conv}


def rglru_forward(cfg: ModelConfig, p, x):
    """Prefill path. x: (B,S,D) -> (out (B,S,D), state)."""
    if tp.placed(x):
        return _tp_forward(cfg, p, x)
    raw = x @ p["w_in"]
    u = _conv1d_causal(raw, p["conv_w"], p["conv_b"])
    a, gin = _gates(p, u)                                 # (B,S,W) f32
    h = _linear_scan(a, gin).to(x.dtype)
    gate = _gelu(x @ p["w_gate"])
    out = (h * gate) @ p["w_out"]
    cw = cfg.conv1d_width
    # the state keeps the raw x @ w_in tail, not the convolved one
    state = {"h": h[:, -1].to(torch.float32),
             "conv": raw[:, max(raw.shape[1] - (cw - 1), 0):, :]}
    return out, state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device)}


def rglru_state_specs(cfg: ModelConfig, batch_axes):
    return {"h": P(batch_axes, "model"), "conv": P(batch_axes, None, "model")}


def _tp_decode(cfg, p, x, state):
    """The decode step on DTensor x; `state` holds the rank's channels
    (plain views of the placed cache) and is written in place."""
    raw = tp.col(x, p["w_in"])                            # (B,1,W)
    gate = tp.col(x, p["w_gate"])

    def conv(raw, conv_w, conv_b, state):
        hist = torch.cat([state["conv"].to(raw.dtype), raw], dim=1)
        u = torch.einsum("btw,tw->bw", hist, conv_w.flip(0)) + conv_b
        return u, hist
    u, hist = tp.local(conv, [_per_row(raw, p), raw.placements], raw,
                       p["conv_w"], p["conv_b"], state)
    u_all = tp.gather(u)
    gp = {k: p[k] for k in _GATE_KEYS}

    def body(u, u_all, hist, gate, gp, state):
        a, gin = _gates(gp, u, u_all)
        h = a * state["h"] + gin
        state["h"].copy_(h)
        state["conv"].copy_(hist[:, 1:, :])
        return h.to(x.dtype) * _gelu(gate)[:, 0]
    y = tp.local(body, _per_row(raw, p), u, u_all, hist, gate, gp, state)
    out = tp.row(y, p["w_out"])
    return tp.local(lambda o: o[:, None, :], out.placements, out), state


def rglru_decode(cfg: ModelConfig, p, x, state):
    """One-step decode. x: (B,1,D). state: {"h": (B,W), "conv": (B,cw-1,W)}.
    Returns (out (B,1,D), new state). On DTensor x the state is the
    rank's local shards, updated in place and returned."""
    if tp.placed(x):
        return _tp_decode(cfg, p, x, state)
    raw = x @ p["w_in"]                                   # (B,1,W)
    hist = torch.cat([state["conv"].to(raw.dtype), raw], dim=1)
    # the prefill's conv gives u_{t-k} weight w[k]; hist runs oldest to
    # newest, so the kernel is reversed here
    u = torch.einsum("btw,tw->bw", hist, p["conv_w"].flip(0)) + p["conv_b"]
    a, gin = _gates(p, u)                                 # (B,W)
    h = a * state["h"] + gin
    gate = _gelu(x @ p["w_gate"])[:, 0]
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out[:, None, :], {"h": h, "conv": hist[:, 1:, :]}
