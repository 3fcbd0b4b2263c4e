"""xLSTM blocks (arXiv:2405.04517; the port of `repro/models/xlstm.py`):
sLSTM (scalar memory, nonlinear state-mixing recurrence) and mLSTM
(matrix memory, attention-like parallel form).

Prefill:
  - sLSTM: stabilised exponential gating, a sequential loop over time
    (the recurrence is nonlinear, so no associative form exists; the
    JAX package runs `lax.scan`).
  - mLSTM: chunkwise-parallel stabilised form, an intra-chunk quadratic
    part and an inter-chunk recurrent (C, n, m) state over chunks of
    `MLSTM_CHUNK` (one chunk when S is not a multiple of it: the chunking
    sets both the rounding and the peak memory, so it is the JAX
    package's). Decode is the O(1) recurrent update of each cell.

Both loops' trip counts grow with the sequence. `cut_loops` lets the
dryrun (`launch/dryrun.py`) count a step's FLOPs from one and two trips
of each loop: on `meta` tensors (shapes only) a cut loop runs its first
trips and repeats its last output to the full length. Tensors on any
other device never take the cut.

Both blocks' specs replicate every parameter (the recurrences mix every
unit at each step), so on DTensor activations (`sharding.tp`) each block
runs whole on every rank of "model" inside `tp.local`, with no
collective; the batch stays split over the batch axes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal, zeros
from repro_torch.sharding import tp
from repro_torch.tree import P, tree_leaves

NEG_INF = -1e30
M_INIT = -30.0                  # the stabiliser's start: exp(m) ~ 0

# trips of the sLSTM step loop / the mLSTM chunk loop on meta (None: all)
_CUT = {"slstm": None, "mlstm": None}


@contextlib.contextmanager
def cut_loops(slstm: int = None, mlstm: int = None):
    """Within the block, run at most `slstm` sLSTM steps and `mlstm`
    mLSTM chunks on meta tensors (None: every trip)."""
    old = dict(_CUT)
    _CUT.update(slstm=slstm, mlstm=mlstm)
    try:
        yield
    finally:
        _CUT.update(old)


def _trips(loop: str, n: int, x: torch.Tensor) -> int:
    cut = _CUT[loop]
    return n if cut is None or x.device.type != "meta" else min(n, cut)


# ===========================================================================
# sLSTM
# ===========================================================================
def slstm_shapes(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {"w": (4, d, d),                # i, f, z, o input weights
            "r": (4, h, dh, dh),           # block-diagonal recurrence
            "b": (4, d), "w_out": (d, d)}


def slstm_specs(cfg: ModelConfig):
    """Replicated: the recurrence mixes every unit each step."""
    return {"w": P(None, None, None), "r": P(None, None, None, None),
            "b": P(None, None), "w_out": P(None, None)}


SLSTM_INIT = {"b": zeros()}


def _slstm_step(cfg, p, state, wx_t):
    """state: (h, c, n, m) each (B, D) f32; wx_t: (4, B, D) the input
    part, precomputed."""
    h_prev, c_prev, n_prev, m_prev = state
    b = h_prev.shape[0]
    hh = h_prev.reshape(b, cfg.num_heads, -1)
    rec = torch.einsum("bhe,ghef->gbhf", hh, p["r"].to(torch.float32))
    pre = wx_t + rec.reshape(4, b, -1) \
        + p["b"].to(torch.float32)[:, None, :]
    i_t, f_t, z_t, o_t = pre.unbind(0)
    m_t = torch.maximum(f_t + m_prev, i_t)
    i_g = torch.exp(i_t - m_t)
    f_g = torch.exp(f_t + m_prev - m_t)
    c_t = f_g * c_prev + i_g * torch.tanh(z_t)
    n_t = f_g * n_prev + i_g
    h_t = torch.sigmoid(o_t) * c_t / torch.clamp(n_t, min=1e-6)
    return (h_t, c_t, n_t, m_t)


def _tp_block(fn, cfg, p, x, n_state: int):
    """A replicated block's forward on DTensor x: run whole on the local
    batch; its output and its `n_state` state tensors keep x's
    placements."""
    return tp.local(lambda p, x: fn(cfg, p, x), [x.placements] * (1 + n_state),
                    p, x)


def _tp_step(fn, cfg, p, x, state):
    """A replicated block's decode step on DTensor x, its state the
    rank's local tensors (written in place and returned)."""
    def step(p, x, state):
        out, new = fn(cfg, p, x, state)
        for d, s in zip(tree_leaves(state), tree_leaves(new)):
            d.copy_(s)
        return out
    return tp.local(step, x.placements, p, x, state), state


def slstm_forward(cfg: ModelConfig, p, x, state=None):
    """x: (B,S,D) -> (out, final state)."""
    if tp.placed(x):
        return _tp_block(slstm_forward, cfg, p, x, 4)
    b, s, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    wx = torch.einsum("bsd,gde->gbse", x.to(torch.float32),
                      p["w"].to(torch.float32))           # (4,B,S,D)
    hs = []
    for t in range(_trips("slstm", s, x)):
        state = _slstm_step(cfg, p, state, wx[:, :, t])
        hs.append(state[0])
    hs += hs[-1:] * (s - len(hs))                 # a cut loop (meta only)
    out = torch.stack(hs, dim=1).to(x.dtype) @ p["w_out"]
    return out, state


def init_slstm_state(cfg: ModelConfig, batch: int, device=None):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(), torch.full_like(z, M_INIT))


def slstm_state_specs(cfg: ModelConfig, batch_axes):
    s = P(batch_axes, None)
    return (s, s, s, s)


def slstm_decode(cfg: ModelConfig, p, x, state):
    """x: (B,1,D) -> (out (B,1,D), new state)."""
    if tp.placed(x):
        return _tp_step(slstm_decode, cfg, p, x, state)
    wx = torch.einsum("bd,gde->gbe", x[:, 0].to(torch.float32),
                      p["w"].to(torch.float32))
    state = _slstm_step(cfg, p, state, wx)
    out = state[0].to(x.dtype) @ p["w_out"]
    return out[:, None, :], state


# ===========================================================================
# mLSTM
# ===========================================================================
def mlstm_shapes(cfg: ModelConfig):
    d = cfg.d_model
    di = 2 * d                             # inner width
    return {"w_up": (d, di), "w_z": (d, di),      # w_z: the gate branch
            "w_q": (di, di), "w_k": (di, di), "w_v": (di, di),
            "w_if": (di, 2 * cfg.num_heads), "b_if": (2 * cfg.num_heads,),
            "w_down": (di, d)}


def mlstm_specs(cfg: ModelConfig):
    return {"w_up": P(None, None), "w_z": P(None, None), "w_q": P(None, None),
            "w_k": P(None, None), "w_v": P(None, None),
            "w_if": P(None, None), "b_if": P(None),
            "w_down": P(None, None)}


MLSTM_INIT = {"w_if": normal(0.01), "b_if": zeros(torch.float32)}


def _mlstm_qkv_gates(cfg, p, x):
    u = x @ p["w_up"]
    b, s, di = u.shape
    h = cfg.num_heads
    dh = di // h

    def heads(w):
        return (u @ w).reshape(b, s, h, dh)

    q, k, v = heads(p["w_q"]), heads(p["w_k"]), heads(p["w_v"])
    gates = u.to(torch.float32) @ p["w_if"].to(torch.float32) + p["b_if"]
    log_i = gates[..., :h]                                 # (B,S,H)
    log_f = F.logsigmoid(gates[..., h:])                   # (B,S,H)
    z = F.silu(x @ p["w_z"])
    return q, k, v, log_i, log_f, z, dh


MLSTM_CHUNK = 256


def mlstm_forward(cfg: ModelConfig, p, x, state=None):
    """Chunkwise-parallel stabilised form: intra-chunk quadratic plus
    inter-chunk recurrent (C, n, m) state, peak memory O(B * L^2 * H) for
    chunks of length L. x: (B,S,D) -> (out, final state)."""
    if tp.placed(x):
        return _tp_block(mlstm_forward, cfg, p, x, 3)
    q, k, v, log_i, log_f, z, dh = _mlstm_qkv_gates(cfg, p, x)
    b, s, h, _ = q.shape
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    L = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s         # fallback: 1 chunk
    scale = dh ** -0.5
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))

    C_p, n_p, m_p = state["C"], state["n"], state["m"]
    hs = []
    starts = range(0, s, L)
    for c0 in starts[:_trips("mlstm", len(starts), x)]:
        q_b, k_b, v_b = (a[:, c0:c0 + L] for a in (qf, kf, vf))
        li, lf = log_i[:, c0:c0 + L], log_f[:, c0:c0 + L]  # (B,L,H)
        fcs = torch.cumsum(lf, dim=1)                      # inclusive
        ftot = fcs[:, -1]                                  # (B,H)
        # intra-chunk decay  D[t, tau] = fcs[t] - fcs[tau] + li[tau]
        dmat = fcs[:, :, None, :] - fcs[:, None, :, :] + li[:, None, :, :]
        dmat = dmat.masked_fill(~causal[None, :, :, None], NEG_INF)
        # the prior state's log scale at position t: fcs[t] + m_prev
        b_t = fcs + m_p[:, None, :]                        # (B,L,H)
        m_t = torch.maximum(dmat.amax(dim=2), b_t)         # (B,L,H)
        dexp = torch.exp(dmat - m_t[:, :, None, :])
        inter_w = torch.exp(b_t - m_t)                     # (B,L,H)

        w_sc = torch.einsum("bthd,bshd->btsh", q_b, k_b) * scale * dexp
        num_intra = torch.einsum("btsh,bshe->bthe", w_sc, v_b)
        num_inter = inter_w[..., None] * torch.einsum(
            "bhde,bthd->bthe", C_p, q_b) * scale
        den_intra = w_sc.sum(dim=2)
        den_inter = inter_w * torch.einsum("bhd,bthd->bth", n_p, q_b) * scale
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
        hs.append((num_intra + num_inter) / den[..., None])  # (B,L,H,dh)

        # the state at the end of the chunk
        w_tau = ftot[:, None, :] - fcs + li                # (B,L,H)
        m_new = torch.maximum(m_p + ftot, w_tau.amax(dim=1))
        wexp = torch.exp(w_tau - m_new[:, None, :])
        decay = torch.exp(m_p + ftot - m_new)              # (B,H)
        C_p = decay[..., None, None] * C_p + torch.einsum(
            "bshd,bshe->bhde", wexp[..., None] * k_b, v_b)
        n_p = decay[..., None] * n_p + torch.einsum(
            "bsh,bshd->bhd", wexp, k_b)
        m_p = m_new
    hs += hs[-1:] * (len(starts) - len(hs))       # a cut loop (meta only)
    out_h = torch.cat(hs, dim=1).reshape(b, s, -1).to(x.dtype) * z
    return out_h @ p["w_down"], {"C": C_p, "n": n_p, "m": m_p}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None):
    h = cfg.num_heads
    dh = 2 * cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), M_INIT, **f32)}


def mlstm_state_specs(cfg: ModelConfig, batch_axes):
    return {"C": P(batch_axes, None, None, None),
            "n": P(batch_axes, None, None),
            "m": P(batch_axes, None)}


def mlstm_decode(cfg: ModelConfig, p, x, state):
    """O(1) recurrent update. x: (B,1,D) -> (out (B,1,D), new state)."""
    if tp.placed(x):
        return _tp_step(mlstm_decode, cfg, p, x, state)
    q, k, v, log_i, log_f, z, dh = _mlstm_qkv_gates(cfg, p, x)
    qf, kf, vf = (a[:, 0].to(torch.float32) for a in (q, k, v))  # (B,H,dh)
    log_i, log_f = log_i[:, 0], log_f[:, 0]                # (B,H)
    m_t = torch.maximum(log_f + state["m"], log_i)
    f_g = torch.exp(log_f + state["m"] - m_t)[..., None]
    i_g = torch.exp(log_i - m_t)[..., None]
    C = f_g[..., None] * state["C"] \
        + i_g[..., None] * kf[..., :, None] * vf[..., None, :]
    n = f_g * state["n"] + i_g * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf) * (dh ** -0.5)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs()
                        * (dh ** -0.5), torch.exp(-m_t))
    out_h = (num / den[..., None]).reshape(x.shape[0], -1)
    out = (out_h.to(x.dtype) * z[:, 0]) @ p["w_down"]
    return out[:, None, :], {"C": C, "n": n, "m": m_t}
