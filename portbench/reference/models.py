"""The paper's client models as batched products over a group of G
clients: params {name: (G, ...)}, x (G, B, ...) -> logits (G, B, C).

Convolutions are written as im2col followed by one batched matrix
product per layer, so nothing here runs through cuDNN. Parameter names
and layouts are the port's (HWIO for the CNN, TIO for the TCN, (in, out)
for dense layers), which `portbench.inputs.param_shapes` states.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor = None):
    """x (G, ..., I) @ w (G, I, O) (+ b (G, O))."""
    g, i = x.shape[0], x.shape[-1]
    y = torch.bmm(x.reshape(g, -1, i), w).reshape(*x.shape[:-1], w.shape[-1])
    if b is not None:
        y = y + b.reshape((g,) + (1,) * (y.ndim - 2) + (b.shape[-1],))
    return y


def _conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int):
    """NHWC x (G, B, H, W, C), w (G, kh, kw, C, O) -> (G, B, H', W', O)
    with XLA "SAME" padding (the extra row and column go after)."""
    g, b, h, wd, c = x.shape
    kh, kw = w.shape[1:3]

    def pad(size, k):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2

    (ht, hb), (wl, wr) = pad(h, kh), pad(wd, kw)
    xp = F.pad(x, (0, 0, wl, wr, ht, hb))
    p = xp.unfold(2, kh, stride).unfold(3, kw, stride)   # (G,B,H',W',C,kh,kw)
    oh, ow = p.shape[2], p.shape[3]
    p = p.permute(0, 1, 2, 3, 5, 6, 4).reshape(g, b, oh, ow, kh * kw * c)
    return _dense(p, w.reshape(g, kh * kw * c, w.shape[-1]))


def cnn(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g, b = x.shape[:2]
    y = torch.relu(_conv2d_same(x, params["conv1"], 2)
                   + params["b1"][:, None, None, None, :])
    y = torch.relu(_conv2d_same(y, params["conv2"], 2)
                   + params["b2"][:, None, None, None, :])
    y = y.reshape(g, b, -1)                                # NHWC flatten
    y = torch.relu(_dense(y, params["fc1"], params["bf1"]))
    return _dense(y, params["fc2"], params["bf2"])


def tcn(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Causal dilated blocks (dilation 2^i), residual (a dense map where
    the width changes), mean over time, dense head. x (G, B, T, C)."""
    y = x
    t = x.shape[2]
    i = 0
    while f"blocks.{i}.conv" in params:
        w = params[f"blocks.{i}.conv"]                     # (G, K, I, O)
        k, cin, cout = w.shape[1:]
        d = 2 ** i
        yp = F.pad(y, (0, 0, (k - 1) * d, 0))
        taps = torch.stack([yp[:, :, j * d:j * d + t, :] for j in range(k)],
                           dim=3)                          # (G,B,T,K,I)
        conv = _dense(taps.reshape(*taps.shape[:3], k * cin),
                      w.reshape(w.shape[0], k * cin, cout),
                      params[f"blocks.{i}.b"])
        res = params.get(f"blocks.{i}.res")
        y = torch.relu(conv) + (_dense(y, res) if res is not None else y)
        i += 1
    return _dense(y.mean(2), params["fc"], params["bf"])


MODELS = {"cnn": cnn, "tcn": tcn}


def forward(kind: str, params: Dict[str, torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    return MODELS[kind](params, x)
