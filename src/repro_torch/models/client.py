"""Small per-client models (WPFed §4.3) as `nn.Module`s.
Counterpart of `repro/models/client.py`.

Parameters keep the JAX package's names and layouts (HWIO for the CNN's
convolutions, TIO for the TCN's, (in, out) for dense layers), so the
flattened parameter vector that the LSH code hashes is the same in both
packages; layouts are converted only at the convolution calls. The M
clients of a federation are a dict of stacked (M, ...) tensors; one
client is applied with `torch.func.functional_call` on a parameter-free
template (`apply_client_model`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_models import ClientModelConfig


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding (before, after): the extra pad goes after. At
    stride 2, a 3x3 kernel and an even size that is (0, 1), where
    PyTorch's padding=1 would pad both sides."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int):
    """x (B, C, H, W), w HWIO -> (B, O, H', W') with XLA SAME padding."""
    kh, kw = w_hwio.shape[:2]
    ph, pw = _same_pad(x.shape[2], kh, stride), _same_pad(x.shape[3], kw,
                                                          stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


class CNN(nn.Module):
    """Two stride-2 3x3 convolutions + two dense layers (the JAX
    package's reduced MobileNetV2 stage). x: (B, H, W, C) NHWC."""

    def __init__(self, cfg: ClientModelConfig):
        super().__init__()
        h0, h1 = cfg.hidden
        kk, cin = cfg.kernel_size, cfg.input_shape[-1]
        flat = (cfg.input_shape[0] // 4) * (cfg.input_shape[1] // 4) * h1
        self.conv1, self.b1 = _param(kk, kk, cin, h0), _param(h0)
        self.conv2, self.b2 = _param(kk, kk, h0, h1), _param(h1)
        self.fc1, self.bf1 = _param(flat, 128), _param(128)
        self.fc2, self.bf2 = _param(128, cfg.num_classes), \
            _param(cfg.num_classes)

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        y = F.relu(_conv2d_same(y, self.conv1, 2)
                   + self.b1[:, None, None])
        y = F.relu(_conv2d_same(y, self.conv2, 2)
                   + self.b2[:, None, None])
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)   # NHWC flatten
        y = F.relu(y @ self.fc1 + self.bf1)
        return y @ self.fc2 + self.bf2


class TCNBlock(nn.Module):
    def __init__(self, kk: int, ch_in: int, ch: int):
        super().__init__()
        self.conv, self.b = _param(kk, ch_in, ch), _param(ch)
        if ch_in != ch:
            self.res = _param(ch_in, ch)
        else:
            self.res = None


class TCN(nn.Module):
    """Dilated causal TCN with residual blocks, global average pool and a
    dense head. x: (B, T, C)."""

    def __init__(self, cfg: ClientModelConfig):
        super().__init__()
        self.kk = cfg.kernel_size
        blocks, ch_in = [], cfg.input_shape[-1]
        for ch in cfg.hidden:
            blocks.append(TCNBlock(cfg.kernel_size, ch_in, ch))
            ch_in = ch
        self.blocks = nn.ModuleList(blocks)
        self.fc, self.bf = _param(ch_in, cfg.num_classes), \
            _param(cfg.num_classes)

    def forward(self, x):
        y = x
        for i, blk in enumerate(self.blocks):
            dil = 2 ** i
            yp = F.pad(y.transpose(1, 2), ((self.kk - 1) * dil, 0))  # causal
            conv = F.conv1d(yp, blk.conv.permute(2, 1, 0), dilation=dil)
            conv = conv.transpose(1, 2) + blk.b
            res = y @ blk.res if blk.res is not None else y
            y = F.relu(conv) + res
        return y.mean(1) @ self.fc + self.bf


class MLP(nn.Module):
    """Dense ReLU network (the fast unit tests' model)."""

    def __init__(self, cfg: ClientModelConfig):
        super().__init__()
        dims = (math.prod(cfg.input_shape), *cfg.hidden, cfg.num_classes)
        self.w = nn.ParameterList([_param(dims[i], dims[i + 1])
                                   for i in range(len(dims) - 1)])
        self.b = nn.ParameterList([_param(dims[i + 1])
                                   for i in range(len(dims) - 1)])

    def forward(self, x):
        y = x.reshape(x.shape[0], -1)
        n = len(self.w)
        for i in range(n):
            y = y @ self.w[i] + self.b[i]
            if i < n - 1:
                y = F.relu(y)
        return y


MODELS = {"cnn": CNN, "tcn": TCN, "mlp": MLP}
# initial std of the conv weights; other weights use fan-in**-0.5
CONV_SCALE = 0.1


def client_template(cfg: ClientModelConfig) -> nn.Module:
    """A parameter-free (meta-device) module of `cfg`'s architecture, for
    `apply_client_model`."""
    with torch.device("meta"):
        return MODELS[cfg.kind](cfg)


def init_client_model(cfg: ClientModelConfig, generator: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """One client's parameters, {name: tensor}: weights truncated-normal
    on [-2, 2] times the JAX package's std (0.1 for convolutions, fan-in
    ** -0.5 otherwise), biases zero. Drawn from `generator` on the CPU,
    then moved to `device`; the values differ from the JAX package's,
    whose keys torch cannot reproduce."""
    params = {}
    for name, p in client_template(cfg).named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim == 1:
            t = torch.zeros(p.shape)
        else:
            std = CONV_SCALE if leaf.startswith("conv") else p.shape[-2] ** -0.5
            t = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0,
                                            -2.0, 2.0, generator=generator)
            t = t * std
        params[name] = t.to(device)
    return params


def apply_client_model(model: nn.Module, params: Dict[str, torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """Logits of one client: `model` is a `client_template`."""
    return torch.func.functional_call(model, params, (x,))
