"""Carry a client's weights across from the JAX package.

`params_from_jax(cfg, tree)` turns a JAX client pytree of numpy arrays
(dicts and lists, `None` leaves as in the TCN's `res`), one client's or
stacked (M, ...), into the port's {name: tensor} params, so that both
packages compute on the same weights. The port never imports JAX: the
caller converts its arrays to numpy first.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_models import ClientModelConfig
from repro_torch.models.client import client_template


def _walk(tree, prefix, out):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in tree:
            _walk(tree[k], f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(cfg: ClientModelConfig, tree,
                    device=None) -> Dict[str, torch.Tensor]:
    """Nested dict/list pytree of arrays -> {dotted name: tensor}, checked
    against the port's parameter names and (trailing) shapes."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    want = dict(client_template(cfg).named_parameters())
    if set(flat) != set(want):
        raise ValueError(f"parameter names differ: JAX {sorted(flat)} vs "
                         f"port {sorted(want)}")
    out = {}
    for name, arr in flat.items():
        shape = tuple(want[name].shape)
        if arr.shape[arr.ndim - len(shape):] != shape:
            raise ValueError(f"{name}: shape {arr.shape} does not end in "
                             f"{shape}")
        out[name] = torch.from_numpy(np.array(arr, np.float32)).to(device)
    return out
