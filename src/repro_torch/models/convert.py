"""Carry weights across from the JAX package.

`params_from_jax(cfg, tree)` turns a JAX client pytree of numpy arrays
(dicts and lists, `None` leaves as in the TCN's `res`), one client's or
stacked (M, ...), into the port's {name: tensor} params, so that both
packages compute on the same weights. `lm_params_from_jax(cfg, tree)`
does the same for the transformer zoo's `init_params` pytree, and
`service_state_from_jax` turns a JAX federation service state into the
port's `ServiceState`, so both packages start a round from one state. The
port never imports JAX: the caller converts its arrays to numpy first.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import ClientModelConfig
from repro_torch.models.client import client_template
from repro_torch.models.transformer import param_shapes


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


def service_state_from_jax(cfg: ClientModelConfig, arrays: Dict[str, Any],
                           seed: int = 0, device=None):
    """A JAX `ServiceState` as numpy arrays -> the port's ServiceState.

    `arrays` holds `params` (the stacked client pytree), `opt_state`
    (a dict whose sub-trees shaped like the params, e.g. Adam's "m" and
    "v", convert by `params_from_jax` and whose other entries, e.g.
    "step", become tensors), `codes` (M, W) uint32 (held as their int32
    bit patterns), `rankings` (M, N), `commitments` (M,) uint32 (held as
    int64), `active` (M,) bool, `code_age` and `gossip_count` (M,) int32,
    and the scalars `period_start` and `round`. `seed` is the port's
    federation seed, from which its round generators derive (the JAX
    state's PRNG key has no counterpart)."""
    from repro_torch.core.protocol import FedState
    from repro_torch.service.membership import ServiceState

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    opt = {k: params_from_jax(cfg, v, device) if isinstance(v, dict)
           else torch.from_numpy(np.array(v)).to(device)
           for k, v in arrays["opt_state"].items()}
    fed = FedState(
        params_from_jax(cfg, arrays["params"], device), opt,
        t(np.asarray(arrays["codes"], np.uint32).view(np.int32),
          torch.int32),
        t(arrays["rankings"], torch.int32),
        t(np.asarray(arrays["commitments"]).astype(np.int64), torch.int64),
        seed, int(arrays["round"]))
    return ServiceState(fed, t(arrays["active"], torch.bool),
                        t(arrays["code_age"], torch.int32),
                        t(arrays["gossip_count"], torch.int32),
                        int(arrays["period_start"]))


def lm_params_from_jax(cfg: ModelConfig, tree, device=None):
    """The JAX `init_params(cfg, key)` pytree, as numpy arrays -> the
    port's transformer params (same nesting: `embed`, `layers` as a tuple
    over pattern positions stacked on (reps,), `tail`, `final_norm`; the
    same (in, out) layouts, so nothing is transposed). Every name and
    shape is checked against `param_shapes(cfg)`; a mismatch raises."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    want: Dict[str, tuple] = {}
    _walk_shapes(param_shapes(cfg), "", want)
    if set(flat) != set(want):
        raise ValueError(f"parameter names differ: JAX-only "
                         f"{sorted(set(flat) - set(want))}, port-only "
                         f"{sorted(set(want) - set(flat))}")
    for name, arr in flat.items():
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the port "
                             f"expects {want[name]}")

    def build(shapes, prefix):
        if isinstance(shapes, torch.Size):
            return torch.from_numpy(np.array(flat[prefix[:-1]],
                                             np.float32)).to(device)
        if isinstance(shapes, tuple):
            return tuple(build(v, f"{prefix}{i}.")
                         for i, v in enumerate(shapes))
        return {k: build(v, f"{prefix}{k}.") for k, v in shapes.items()}
    return build(param_shapes(cfg), "")


def _walk_shapes(tree, prefix, out):
    if isinstance(tree, torch.Size):
        out[prefix[:-1]] = tuple(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk_shapes(v, f"{prefix}{k}.", out)
    else:
        for i, v in enumerate(tree):
            _walk_shapes(v, f"{prefix}{i}.", out)
