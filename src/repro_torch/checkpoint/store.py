"""Pytree checkpointing to .npz, in the JAX package's layout
(`repro/checkpoint/store.py`), so a checkpoint written by either package
restores into the other.

Layout: <dir>/step_<N>.npz, one array per leaf, keyed by its path:
segments "d:<key>" (dict entry), "s:<index>" (tuple or list item) and
"a:<field>" (named tuple field) joined by "/", in `repro_torch.tree`'s
walk (the JAX key paths). bfloat16 leaves are saved as float32 (npz has
no bfloat16); `restore` casts back to the template's dtype. A Python int
leaf (a round counter, a seed) is saved as a 0-d int64 array, where the
JAX package holds a 0-d device scalar.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

_SEP = "/"


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def _is_int(leaf) -> bool:
    return isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool)


def _flatten(tree) -> dict:
    out = {}
    for path, leaf in tree_paths(tree):
        if _is_int(leaf):
            out[_SEP.join(path)] = np.asarray(leaf, np.int64)
            continue
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{_SEP.join(path)}: a checkpoint holds tensors "
                            f"and ints, got {type(leaf).__name__}")
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[_SEP.join(path)] = t.cpu().numpy()  # analysis: host-ok to the .npz
    return out


def save(ckpt_dir: str, step: int, tree: Any, *,
         keep_last_k: Optional[int] = None) -> str:
    """Atomic snapshot (written to a temporary name, then renamed); with
    `keep_last_k`, prune older step_*.npz after the new file is in place.
    The newest k survive by step number; other files are never touched."""
    if keep_last_k is not None and keep_last_k < 1:
        raise ValueError(f"keep_last_k must be >= 1, got {keep_last_k}")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp.npz"          # .npz suffix so np.savez doesn't append
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    if keep_last_k is not None:
        for old in steps(ckpt_dir)[:-keep_last_k]:
            os.remove(_path(ckpt_dir, old))
    return path


def steps(ckpt_dir: str) -> List[int]:
    """All retained snapshot steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", f)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    found = steps(ckpt_dir)
    return found[-1] if found else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into `like`, a template tree of tensors and ints: each
    tensor leaf is overwritten in place with the checkpoint's array of
    the same path (cast to the leaf's dtype, copied to its device), one
    leaf at a time, so restoring a training state needs no second copy
    of it. Returns a tree shaped like `like` that holds those tensors and
    the checkpoint's value for each int leaf (`like` itself when it has
    no int leaf). A missing key or a shape mismatch raises."""
    leaves, has_int = [], False
    with np.load(_path(ckpt_dir, step)) as data:
        keys = set(data.files)
        for path, leaf in tree_paths(like):
            key = _SEP.join(path)
            if key not in keys:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            shape = () if _is_int(leaf) else tuple(leaf.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            if _is_int(leaf):
                leaves.append(int(arr))
                has_int = True
            else:
                leaf.copy_(torch.from_numpy(arr))
                leaves.append(leaf)
    return tree_unflatten(like, leaves) if has_int else like
