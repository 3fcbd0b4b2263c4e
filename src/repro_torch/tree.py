"""Pytrees of tensors: nested dicts, tuples and lists, in the JAX
package's leaf order.

`tree_leaves` and `tree_paths` walk a tree as `jax.tree.leaves` and
`jax.tree_util.tree_flatten_with_path` do: dict keys sorted, sequences in
order, `None` a subtree without leaves. The order matters where leaves
are combined (the global-norm sum) and where they are named (checkpoint
keys); `tree_map` keeps each dict's own key order.

`P`, the port's partition spec, is a tuple that every function here takes
as one leaf, as the JAX package's spec trees treat `PartitionSpec`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple


class P(tuple):
    """A partition spec (the port's `jax.sharding.PartitionSpec`): per
    dimension None (replicated), a mesh axis name, or a tuple of axis
    names (sharded over their product, the first outermost); a tuple of
    one name is that name, as JAX normalises it. Dimensions past its
    length are replicated. A leaf of every tree function here."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the same leaves of `rest`."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def tree_paths(tree, path: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX leaf order; a path segment is "d:<key>" for a
    dict entry, "a:<field>" for a named tuple's field and "s:<index>" for
    a sequence item (the JAX checkpoint store's key segments)."""
    if tree is None:
        return
    if isinstance(tree, P):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (f"d:{k}",))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_paths(v, path + (f"a:{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (f"s:{i}",))
    else:
        yield path, tree


def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX leaf order."""
    return [leaf for _, leaf in tree_paths(tree)]


def dotted_names(tree) -> List[str]:
    """The leaves' dotted names ("layers.0.attn.wq": dict keys and
    sequence indices joined by dots), in JAX leaf order."""
    return [".".join(seg[2:] for seg in path) for path, _ in tree_paths(tree)]


def flatten_dotted(tree) -> Dict[str, Any]:
    """A nested tree -> {dotted name: leaf}, in JAX leaf order. Sorted by
    `kernels.ops.leaf_key`, the names keep that order, so the flat dict
    is what the federation's round takes as one client's params."""
    return dict(zip(dotted_names(tree), tree_leaves(tree)))


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (in JAX leaf order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, P):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            out = [build(v) for v in t]
            return type(t)(*out) if _is_namedtuple(t) else type(t)(out)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
