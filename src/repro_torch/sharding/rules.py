"""Sharding rules (the port of `repro/sharding/rules.py`): partition-spec
trees (`repro_torch.tree.P` leaves) for params, optimizer states, batches
and decode caches, and their binding to a mesh.

Conventions, as in the JAX package:
  - batch / client axes shard over ("pod", "data") when the mesh has a
    "pod" axis, ("data",) on a single pod;
  - tensor parallelism shards heads / FFN width / experts over "model";
  - stacked layer params and caches have an unsharded leading (reps,)
    axis.

Binding. JAX turns a spec into a `NamedSharding`; the port turns it into
DTensor placements, one per mesh dimension: `Shard(d)` where the spec
names that mesh axis for tensor dimension d, `Replicate()` where it names
it nowhere (`placements`, `named`). `place` lays a tree of tensors out
by its specs with `distribute_tensor`, and `to_local` takes each rank's
shard back as a plain tensor: the port's kernels read `data_ptr()` and
never see a DTensor. JAX's rule on divisibility holds: a dimension that
its axes do not divide raises (DTensor alone would shard it unevenly).
`sanitize` is the JAX dryrun's exception to it: such a dimension is
replicated instead (`place_params` lays params out so, for the
tensor-parallel forward of `tp`).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import attention as attn
from repro_torch.models import rglru, xlstm
from repro_torch.models.transformer import param_specs
from repro_torch.tree import P, tree_map


def batch_axes(mesh):
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def batch_spec(mesh, *trailing) -> P:
    return P(batch_axes(mesh), *trailing)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: Sequence[int], spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a `shape` tensor laid out by
    `spec`; raises where a dimension does not divide by its axes."""
    sizes = axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)}")
    out = list(shape)
    for d, entry in enumerate(spec):
        div = 1
        for a in _axes(entry):
            div *= sizes[a]
        if out[d] % div:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide by {entry} ({div}) in spec {spec}")
        out[d] //= div
    return tuple(out)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dimension.
    The axes of one tensor dimension must follow the mesh's order (the
    first outermost, as a JAX spec reads them)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of spec {spec} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} appears twice in "
                                 f"spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """Spec tree -> tree of DTensor placement tuples (JAX's
    `NamedSharding` tree)."""
    return tree_map(lambda s: placements(s, mesh), spec_tree)


def place(tree, mesh, spec_tree):
    """Lay each tensor of `tree` out on `mesh` by its spec in `spec_tree`
    (a DTensor tree). Every rank passes the same global tensors, and keeps
    its own shard of them: nothing is sent between ranks."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        local_shape(t.shape, spec, mesh)           # the divisibility rule
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)
    return tree_map(one, tree, spec_tree)


def sanitize(spec_tree, shape_tree, mesh):
    """Drop sharding on dims not divisible by their mesh axes (e.g.
    whisper's vocab 51,865 on a 16-way model axis, or batch 1 of
    long_500k on the 16-way data axis): those dims are replicated, as in
    the JAX dryrun. `shape_tree`: tensors (or anything with `.shape`) in
    the specs' tree."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, ax in zip(shape, parts):
            if ax is None:
                out.append(None)
                continue
            div = math.prod(sizes[a] for a in _axes(ax))
            out.append(ax if dim % div == 0 else None)
        return P(*out)

    return tree_map(fix, spec_tree, shape_tree)


def place_params(cfg: ModelConfig, params, mesh):
    """The model's params laid out by `param_specs` after `sanitize`: the
    tensor-parallel forward's input (`sharding.tp`)."""
    return place(params, mesh, sanitize(param_specs(cfg), params, mesh))


def to_local(tree):
    """Each DTensor's local shard, as a plain tensor (a view)."""
    return tree_map(lambda t: t.to_local(), tree)


def opt_state_specs(cfg: ModelConfig):
    """AdamW state: step replicated; m / v mirror the param specs."""
    ps = param_specs(cfg)
    return {"step": P(), "m": ps, "v": ps}


def train_batch_specs(cfg: ModelConfig, mesh):
    b = batch_axes(mesh)
    specs = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.is_encdec:
        specs["audio"] = P(b, None, None)
    if cfg.vision_tokens:
        specs["vision"] = P(b, None, None)
    return specs


# ---------------------------------------------------------------------------
# decode-cache specs (mirror transformer.init_cache's tree)
# ---------------------------------------------------------------------------
def _add_layer_dim(tree):
    return tree_map(lambda s: P(None, *s), tree)


def _block_cache_specs(cfg: ModelConfig, t: str, b, *, decoder: bool):
    c = {}
    if t in "AL" and not (cfg.is_encdec and not decoder):
        c["kv"] = attn.attn_cache_specs(cfg, b)
    elif t == "X":
        c["kv"] = attn.attn_cache_specs(cfg, b)
    elif t == "R":
        c["state"] = rglru.rglru_state_specs(cfg, b)
    elif t == "S":
        c["state"] = xlstm.slstm_state_specs(cfg, b)
    elif t == "M":
        c["state"] = xlstm.mlstm_state_specs(cfg, b)
    if decoder and cfg.is_encdec:
        c["cross"] = attn.attn_cache_specs(cfg, b)
    return c


def cache_specs(cfg: ModelConfig, mesh):
    b = batch_axes(mesh)
    pattern = cfg.block_pattern
    reps, tail = cfg.pattern_reps, cfg.pattern_tail
    decoder = cfg.is_encdec
    out = {}
    if reps > 0:
        out["layers"] = tuple(
            _add_layer_dim(_block_cache_specs(cfg, t, b, decoder=decoder))
            for t in pattern)
    out["tail"] = tuple(
        _block_cache_specs(cfg, pattern[i], b, decoder=decoder)
        for i in range(tail))
    return out
