"""Tensor parallelism over the mesh's "model" axis: the placements of the
forward's activations, each one stated (what GSPMD does to the JAX
package's jitted steps under `param_specs`, written out).

Params are DTensors laid out by `rules.place` after `rules.sanitize`, so
each rank holds its `param_specs` shard and the bytes the dryrun counts
per device are the bytes the forward holds. The residual stream is a
DTensor sharded on the batch over the batch axes (where they divide it;
`stream`) and `Replicate()` on "model" at every block boundary. Every
computation runs on local shards through `local`, a `local_map` wrapper:
the kernel wrappers read `data_ptr()` and receive plain tensors, so
flash attention launches on the rank's own heads. Every collective is an
explicit `redistribute`; nothing is left to DTensor's propagation, which
chooses its own redistributions (weights gathered).

- column-parallel (`col`): x Replicate @ w[:, cols] -> Shard(-1), no
  communication;
- row-parallel (`row`): h Shard(-1) @ w[rows, :] -> Partial, then one
  all-reduce to Replicate;
- the head rule (`head_plan`): where "model" divides a head count, a
  projection's column shard is whole heads and attention runs on the
  rank's heads with no collective before it; where it does not, the
  projection is gathered to Replicate before the head reshape. With the
  query heads divided, each rank then keeps the K/V heads its own query
  heads read (a local index: each once, or one K/V head per query head
  where the groups straddle ranks); with the query heads not divided, every rank
  computes every head and keeps its column chunk of the context for the
  row-parallel `wo` (Replicate -> Shard(-1), a local chunk).

The head rule keeps `param_specs` exact and needs no kernel change (a
sequence split of the queries would need a query offset, which the flash
kernel's top-left causal mask lacks). Its cost is the gathers and, where
the query heads do not divide, the attention core repeated on every rank
of "model".

Gradients: `local` gives each input the gradient placement its local
computation implies. An input replicated on a mesh dimension over which
some output is split or partial gets a `Partial()` gradient there (each
rank holds its share of the sum); DTensor's autograd reduces it where
the placements meet, which is the backward's only communication.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def placed(t) -> bool:
    """Whether `t` is a DTensor (the tensor-parallel path) or plain."""
    return isinstance(t, DTensor)


def model_dim(mesh) -> int:
    """Index of "model": the last mesh dimension in every layout of the
    port ("data", "model") and ("pod", "data", "model")."""
    names = list(mesh.mesh_dim_names)
    if names[-1] != "model":
        raise ValueError(f"mesh {names} does not end in a \"model\" axis")
    return len(names) - 1


def model_size(mesh) -> int:
    return mesh.size(model_dim(mesh))


def model_rank(mesh) -> int:
    return mesh.get_local_rank("model")


def on_model(placements, p) -> tuple:
    """`placements` with the "model" (last) entry replaced by `p`."""
    return (*placements[:-1], p)


def split(t) -> bool:
    """Whether DTensor `t` is split (sharded) over "model"."""
    return isinstance(t.placements[model_dim(t.device_mesh)], Shard)


def stream(mesh, batch: int) -> tuple:
    """Placements of an activation with `batch` rows: Shard(0) over the
    batch axes (every axis but "model") where their product divides
    `batch`, else Replicate (the dryrun's `sanitize` rule); Replicate on
    "model"."""
    names = list(mesh.mesh_dim_names)
    axes = [i for i, n in enumerate(names) if n != "model"]
    shard = batch % math.prod(mesh.size(i) for i in axes) == 0
    return tuple(Shard(0) if i in axes and shard else Replicate()
                 for i in range(len(names)))


def place_batch(t, mesh):
    """An input every rank holds whole (tokens, frames, patches), split
    on its batch by `stream` and replicated on "model": each rank keeps
    its shard and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, stream(mesh, t.shape[0]),
                             src_data_rank=None)


def _grad_placements(pl, outs) -> tuple:
    return tuple(
        Partial() if isinstance(p, Replicate) and any(
            not isinstance(o[i], Replicate) for o in outs)
        else p for i, p in enumerate(pl))


def local(fn, out, *args):
    """fn(*args with each DTensor replaced by its local shard) -> DTensor
    outputs placed by `out`: one placements tuple (one output) or a list
    of them (one per output). The inputs keep their placements (a
    mismatch is the caller's to state with `redistribute`); their
    gradients are placed by `_grad_placements`, which holds where every
    output reads every input alike: a function whose outputs are placed
    apart and read apart is split into one call per group of outputs."""
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree
    outs = out if isinstance(out, list) else [out]
    flat, _ = pytree.tree_flatten(args)
    ins = tuple(a.placements if isinstance(a, DTensor) else None
                for a in flat)
    grads = tuple(None if p is None else _grad_placements(p, outs)
                  for p in ins)
    out_pl = tuple(list(o) for o in outs) if isinstance(out, list) \
        else list(out)
    return local_map(fn, out_placements=out_pl, in_placements=ins,
                     in_grad_placements=grads)(*args)


def _c10d_transport(t) -> bool:
    """Whether `t`'s collectives go as c10d ops: CUDA tensors on a gloo
    group. Gloo carries CUDA tensors through its c10d ops, while the
    functional collectives DTensor issues crash there (a segfault in
    `_c10d_functional.all_gather_into_tensor`, torch 2.11 on an H100);
    this path is forward only."""
    if t.device.type != "cuda":
        return False
    import torch.distributed as dist
    return dist.get_backend(t.device_mesh.get_group(0)) == "gloo"


def _c10d_redistribute(t, placements):
    """`redistribute` by c10d ops, one mesh dimension at a time: Partial
    -> Replicate by `all_reduce`, Shard(d) -> Replicate by
    `all_gather_into_tensor`, Replicate -> Shard by a local chunk."""
    import torch.distributed as dist
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("the c10d transport of gloo on CUDA is forward "
                           "only")
    mesh = t.device_mesh
    x, cur = t.to_local(), list(t.placements)
    for i, (src, dst) in enumerate(zip(t.placements, placements)):
        if src == dst:
            continue
        group, n = mesh.get_group(i), mesh.size(i)
        if isinstance(src, Partial) and isinstance(dst, Replicate):
            op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[
                src.reduce_op]
            x = x.clone()
            dist.all_reduce(x, op=op, group=group)
        elif isinstance(src, Shard) and isinstance(dst, Replicate):
            part = x.movedim(src.dim, 0).contiguous()
            out = part.new_empty((n * part.shape[0], *part.shape[1:]))
            dist.all_gather_into_tensor(out, part, group=group)
            x = out.movedim(0, src.dim)
        elif isinstance(src, Replicate) and isinstance(dst, Shard):
            x = x.chunk(n, dim=dst.dim)[mesh.get_local_rank(i)]
        else:
            raise NotImplementedError(f"{src} -> {dst} on the c10d "
                                      "transport")
        cur[i] = dst
    return DTensor.from_local(x, mesh, tuple(cur), run_check=False)


def redistribute(t, placements):
    """`t` laid out by `placements` (DTensor's `redistribute`; on CUDA
    tensors of a gloo group, the same collectives as c10d ops)."""
    placements = tuple(placements)
    if t.placements == placements:
        return t
    if _c10d_transport(t):
        return _c10d_redistribute(t, placements)
    return t.redistribute(t.device_mesh, placements)


def gather(t):
    """`t` Replicate on "model" (one all-gather where it is split)."""
    if not split(t):
        return t
    return redistribute(t, on_model(t.placements, Replicate()))


def chunk(t):
    """`t` split on its last dimension over "model" (a local chunk of a
    replicated tensor: no communication)."""
    if split(t):
        return t
    return redistribute(t, on_model(t.placements, Shard(t.ndim - 1)))


def col_out(x, w) -> tuple:
    """Placements of a column-parallel product of x (replicated on
    "model") and w: split on its last dimension where w is split over
    "model" (by columns, or a tied table by rows), else Replicate."""
    return on_model(x.placements, Shard(x.ndim - 1) if split(w)
                    else Replicate())


def col(x, w, b=None):
    """Column-parallel x @ w (+ b): x replicated on "model", each rank's
    columns of w give its columns of the output (Shard(-1)); the whole
    output where w is replicated on "model"."""
    def f(x, w, b):
        y = x @ w
        return y if b is None else y + b
    return local(f, col_out(x, w), x, w, b)


def embed(table, ids):
    """Rows `ids` of a vocabulary-split table (V, D): each rank looks up
    the ids in its range (zeros elsewhere) and one all-reduce sums them
    over "model"; a replicated table is read locally."""
    if not split(table):
        return local(lambda t, i: t[i], ids.placements, table, ids)
    r = model_rank(ids.device_mesh)

    def look(t, i):
        v = t.shape[0]
        off = i - r * v
        mine = (off >= 0) & (off < v)
        e = t[off.clamp(0, v - 1)]
        return torch.where(mine[..., None], e, torch.zeros_like(e))
    e = local(look, on_model(ids.placements, Partial()), table, ids)
    return redistribute(e, ids.placements)


def row(h, w, b=None):
    """Row-parallel h @ w (+ b): h split on its last dimension, w on its
    first; the partial products are summed over "model" by one all-reduce
    (Partial -> Replicate). A replicated h is chunked locally first; a
    replicated w (its rows not divisible) takes h gathered instead."""
    mesh = h.device_mesh
    if split(w):
        h = chunk(h)
        y = local(torch.matmul, on_model(h.placements, Partial()), h, w)
        y = redistribute(y, on_model(h.placements, Replicate()))
    else:
        h = gather(h)
        y = local(torch.matmul, h.placements, h, w)
    if b is not None:
        y = local(torch.add, y.placements, y, b)
    return y


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How one attention layer splits its heads over "model" (module
    docstring). `heads` / `kv_heads`: the query and K/V heads the rank's
    attention core sees; `kv_index`: the K/V heads it keeps of all of
    them, in the order its query heads' groups read them: each once where
    the rank's query heads fall in whole groups, else one per query head
    (None where the K/V projection is split by whole heads, or where
    every rank computes every head)."""
    q_split: bool
    kv_split: bool
    heads: int
    kv_heads: int
    kv_index: Optional[Tuple[int, ...]] = None

    def cfg(self, cfg):
        """`cfg` with the rank's head counts (what the plain attention
        functions reshape by)."""
        return dataclasses.replace(cfg, num_heads=self.heads,
                                   num_kv_heads=self.kv_heads,
                                   head_dim=cfg.resolved_head_dim)

    def take_kv(self, k):
        """The rank's K/V heads of (B, S, KV, dh) `k`, by a local index
        (no communication)."""
        if self.kv_index is None:
            return k
        return k.index_select(2, torch.tensor(self.kv_index,
                                              device=k.device))


def head_plan(cfg, wq, wk) -> HeadPlan:
    """The head rule for a layer whose projections are `wq`, `wk`
    (DTensors)."""
    mesh = wq.device_mesh
    n, r = model_size(mesh), model_rank(mesh)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if not (split(wq) and h % n == 0):
        return HeadPlan(False, False, h, kv)
    hl = h // n
    if split(wk) and kv % n == 0:
        return HeadPlan(True, True, hl, kv // n)
    g = h // kv
    idx = tuple((r * hl + j) // g for j in range(hl))
    kept = tuple(sorted(set(idx)))
    if all(idx.count(i) == hl // len(kept) for i in kept):
        idx = kept                       # whole groups: GQA on the rank
    return HeadPlan(True, False, hl, len(idx), kv_index=idx)


def heads_placement(x, split_heads: bool) -> tuple:
    """Placements of a (B, S, H, dh) activation: Shard(2) over "model"
    where its heads are split, else Replicate."""
    return on_model(x.placements, Shard(2) if split_heads else Replicate())


def argmax(logits):
    """Greedy tokens (B,) of vocabulary-split (B, V) logits, first index
    on ties (`jnp.argmax`): each rank's (max, index) over its columns,
    then one all-gather of each over "model" and the first best."""
    mesh = logits.device_mesh
    if not split(logits):
        return local(lambda t: torch.argmax(t, dim=-1),
                     on_model(logits.placements, Replicate()), logits)
    r = model_rank(mesh)
    bdim = on_model(logits.placements, Shard(1))

    def best(t):
        v, i = torch.max(t, dim=-1)
        return v[:, None], (i + r * t.shape[-1])[:, None]
    vals, ids = local(best, [bdim, bdim], logits)
    vals, ids = gather(vals), gather(ids)

    def pick(v, i):
        top = v == v.max(dim=-1, keepdim=True).values
        return torch.where(top, i, torch.iinfo(i.dtype).max).min(-1).values
    return local(pick, on_model(logits.placements, Replicate()), vals, ids)


def cross_entropy(logits, labels):
    """Per-token NLL (B, S) f32 of vocabulary-split logits (B, S, V),
    without gathering them: the row max by one all-reduce (max) over
    "model", the sum of exp(x - max) and the label's logit by one
    all-reduce (sum) each. The max is a constant of the gradient, as in
    any stable log-softmax."""
    mesh = logits.device_mesh
    rows = on_model(logits.placements, Replicate())
    if not split(logits):
        def nll(t, y):
            logp = torch.log_softmax(t, dim=-1)
            return -torch.take_along_dim(logp, y[..., None].long(),
                                         dim=-1)[..., 0]
        return local(nll, rows, logits, labels)
    r = model_rank(mesh)
    m = local(lambda t: t.detach().amax(-1),
              on_model(rows, Partial("max")), logits)
    m = redistribute(m, rows)

    def parts(t, y, m):
        v = t.shape[-1]
        z = torch.exp(t - m[..., None]).sum(-1)
        off = y.long() - r * v
        mine = (off >= 0) & (off < v)
        pick = torch.take_along_dim(t, off.clamp(0, v - 1)[..., None],
                                    dim=-1)[..., 0]
        return z, torch.where(mine, pick, torch.zeros_like(pick))
    part = on_model(rows, Partial())
    z, tgt = local(parts, [part, part], logits, labels, m)
    z = redistribute(z, rows)
    tgt = redistribute(tgt, rows)
    return local(lambda z, t, m: m + torch.log(z) - t, rows, z, tgt, m)


def mean(t):
    """The mean of all of `t`'s entries, as a plain 0-d tensor holding
    the same value on every rank: the local mean over the number of
    shards, then one all-reduce (sum) over the axes that split `t` (the
    shards are even)."""
    mesh = t.device_mesh
    shards = math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                       if isinstance(p, Shard))
    parts = tuple(Partial() if isinstance(p, Shard) else p
                  for p in t.placements)
    m = local(lambda x: x.mean() / shards, parts, t)
    return redistribute(m, tuple(Replicate() for _ in parts)).to_local()


def global_norm(leaves):
    """sqrt of the sum of squares of DTensor leaves (gradients, each
    placed as its parameter): each rank's f32 sums over its shards, the
    sums of the leaves split over "model" added over it by one all-reduce
    (a replicated leaf counted once)."""
    mesh = leaves[0].device_mesh
    rep = tuple(Replicate() for _ in leaves[0].placements)
    zero = torch.zeros((), dtype=torch.float32,
                       device=leaves[0].to_local().device)
    sums = {True: zero, False: zero}
    for g in leaves:
        sums[split(g)] = sums[split(g)] + torch.sum(torch.square(
            g.to_local().to(torch.float32)))
    split_sum = DTensor.from_local(sums[True], mesh,
                                   on_model(rep, Partial()))
    total = redistribute(split_sum, rep).to_local() + sums[False]
    return torch.sqrt(total)
