"""Dry run on the production layout (the port of `repro/launch/dryrun.py`):
for each (architecture x input shape), what one device of the (16, 16)
or (2, 16, 16) mesh would hold and compute. It counts; it compiles and
allocates nothing: every tensor lies on the `meta` device (shapes and
dtypes, no storage), where the kernel wrappers take their plain versions
(`kernels.build.PLAIN_DEVICES`) because meta computes nothing.

For each (arch, shape) it reports:
  - bytes per device of the params, the AdamW state (train), the decode
    cache (decode) and the inputs, exactly, from the spec trees
    (`param_specs`, `sharding.opt_state_specs` / `cache_specs` /
    `train_batch_specs`) after `sanitize` (a dimension its axes do not
    divide is replicated, as in the JAX dryrun), in bf16 (`DTYPE`; AdamW
    keeps m and v in f32 and its step in int32);
  - `input_specs` and `model_flops` (6ND train, 2ND prefill, 2NB decode,
    N the active parameters), as the JAX dryrun has them;
  - the FLOPs of one step, counted by `torch.utils.flop_counter.
    FlopCounterMode` over the step on meta (train: loss, gradients,
    clipping and the AdamW update; prefill; one decode step), at 1 and at
    2 repetitions of the block pattern, and rebuilt as base + reps * body
    (body = count(2) - count(1)), the JAX dryrun's "scan2". The counter
    sees matrix products and attention (mm, bmm, addmm, baddbmm,
    convolution, SDPA), not elementwise work. The time loops whose trips
    grow with the sequence, xLSTM's sLSTM steps (S trips) and mLSTM
    chunks (S / 256), are rebuilt the same way: at each repetition count,
    from counts with one loop at two trips and every loop at one
    (`models.xlstm.cut_loops`), as count(1) + (trips - 1) * (count(2) -
    count(1)) per loop, which equals the step-by-step count exactly
    (`tests/test_torch_dryrun_loops.py`); a loop costs the same each
    trip. FLOPs per device are the global count over the mesh's devices:
    the partition is taken as even, and work a real partition would
    replicate is not seen;
  - roofline terms on one NVIDIA H100 SXM (NVIDIA's data sheet, as
    `chip_smoke.py` uses them): compute_s = FLOPs per device at the bf16
    tensor-core peak, memory_s = the bytes per device above read once
    over HBM (a lower bound: activations are not counted);
  - `collectives`: the collectives of one tensor-parallel step
    (`sharding.tp`: params placed by `param_specs` after `sanitize`,
    each placement of the forward stated), run on meta over a fake
    process group of the mesh's size (`fake_mesh`: backend "fake", this
    process as rank 0; a process group already running is set aside and
    restored). A `TorchDispatchMode` (`CollectiveCounter`) records each
    `_c10d_functional` collective DTensor issues and each c10d op issued
    directly, `wait_tensor` and `_wrap_tensor_autograd` left out:
    {"bytes_by_kind", "total_bytes", "num_collectives"} under JAX's kind
    names (`collective_stats`), bytes per device of each collective's
    result, as the JAX `collective_stats` counts HLO result shapes, and
    "bytes_by_axis" (the mesh axis of each collective's group). They are
    rebuilt from the counts at 1 and 2 pattern repetitions by the JAX
    dryrun's rule, base + (reps - 1) * max(count(2) - count(1), 0) per
    kind and per axis; `num_collectives` is rebuilt the same way (the
    collectives a whole-depth step issues), where the JAX dryrun reports
    the count of its one-repetition HLO. The time loops issue none, so
    they are counted cut to one trip. DTensor's collectives are not XLA's:
    GSPMD chooses its own (it may all-gather weights, fuse or combine
    collectives, or reduce-scatter where the port all-reduces), while the
    port issues exactly the redistributions its forward states and
    DTensor's autograd derives the backward's; a decode step's cache is
    made before the count, where JAX takes it as an input. No
    collective_s term is reported: the (16, 16) mesh spans more cards
    than one NVLink domain, and the port has no measured rate for it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
        --shape train_4k [--multi-pod] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, List

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, supports_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import xlstm
from repro_torch.models.transformer import (init_cache, meta_params,
                                            param_specs)
from repro_torch.optim import adamw
from repro_torch.sharding import (batch_axes, cache_specs, local_shape,
                                  opt_state_specs, place_params, sanitize,
                                  train_batch_specs)
from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                     make_train_step)
from repro_torch.tree import P, tree_leaves

# one NVIDIA H100 SXM (data sheet): dense bf16 tensor-core FLOP/s and HBM
# bytes/s, the constants of chip_smoke.py
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")



def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=DTYPE) -> Dict[str, torch.Tensor]:
    """Model inputs of the step at this shape (stubs included), on meta."""
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        specs = {"tokens": _meta((b,), torch.int32)}
    else:
        specs = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
    if cfg.is_encdec:
        specs["audio"] = _meta((b, cfg.encoder_seq_len, cfg.d_model), dtype)
    if cfg.vision_tokens:
        specs["vision"] = _meta((b, cfg.vision_tokens,
                                 cfg.vision_dim or cfg.d_model), dtype)
    return specs


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode),
    N = active params (MoE: routed only)."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token / seq


def device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of `tree` (tensors, e.g. on meta) laid out
    by `spec_tree` after `sanitize`."""
    specs = tree_leaves(sanitize(spec_tree, tree, mesh))
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(tree_leaves(tree), specs))


def _window_override(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return (cfg.serve_window if shape.name == "long_500k"
            and cfg.family == "dense" else 0)


def _decode_cache(cfg, params, shape, batch):
    win = _window_override(cfg, shape)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    cache_len = min(shape.seq_len, win) if win else shape.seq_len
    return init_cache(cfg, params, shape.global_batch, cache_len, DTYPE,
                      extra or None, window_override=win)


def step_flops(cfg: ModelConfig, shape: ShapeConfig, *,
               remat: str = "block") -> int:
    """FlopCounterMode's count of one step at this config's depth, on
    meta (the mesh plays no part: the global step)."""
    from torch.utils.flop_counter import FlopCounterMode
    params = meta_params(cfg, DTYPE)
    batch = input_specs(cfg, shape)
    win = _window_override(cfg, shape)
    if shape.mode == "train":
        opt = adamw(1e-4, weight_decay=0.1)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=remat)
        args = (params, state, batch)
    elif shape.mode == "prefill":
        step = make_prefill_step(cfg)
        args = (params, {k: v for k, v in batch.items() if k != "labels"})
    else:
        step = make_serve_step(cfg, window_override=win)
        cache = _decode_cache(cfg, params, shape, batch)
        args = (params, cache, batch["tokens"], shape.seq_len - 1)
    with FlopCounterMode(display=False) as counter:
        step(*args)
    return counter.get_total_flops()


def _with_reps(cfg: ModelConfig, reps: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=reps * len(cfg.block_pattern) + cfg.pattern_tail)


def loop_trips(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, int]:
    """The trips of each time loop of one step ({} in decode, one token):
    "slstm" S steps, "mlstm" S / MLSTM_CHUNK chunks (one chunk when S is
    not a multiple), for the block types the config has."""
    if shape.mode == "decode":
        return {}
    s, chunk = shape.seq_len, xlstm.MLSTM_CHUNK
    trips = {"S": ("slstm", s), "M": ("mlstm", s // chunk if s % chunk == 0
                                      else 1)}
    return dict(trips[t] for t in dict.fromkeys(cfg.block_pattern)
                if t in trips)


def _loops_rebuilt(cfg: ModelConfig, shape: ShapeConfig, trips, remat):
    """The step's count at this config's depth with every time loop
    rebuilt from one and two trips (`loop_trips`)."""
    one = {loop: 1 for loop in trips}
    with xlstm.cut_loops(**one):
        base = step_flops(cfg, shape, remat=remat)
    total = base
    for loop, n in trips.items():
        if n > 1:
            with xlstm.cut_loops(**{**one, loop: 2}):
                total += (n - 1) * (step_flops(cfg, shape, remat=remat)
                                    - base)
    return total


def counted_flops(cfg: ModelConfig, shape: ShapeConfig, *,
                  remat: str = "block") -> Dict[str, Any]:
    """The step's FLOPs at full depth, rebuilt from counts at 1 and 2
    pattern repetitions (base + reps * body); one count when the config
    has fewer than two repetitions. Each count rebuilds the time loops
    from one and two trips (`loop_trips`)."""
    trips = loop_trips(cfg, shape)
    reps = cfg.pattern_reps
    loops = {"counted_trips": [1, 2], "loop_trips": trips} if trips else {}
    if reps < 2:
        total = _loops_rebuilt(cfg, shape, trips, remat)
        return {"flops": float(total), "counted_reps": [reps], **loops}
    one = _loops_rebuilt(_with_reps(cfg, 1), shape, trips, remat)
    two = _loops_rebuilt(_with_reps(cfg, 2), shape, trips, remat)
    body = two - one
    return {"flops": float(one + (reps - 1) * body),
            "body_flops": float(body), "base_flops": float(one - body),
            "counted_reps": [1, 2], **loops}


# ---------------------------------------------------------------------------
# collectives: the tensor-parallel step counted on a fake process group
# ---------------------------------------------------------------------------
# JAX's HLO kind of each collective op, functional (what DTensor issues)
# or c10d (issued directly, as `tp.redistribute`'s transport for gloo
# groups of CUDA tensors);
# `wait_tensor` and `_wrap_tensor_autograd` move no data
KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _group_name(args) -> str:
    """The group of a functional collective (its name, a str argument)
    or of a c10d op (its ProcessGroup, a ScriptObject argument)."""
    for a in args:
        if isinstance(a, str) and a not in ("sum", "avg", "max", "min",
                                            "product"):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return torch.distributed.ProcessGroup.unbox(a).group_name
            except (AttributeError, RuntimeError, TypeError):
                continue
    return ""


class CollectiveCounter:
    """A `TorchDispatchMode` (made on `__enter__`) that records every
    collective issued under it: one record {"kind", "bytes", "axis"} per
    op, `bytes` those of its result on this device (the HLO result shapes
    JAX's `collective_stats` counts), `axis` the mesh axis of its group
    (`axes`: group name -> axis name)."""

    def __init__(self, axes: Dict[str, str]):
        self.axes = axes
        self.records: List[Dict[str, Any]] = []

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils import _pytree as pytree
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                kind = KINDS.get(func.__name__.split(".")[0])
                if func.namespace in _COLLECTIVE_NS and kind:
                    leaves = [t for t in pytree.tree_leaves(out)
                              if isinstance(t, torch.Tensor)]
                    counter.records.append({
                        "kind": kind,
                        "bytes": sum(t.numel() * t.element_size()
                                     for t in leaves),
                        "axis": counter.axes.get(_group_name(args), "?")})
                return out
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def collective_stats(records) -> Dict[str, Any]:
    """Per-device collective bytes by kind, the JAX `collective_stats`
    dict, from `CollectiveCounter` records (each {"kind", "bytes"})."""
    per_kind: Dict[str, float] = {}
    for r in records:
        per_kind[r["kind"]] = per_kind.get(r["kind"], 0) + r["bytes"]
    return {"bytes_by_kind": per_kind,
            "total_bytes": sum(per_kind.values()),
            "num_collectives": len(records)}


@contextlib.contextmanager
def fake_mesh(layout):
    """A `DeviceMesh` of `layout`'s shape and names over a fake process
    group (backend "fake": no ranks, no storage; this process plays rank
    0 and every collective returns at once). A process group already
    running is set aside while it lives and restored after, with every
    group made here destroyed."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    saved = c10d._world.default_pg
    before = set(c10d._world.pg_map)
    c10d._world.default_pg = None
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=layout.size())
        yield init_device_mesh("cpu", tuple(layout.shape),
                               mesh_dim_names=tuple(layout.mesh_dim_names))
    finally:
        _clear_sharding_cache()
        c10d._world.default_pg = saved
        for pg in [g for g in list(c10d._world.pg_map) if g not in before]:
            dist.destroy_process_group(pg)


def _clear_sharding_cache() -> None:
    """Empty DTensor's sharding caches: the Python ones and, where this
    torch has it, the native dispatch path's."""
    from torch.distributed.tensor import DTensor
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        clear = getattr(getattr(prop, name, None), "cache_clear", None)
        if clear is not None:
            clear()


def _mesh_axes(mesh) -> Dict[str, str]:
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     remat: str = "block") -> List[Dict[str, Any]]:
    """The collectives of one tensor-parallel step on `mesh` (a
    `fake_mesh`), on meta: params laid out by `place_params`, the step as
    `step_flops` builds it (a decode step's cache made beforehand, not
    counted). The time loops issue none (xLSTM's blocks are replicated),
    so they run cut to one trip."""
    params = place_params(cfg, meta_params(cfg, DTYPE), mesh)
    batch = input_specs(cfg, shape)
    win = _window_override(cfg, shape)
    if shape.mode == "train":
        opt = adamw(1e-4, weight_decay=0.1)
        args = (params, opt.init(params), batch)
        step = make_train_step(cfg, opt, remat=remat)
    elif shape.mode == "prefill":
        step = make_prefill_step(cfg)
        args = (params, {k: v for k, v in batch.items() if k != "labels"})
    else:
        step = make_serve_step(cfg, window_override=win)
        args = (params, _decode_cache(cfg, params, shape, batch),
                batch["tokens"], shape.seq_len - 1)
    with xlstm.cut_loops(slstm=1, mlstm=1), \
            CollectiveCounter(_mesh_axes(mesh)) as counter:
        step(*args)
    return counter.records


def _by_axis(records) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in records:
        out[r["axis"]] = out.get(r["axis"], 0) + r["bytes"]
    return out


def counted_collectives(cfg: ModelConfig, shape: ShapeConfig, layout, *,
                        remat: str = "block") -> Dict[str, Any]:
    """`collective_stats` of the whole-depth step, rebuilt from counts at
    1 and 2 pattern repetitions by the JAX dryrun's rule, base + (reps -
    1) * max(body, 0) for each kind, the bytes by mesh axis and the
    number of collectives alike (one count below two repetitions)."""
    reps = cfg.pattern_reps
    with fake_mesh(layout) as mesh:
        if reps < 2:
            recs = step_collectives(cfg, shape, mesh, remat=remat)
            return {**collective_stats(recs), "bytes_by_axis":
                    _by_axis(recs), "counted_reps": [reps]}
        one = step_collectives(_with_reps(cfg, 1), shape, mesh, remat=remat)
        two = step_collectives(_with_reps(cfg, 2), shape, mesh, remat=remat)

    def corr(a, b):
        return a + max(reps - 1, 0) * max(b - a, 0)

    def rebuilt(f):
        c1, c2 = f(one), f(two)
        return {k: corr(c1.get(k, 0), c2.get(k, 0))
                for k in sorted(set(c1) | set(c2))}
    by_kind = rebuilt(lambda r: collective_stats(r)["bytes_by_kind"])
    return {"bytes_by_kind": by_kind, "total_bytes": sum(by_kind.values()),
            "num_collectives": corr(len(one), len(two)),
            "bytes_by_axis": rebuilt(_by_axis), "counted_reps": [1, 2]}


def memory_per_device(cfg: ModelConfig, shape: ShapeConfig,
                      mesh) -> Dict[str, int]:
    """Bytes per device of params, optimizer state (train), decode cache
    (decode) and inputs, from the spec trees on `mesh`."""
    params = meta_params(cfg, DTYPE)
    out = {"params": device_bytes(params, param_specs(cfg), mesh)}
    batch = input_specs(cfg, shape)
    if shape.mode == "train":
        state = adamw(1e-4, weight_decay=0.1).init(params)
        out["optimizer"] = device_bytes(state, opt_state_specs(cfg), mesh)
    if shape.mode == "decode":
        cache = _decode_cache(cfg, params, shape, batch)
        out["cache"] = device_bytes(cache, cache_specs(cfg, mesh), mesh)
        in_specs = {"tokens": P(batch_axes(mesh))}
    else:
        in_specs = train_batch_specs(cfg, mesh)
    in_specs = {k: v for k, v in in_specs.items() if k in batch}
    out["inputs"] = device_bytes({k: batch[k] for k in in_specs}, in_specs,
                                 mesh)
    out["total"] = sum(out.values())
    return out


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               remat: str = "block", verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    t0 = time.time()
    mem = memory_per_device(cfg, shape, mesh)
    counts = counted_flops(cfg, shape, remat=remat)
    coll = counted_collectives(cfg, shape, mesh, remat=remat)
    flops = counts["flops"] / chips
    mf = model_flops(cfg, shape)
    terms = {"compute_s": flops / BF16_FLOP_PER_S,
             "memory_s": mem["total"] / HBM_BYTES_PER_S}
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)), "chips": chips,
        "remat": remat, "device": "meta",
        "window_override": _window_override(cfg, shape),
        "wall_s": round(time.time() - t0, 1),
        "bytes_per_device": mem,
        "flops_per_device": flops, **counts,
        "collectives": coll,
        "roofline": {**terms, "dominant": max(terms, key=terms.get),
                     "hardware": "NVIDIA H100 SXM (data sheet peaks)",
                     "model_flops": mf,
                     "useful_flop_frac": mf / counts["flops"]
                     if counts["flops"] else 0.0},
    }
    if verbose:
        print(json.dumps(result, indent=1, default=str), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="block", choices=["none", "block"])
    ap.add_argument("--json", default=None, help="write results to file")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    results = []
    for a, s in combos:
        layout = "2x16x16" if args.multi_pod else "16x16"
        print(f"=== dryrun {a} x {s} ({layout}, meta) ===", flush=True)
        try:
            results.append(dryrun_one(a, s, multi_pod=args.multi_pod,
                                      remat=args.remat))
        except Exception as e:       # one combo's failure is its result
            results.append({"arch": a, "shape": s, "error": repr(e)})
            traceback.print_exc()
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1, default=str)
    n_err = sum("error" in r for r in results)
    print(f"\n{len(results)} combos: {n_err} errors, "
          f"{sum('skipped' in r for r in results)} skipped")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
