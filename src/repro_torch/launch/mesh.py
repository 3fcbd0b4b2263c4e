"""Meshes (the port of `repro/launch/mesh.py`) and the ranks that run on
them.

Every mesh is made by a function, never at import, as in the JAX
package: importing this module starts no process group.

- `make_production_mesh`: the JAX package's production layouts, one pod
  (16, 16) ("data", "model") or two (2, 16, 16) ("pod", "data",
  "model"), as an abstract `MeshLayout` (shape and names, no processes),
  which the dryrun counts against.
- `make_host_mesh`: a (1, 1) ("data", "model") `DeviceMesh` of this
  process, starting a one-rank process group if none is running (gloo
  for the CPU, NCCL for a card); the caller destroys it
  (`torch.distributed.destroy_process_group`).
- `make_device_mesh`: `init_device_mesh` over a process group that is
  already running.
- `spawn_ranks`: runs a function on `world` fresh processes, each a rank
  of a gloo process group on this host, and returns their results.

Nothing tells a program of a cluster here, so a process group gets its
rendezvous, world size and rank explicitly: `spawn_ranks` meets its ranks
at a file in a fresh temporary directory (no port to race for).
"""
from __future__ import annotations

import math
import os
import pickle
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

HOST_AXES = ("data", "model")


@dataclass(frozen=True)
class MeshLayout:
    """An abstract mesh: axis sizes and names, with `DeviceMesh`'s
    attribute names, and no processes behind it."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `MeshLayout` or a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """One pod: (data=16, model=16). Two pods: (pod=2, data=16,
    model=16)."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), HOST_AXES)


def make_device_mesh(shape: Sequence[int], names: Sequence[str],
                     device="cpu"):
    """A `DeviceMesh` of the running process group (its world size is
    the product of `shape`), on `device`'s type."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs a running process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_host_mesh(device="cpu"):
    """A (1, 1) ("data", "model") mesh of this process alone."""
    if not dist.is_initialized():
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_device_mesh((1, 1), HOST_AXES, device)


def _rank_main(rank: int, fn: Callable, world: int, outdir: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn: Callable, world: int, *args: Any) -> List[Any]:
    """[fn(rank, world, *args) for each rank], each run in its own
    process (started by `spawn`, one intra-op thread) as a rank of a gloo
    process group of `world` ranks, which is destroyed when fn returns.
    `fn` and `args` must pickle (`fn` a module-level function). A rank
    that raises makes this raise (`torch.multiprocessing.
    ProcessRaisedException`); every process has ended when it returns."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(_rank_main, args=(fn, world, outdir, args), nprocs=world,
                 join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(outdir, f"{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
