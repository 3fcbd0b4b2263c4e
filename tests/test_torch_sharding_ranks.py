"""The port's sharding over spawned ranks on the CPU: `sharded_lsh_code`
and expert-parallel MoE at world 2 and 4, and the (2, 2) mesh's local
shards at world 4. Each world is one spawn (`launch.mesh.spawn_ranks`:
gloo on localhost, one intra-op thread a rank).

The ranks import neither JAX nor the JAX package; the parent computes
what they are held against:
* LSH: the sum of JAX's per-shard `jnp.dot(shard, rademacher_block(idx
  * n, n, bits, seed))`, sums within 1e-5 relative to |sum| + ||x||_2
  (gloo adds the ranks' partial sums in its own order, not `psum`'s),
  codes equal on every bit whose |sum| > 1e-3, the same code on every
  rank;
* MoE: the port's unsharded `apply_moe` on the same weights, output and
  load_balance within 1e-4, dropped_frac within 1e-6, for the FFN width
  sharded (grok-1 reduced, 4 experts) and the experts sharded (kimi-k2
  reduced, widened to 16 experts, top 8), each at a capacity where
  nothing drops and at one where slots drop (dropped_frac > 0);
* the (2, 2) ("data", "model") mesh: every local shard of reduced
  minitron's params, placed by `param_specs`, has its spec's division
  of the global shape and holds that block of the global tensor; both
  MoE layers with other tokens on each data row give each row the
  unsharded layer's output on its tokens (1e-4), and the aux values
  averaged over all four ranks (`aux_group`), as JAX's `pmean` over
  every mesh axis: the mean of the rows' unsharded values.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_ranks

SEED, BITS, N_TOTAL = 7, 128, 12_000
KIMI16 = {"num_experts": 16, "experts_per_token": 8}
# capacity factor 50: nothing can drop; 0.5: every expert's capacity is
# half its expected load, so each rank drops slots of its own experts
MOE_CASES = {"f_sharded": ("grok-1-314b", {"moe_capacity_factor": 50.0}),
             "e_sharded": ("kimi-k2-1t-a32b",
                           {**KIMI16, "moe_capacity_factor": 50.0}),
             "f_sharded_drops": ("grok-1-314b", {"moe_capacity_factor": 0.5}),
             "e_sharded_drops": ("kimi-k2-1t-a32b",
                                 {**KIMI16, "moe_capacity_factor": 0.5})}


def _moe_cfg(name):
    arch, changes = MOE_CASES[name]
    return dataclasses.replace(configs.get_config(arch).reduced(), **changes)


def _moe_weights(cfg, seed):
    from repro_torch.models import moe
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy((rs.randn(*s) / s[-2] ** 0.5).astype(
        np.float32)) for k, s in moe.moe_shapes(cfg).items()}


def _moe_x(cfg, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        2, 16, cfg.d_model).astype(np.float32))


def _rank_checks(rank, world, x):
    """One rank: its sharded LSH sums and code, both MoE layers on
    params and tokens placed on a (1, world) mesh (`moe_forward`'s
    expert-parallel path), and at world 4 the local
    shards of params placed on a (2, 2) mesh."""
    from repro_torch.core import lsh
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.sharding import local_shape, place, to_local, tp
    from repro_torch.tree import tree_paths
    out = {}
    n = x.shape[0] // world
    shard = torch.from_numpy(x[rank * n:(rank + 1) * n].copy())
    out["sums"] = lsh.sharded_lsh_sums(shard, SEED, BITS).numpy()
    out["code"] = lsh.sharded_lsh_code(shard, SEED, BITS).numpy()

    mesh = make_device_mesh((1, world), ("data", "model"))
    for name in MOE_CASES:
        cfg = _moe_cfg(name)
        placed = place(_moe_weights(cfg, 1), mesh, moe.moe_specs(cfg))
        got, aux = moe.moe_forward(cfg, placed,
                                   tp.place_batch(_moe_x(cfg, 2), mesh))
        out[name] = (got.to_local().numpy(), float(aux["load_balance"]),
                     float(aux["dropped_frac"]),
                     {k: tuple(v.shape) for k, v in
                      to_local(placed).items()})

    if world == 4:
        mesh22 = make_device_mesh((2, 2), ("data", "model"))
        cfg = configs.get_config("minitron-4b").reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0))
        specs = param_specs(cfg)                   # params: same everywhere
        placed = to_local(place(params, mesh22, specs))
        coord = dict(zip(mesh22.mesh_dim_names, mesh22.get_coordinate()))
        bad = []
        for (path, t), (_, s), (_, g) in zip(tree_paths(placed),
                                             tree_paths(specs),
                                             tree_paths(params)):
            want = tuple(n // 2 if ax else n for n, ax in
                         zip(g.shape, list(s) + [None] * g.ndim))
            assert local_shape(g.shape, s, mesh22) == want
            for d, ax in enumerate(s):
                if ax is not None:
                    g = g.narrow(d, coord[ax] * want[d], want[d])
            if tuple(t.shape) != want or not torch.equal(t, g):
                bad.append((path, tuple(t.shape), want))
        # MoE on the (2, 2) mesh: each data row its own tokens (the batch
        # split over "data"), experts or FFN width over "model", the aux
        # values averaged over all four
        for name in MOE_CASES:
            cfg = _moe_cfg(name)
            weights = place(_moe_weights(cfg, 1), mesh22, moe.moe_specs(cfg))
            x = torch.cat([_moe_x(cfg, 10 + row) for row in range(2)])
            got, aux = moe.moe_forward(cfg, weights,
                                       tp.place_batch(x, mesh22))
            out["mesh22_" + name] = (coord["data"], got.to_local().numpy(),
                                     float(aux["load_balance"]),
                                     float(aux["dropped_frac"]))
        out["mesh22_bad"] = bad
        out["mesh22_leaves"] = len(list(tree_paths(placed)))
    return out


def _jax_shard_sums(x, world):
    """The JAX package's sharded projection: per-shard dots with the
    shard's global rows, summed."""
    import jax.numpy as jnp
    from repro.kernels.lsh_projection import rademacher_block
    n = x.shape[0] // world
    parts = [np.asarray(jnp.dot(jnp.asarray(x[i * n:(i + 1) * n]),
                                rademacher_block(i * n, n, BITS, SEED)))
             for i in range(world)]
    return np.sum(parts, axis=0, dtype=np.float32)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_lsh_and_moe_over_ranks(world):
    from repro_torch.models import moe
    x = np.random.RandomState(world).randn(N_TOTAL).astype(np.float32)
    results = spawn_ranks(_rank_checks, world, x)

    want = _jax_shard_sums(x, world)
    firm = torch.from_numpy(np.abs(want) > 1e-3)
    code0 = results[0]["code"]
    for r in results:
        err = np.abs(r["sums"] - want)
        assert np.all(err <= 1e-5 * (np.abs(want) + np.linalg.norm(x)))
        assert np.array_equal(r["code"], code0)
    bits = ops.unpack_bits(torch.from_numpy(code0), BITS)
    assert torch.equal(bits[firm], (torch.from_numpy(want) > 0)[firm].to(
        bits.dtype))

    for name in MOE_CASES:
        cfg = _moe_cfg(name)
        p = _moe_weights(cfg, 1)
        plain, aux = moe.apply_moe(cfg, p, _moe_x(cfg, 2))
        e_sharded = cfg.num_experts >= moe.EXPERT_SHARD_MIN
        assert (float(aux["dropped_frac"]) > 0) == name.endswith("_drops")
        for r in results:
            got, lb, dropped, shapes = r[name]
            assert float(np.max(np.abs(got - plain.numpy()))) < 1e-4, name
            assert abs(lb - float(aux["load_balance"])) < 1e-4, name
            assert abs(dropped - float(aux["dropped_frac"])) < 1e-6, name
            # each rank held its slice, not the whole layer
            if e_sharded:
                assert shapes["wi"][0] == cfg.num_experts // world
            else:
                assert shapes["wi"][2] == cfg.d_ff // world

    if world == 4:
        for r in results:
            assert r["mesh22_bad"] == [] and r["mesh22_leaves"] > 10
        # on (2, 2): each data row's output is the unsharded layer's on its
        # tokens; the aux values the mean over the data rows (JAX's pmean
        # over every mesh axis)
        for name in MOE_CASES:
            cfg = _moe_cfg(name)
            p = _moe_weights(cfg, 1)
            plain = [moe.apply_moe(cfg, p, _moe_x(cfg, 10 + d))
                     for d in range(2)]
            lb = np.mean([float(a["load_balance"]) for _, a in plain])
            dropped = np.mean([float(a["dropped_frac"]) for _, a in plain])
            for r in results:
                d, got, got_lb, got_dropped = r["mesh22_" + name]
                assert float(np.max(np.abs(got - plain[d][0].numpy()))) \
                    < 1e-4, name
                assert abs(got_lb - lb) < 1e-4, name
                assert abs(got_dropped - dropped) < 1e-6, name
