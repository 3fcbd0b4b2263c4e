"""The port's sharding held against the JAX package's on the CPU, in one
process: spec trees (`param_specs`, `sharding.opt_state_specs`,
`cache_specs`), specs bound on a (1, 1) gloo mesh, `sharded_lsh_code` at
world 1, the row offset of the LSH plain version, grouped and
expert-parallel MoE dispatch at world 1, and the dryrun's helpers.

Tolerances:
* spec trees: equal leaf for leaf (`tuple(P_jax) == tuple(P_port)`) and
  the structure of the port's own params, optimizer state and cache;
* the (1, 1) mesh: logits bitwise equal to the unplaced port forward,
  and within rtol 1e-4, atol 1e-4 of the JAX forward (f32 GEMMs in
  another order, as `tests/test_torch_lm.py` holds them);
* LSH: sums within 1e-5 relative to |sum| + the shard's L2 norm (f32
  summation order), codes equal on every bit whose |sum| > 1e-3, the
  Rademacher rows equal exactly (across the 2^32 wrap);
* MoE: outputs within 1e-4 (1e-5 for G = 4 against G = 1), load_balance
  within 1e-4, positions in expert equal;
* dryrun: `sanitize`, `input_specs` and `model_flops` equal.

Ranks beyond one: `tests/test_torch_sharding_ranks.py`.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from jax.sharding import PartitionSpec as JP
from repro import configs as jconfigs
from repro.compat import shard_map as jshard_map
from repro.core import lsh as jlsh
from repro.kernels.lsh_projection import rademacher_block as j_rademacher
from repro.launch import dryrun as jdr
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import forward as jforward
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro.models.transformer import param_specs as j_param_specs
from repro.sharding import cache_specs as j_cache_specs
from repro.sharding import opt_state_specs as j_opt_state_specs

from repro_torch import configs
from repro_torch.core import lsh
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, mesh as pmesh
from repro_torch.models import moe
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.transformer import (forward, init_cache, meta_params,
                                            param_specs)
from repro_torch.optim import adamw
from repro_torch.sharding import (cache_specs, local_shape, named,
                                  opt_state_specs, place, sanitize, to_local,
                                  tp)
from repro_torch.tree import P, tree_leaves, tree_map, tree_paths


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def host_mesh():
    """The port's (1, 1) mesh over a one-rank gloo group, torn down after
    the module."""
    m = pmesh.make_host_mesh()
    yield m
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _reset_moe():
    yield
    moe.set_dispatch_spec(1)
    jmoe.set_sharded_impl(None)
    jmoe.set_dispatch_spec(None, num_groups=1)


def _jax_spec_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_spec_leaves(tree):
    leaves = tree_leaves(tree)
    assert all(isinstance(s, P) for s in leaves)
    return [tuple(s) for s in leaves]


def _same_structure(specs, tree):
    """Spec tree and tensor tree have the same paths; each spec's rank is
    at most its leaf's."""
    sp, tp = list(tree_paths(specs)), list(tree_paths(tree))
    assert [p for p, _ in sp] == [p for p, _ in tp]
    for (path, s), (_, t) in zip(sp, tp):
        assert len(s) <= t.ndim, (path, s, tuple(t.shape))


def _extra(cfg, b=2):
    if cfg.is_encdec:
        return {"audio": torch.zeros((b, cfg.encoder_seq_len, cfg.d_model),
                                     device="meta")}
    if cfg.vision_tokens:
        return {"vision": torch.zeros((b, cfg.vision_tokens, cfg.vision_dim),
                                      device="meta")}
    return None


# ---------------------------------------------------------------------------
# spec trees, leaf for leaf against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_param_specs_mirror_params_and_jax(arch):
    cfg = configs.get_config(arch).reduced()
    specs = param_specs(cfg)
    _same_structure(specs, meta_params(cfg))
    want = j_param_specs(jconfigs.get_config(arch).reduced())
    assert _port_spec_leaves(specs) == _jax_spec_leaves(want)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_opt_specs_mirror_state_and_jax(arch):
    cfg = configs.get_config(arch).reduced()
    specs = opt_state_specs(cfg)
    _same_structure(specs, adamw(1e-3).init(meta_params(cfg)))
    want = j_opt_state_specs(jconfigs.get_config(arch).reduced())
    assert _port_spec_leaves(specs) == _jax_spec_leaves(want)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_cache_specs_mirror_cache_and_jax(arch):
    cfg = configs.get_config(arch).reduced()
    layout = pmesh.MeshLayout((1, 1), ("data", "model"))
    specs = cache_specs(cfg, layout)
    cache = init_cache(cfg, meta_params(cfg), 2, 8, extra=_extra(cfg))
    _same_structure(specs, cache)
    want = j_cache_specs(jconfigs.get_config(arch).reduced(), j_host_mesh())
    assert _port_spec_leaves(specs) == _jax_spec_leaves(want)


def test_multi_pod_batch_axes_and_production_layouts():
    one, two = (pmesh.make_production_mesh(multi_pod=m) for m in (0, 1))
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert two.size() == 512
    cfg = configs.get_config("whisper-small").reduced()
    specs = cache_specs(cfg, two)
    assert tree_leaves(specs)[0][1] == ("pod", "data")   # after (reps,)
    fake = types.SimpleNamespace(axis_names=("pod", "data", "model"))
    want = j_cache_specs(jconfigs.get_config("whisper-small").reduced(), fake)
    assert _port_spec_leaves(specs) == _jax_spec_leaves(want)


def test_local_shapes_and_placements_follow_the_spec():
    layout = pmesh.make_production_mesh(multi_pod=True)
    assert local_shape((64, 32, 8), P(("pod", "data"), "model"),
                       layout) == (2, 2, 8)
    with pytest.raises(ValueError, match="does not divide"):
        local_shape((51_865, 64), P("model", None), layout)
    from torch.distributed.tensor import Replicate, Shard
    assert named(layout, {"w": P(None, ("pod", "data"))})["w"] == (
        Shard(1), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        named(layout, P(("data", "pod")))


# ---------------------------------------------------------------------------
# specs bind on a (1, 1) gloo mesh
# ---------------------------------------------------------------------------
def test_specs_bind_on_host_mesh(host_mesh):
    """Reduced phi3's params placed by `param_specs` (DTensors on the
    (1, 1) mesh) give the unplaced forward's logits bit for bit, and the
    JAX forward's within tolerance: the port's counterpart of the JAX
    `test_specs_bind_on_mesh`."""
    arch = "phi3-medium-14b"
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    placed = place(params, host_mesh, param_specs(cfg))
    from torch.distributed.tensor import DTensor
    assert all(isinstance(t, DTensor) for t in tree_leaves(placed))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    got, _ = forward(cfg, to_local(placed), torch.from_numpy(tokens))
    plain, _ = forward(cfg, params, torch.from_numpy(tokens))
    assert got.shape == (2, 8, cfg.vocab_size)
    assert torch.equal(got, plain)
    want, _ = jforward(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_place_keeps_the_divisibility_rule(host_mesh):
    with pytest.raises(ValueError, match="more entries"):
        place({"w": torch.zeros(3)}, host_mesh, {"w": P(None, "model")})


# ---------------------------------------------------------------------------
# sharded LSH codes
# ---------------------------------------------------------------------------
def _close_sums(got, want, x_norm):
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 * (np.abs(want) + x_norm)), err.max()


def _codes_agree(got_code, want_code, sums, bits):
    """Codes equal on every bit whose |sum| > 1e-3."""
    g, w = (ops.unpack_bits(torch.from_numpy(np.array(c).view(np.int32)),
                            bits) for c in (got_code, want_code))
    firm = torch.as_tensor(np.abs(np.asarray(sums)) > 1e-3)
    assert torch.equal(g[firm], w[firm])


@pytest.mark.parametrize("n", [4096, 5000])
def test_sharded_lsh_code_at_world_1_matches_jax(host_mesh, n):
    """World 1 against the JAX `sharded_lsh_code` under shard_map on a
    one-device mesh, as `tests/test_protocol_properties.py` runs it; a
    length that is no CHUNK multiple pads with zeros."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    seed, bits = 7, 128
    jm = jax.make_mesh((1,), ("model",))
    fn = jshard_map(lambda v: jlsh.sharded_lsh_code(v, seed, bits, "model"),
                    mesh=jm, in_specs=JP("model"), out_specs=JP(),
                    check_vma=False)
    want_code = np.asarray(fn(jnp.asarray(x)))
    want_sums = np.asarray(jnp.dot(jnp.asarray(x),
                                   j_rademacher(0, n, bits, seed)))
    group = host_mesh.get_group("model")
    sums = lsh.sharded_lsh_sums(torch.from_numpy(x), seed, bits, group)
    code = lsh.sharded_lsh_code(torch.from_numpy(x), seed, bits, group)
    _close_sums(_np(sums), want_sums, np.linalg.norm(x))
    assert torch.equal(code, ops.pack_bits(sums))
    _codes_agree(_np(code), want_code, want_sums, bits)


@pytest.mark.parametrize("offset", [2 ** 32 - 3000, 2 ** 31 + 17, 123_456])
def test_row_offset_matches_jax_rademacher_block_across_the_wrap(offset):
    n, bits, seed = 4096, 64, 11
    r = ops.rademacher_block(offset, n, bits, seed)
    want_r = np.asarray(j_rademacher(offset, n, bits, seed))
    assert np.array_equal(_np(r), want_r)
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    got = ref.lsh_project_sums_ref(torch.from_numpy(x), seed, bits=bits,
                                   row_offset=offset)
    want = x @ want_r
    _close_sums(_np(got), want, np.linalg.norm(x))
    order = ref.lsh_project_sums_split_order(
        torch.from_numpy(x)[None], seed, bits=bits, chunk=2048,
        row_offset=offset)[0]
    _close_sums(_np(order), want, np.linalg.norm(x))
    # the offset is mod 2^32: 2^32 + offset hashes the same rows
    assert torch.equal(ref.lsh_project_sums_ref(
        torch.from_numpy(x), seed, bits=bits, row_offset=2 ** 32 + offset),
        got)


# ---------------------------------------------------------------------------
# MoE: grouped dispatch, expert parallelism at world 1, positions
# ---------------------------------------------------------------------------
def _moe_layer(arch, changes, seed):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               **changes)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **changes)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, pp


def test_grouped_dispatch_matches_one_group_and_jax():
    jcfg, cfg, jp, pp = _moe_layer("grok-1-314b",
                                   {"moe_capacity_factor": 50.0}, 2)
    x = np.random.RandomState(3).randn(4, 32, cfg.d_model).astype(np.float32)
    o1, a1 = moe.apply_moe(cfg, pp, torch.from_numpy(x))
    moe.set_dispatch_spec(4)
    o4, a4 = moe.apply_moe(cfg, pp, torch.from_numpy(x))
    jmoe.set_dispatch_spec(None, num_groups=4)
    want, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    assert float((o1 - o4).abs().max()) < 1e-5
    np.testing.assert_allclose(_np(o4), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for key in ("load_balance", "dropped_frac"):
        assert abs(float(a4[key]) - float(jaux[key])) < 1e-4, key


def test_grouped_dispatch_drops_per_group_as_jax():
    """At a small capacity each group drops on its own, as in JAX."""
    jcfg, cfg, jp, pp = _moe_layer("grok-1-314b",
                                   {"moe_capacity_factor": 0.5}, 4)
    x = np.random.RandomState(5).randn(4, 16, cfg.d_model).astype(np.float32)
    moe.set_dispatch_spec(4)
    jmoe.set_dispatch_spec(None, num_groups=4)
    got, aux = moe.apply_moe(cfg, pp, torch.from_numpy(x))
    want, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert float(aux["dropped_frac"]) > 0.1
    assert abs(float(aux["dropped_frac"])
               - float(jaux["dropped_frac"])) < 1e-6


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_sharded_moe_at_world_1_matches_jax(host_mesh, arch):
    """The expert-parallel path (params and tokens placed on the (1, 1)
    mesh) against the JAX `moe_forward` under
    `set_sharded_impl(make_host_mesh())`, as `tests/test_perf_features.py`
    holds the JAX path to its global one."""
    jcfg, cfg, jp, pp = _moe_layer(arch, {"moe_capacity_factor": 50.0}, 0)
    x = np.random.RandomState(1).randn(2, 32, cfg.d_model).astype(np.float32)
    jm = j_host_mesh()
    jmoe.set_sharded_impl(jm, batch_axes=("data",))
    with jm:
        want, jaux = jax.jit(lambda p_, x_: jmoe.moe_forward(jcfg, p_, x_))(
            jp, jnp.asarray(x))
    got, aux = moe.moe_forward(
        cfg, place(pp, host_mesh, moe.moe_specs(cfg)),
        tp.place_batch(torch.from_numpy(x), host_mesh))
    got = got.to_local()
    assert float(np.max(np.abs(_np(got) - np.asarray(want)))) < 1e-4
    assert abs(float(aux["load_balance"])
               - float(jaux["load_balance"])) < 1e-4
    assert abs(float(aux["dropped_frac"])
               - float(jaux["dropped_frac"])) < 1e-6
    plain, _ = moe.moe_forward(cfg, pp, torch.from_numpy(x))
    assert float((got - plain).abs().max()) < 1e-5


@pytest.mark.parametrize("seed,e,n", [(0, 2, 16), (1, 7, 100), (2, 12, 300),
                                      (3, 384, 257)])
def test_position_in_expert_matches_jax(seed, e, n):
    fe = np.random.RandomState(seed).randint(0, e, n)
    want = np.asarray(jmoe._position_in_expert(jnp.asarray(fe, jnp.int32)))
    got = moe._position_in_expert(torch.from_numpy(fe))
    assert np.array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# the dryrun's helpers and one run on meta
# ---------------------------------------------------------------------------
def _jax_mesh(shape, names):
    """What the JAX `_sanitize` reads of a mesh, without 256 devices."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _sds(tree):
    return tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                   jnp.float32), tree)


@pytest.mark.parametrize("arch", ["whisper-small", "kimi-k2-1t-a32b",
                                  "recurrentgemma-2b"])
def test_sanitize_matches_jax_on_the_production_layout(arch):
    cfg = configs.get_config(arch)
    layout = pmesh.make_production_mesh()
    params = meta_params(cfg)
    got = sanitize(param_specs(cfg), params, layout)
    want = jdr._sanitize(j_param_specs(jconfigs.get_config(arch)),
                         _sds(params),
                         _jax_mesh((16, 16), ("data", "model")))
    assert _port_spec_leaves(got) == _jax_spec_leaves(want)
    if arch == "whisper-small":       # vocab 51,865 on 16: replicated
        assert got["embed"]["tok"] == P(None, None)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "whisper-small",
                                  "llama-3.2-vision-90b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_input_specs_and_model_flops_match_jax(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = dryrun.input_specs(cfg, configs.SHAPES[shape])
    want = jdr.input_specs(jcfg, jconfigs.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype)[6:] == str(v.dtype), k
    assert dryrun.model_flops(cfg, configs.SHAPES[shape]) == \
        jdr.model_flops(jcfg, jconfigs.SHAPES[shape])


def test_flops_rebuilt_from_two_depths_equal_the_direct_count():
    """base + reps * body from 1 and 2 repetitions gives the count of the
    whole depth (the JAX dryrun's scan2, here exact)."""
    cfg = dataclasses.replace(configs.get_config("minitron-4b").reduced(),
                              num_layers=5)
    small = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    counts = dryrun.counted_flops(cfg, small)
    assert counts["counted_reps"] == [1, 2]
    assert counts["flops"] == dryrun.step_flops(cfg, small)


def test_dryrun_one_on_meta_for_a_reduced_config(monkeypatch):
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: real(a).reduced())
    res = dryrun.dryrun_one("grok-1-314b", "decode_32k", verbose=False)
    cfg = real("grok-1-314b").reduced()
    assert res["chips"] == 256 and res["device"] == "meta"
    # the tensor-parallel decode step's collectives, from shapes: 8 rows a
    # data shard, bf16; 4 query / 1 K/V heads do not divide 16, so each
    # layer gathers q (256 columns) and k, v (64 each), all-reduces the
    # attention and MoE outputs (256) and the MoE aux pair (f32, once per
    # axis); one all-reduce of the embedding, and the greedy token's
    # (value f32, index int64) gathered over 16 ranks
    rows, d, kvd, layers = 8, 256, 64, 2
    gathers = layers * rows * (d + 2 * kvd) * 2 + rows * 16 * (4 + 8)
    reduces = rows * d * 2 + layers * (2 * rows * d * 2 + 2 * 2 * 4)
    assert res["collectives"]["bytes_by_kind"] == {"all-gather": gathers,
                                                   "all-reduce": reduces}
    assert res["collectives"]["num_collectives"] == 1 + layers * 7 + 2
    # params by hand: every dim divides 16 here except the router's 4
    # experts and the 4 kv heads; bf16
    want = 0
    for t, s in zip(tree_leaves(meta_params(cfg)),
                    tree_leaves(param_specs(cfg))):
        div = 1
        for d, ax in enumerate(s):
            if ax is not None and t.shape[d] % 16 == 0:
                div *= 16
        want += t.numel() // div * 2
    assert res["bytes_per_device"]["params"] == want
    assert res["bytes_per_device"]["cache"] > 0
    assert res["flops_per_device"] * 256 == res["flops"] > 0
    assert dryrun.main(["--arch", "grok-1-314b", "--shape",
                        "decode_32k"]) == 0
