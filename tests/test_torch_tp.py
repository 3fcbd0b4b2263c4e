"""The port's tensor-parallel forward (`sharding.tp`) on the CPU: four
gloo ranks (`launch.mesh.spawn_ranks`, one spawn) on (1, 4) and (2, 2)
("data", "model") meshes against the JAX package's unsharded prefill and
decode step and the port's own, one case also through the transport
the card's gloo groups take (`tp._c10d_transport`, forced here); the
same layout at one rank bit for bit; and the dryrun's collective counts on meta at (16, 16) and (2, 16, 16)
against counts written out here from shapes.

Configurations: the `reduced()` configs of minitron-4b (4 query heads
over 1 K/V head: the K/V projection gathered), grok-1-314b (MoE, the FFN
width split), recurrentgemma-2b (the channel-split R block), whisper-small
(4 over 4 heads: split by whole heads; the encoder and cross-attention)
and llama-3.2-vision-90b (the vision projector, cross-attention),
minitron with 6 query over 2 K/V heads, where neither count divides 4
(every head on every rank), and minitron with 12 query over 3 K/V heads,
where the query heads divide and the K/V heads do not, and each group
of 4 query heads straddles ranks (one K/V head kept per query head).
Two of them also take one whole train step (`make_train_step`, clip
1.0, AdamW with weight decay; grad_accum 2 in one) against the same
step unsharded. Inputs are made with numpy from a seed, and
the weights by the port's `init_params` from a seeded generator, carried
to JAX as the same arrays (the two packages share every parameter name
and layout).

Tolerances:
* logits of the prefill and of one decode step: rtol 1e-4, atol 1e-4
  against the JAX package (`tests/test_torch_lm.py`'s bound: f32 GEMMs,
  softmax and RoPE in another order), rtol 1e-5, atol 1e-5 against the
  port's unsharded forward (the same ops, the row-parallel sums over
  ranks reordered);
* the train step's loss within 1e-5 and every gradient leaf within
  rtol 1e-4, atol 1e-6 of the unsharded `loss_and_grads` (the
  vocabulary-split cross entropy and the sums over ranks reorder f32
  additions); after a whole step, grad_norm within 1e-5, the AdamW
  moments at the gradients' tolerance, and the update within what that
  tolerance allows a first Adam step (`_update_bound`);
* at one rank: logits equal bit for bit;
* collective counts: equal.

On (2, 2) each data row of grok's MoE layer routes its own tokens with
its own capacity, as the JAX package's shard_map path does, so its
reference is the unsharded model run on each row alone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.models import transformer as jtf

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (MeshLayout, make_device_mesh,
                                     make_host_mesh, make_production_mesh,
                                     spawn_ranks)
from repro_torch.models import transformer
from repro_torch.models.transformer import meta_params, param_specs
from repro_torch.optim import adamw
from repro_torch.sharding import place_params, tp
from repro_torch.train import loss_and_grads, make_train_step
from repro_torch.tree import tree_leaves, tree_map

B, S = 2, 8
MESHES = ((1, 4), (2, 2))
VARIANT = {"num_heads": 6, "num_kv_heads": 2}
# 12 query heads over 3 K/V heads: "model" divides the query heads (3 a
# rank on 4, 6 on 2) and not the K/V heads, and groups of 4 straddle
# ranks, so each rank keeps one K/V head per query head
STRADDLE = {"num_heads": 12, "num_kv_heads": 3}
CASES = {"minitron": ("minitron-4b", {}), "grok": ("grok-1-314b", {}),
         "recurrentgemma": ("recurrentgemma-2b", {}),
         "whisper": ("whisper-small", {}),
         "llama-vision": ("llama-3.2-vision-90b", {}),
         "minitron-6-over-2": ("minitron-4b", VARIANT),
         "minitron-12-over-3": ("minitron-4b", STRADDLE)}
GRAD_CASES = (("grok", (1, 4), "none"),
              ("minitron-6-over-2", (2, 2), "block"),
              ("recurrentgemma", (1, 4), "none"))
# the whole train step (clip, AdamW with weight decay): (case, mesh,
# grad_accum)
STEP_CASES = (("recurrentgemma", (2, 2), 1),
              ("minitron-12-over-3", (1, 4), 2))
STEP_CLIP, STEP_LR, STEP_DECAY = 1.0, 1e-3, 0.1
# the case run once more through the c10d transport (gloo on CUDA)
C10D_CASE = "recurrentgemma"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _case(name):
    """(JAX cfg, port cfg, JAX params, port params, numpy tokens, next
    tokens, numpy modality stub)."""
    arch, changes = CASES[name]
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **changes)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, cfg.vocab_size, (B, S))
    nxt = rs.randint(0, cfg.vocab_size, (B,))
    return jcfg, cfg, jp, params, tokens, nxt, synthetic.modality_stub(
        cfg, B, rs)


def _jax_logits(jcfg, jp, tokens, nxt, stub, rows):
    """The JAX prefill's and decode step's logits, over `rows` of the
    batch at a time."""
    pre, dec = [], []
    for r in range(0, B, rows):
        sl = slice(r, r + rows)
        jex = {k: jnp.asarray(v[sl]) for k, v in stub.items()} or None
        jl, cache = jtf.prefill(jcfg, jp, jnp.asarray(tokens[sl], jnp.int32),
                                jex, cache_len=S + 1)
        jl2, _ = jtf.decode_step(jcfg, jp, cache,
                                 jnp.asarray(nxt[sl], jnp.int32), S)
        pre.append(np.asarray(jl))
        dec.append(np.asarray(jl2))
    return np.concatenate(pre), np.concatenate(dec)


def _port_logits(cfg, params, tokens, nxt, stub):
    extra = {k: _t(v) for k, v in stub.items()} or None
    with torch.no_grad():
        lg, cache = transformer.prefill(cfg, params, _t(tokens), extra,
                                        cache_len=S + 1)
        lg2, _ = transformer.decode_step(cfg, params, cache, _t(nxt), S)
    return lg, lg2


def _train_batch(cfg, tokens, stub):
    labels = np.roll(tokens, -1, axis=1)
    batch = {"tokens": _t(tokens), "labels": _t(labels)}
    batch.update({k: _t(v) for k, v in stub.items()})
    return batch


def _tp_rank(rank, world, cases, grad_cases):
    """One rank: for each mesh and case, the tensor-parallel prefill and
    decode step's logits (whole, gathered for the parent), then the
    train step's loss and gradients for `grad_cases`."""
    out = {}
    meshes = {shape: make_device_mesh(shape, ("data", "model"))
              for shape in MESHES}
    for shape, mesh in meshes.items():
        for name, (cfg, params, tokens, nxt, extra, _) in cases.items():
            placed = place_params(cfg, params, mesh)
            with torch.no_grad():
                lg, cache = transformer.prefill(cfg, placed, tokens, extra,
                                                cache_len=S + 1)
                lg2, _ = transformer.decode_step(cfg, placed, cache, nxt, S)
            out[name, shape] = (lg.full_tensor(), lg2.full_tensor())
    # the card's transport for gloo groups of CUDA tensors (c10d ops in
    # place of DTensor's functional collectives), forced on this CPU
    transport, tp._c10d_transport = tp._c10d_transport, lambda t: True
    try:
        cfg, params, tokens, nxt, extra, _ = cases[C10D_CASE]
        placed = place_params(cfg, params, meshes[(2, 2)])
        with torch.no_grad():
            lg, cache = transformer.prefill(cfg, placed, tokens, extra,
                                            cache_len=S + 1)
            lg2, _ = transformer.decode_step(cfg, placed, cache, nxt, S)
        whole = (Replicate(), Replicate())
        out["c10d"] = tuple(tp.redistribute(t, whole).to_local()
                            for t in (lg, lg2))
    finally:
        tp._c10d_transport = transport
    for name, shape, remat in grad_cases:
        cfg, params, batch = cases[name][0], cases[name][1], cases[name][5]
        placed = place_params(cfg, params, meshes[shape])
        (loss, _, _), grads = loss_and_grads(cfg, placed, batch, remat=remat)
        out["grads", name] = (loss, [g.full_tensor() for g in
                                     tree_leaves(grads)])
    for name, shape, accum in STEP_CASES:
        cfg, params, batch = cases[name][0], cases[name][1], cases[name][5]
        placed = place_params(cfg, tree_map(torch.clone, params),
                              meshes[shape])
        out["step", name] = _train_step(cfg, placed, batch, accum)
    return out


def _train_step(cfg, params, batch, accum):
    """One `make_train_step` (clipped, AdamW) on `params`, updated in
    place: the metrics, the params' and the moments' leaves (whole), and
    whether each moment is placed as its param."""
    opt = adamw(STEP_LR, weight_decay=STEP_DECAY)
    step = make_train_step(cfg, opt, remat="none", grad_clip=STEP_CLIP,
                           grad_accum=accum)
    def whole(t):
        return t.full_tensor() if tp.placed(t) else t
    before = [whole(t).clone() for t in tree_leaves(params)]
    state = opt.init(params)
    params, state, metrics = step(params, state, batch)
    leaves = {k: [whole(t) for t in tree_leaves(tree)] for k, tree in
              (("m", state["m"]), ("v", state["v"]))}
    leaves["params"] = [whole(t) for t in tree_leaves(params)]
    leaves["update"] = [p1 - p0 for p1, p0 in zip(leaves["params"], before)]
    placed_as = [not tp.placed(p) or (m.placements == p.placements
                                      and v.placements == p.placements)
                 for p, m, v in zip(tree_leaves(params),
                                    tree_leaves(state["m"]),
                                    tree_leaves(state["v"]))]
    return ({k: float(v) for k, v in metrics.items()}, leaves, placed_as)


@pytest.fixture(scope="module")
def ranks():
    """Every case's JAX and port references, and the four ranks'
    results (one spawn)."""
    refs, cases, grads = {}, {}, {}
    for name in CASES:
        jcfg, cfg, jp, params, tokens, nxt, stub = _case(name)
        refs[name] = {"jax": _jax_logits(jcfg, jp, tokens, nxt, stub, B),
                      "port": _port_logits(cfg, params, tokens, nxt, stub)}
        if cfg.is_moe:
            refs[name]["jax_rows"] = _jax_logits(jcfg, jp, tokens, nxt,
                                                 stub, 1)
        cases[name] = (cfg, params, _t(tokens), _t(nxt),
                       {k: _t(v) for k, v in stub.items()} or None,
                       _train_batch(cfg, tokens, stub))
    for name, _, remat in GRAD_CASES:
        cfg, params, batch = (cases[name][i] for i in (0, 1, 5))
        (loss, _, _), g = loss_and_grads(cfg, params, batch, remat=remat)
        grads[name] = (loss, g)
    for name, _, accum in STEP_CASES:
        cfg, params, batch = (cases[name][i] for i in (0, 1, 5))
        grads["step", name] = _train_step(
            cfg, tree_map(torch.clone, params), batch, accum)
    results = spawn_ranks(_tp_rank, 4, cases, GRAD_CASES)
    return refs, grads, results


@pytest.mark.parametrize("shape", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_prefill_and_decode_match_jax_and_the_port(ranks, name, shape):
    refs, _, results = ranks
    want_jax = refs[name]["jax_rows" if shape == (2, 2)
                          and "jax_rows" in refs[name] else "jax"]
    for out in results:
        pre, dec = out[name, shape]
        for got, jax_ref, port in zip((pre, dec), want_jax,
                                      refs[name]["port"]):
            np.testing.assert_allclose(_np(got), jax_ref, rtol=1e-4,
                                       atol=1e-4)
            if "jax_rows" not in refs[name] or shape == (1, 4):
                np.testing.assert_allclose(_np(got), _np(port), rtol=1e-5,
                                           atol=1e-5)


def test_tp_c10d_transport_gives_the_same_logits(ranks):
    """The transport the card's gloo groups take (c10d all-reduce and
    all-gather in place of DTensor's functional collectives), forced on
    the CPU for one case on (2, 2): the prefill's and decode step's
    logits within 1e-5 of the port's unsharded forward."""
    refs, _, results = ranks
    for out in results:
        for got, want in zip(out["c10d"], refs[C10D_CASE]["port"]):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("name,shape,remat", GRAD_CASES)
def test_tp_train_gradients_match_the_unsharded_step(ranks, name, shape,
                                                     remat):
    _, grads, results = ranks
    loss, want = grads[name]
    want = tree_leaves(want)
    for out in results:
        got_loss, got = out["grads", name]
        assert abs(float(got_loss) - float(loss)) <= 1e-5
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6)


def _update_bound(g, p, d):
    """How far one AdamW step's update may move from the unsharded one
    when the gradient moves within the gradients' tolerance: after one
    step the update is -lr (g / (|g| + eps) + decay p), monotone in g, so
    its distance is at most lr times the larger change of g / (|g| + eps)
    over [g - tol, g + tol], tol = 1e-6 + 1e-4 |g|; plus eight f32 ulps
    of |p1| + |d| (`d` the unsharded update) for rounding: each of the two
    steps rounds seven times (m / c1, * lr, v / c2, sqrt, + eps, the
    quotient, p0 + u), half an ulp each, and the update is read back as
    p1 - p0 once more."""
    def u(x):
        return x / (x.abs() + 1e-8)
    tol = 1e-6 + 1e-4 * g.abs()
    move = torch.maximum(u(g + tol) - u(g), u(g) - u(g - tol))
    return STEP_LR * move + 8 * torch.finfo(torch.float32).eps * (
        p.abs() + d.abs())


@pytest.mark.parametrize("name,shape,accum", STEP_CASES)
def test_tp_train_step_matches_the_unsharded_step(ranks, name, shape,
                                                  accum):
    """One clipped AdamW step (weight decay 0.1) on placed params against
    the same step unsharded: loss and grad_norm within 1e-5, the clip
    active (grad_norm above it); per leaf the first moment over 1 - b1
    and the square root of the second over 1 - b2 (after one step, the
    clipped gradient and its magnitude) at the gradients' tolerance,
    rtol 1e-4, atol 1e-6; the update p1 - p0 within `_update_bound` of
    the unsharded one, element by element; every moment placed as its
    param."""
    _, refs, results = ranks
    metrics, want, _ = refs["step", name]
    assert metrics["grad_norm"] > STEP_CLIP
    scale = {"m": lambda t: t / (1 - 0.9),
             "v": lambda t: torch.sqrt(t / (1 - 0.999))}
    bounds = [_update_bound(m / (1 - 0.9), p, d) for m, p, d in
              zip(want["m"], want["params"], want["update"])]
    for out in results:
        got_metrics, got, placed_as = out["step", name]
        for k in ("loss", "grad_norm"):
            assert abs(got_metrics[k] - metrics[k]) <= 1e-5, k
        assert all(placed_as)
        for k, f in scale.items():
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(_np(f(g)), _np(f(w)), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
        for g, w, bound in zip(got["update"], want["update"], bounds):
            assert bool(((g - w).abs() <= bound).all())


def test_tp_forward_on_one_rank_is_bitwise_and_survives_a_fake_mesh():
    """A (1, 1) gloo mesh: the placed prefill gives the unplaced logits
    bit for bit; a dryrun count on a fake mesh in between leaves the
    running group in place and working."""
    jcfg, cfg, jp, params, tokens, nxt, stub = _case("minitron")
    want, want2 = _port_logits(cfg, params, tokens, nxt, stub)
    mesh = make_host_mesh()
    try:
        world = dist.group.WORLD
        placed = place_params(cfg, params, mesh)
        dryrun.counted_collectives(cfg, _PREFILL, make_production_mesh())
        assert dist.group.WORLD is world
        with torch.no_grad():
            got, cache = transformer.prefill(cfg, placed, _t(tokens),
                                             cache_len=S + 1)
            got2, _ = transformer.decode_step(cfg, placed, cache, _t(nxt), S)
        assert torch.equal(got.to_local(), want)
        assert torch.equal(got2.to_local(), want2)
        t = torch.ones(3)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dryrun's collectives on meta, against counts from shapes
# ---------------------------------------------------------------------------
_PREFILL = ShapeConfig("prefill_small", 64, 64, "prefill")
_TRAIN = ShapeConfig("train_small", 16, 64, "train")
LAYOUTS = {"16x16": make_production_mesh(),
           "2x16x16": make_production_mesh(multi_pod=True)}


def _rows(layout):
    """Rows of the batch on one device: B over every axis but "model"."""
    return _PREFILL.global_batch // (layout.size() // 16)


def _dense16():
    """Reduced minitron with 16 query and 16 K/V heads of 16: "model"
    divides every head count."""
    return dataclasses.replace(configs.get_config("minitron-4b").reduced(),
                               num_heads=16, num_kv_heads=16, head_dim=16)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_collectives_where_heads_divide_are_the_row_all_reduces(
        layout):
    cfg = _dense16()
    got = dryrun.counted_collectives(cfg, _PREFILL, LAYOUTS[layout])
    act = _rows(LAYOUTS[layout]) * _PREFILL.seq_len * cfg.d_model * 2
    per_layer = 2 * act                  # attention's wo and the MLP's wo
    assert got["bytes_by_kind"] == {
        "all-reduce": cfg.num_layers * per_layer + act}  # + the embedding
    assert got["num_collectives"] == 2 * cfg.num_layers + 1
    assert got["bytes_by_axis"] == {"model": got["total_bytes"]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_collectives_where_heads_do_not_divide_add_the_gathers(
        layout):
    """Reduced minitron, 4 query heads over 1 K/V head on 16: each layer
    gathers q (256 columns) and k, v (64 each) before the head reshape."""
    cfg = configs.get_config("minitron-4b").reduced()
    got = dryrun.counted_collectives(cfg, _PREFILL, LAYOUTS[layout])
    tokens = _rows(LAYOUTS[layout]) * _PREFILL.seq_len
    act = tokens * cfg.d_model * 2
    dh = cfg.resolved_head_dim
    gathers = tokens * (cfg.num_heads + 2 * cfg.num_kv_heads) * dh * 2
    assert got["bytes_by_kind"] == {
        "all-reduce": cfg.num_layers * 2 * act + act,
        "all-gather": cfg.num_layers * gathers}
    assert got["num_collectives"] == 5 * cfg.num_layers + 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_reduces_each_gradient_over_the_batch_axes(layout):
    """The train step's collectives over the batch axes are the gradients'
    all-reduces, one per leaf of its local bytes (bf16), and the
    loss's mean (one f32): the param bytes per device, plus 4, on each
    batch axis."""
    cfg = _dense16()
    mesh = LAYOUTS[layout]
    got = dryrun.counted_collectives(cfg, _TRAIN, mesh)
    params = dryrun.device_bytes(meta_params(cfg, dryrun.DTYPE),
                                 param_specs(cfg), mesh)
    batch_axes = [a for a in mesh.mesh_dim_names if a != "model"]
    for axis in batch_axes:
        assert got["bytes_by_axis"][axis] == params + 4


def test_collective_stats_and_the_counter_on_hand_made_records():
    recs = [{"kind": "all-reduce", "bytes": 10, "axis": "model"},
            {"kind": "all-gather", "bytes": 7, "axis": "data"},
            {"kind": "all-reduce", "bytes": 5, "axis": "data"}]
    assert dryrun.collective_stats(recs) == {
        "bytes_by_kind": {"all-reduce": 15, "all-gather": 7},
        "total_bytes": 22, "num_collectives": 3}
    assert dryrun.collective_stats([]) == {
        "bytes_by_kind": {}, "total_bytes": 0, "num_collectives": 0}
    # a c10d all_reduce issued directly (as the c10d transport's) and a
    # functional all-gather, each with its result's bytes and axis
    with dryrun.fake_mesh(MeshLayout((2, 4), ("data", "model"))) as mesh:
        with dryrun.CollectiveCounter(dryrun._mesh_axes(mesh)) as counter:
            dist.all_reduce(torch.empty(6, device="meta"),
                            group=mesh.get_group("model"))
            torch.ops._c10d_functional.all_gather_into_tensor(
                torch.empty(3, 2, device="meta", dtype=torch.bfloat16), 2,
                mesh.get_group("data").group_name)
    assert counter.records == [
        {"kind": "all-reduce", "bytes": 24, "axis": "model"},
        {"kind": "all-gather", "bytes": 24, "axis": "data"}]
