"""The exchange wrappers' launch plans on the CPU, the route they must not
move, and the plain versions against the JAX oracle at the small-C,
N = 16 shapes the one-shot kernel's packed rows take.

`exchange.oneshot_plan` and `exchange.streamed_plan` are pure Python:
what the one-shot kernel launches (cluster size, rows per CTA, lanes per
row, whether a client's rows are held in shared memory) and how the
streamed kernel cuts C. They are checked here at the paper's shapes and
over grids. `oneshot_smem_bytes` and `backends.resolve_tiling` decide
which kernel "auto" takes; they are held to their formula over a grid of
(N, R), so no plan changes a route.

Inputs are made with numpy from a seed; the JAX side runs its jnp oracle
(`repro/kernels/ref.py:all_in_one_exchange_ref`). Tolerances: l_ij
rtol 1e-5 against the one-shot plain version and rtol 2e-5, atol 1e-5
against the streamed one (its online softmax reorders the C sum); target
rtol 1e-5, atol 1e-6 and rtol 2e-5, atol 1e-5; valid and has_target
equal. The CUDA kernels are held against the plain versions on the card
by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.core import backends
from repro_torch.kernels import exchange, ref
from repro_torch.kernels.build import MAX_SHARED_BYTES


def _pow2(x):
    return x > 0 and x & (x - 1) == 0


# (M, N, R, C) -> (cluster, rows per CTA, lanes, staged): the main path,
# the one-shot contract point at C = 1,024, the ANN federations
PAPER_PLANS = [
    ((10, 9, 64, 10), (8, 72, 2, True)),
    ((8, 16, 64, 1024), (8, 128, 32, False)),
    ((4096, 16, 64, 10), (1, 1024, 1, True)),
    ((65_536, 16, 64, 10), (1, 1024, 1, True)),
    ((100, 16, 64, 10), (6, 172, 1, True)),
    ((3, 512, 5, 30), (8, 320, 2, True)),
]


@pytest.mark.parametrize("shape,want", PAPER_PLANS)
def test_oneshot_plan_at_the_paper_shapes(shape, want):
    plan = exchange.oneshot_plan(*shape)
    assert (plan["cluster"], plan["rows_per_cta"], plan["lanes"],
            plan["staged"]) == want
    assert plan["ctas"] == shape[0] * plan["cluster"]
    assert plan["threads"] == (256 if plan["staged"] else 512)


def test_oneshot_plan_fills_the_card_at_the_main_shape():
    """80 CTAs at M = 10 (the parent launched 10); the staged slab of a
    client is 23 KB at N = 9 and 41 KB at N = 16."""
    assert exchange.oneshot_plan(10, 9, 64, 10)["ctas"] >= 80
    assert 4 * 9 * 64 * 10 == 23_040 and 4 * 16 * 64 * 10 == 40_960
    assert exchange.oneshot_plan(1, 16, 64, 10)["staged"]


@pytest.mark.parametrize("n", [1, 2, 9, 16, 100, 512])
def test_oneshot_plan_runs_every_shape_the_route_sends(n):
    """Wherever `oneshot_smem_bytes` admits (N, R), the plan's CTAs cover
    the rows, a cluster's pieces start on 16 bytes, lanes are a power of
    two and the CTA's shared memory fits; unstaged it never passes the
    route's estimate, the parent kernel's layout."""
    for r in (1, 5, 33, 64, 1000, 14_526):
        if exchange.oneshot_smem_bytes(n, r) > MAX_SHARED_BYTES:
            continue
        for m in (1, 10, 600, 65_536):
            for c in (1, 3, 10, 32, 33, 1024, 100_352):
                plan = exchange.oneshot_plan(m, n, r, c)
                g, q = plan["cluster"], plan["rows_per_cta"]
                assert 1 <= g <= exchange.CLUSTER_MAX
                assert g * q >= n * r and (g - 1) * q < n * r
                assert g == 1 or q % 4 == 0
                assert _pow2(plan["lanes"]) and plan["lanes"] <= 32
                assert plan["smem_bytes"] <= MAX_SHARED_BYTES
                if not plan["staged"]:
                    assert plan["smem_bytes"] <= exchange.oneshot_smem_bytes(
                        n, r)


@pytest.mark.parametrize("c,q,threads,lanes", [
    (1, 1024, 256, 1), (8, 1024, 256, 1), (10, 1024, 256, 1),
    (16, 1024, 256, 1), (17, 1024, 256, 2), (32, 1024, 256, 2),
    (33, 1024, 256, 4), (256, 1024, 256, 16), (257, 1024, 256, 32),
    (1024, 128, 512, 32), (10, 72, 256, 2), (10, 128, 256, 2),
    (10, 129, 256, 1), (10, 129, 512, 2), (3, 8, 256, 2), (1, 8, 256, 1),
    (100, 4, 256, 32)])
def test_lanes_per_row_cover_sixteen_columns_a_lane(c, q, threads, lanes):
    """Up to 16 columns a lane; more lanes while a CTA of q rows would
    leave half its threads idle and each lane keeps two columns."""
    assert exchange.lanes_per_row(c, q, threads) == lanes


@pytest.mark.parametrize("c", [1, 3, 10, 32, 127, 128, 129, 511, 512, 513,
                               2048, 4096, 100_352])
def test_streamed_plan_cuts_c_into_whole_chunks(c):
    plan = exchange.streamed_plan(8, 8, 32, c)
    width = plan["lanes"] * plan["elems"]
    assert _pow2(plan["lanes"]) and plan["lanes"] <= 32
    assert plan["elems"] == (16 if c >= 512 else 4)
    assert plan["chunks"] * width >= c > (plan["chunks"] - 1) * width
    assert plan["lanes"] == 32 or plan["chunks"] == 1
    rows_per_warp = 32 // plan["lanes"]
    assert plan["row_groups"] * rows_per_warp >= 32
    g, per = plan["groups"], plan["per_group"]
    assert g * per >= 8 > (g - 1) * per
    assert plan["units"] == 8 * plan["row_groups"] * plan["chunks"] * g
    assert plan["fused"] == (32 * c <= exchange.FUSED_RC)
    assert plan["merged"] == (plan["chunks"] >= exchange.MERGE_CHUNKS)


def test_streamed_plan_at_the_contract_shapes():
    """The main shape: 4 lanes a row, one neighbour a warp (720 warps),
    the target in the mask launch; C = 100,352: 196 chunks, the own
    chunk read once for all 8 neighbours (50,176 warps), rows merged by
    a launch of their own."""
    assert exchange.streamed_plan(10, 9, 64, 10) == {
        "lanes": 4, "elems": 4, "chunks": 1, "row_groups": 8, "groups": 9,
        "per_group": 1, "units": 720, "merged": False, "fused": True}
    big = exchange.streamed_plan(8, 8, 32, 100_352)
    assert (big["chunks"], big["groups"], big["units"], big["merged"],
            big["fused"]) == (196, 1, 50_176, True, False)
    mid = exchange.streamed_plan(4, 16, 64, 1024)
    assert (mid["groups"], mid["per_group"], mid["units"]) == (4, 4, 2048)


@pytest.mark.parametrize("n", [1, 9, 16, 512, 513])
def test_route_estimate_and_tiling_are_unchanged(n):
    """The one-shot route's estimate is 4 * (2R + 2NR + 2N), one byte over
    the budget past 512 slots, and "auto" takes the one-shot kernel
    exactly where it fits."""
    for r in (1, 64, 1000, 3416, 3417, 14_526, 14_527):
        want = (4 * (2 * r + 2 * n * r + 2 * n) if n <= 512
                else MAX_SHARED_BYTES + 1)
        est = backends.exchange_oneshot_smem_bytes(n, r)
        assert est == exchange.oneshot_smem_bytes(n, r) == want
        assert backends.resolve_tiling("auto", est) == (
            "oneshot" if want <= MAX_SHARED_BYTES else "tiled")


def _inputs(m, n, r, c, seed, tie):
    rs = np.random.RandomState(seed)
    own = (rs.randn(m, r, c) * 3).astype(np.float32)
    nb = (rs.randn(m, n, r, c) * 3).astype(np.float32)
    y = rs.randint(0, c, size=(m, r)).astype(np.int32)
    sel = rs.rand(m, n) < 0.7
    if tie:                     # an exact KL tie, all slots selected
        nb[:, 3] = nb[:, 1]
        sel[:] = True
    return own, nb, y, sel


@pytest.mark.parametrize("m,n,r,c,lsh_verification,tie", [
    (6, 16, 8, 10, True, False), (5, 16, 12, 3, False, False),
    (4, 16, 16, 10, True, True), (3, 16, 5, 33, True, False),
    (2, 16, 7, 17, False, True)])
def test_plain_versions_match_jax_at_small_c_and_n16(m, n, r, c,
                                                     lsh_verification, tie):
    own, nb, y, sel = _inputs(m, n, r, c, seed=m * c + r, tie=tie)
    j = jref.all_in_one_exchange_ref(
        jnp.asarray(own), jnp.asarray(nb), jnp.asarray(y), jnp.asarray(sel),
        lsh_verification=lsh_verification)
    jl, jv, jt, jh = (np.asarray(a) for a in j)
    args = [torch.from_numpy(a) for a in (own, nb, y, sel)]
    for fn, rtol, atol_l, atol_t in (
            (exchange.fused_exchange, 1e-5, 0.0, 1e-6),
            (exchange.fused_exchange_streamed, 2e-5, 1e-5, 1e-5)):
        pl, pv, pt, ph = (a.numpy() for a in fn(
            *args, lsh_verification=lsh_verification))
        np.testing.assert_allclose(pl, jl, rtol=rtol, atol=atol_l)
        np.testing.assert_allclose(pt, jt, rtol=rtol, atol=atol_t)
        assert pv.dtype == np.bool_ and np.array_equal(pv, jv)
        assert np.array_equal(ph, jh)
