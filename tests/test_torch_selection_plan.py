"""The exact selection kernels' launch plan, distance identities and
order on the CPU, held against the plain versions and the JAX package.

`selection.select_plan` is pure Python: which instance the one-shot and
column-tiled kernels (`csrc/selection.cu`) launch, with how many rows a
CTA, how many column splits and which shared memory. It is checked over a
grid of (M, W, N). The TPU kernels take Hamming distances from the +-1
Gram, d = (W*32 - dot) / 2; the CUDA kernels take them on the binary
tensor cores, d = popc(a) + popc(b) - 2 popc(a & b), with the code words
laid into the m16n8k256 fragments as the kernels lay them (emulated here
in numpy). Both identities are held to the popcount distance in plain
torch. `ref.fused_select_split_ref` walks the plan's row tiles, splits
and column tiles as the kernels do; it must equal `ref.fused_select_ref`
bit for bit (ids and weights), and the JAX package's `fused_select` and
`fused_select_tiled(interpret=True)` bit for bit when it reads the table
XLA computes (the port's own table, from torch's exp, differs from XLA's
in some last bits: ids equal, as `tests/test_torch_tiled.py` states).
Inputs are made with numpy from a seed. The CUDA kernels are held
against the twin and the plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.kernels import ref as jref
from repro.kernels.selection import fused_select as jax_select
from repro.kernels.selection import fused_select_tiled as jax_select_tiled

from repro_torch.core import backends
from repro_torch.kernels import ref, selection
from repro_torch.kernels.build import MAX_SHARED_BYTES


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _codes(rs, m, w):
    """Random packed codes: (uint32 for JAX, int32 view for the port)."""
    u = rs.randint(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


GRID_M = (1, 2, 10, 17, 40, 100, 129, 700, 1024, 4097, 16_384, 46_489,
          65_536)
GRID_W = (1, 2, 3, 4, 8, 16, 32, 33, 40)
GRID_N = (1, 9, 16, 128, 129, 200)


@pytest.mark.parametrize("w", GRID_W)
def test_select_plan_invariants(w):
    """Rows a multiple of 16 held in 1-4 warps, splits 1-8 that cover the
    columns (none empty), shared memory within one CTA's, the grid as
    the kernel launches it; N > 128 or W > 32 takes the knockout, whose
    block fits wherever the route sends M (to 46,489)."""
    for m in GRID_M:
        for n in GRID_N:
            plan = selection.select_plan(m, w, n)
            nsel = max(min(n, m - 1), 0)
            if nsel > selection.TILED_MAX_NEIGHBORS or \
                    w > selection.TILED_MAX_WORDS:
                assert plan["instance"] == "knockout"
                assert plan["smem_bytes"] == selection.knockout_smem_bytes(m)
                # wherever the route admits M, with the 64 static bytes
                assert plan["smem_bytes"] + 64 <= MAX_SHARED_BYTES or \
                    selection.oneshot_smem_bytes(m) > MAX_SHARED_BYTES
                assert plan["ctas"] == m and plan["threads"] == 256
                continue
            assert plan["instance"] == "mma"
            kw, rows, s, sl = (plan["kw"], plan["rows"], plan["splits"],
                               plan["split_len"])
            assert kw >= w and kw in (8, 16, 32)
            assert rows % 16 == 0
            assert rows == selection.ROWS_PER_WARP * plan["warps"]
            assert 1 <= plan["warps"] <= selection.MAX_WARPS
            assert plan["threads"] == 32 * plan["warps"]
            assert 1 <= s <= selection.MAX_SPLITS and sl % 8 == 0
            assert s * sl >= m and (s - 1) * sl < max(m, 1)
            assert plan["smem_bytes"] <= MAX_SHARED_BYTES
            assert plan["smem_bytes"] == selection.select_smem_bytes(
                kw, rows, nsel)
            assert plan["ctas"] == -(-m // rows) * s
            assert plan["block_k"] == selection.BLOCK_K


def test_select_plan_at_the_paper_shapes():
    """M = 10: one CTA, one 32-row tile with 10 live rows; from M = 1,024
    on the plan launches at least a warp per SM; at M = 65,536 four
    warps a CTA and no split."""
    p = selection.select_plan(10, 8, 9)
    assert (p["ctas"], p["rows"], p["splits"]) == (1, 32, 1)
    for m in (1024, 4096, 16_384, 46_489, 65_536):
        p = selection.select_plan(m, 8, 16)
        assert p["ctas"] * p["warps"] >= selection.FILL_SMS
    big = selection.select_plan(65_536, 8, 16)
    assert (big["warps"], big["rows"], big["splits"]) == (4, 128, 1)
    assert selection.select_plan(4096, 16, 16)["kw"] == 16
    assert [selection.mma_words(w) for w in (1, 3, 8, 9, 16, 17, 32)] == \
        [8, 8, 8, 16, 16, 32, 32]


def test_the_route_does_not_move():
    """"auto" still switches at the knockout row's 5 bytes a column:
    M = 46,489 one-shot, 46,490 tiled; the tiled bounds stay."""
    assert selection.oneshot_smem_bytes(46_489) <= MAX_SHARED_BYTES
    assert selection.oneshot_smem_bytes(46_490) > MAX_SHARED_BYTES
    for m in (1, 10, 46_489, 46_490):
        assert selection.oneshot_smem_bytes(m) == 5 * m
    assert backends.resolve_tiling(
        "auto", backends.selection_oneshot_smem_bytes(46_489)) == "oneshot"
    assert backends.resolve_tiling(
        "auto", backends.selection_oneshot_smem_bytes(46_490)) == "tiled"
    assert selection.TILED_MAX_NEIGHBORS == 128
    assert selection.TILED_MAX_WORDS == 32


def _fragment_words(u, kw):
    """The kernels' b1 fragments of packed codes u (M, W) uint32, padded to
    KW words: for k256 step s, lane group tig holds word 8s + tig
    (registers a0/a1 of rows g, g + 8; b0 of column g) and 8s + 4 + tig
    (a2/a3, b1). Returns {(s, tig, half): (M,) words}."""
    pad = np.zeros((u.shape[0], kw), np.uint32)
    pad[:, :u.shape[1]] = u
    return {(st, tig, h): pad[:, 8 * st + 4 * h + tig]
            for st in range(kw // 8) for tig in range(4) for h in range(2)}


def _popc(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8)
                         .reshape(*x.shape, 4), axis=-1).sum(-1)


@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 32])
def test_fragment_words_give_the_and_popc_distance(w):
    """Emulate the m16n8k256 .and.popc steps over the kernels' fragment
    words: the mma's sum over (step, lane group, half) of popc(a & b),
    with the row and column popcounts, is the popcount distance, bit for
    bit; every code word feeds exactly one fragment register."""
    rs = np.random.RandomState(w)
    u, _ = _codes(rs, 24, w)
    u[3] = u[2]                                   # equal codes: d = 0
    u[5] = ~u[4]                                  # complementary: d = W*32
    kw = selection.mma_words(w)
    frags = _fragment_words(u, kw)
    assert sorted(8 * s + 4 * h + t for s, t, h in frags) == list(range(kw))
    both = sum(_popc(x[:, None] & x[None, :]) for x in frags.values())
    pop = _popc(u).sum(-1)
    d = pop[:, None] + pop[None, :] - 2 * both
    want = ref.hamming_all_pairs_ref(_t(u.view(np.int32)),
                                     _t(u.view(np.int32))).numpy()
    assert np.array_equal(d, want)
    assert d[2, 3] == 0 and d[4, 5] == w * 32


def _gram_distances(codes_a, codes_b):
    """The TPU kernels' identity: d = (bits - a . b) / 2 on the +-1
    unpacked codes, exact in f32 (every partial sum is an integer of
    magnitude <= bits)."""
    pa, pb = ref.unpack_pm1(codes_a), ref.unpack_pm1(codes_b)
    return ((pa.shape[1] - pa @ pb.T) / 2).to(torch.int64)


@pytest.mark.parametrize("w", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("identity", ["pm1_gram", "and_popc"])
def test_distance_identities(w, identity):
    """(W*32 - dot) / 2 (the TPU kernels') and popc(a) + popc(b) -
    2 popc(a & b) (the CUDA kernels') equal the popcount distance in
    plain torch, for random, all-equal and complementary codes."""
    rs = np.random.RandomState(10 + w)
    u, ci = _codes(rs, 20, w)
    ci[7:10] = ci[6]
    ci[11] = ~ci[10]
    codes = _t(ci)
    fn = _gram_distances if identity == "pm1_gram" else \
        ref.and_popc_distances
    d = fn(codes, codes)
    assert torch.equal(d, ref.hamming_all_pairs_ref(codes, codes).long())
    assert d[6, 9] == 0 and d[10, 11] == w * 32
    assert fn(codes[[6, 6]], codes[[6, 6]]).eq(0).all()
    pm1 = ref.unpack_pm1(codes)
    assert pm1.shape == (20, w * 32)
    assert set(pm1.unique().tolist()) <= {-1.0, 1.0}


def test_pm1_matches_the_jax_unpack():
    from repro.kernels.selection import unpack_pm1 as jax_unpack
    rs = np.random.RandomState(3)
    u, ci = _codes(rs, 7, 3)
    assert np.array_equal(ref.unpack_pm1(_t(ci)).numpy(),
                          np.asarray(jax_unpack(jnp.asarray(u))))


def _xla_lut(w, gamma):
    """The table XLA computes: the JAX kernels' exp(-gamma * (d / bits))."""
    bits = w * 32
    return _t(np.array(jnp.exp(-gamma * (
        jnp.arange(bits + 1, dtype=jnp.float32) / float(bits)))))


def _twin(ci, scores, lut, n, plan=None, **flags):
    """The order twin at `plan` (default the wrapper's); a forced plan
    gives rows, splits and block_k, and its splits cover M in ranges of a
    multiple of 8 (trailing ones may be empty, as the kernel allows)."""
    m, w = ci.shape
    plan = plan or selection.select_plan(m, w, n)
    split_len = plan.get("split_len",
                         -(-(-(-m // plan["splits"])) // 8) * 8)
    return ref.fused_select_split_ref(
        _t(ci), _t(scores), lut, num_neighbors=n, rows=plan["rows"],
        splits=plan["splits"], split_len=split_len,
        block_k=plan["block_k"], **flags)


# plans small enough to cut M = 2..130 into several row tiles, splits
# and column tiles
FORCED = [dict(rows=16, splits=3, block_k=8),
          dict(rows=32, splits=5, block_k=8),
          dict(rows=48, splits=2, block_k=64)]


def _inputs(m, w, kind, seed):
    rs = np.random.RandomState(seed)
    u, ci = _codes(rs, m, w)
    if kind == "ties":                    # round 0: every Eq. 7 score is 0
        scores = np.zeros(m, np.float32)
    elif kind == "duplicates":            # equal distances, equal scores
        lo = min(4, m - 2)
        u[lo + 1:lo + 5] = u[lo]
        scores = np.round(rs.rand(m) * 4).astype(np.float32) / 4
    else:
        scores = rs.rand(m).astype(np.float32)
    return u, u.view(np.int32), scores


@pytest.mark.parametrize("m,w,n", [(2, 1, 1), (10, 8, 9), (17, 3, 16),
                                   (40, 8, 9), (130, 4, 128), (97, 2, 16)])
@pytest.mark.parametrize("kind", ["random", "ties", "duplicates"])
@pytest.mark.parametrize("flags", [{}, dict(use_lsh=False),
                                   dict(use_rank=False)])
def test_split_twin_equals_the_plain_version(m, w, n, kind, flags):
    """At the plan and at forced small plans (several row tiles, splits,
    column tiles, ragged edges), ids and weights bit for bit."""
    u, ci, scores = _inputs(m, w, kind, m * w)
    lut = ref.selection_lut(w, w * 32, 1.0)
    want = ref.fused_select_ref(_t(ci), _t(scores), lut, num_neighbors=n,
                                **flags)
    for plan in [None] + FORCED:
        got = _twin(ci, scores, lut, n, plan, **flags)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,w,n,gamma", [(10, 8, 9, 1.0), (37, 3, 16, 1.5),
                                         (130, 4, 128, 0.5),
                                         (60, 1, 1, 2.0)])
@pytest.mark.parametrize("kind", ["random", "ties", "duplicates"])
def test_split_twin_equals_the_jax_kernels(m, w, n, gamma, kind):
    """Against the JAX package's one-shot and column-tiled Pallas kernels
    (interpret mode) and its jnp oracle: bit for bit on XLA's table, ids
    equal on the port's."""
    u, ci, scores = _inputs(m, w, kind, m + w)
    kw = dict(bits=w * 32, gamma=gamma, num_neighbors=n)
    outs = [jax_select(jnp.asarray(u), jnp.asarray(scores), **kw,
                       interpret=True),
            jax_select_tiled(jnp.asarray(u), jnp.asarray(scores), **kw,
                             block_m=32, block_k=128, interpret=True),
            jref.fused_select_ref(jnp.asarray(u), jnp.asarray(scores), **kw)]
    got_x = _twin(ci, scores, _xla_lut(w, gamma), n)
    got_x_forced = _twin(ci, scores, _xla_lut(w, gamma), n, FORCED[0])
    got_t = _twin(ci, scores, ref.selection_lut(w, w * 32, gamma), n)
    for ji, jw in outs:
        for got in (got_x, got_x_forced):
            assert np.array_equal(got[0].numpy(), np.asarray(ji))
            assert np.array_equal(got[1].numpy(), np.asarray(jw))
        assert np.array_equal(got_t[0].numpy(), np.asarray(ji))


@pytest.mark.parametrize("flags", [dict(use_lsh=False), dict(use_rank=False)])
def test_split_twin_equals_the_jax_kernels_under_the_switches(flags):
    u, ci, scores = _inputs(45, 4, "duplicates", 7)
    kw = dict(bits=128, gamma=0.5, num_neighbors=6, **flags)
    ji, jw = jax_select_tiled(jnp.asarray(u), jnp.asarray(scores), **kw,
                              block_m=32, block_k=128, interpret=True)
    for plan in (None, FORCED[1]):
        gi, gw = _twin(ci, scores, _xla_lut(4, 0.5), 6, plan, **flags)
        assert np.array_equal(gi.numpy(), np.asarray(ji))
        assert np.array_equal(gw.numpy(), np.asarray(jw))


def test_wrappers_take_the_plain_versions_on_cpu_at_the_plan_shapes():
    """On the CPU both wrappers return the plain versions, equal to the
    twin at the plan; no kernel launches."""
    rs = np.random.RandomState(4)
    u, ci = _codes(rs, 33, 8)
    scores = rs.rand(33).astype(np.float32)
    selection.KERNEL.launches = selection.TILED_KERNEL.launches = 0
    a = selection.fused_select(_t(ci), _t(scores), bits=256, gamma=1.0,
                               num_neighbors=16)
    b = selection.fused_select_tiled(_t(ci), _t(scores), bits=256, gamma=1.0,
                                     num_neighbors=16)
    c = _twin(ci, scores, ref.selection_lut(8, 256, 1.0), 16)
    for x in (a, b):
        assert torch.equal(x[0], c[0]) and torch.equal(x[1], c[1])
    assert selection.KERNEL.launches == selection.TILED_KERNEL.launches == 0
