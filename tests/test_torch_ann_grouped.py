"""The per-bucket ANN candidates and the grouped ANN kernel's plan, on
the CPU, held against the port's per-row form and the JAX package.

`ann.bucket_candidates` gives one candidate list per non-empty bucket.
A client's list depends only on its bucket, so `lists[slot]` must equal
the (M, K) ids of `ann.ann_candidates` and of the JAX
`repro.core.ann.ann_candidates` exactly, on the candidate-generation
grid of `tests/test_torch_ann.py`, a skewed layout with overflow and
drops, prefix 0, tiny M with empty probe buckets and M < 2^prefix_bits.
`ref.ann_select_grouped_ref` (the grouped kernel's plain version, which
its wrapper takes for CPU tensors) must equal the JAX `ann_select_ref`
bit for bit when it reads the JAX exp table, and the per-row route's
ids through the port's own table. `selection.ann_plan` is pure Python:
its tiles must cover every bucket layout under the kernel's tile-to-slot
mapping (emulated here), and its shared memory must fit one CTA. Inputs
are made with numpy from a seed. The CUDA kernel is held against the
plain version on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.core import ann as jann
from repro.kernels import ref as jref

from repro_torch.core import ann
from repro_torch.kernels import ref, selection
from repro_torch.kernels.build import MAX_SHARED_BYTES

GAMMA = 1.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(m, w, seed):
    """Random packed codes: (uint32 for JAX, int32 view for the port)."""
    u = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


def _skewed_codes(m, w, seed):
    """Most clients share one code (one giant bucket past its cap), a few
    share another, the rest random."""
    u, _ = _codes(m, w, seed)
    u[: m // 2] = u[0]
    u[m // 2: m // 2 + 5] = u[m // 2]
    return u, u.view(np.int32)


def _distinct_codes(m, w, pb, seed):
    """Random codes whose prefix bits (the permutation of `seed`) put
    every client in a bucket of its own, so S = M slots are all live."""
    u, _ = _codes(m, w, seed)
    rs = np.random.RandomState(seed)
    own = rs.choice(1 << pb, size=m, replace=False)
    for t, b in enumerate(ann.prefix_bit_indices(w * 32, pb, seed).tolist()):
        bit = ((own >> t) & 1).astype(np.uint32) << np.uint32(b % 32)
        u[:, b // 32] = (u[:, b // 32] & ~np.uint32(1 << (b % 32))) | bit
    return u, u.view(np.int32)


def _scores(m, seed, grid=True):
    rs = np.random.RandomState(seed)
    if grid:                     # Eq. 7-like: few values, many ties
        return rs.choice([0.0, 0.25, 0.5, 1.0], m).astype(np.float32)
    return rs.rand(m).astype(np.float32)


def _jax_lut(w, bits, gamma=GAMMA):
    return _t(np.asarray(jnp.exp(-gamma * (
        jnp.arange(w * 32 + 1, dtype=jnp.float32) / float(bits)))))


def _all_three(cu, ci, scores, **kw):
    j = jann.ann_candidates(jnp.asarray(cu), jnp.asarray(scores), **kw)
    p = ann.ann_candidates(_t(ci), _t(scores), **kw)
    b = ann.bucket_candidates(_t(ci), _t(scores), **kw)
    return j, p, b


def _assert_same_candidates(j, p, b):
    want = np.asarray(j.ids)
    got = b.lists[b.slot.long()]
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p.ids)
    assert np.array_equal(b.bucket.numpy(), np.asarray(j.bucket))
    assert np.array_equal(b.counts.numpy(), np.asarray(j.counts))
    assert int(b.dropped) == int(j.dropped)


def _assert_layout(b, m, pb):
    """order / starts / slot agree with each other and the buckets; the
    slots number the non-empty buckets in ascending order; rows past the
    count are all sentinel."""
    s = min(1 << pb, m)
    assert b.lists.shape[0] == s and b.starts.shape == (s + 1,)
    for t in (b.lists, b.bucket, b.slot, b.order, b.starts, b.counts):
        assert t.dtype == torch.int32
    order = b.order.long()
    assert sorted(order.tolist()) == list(range(m))
    assert torch.equal(order, torch.sort(b.bucket.long(), stable=True)
                       .indices)
    sizes = (b.starts[1:] - b.starts[:-1]).long()
    assert int(b.starts[0]) == 0 and int(b.starts[-1]) == m
    assert bool((sizes >= 0).all())
    live = int((b.counts > 0).sum())
    assert bool((sizes[:live] > 0).all()) and int(sizes[live:].sum()) == 0
    assert bool((b.lists[live:] == m).all())
    slot_of_pos = torch.repeat_interleave(torch.arange(s), sizes)
    assert torch.equal(b.slot.long()[order], slot_of_pos)
    nonempty = torch.nonzero(b.counts > 0).flatten()
    assert torch.equal(nonempty[b.slot.long()], b.bucket.long())
    assert torch.equal(b.counts.long()[nonempty], sizes[:live])


# ---------------------------------------------------------------------------
# per-bucket candidates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,pb,probes", [
    (13, 0, 0), (13, 2, 1), (13, 5, 5), (37, 0, 0), (37, 2, 2), (37, 5, 3),
    (64, 0, 0), (64, 2, 1), (64, 5, 5)])
@pytest.mark.parametrize("seed", [0, 7])
def test_bucket_lists_equal_the_candidate_ids(m, pb, probes, seed):
    """`test_candidates_equal_jax`'s grid: each client's slot list is its
    row of candidate ids, in the port and in the JAX package."""
    cu, ci = _codes(m, 4, seed=m)
    scores = _scores(m, seed=m + 1)
    kw = dict(seed=seed, prefix_bits=pb, probes=probes, num_neighbors=5)
    j, p, b = _all_three(cu, ci, scores, **kw)
    _assert_same_candidates(j, p, b)
    _assert_layout(b, m, pb)


@pytest.mark.parametrize("m,pb,probes,n", [(60, 3, 2, 4), (90, 4, 4, 6),
                                           (200, 5, 3, 12)])
def test_skewed_buckets_with_overflow_and_drops(m, pb, probes, n):
    """Half the clients in one bucket, far past its cap: the candidate
    side drops them exactly as the per-row form and the JAX package do."""
    cu, ci = _skewed_codes(m, 4, seed=m)
    scores = _scores(m, seed=m + 3, grid=False)
    j, p, b = _all_three(cu, ci, scores, seed=3, prefix_bits=pb,
                         probes=probes, num_neighbors=n)
    assert int(b.dropped) > 0
    assert int(b.counts.max()) > ann.bucket_cap(m, pb, n)
    _assert_same_candidates(j, p, b)
    _assert_layout(b, m, pb)


@pytest.mark.parametrize("m,n", [(2, 1), (13, 4), (100, 16)])
def test_prefix_zero_is_one_list_of_every_client(m, n):
    """prefix_bits=0: one slot, its list every client in ascending id and
    the teaser all sentinel."""
    cu, ci = _codes(m, 2, seed=m)
    scores = _scores(m, seed=m)
    j, p, b = _all_three(cu, ci, scores, seed=0, prefix_bits=0, probes=0,
                         num_neighbors=n)
    _assert_same_candidates(j, p, b)
    _assert_layout(b, m, 0)
    t = ann.teaser_count(m, n)
    assert b.lists.shape == (1, m + t)
    assert b.lists[0].tolist() == list(range(m)) + [m] * t


@pytest.mark.parametrize("m,pb,probes", [(10, 6, 6), (5, 4, 2), (3, 16, 4),
                                         (20, 10, 8), (1, 3, 1)])
def test_tiny_m_below_the_bucket_count(m, pb, probes):
    """M < 2^prefix_bits: S = M list rows; most probes hit empty buckets."""
    cu, ci = _codes(m, 4, seed=m + 40)
    scores = _scores(m, seed=m + 41, grid=False)
    j, p, b = _all_three(cu, ci, scores, seed=5, prefix_bits=pb,
                         probes=probes, num_neighbors=4)
    assert b.lists.shape[0] == m
    _assert_same_candidates(j, p, b)
    _assert_layout(b, m, pb)


@pytest.mark.parametrize("m", [33, 37, 63, 67])
def test_every_client_in_its_own_bucket_past_one_warp(m):
    """S = M > 32 live slots at the default prefix 10: the kernel's
    tile-to-slot search takes more than one 32-way round and its last
    round steps by more than one. Candidates equal the per-row form and
    the JAX package, and the grouped plain version the JAX selection."""
    n, pb, probes, seed = 16, 10, 8, 11
    cu, ci = _distinct_codes(m, 8, pb, seed)
    scores = _scores(m, seed=m + 5, grid=False)
    kw = dict(seed=seed, prefix_bits=pb, probes=probes, num_neighbors=n)
    j, p, b = _all_three(cu, ci, scores, **kw)
    assert b.lists.shape[0] == m and int((b.counts > 0).sum()) == m
    _assert_same_candidates(j, p, b)
    _assert_layout(b, m, pb)
    ji, jw = jref.ann_select_ref(jnp.asarray(cu), jnp.asarray(scores), j.ids,
                                 bits=256, gamma=GAMMA, num_neighbors=n)
    gi, gw = ref.ann_select_grouped_ref(_t(ci), _t(scores), b,
                                        _jax_lut(8, 256), num_neighbors=n)
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    assert np.array_equal(gw.numpy(), np.asarray(jw))


def test_bucket_lists_at_the_auto_threshold():
    """M = 4,096 at the defaults (prefix 10, probes 8, N=16): K = 185, at
    most 1,024 list rows, far fewer bytes than the (M, K) ids."""
    m, n = 4096, 16
    _, ci = _codes(m, 8, seed=1)
    scores = _t(_scores(m, seed=2))
    p = ann.ann_candidates(_t(ci), scores, seed=2, prefix_bits=10, probes=8,
                           num_neighbors=n)
    b = ann.bucket_candidates(_t(ci), scores, seed=2, prefix_bits=10,
                              probes=8, num_neighbors=n)
    assert b.lists.shape == (1024, 185)
    assert torch.equal(b.lists[b.slot.long()], p.ids)
    _assert_layout(b, m, 10)


def test_probe_masks_are_the_home_bucket_then_single_flips():
    for pb, probes in ((0, 0), (3, 1), (5, 5), (10, 8), (4, 9)):
        got = ann.probe_masks(pb, probes)
        np_ = ann.effective_probes(probes, pb)
        assert got.dtype == torch.int32
        assert got.tolist() == [0] + [1 << t for t in range(np_)]
        assert np.array_equal(got.numpy(),
                              np.asarray(jann.probe_masks(pb, probes)))


# ---------------------------------------------------------------------------
# the grouped kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,w,pb,probes,n", [
    (13, 2, 0, 0, 4), (37, 4, 2, 2, 5), (64, 8, 4, 3, 12),
    (130, 4, 6, 6, 12), (9, 2, 3, 1, 8)])
@pytest.mark.parametrize("case", ["random", "zero_scores", "no_lsh",
                                  "no_rank", "skewed"])
def test_grouped_ref_bit_exact_vs_jax(m, w, pb, probes, n, case):
    cu, ci = (_skewed_codes if case == "skewed" else _codes)(m, w, seed=m)
    scores = _scores(m, seed=m + 1, grid=case == "no_lsh")
    if case == "zero_scores":     # round 0: every weight ties
        scores[:] = 0.0
    flags = {"no_lsh": dict(use_lsh=False),
             "no_rank": dict(use_rank=False)}.get(case, {})
    kw = dict(seed=7, prefix_bits=pb, probes=probes, num_neighbors=n)
    j = jann.ann_candidates(jnp.asarray(cu), jnp.asarray(scores), **kw)
    b = ann.bucket_candidates(_t(ci), _t(scores), **kw)
    ji, jw = jref.ann_select_ref(jnp.asarray(cu), jnp.asarray(scores), j.ids,
                                 bits=w * 32, gamma=GAMMA, num_neighbors=n,
                                 **flags)
    gi, gw = ref.ann_select_grouped_ref(_t(ci), _t(scores), b,
                                        _jax_lut(w, w * 32), num_neighbors=n,
                                        block_m=16, **flags)
    assert gi.dtype == torch.int32
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    assert np.array_equal(gw.numpy(), np.asarray(jw))
    # the wrapper on the CPU: the plain version, equal to the per-row
    # wrapper on `ann_candidates` bit for bit, and no launch
    p = ann.ann_candidates(_t(ci), _t(scores), **kw)
    before = (selection.GROUPED_KERNEL.launches,
              selection.ANN_KERNEL.launches)
    wi, ww = selection.fused_select_ann_grouped(
        _t(ci), _t(scores), b, bits=w * 32, gamma=GAMMA, num_neighbors=n,
        **flags)
    ri, rw = selection.fused_select_ann(_t(ci), _t(scores), p.ids,
                                        bits=w * 32, gamma=GAMMA,
                                        num_neighbors=n, **flags)
    assert torch.equal(wi, ri) and torch.equal(ww, rw)
    assert np.array_equal(wi.numpy(), np.asarray(ji))
    assert (selection.GROUPED_KERNEL.launches,
            selection.ANN_KERNEL.launches) == before


@pytest.mark.parametrize("m,n", [(13, 4), (64, 5)])
def test_grouped_prefix_zero_equals_the_exact_selection(m, n):
    _, ci = _codes(m, 4, seed=m)
    scores = _t(_scores(m, seed=m + 2, grid=False))
    b = ann.bucket_candidates(_t(ci), scores, seed=0, prefix_bits=0,
                              probes=0, num_neighbors=n)
    lut = ref.selection_lut(4, 128, GAMMA)
    gi, gw = ref.ann_select_grouped_ref(_t(ci), scores, b, lut,
                                        num_neighbors=n)
    ei, ew = ref.fused_select_ref(_t(ci), scores, lut, num_neighbors=n)
    assert torch.equal(gi, ei) and torch.equal(gw, ew)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
def _kernel_tile(starts, rows, tile):
    """The grouped kernel's tile-to-slot mapping (csrc/selection.cu,
    select_mma<..., GROUPED>), step for step: the last slot s with key
    starts[s] // rows + s <= tile, found 32 ways at a time (lane l tests
    slot lo + l * step, lanes at or past hi test nothing), then the
    slot's offsets read from `starts`; None past the slot's clients,
    else (slot, first position in `order`, live rows)."""
    lo, hi = 0, len(starts) - 1
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        le = [s < hi and starts[s] // rows + s <= tile
              for s in (lo + lane * step for lane in range(32))]
        last = max(i for i, x in enumerate(le) if x)
        hi = min(hi, lo + (last + 1) * step)
        lo += last * step
    first = starts[lo]
    n_s = starts[lo + 1] - first
    j = tile - (first // rows + lo)
    if j * rows >= n_s:
        return None
    return lo, first + j * rows, min(rows, n_s - j * rows)


def _layouts(m, s, rs):
    """Bucket layouts of M clients over S slots (the non-empty first):
    even, one giant, singletons, sizes just past a tile, random."""
    out = [[m] + [0] * (s - 1)]
    live = min(s, m)
    base = [m // live + (i < m % live) for i in range(live)]
    out.append(base + [0] * (s - live))
    for r in (32, 64, 128):
        sizes, left = [], m
        while left and len(sizes) < s:
            take = min(left, r + 1 if len(sizes) < s - 1 else left)
            sizes.append(take)
            left -= take
        if not left:
            out.append(sizes + [0] * (s - len(sizes)))
    cuts = np.sort(rs.choice(np.arange(1, m), size=min(live, m) - 1,
                             replace=False)) if live > 1 else np.array([])
    sizes = np.diff(np.concatenate([[0], cuts, [m]])).astype(int).tolist()
    out.append(sizes + [0] * (s - len(sizes)))
    return out


@pytest.mark.parametrize("m,pb", [(10, 10), (37, 3), (300, 4), (700, 2),
                                  (1000, 0), (4096, 10), (5000, 6),
                                  (33, 10), (37, 10), (63, 10), (67, 10)])
def test_ann_plan_tiles_cover_every_bucket_layout(m, pb):
    """Under the kernel's mapping, the plan's tiles cover every client of
    every slot exactly once, at most `rows` a tile, whatever the layout."""
    rs = np.random.RandomState(m)
    s = min(1 << pb, m)
    k = ann.candidate_count(m, pb, 8, 16, 256)
    plan = selection.ann_plan(m, 8, 16, k, s)
    rows = plan["rows"]
    for sizes in _layouts(m, s, rs):
        assert sum(sizes) == m and len(sizes) == s
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
        seen = []
        for tile in range(plan["tiles"]):
            got = _kernel_tile(starts, rows, tile)
            if got is None:
                continue
            slot, p0, live = got
            assert 0 < live <= rows
            assert starts[slot] <= p0 and p0 + live <= starts[slot + 1]
            seen += list(range(p0, p0 + live))
        assert sorted(seen) == list(range(m))
        assert sum(-(-n // rows) for n in sizes) <= plan["tiles"]


def test_list_strides():
    """Exact instances: N rounded up to an odd multiple of 4 words;
    grouped: N made odd."""
    for n in range(1, 129):
        e, g = selection.row_stride(n), selection.row_stride(n, True)
        assert e % 4 == 0 and (e // 4) % 2 == 1 and n <= e < n + 8
        assert g % 2 == 1 and n <= g <= n + 1


GRID_W = (1, 2, 3, 8, 16, 32)
GRID_N = (1, 9, 16, 64, 128)
GRID_K = (1, 26, 100, 185, 1000, 2336, 4128, 65_568)


@pytest.mark.parametrize("w", GRID_W)
def test_ann_plan_invariants(w):
    """Rows a multiple of 16 in 16-128, one to four warps; splits 1-8
    that cover the K positions with none empty; shared memory within one
    CTA's and equal to ann_smem_bytes; the grid as the kernel launches
    it; the same plan for the same shapes."""
    for m in (2, 10, 100, 4096, 65_536):
        for s in sorted({1, min(16, m), min(1024, m), m}):
            for n in GRID_N:
                for k in GRID_K:
                    plan = selection.ann_plan(m, w, n, k, s)
                    assert plan == selection.ann_plan(m, w, n, k, s)
                    nsel = max(min(n, m - 1), 0)
                    rows, sp, sl = (plan["rows"], plan["splits"],
                                    plan["split_len"])
                    assert rows % 16 == 0 and 16 <= rows <= 128
                    assert rows == selection.ROWS_PER_WARP * plan["warps"]
                    assert plan["warps"] in (1, 2, 4)
                    assert plan["threads"] == 32 * plan["warps"]
                    assert plan["kw"] == selection.mma_words(w)
                    assert 1 <= sp <= selection.MAX_SPLITS and sl % 8 == 0
                    assert sp * sl >= k and (sp - 1) * sl < k
                    assert plan["smem_bytes"] <= MAX_SHARED_BYTES
                    assert plan["smem_bytes"] == selection.ann_smem_bytes(
                        plan["kw"], rows, nsel)
                    assert plan["tiles"] == -(-m // rows) + s
                    assert plan["ctas"] == plan["tiles"] * sp
                    assert plan["block_k"] == selection.BLOCK_K


def test_ann_plan_at_the_paper_shapes():
    """Four-warp tiles of 128 rows at every paper shape. M = 10 (K = 100,
    10 slots): 11 tiles, no split. M = 4,096 (K = 185, 1,024 slots) and
    M = 65,536 (K = 2,336, 1,024 slots): no split. Prefix 0 at M = 4,096
    (one slot, K = 4,128): the exact kernels' 128 rows x 8 splits."""
    p = selection.ann_plan(10, 8, 9, 100, 10)
    assert (p["rows"], p["splits"], p["tiles"]) == (128, 1, 11)
    p = selection.ann_plan(4096, 8, 16, 185, 1024)
    assert (p["rows"], p["splits"], p["tiles"]) == (128, 1, 1056)
    p = selection.ann_plan(65_536, 8, 16, 2336, 1024)
    assert (p["rows"], p["splits"], p["tiles"]) == (128, 1, 1536)
    p = selection.ann_plan(4096, 8, 16, 4128, 1)
    e = selection.select_plan(4096, 8, 16)
    assert (p["rows"], p["splits"]) == (e["rows"], e["splits"]) == (128, 8)
    # the exact lists' stride (N = 16: 20 words), the grouped one (17)
    # and the ring of three id tiles
    assert (selection.row_stride(16), selection.row_stride(16, True)) == \
        (20, 17)
    assert p["smem_bytes"] == e["smem_bytes"] - 4 * 2 * 128 * 3 + \
        4 * 3 * selection.BLOCK_K
    # N = 128 at W = 32 still fits four warps
    assert selection.ann_plan(65_536, 32, 128, 2336, 1024)["warps"] == 4
