"""The per-row ANN selection in one-slot form, on the CPU.

`selection.fused_select_ann` takes arbitrary (M, K) candidate ids per
row. On the card it runs the grouped kernel on `ann.per_row_slots`
(the ids as the lists, client i alone in slot i) under
`ann_plan(one_row_slots=True)`. Here the form goes through the grouped
kernel's plain version (`ref.ann_select_grouped_ref`) and is held bit
for bit against `ref.ann_select_ref`, the JAX `ann_select_ref` and the
JAX Pallas kernel `fused_select_ann` (interpret mode, as
`tests/test_ann_selection.py` runs it), on lists the buckets never
make: repeated ids, the row itself anywhere, sentinels scattered
between valid ids, a row of sentinels only, K not a multiple of 8 and
K = N, under -inf scores and each Table-3 switch. Weights are compared
bit for bit through the JAX exp table (handed to the port's plain
versions), ids always. Also: the form's fields, and the plan, which
without the keyword is the route's plan exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ann_lists import arbitrary_lists
from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.kernels import ref as jref
from repro.kernels.selection import fused_select_ann as jax_fused_select_ann

from repro_torch.core import ann
from repro_torch.kernels import ref, selection

GAMMA = 1.0
M, W = 45, 4            # not a power of two, above 32 (more than 32 slots)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_lut(w, bits, gamma=GAMMA):
    return _t(np.asarray(jnp.exp(-gamma * (
        jnp.arange(w * 32 + 1, dtype=jnp.float32) / float(bits)))))


def _codes(m, w, seed):
    """Random packed codes with a run of equal ones (uint32 for JAX,
    the int32 view for the port)."""
    u = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    u[5:9] = u[4]
    return u, u.view(np.int32)


def _scores(m, kind, seed):
    """Gridded Eq. 7-like scores (ties), the same with a third of the
    clients departed (-inf), or all zero (round 0)."""
    rs = np.random.RandomState(seed)
    s = rs.choice([0.0, 0.25, 0.5, 1.0], m).astype(np.float32)
    if kind == "departed":
        s[rs.permutation(m)[:m // 3]] = -np.inf
    elif kind == "zero":
        s[:] = 0.0
    return s


FLAGS = {"full": {}, "no_lsh": {"use_lsh": False},
         "no_rank": {"use_rank": False}}


@pytest.mark.parametrize("k,n", [(29, 6), (6, 6)], ids=["k29", "k_eq_n"])
@pytest.mark.parametrize("scores_kind", ["grid", "departed", "zero"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_one_slot_form_equals_the_per_row_references(k, n, scores_kind,
                                                     flag):
    flags = FLAGS[flag]
    cu, ci = _codes(M, W, seed=k + n)
    scores = _scores(M, scores_kind, seed=k)
    ids = arbitrary_lists(M, k, seed=k * n)
    codes_t, scores_t, ids_t = _t(ci), _t(scores), _t(ids)
    lut = _jax_lut(W, W * 32)
    slots = ann.per_row_slots(ids_t, M)
    gi, gw = ref.ann_select_grouped_ref(codes_t, scores_t, slots, lut,
                                        num_neighbors=n, block_m=16, **flags)
    pi, pw = ref.ann_select_ref(codes_t, scores_t, ids_t, lut,
                                num_neighbors=n, **flags)
    assert gi.dtype == torch.int32 and gi.shape == (M, n)
    assert torch.equal(gi, pi) and torch.equal(gw, pw)
    kw = dict(bits=W * 32, gamma=GAMMA, num_neighbors=n, **flags)
    ji, jw = jref.ann_select_ref(jnp.asarray(cu), jnp.asarray(scores),
                                 jnp.asarray(ids), **kw)
    ki, kw_ = jax_fused_select_ann(jnp.asarray(cu), jnp.asarray(scores),
                                   jnp.asarray(ids), interpret=True, **kw)
    for i, w in ((ji, jw), (ki, kw_)):
        assert np.array_equal(gi.numpy(), np.asarray(i))
        assert np.array_equal(gw.numpy(), np.asarray(w))
    # the lists' cases show in the result: row 3 has no finite weight
    # (id 0, -inf), row 5 takes its one id at most once per position,
    # and a rank is never the row itself
    assert bool((gi[3] == 0).all()) and bool(torch.isinf(gw[3]).all())
    assert set(gi[5][gw[5].isfinite()].tolist()) <= {7}
    assert not bool((gi == torch.arange(M)[:, None])[gw.isfinite()].any())
    # the wrapper on the CPU: the plain version, and no launch
    before = (selection.ANN_KERNEL.launches,
              selection.GROUPED_KERNEL.launches)
    wi, ww = selection.fused_select_ann(codes_t, scores_t, ids_t,
                                        bits=W * 32, gamma=GAMMA,
                                        num_neighbors=n, **flags)
    assert torch.equal(wi, gi)
    assert (selection.ANN_KERNEL.launches,
            selection.GROUPED_KERNEL.launches) == before


def test_per_row_slots_fields():
    ids = _t(arbitrary_lists(M, 29, seed=3))
    c = ann.per_row_slots(ids, M)
    assert c.lists is ids and c.lists.data_ptr() == ids.data_ptr()
    idx = torch.arange(M, dtype=torch.int32)
    for t in (c.slot, c.order, c.bucket):
        assert t.dtype == torch.int32 and torch.equal(t, idx)
    assert c.starts.dtype == torch.int32
    assert torch.equal(c.starts, torch.arange(M + 1, dtype=torch.int32))
    assert torch.equal(c.counts, torch.ones(M, dtype=torch.int32))
    assert int(c.dropped) == 0 and c.dropped.shape == ()
    assert torch.equal(c.lists[c.slot.long()], ids)
    meta = ann.per_row_slots(torch.empty((M, 29), dtype=torch.int32,
                                         device="meta"), M)
    assert all(t.device.type == "meta" for t in meta)


# the route's plans before the keyword existed, at its shapes: (M, W, N,
# K, S) with K = candidate_count(M, 10, 8, N) and S = min(2^10, M), and
# one bucket (prefix 0)
ROUTE_PLANS = [
    ((10, 8, 9, 100, 10), dict(
        kw=8, warps=4, rows=128, threads=128, tiles=11, splits=1,
        split_len=104, block_k=64, smem_bytes=22544, ctas=11)),
    ((4096, 8, 16, 185, 1024), dict(
        kw=8, warps=4, rows=128, threads=128, tiles=1056, splits=1,
        split_len=192, block_k=64, smem_bytes=30736, ctas=1056)),
    ((65_536, 8, 16, 2336, 1024), dict(
        kw=8, warps=4, rows=128, threads=128, tiles=1536, splits=1,
        split_len=2336, block_k=64, smem_bytes=30736, ctas=1536)),
    ((4096, 8, 16, 4128, 1), dict(
        kw=8, warps=4, rows=128, threads=128, tiles=33, splits=8,
        split_len=520, block_k=64, smem_bytes=30736, ctas=264)),
    ((65_536, 32, 128, 2560, 1024), dict(
        kw=32, warps=4, rows=128, threads=128, tiles=1536, splits=1,
        split_len=2560, block_k=64, smem_bytes=160784, ctas=1536)),
]


@pytest.mark.parametrize("shape,plan", ROUTE_PLANS,
                         ids=[str(s[0]) for s, _ in ROUTE_PLANS])
def test_route_plan_is_unchanged_without_the_keyword(shape, plan):
    assert selection.ann_plan(*shape) == plan
    assert selection.ann_plan(*shape, one_row_slots=False) == plan


@pytest.mark.parametrize("m,w,n,k", [(10, 8, 9, 100), (4096, 8, 16, 185),
                                     (4097, 8, 16, 64), (65_536, 8, 16, 2336),
                                     (46_489, 32, 128, 4128)])
def test_one_slot_plan_is_a_function_of_the_shapes(m, w, n, k):
    plans = [selection.ann_plan(m, w, n, k, s, one_row_slots=True)
             for s in (1, m, min(1024, m))]
    assert plans[0] == plans[1] == plans[2]
    p = plans[0]
    assert p["instance"] == "warp" and p["splits"] == 1
    assert p["rows"] == p["warps"] == selection.ONE_SLOT_ROWS <= 8
    assert p["threads"] == 32 * p["warps"]
    assert p["tiles"] == p["ctas"] == -(-m // p["rows"])  # a warp a client
    assert p["split_len"] >= k and p["split_len"] % 8 == 0
    assert p["block_k"] == (64 if w <= 16 else 32)
    assert p["smem_bytes"] == 0
