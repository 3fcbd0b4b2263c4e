"""The LSH kernels' split plan and summation order, on the CPU.

The CUDA kernels (`csrc/lsh_projection.cu`) cut P into P / L splits of
L = `lsh_projection.split_len(P)` parameters, run one f32 chain per
split in increasing p and add the splits in order in f64.
`ref.lsh_project_sums_split_order` is that order in plain tensor
operations; `tests/test_torch_cuda.py` and `chip_smoke.py` hold the
kernels to it with `torch.equal` on the card. Here it is held:

* against the JAX oracle (`repro.kernels.ref.lsh_project_sums_batched_ref`,
  one f32 dot per row): sums within 1e-5 * (|oracle| + ||x_row||_2),
  the same tolerance as the plain version's; codes equal on every bit
  whose oracle sum is farther than 1e-3 from zero;
* against itself on one row (bit for bit: a row's sums do not depend on
  M), and against a sequential f32 loop over p in numpy, on the JAX
  package's R (bit for bit: this pins the order the kernel follows).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lsh_projection import rademacher_block as jax_rademacher

from repro_torch.kernels import lsh_projection, ops, ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(m, p, seed):
    return (np.random.RandomState(seed).randn(m, p) * 0.05).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(1, 128), (129, 256), (257, 512)])
def test_split_len_divides_every_padded_p(lo, hi):
    for k in range(lo, hi + 1):
        p = k * ops.CHUNK
        length = lsh_projection.split_len(p)
        assert length in lsh_projection.SPLIT_LENS
        assert p % length == 0
        # one split per SM wherever some length allows it
        assert p // length >= lsh_projection.NUM_SMS or length == 128
        assert (length == 2048) == (p >= 270_336)


def test_split_len_at_the_named_shapes():
    assert [lsh_projection.split_len(p) for p in
            (2048, 4096, 8192, 12_288, 268_288, 270_336, 421_888)] == \
        [128, 128, 128, 128, 1024, 2048, 2048]


@pytest.mark.parametrize("p", [2048, 12_288, 268_288, 421_888])
def test_split_plan_depends_on_p_alone(p):
    length = lsh_projection.split_len(p)
    for bits in (32, 64, 256, 512):
        for m in (None, 1, 3, 17, 64, 4096):
            chunk, groups, shape = lsh_projection.split_plan(p, m, bits)
            assert chunk == length
            rows = () if m is None else (groups[0][1] - groups[0][0],)
            assert shape == (p // length, *rows, bits)


@pytest.mark.parametrize("m,p,bits", [
    (1, 4096, 256), (4096, 4096, 256), (4096, 12_288, 256),
    (65_536, 12_288, 256), (65_537, 12_288, 512), (300, 421_888, 256),
    (20_000, 1_048_576, 512)])
def test_row_groups_cover_the_rows_within_the_scratch_cap(m, p, bits):
    """Consecutive groups from row 0 to m; a group's partial sums fit in
    PARTIAL_BYTES, or the group is one row tile; all groups but the last
    are whole row tiles of one size, and one group is taken when the
    whole batch fits."""
    groups = lsh_projection.row_groups(m, p, bits)
    row_bytes = 4 * (p // lsh_projection.split_len(p)) * bits
    tile = lsh_projection.ROW_TILE
    assert groups[0][0] == 0 and groups[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    for a, b in groups:
        assert 0 < b - a
        assert ((b - a) * row_bytes <= lsh_projection.PARTIAL_BYTES
                or b - a == tile)
    if m * row_bytes <= lsh_projection.PARTIAL_BYTES:
        assert groups == [(0, m)]
    else:
        size = groups[0][1]
        assert size % tile == 0
        assert all(b - a == size for a, b in groups[:-1])


def test_split_plan_and_kernel_plan_count_the_same_sms():
    """split_len fills NUM_SMS with splits; the C launch plan sizes its
    tiles against its own SMS constant. Both are the H100's count."""
    src = (Path(lsh_projection.__file__).parent / "csrc" /
           "lsh_projection.cu").read_text()
    found = re.findall(r"constexpr int SMS = (\d+);", src)
    assert found == [str(lsh_projection.NUM_SMS)]


# ---------------------------------------------------------------------------
# the order twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,seed", [(32, 7), (64, 2 ** 31 + 9), (256, 3)])
@pytest.mark.parametrize("p", [2048, 4096, 12_288])
@pytest.mark.parametrize("m", [1, 3, 17])
def test_split_order_matches_jax_oracle(m, p, bits, seed):
    x = _x(m, p, seed=m * 7 + p)
    j = np.asarray(jref.lsh_project_sums_batched_ref(jnp.asarray(x), seed,
                                                     bits=bits))
    s = ref.lsh_project_sums_split_order(
        _t(x), seed, bits=bits, chunk=lsh_projection.split_len(p)).numpy()
    scale = np.linalg.norm(x, axis=1, keepdims=True)
    assert np.all(np.abs(s - j) <= 1e-5 * (np.abs(j) + scale))
    off_zero = np.abs(j) > 1e-3
    assert np.array_equal((s > 0)[off_zero], (j > 0)[off_zero])
    pc = ops.pack_bits(_t(s)).numpy().view(np.uint32)
    jc = np.asarray(jops.pack_bits(jnp.asarray(j)))
    if off_zero.all():
        assert np.array_equal(pc, jc)


@pytest.mark.parametrize("m,p,bits", [(3, 4096, 64), (17, 12_288, 256)])
def test_split_order_row_is_the_single_row(m, p, bits):
    x = _t(_x(m, p, seed=11))
    chunk = lsh_projection.split_len(p)
    full = ref.lsh_project_sums_split_order(x, 5, bits=bits, chunk=chunk)
    for i in range(m):
        one = ref.lsh_project_sums_split_order(x[i:i + 1], 5, bits=bits,
                                               chunk=chunk)
        assert torch.equal(full[i], one[0])


@pytest.mark.parametrize("chunk", [2048, 128])
def test_split_order_is_a_sequential_f32_loop(chunk):
    """One chain per split in increasing p from 0, every step rounded to
    f32, then the splits added in order from 0 in f64 and the total
    rounded to f32 once; at chunk = P this is one plain sequential f32
    loop."""
    m, p, bits, seed = 2, 2048, 32, 2 ** 31 + 1
    x = _x(m, p, seed=3)
    r = np.asarray(jax_rademacher(0, p, bits, seed))
    out = np.zeros((m, bits), np.float64)
    for k in range(p // chunk):
        acc = np.zeros((m, bits), np.float32)
        for i in range(k * chunk, (k + 1) * chunk):
            acc = acc + x[:, i:i + 1] * r[i][None, :]
        out = out + acc.astype(np.float64)
    s = ref.lsh_project_sums_split_order(_t(x), seed, bits=bits,
                                         chunk=chunk).numpy()
    assert s.dtype == np.float32 and np.array_equal(
        s, out.astype(np.float32))
