"""The flash-attention kernel's launch plan, its persistent schedule and
its packed-row algorithm on the CPU.

`flash_attention.flash_plan` is the Python mirror of the kernel's plan
(the C `flash_plan_field`, compared on the card by the analysis gate):
configuration, G query heads packed per KV head, packed rows per item,
items, keys per stage, stages, shared memory, blocks per SM and grid. It
is checked over f32/bf16 x dh {32, 64, 100, 128, 256} x the paths'
(Sq, G, causal): the federation's neighbour web (32, 4), serving (2,048,
1), Minitron-4B (2,048, 3), grok-1 (2,048, 6), whisper's encoder (1,500,
1, bidirectional) and a ragged shape (41, 3).

The schedule and packed-row tests below check models of the kernel, not
the kernel: `item_schedule` restates the blocks' static schedule
(`flash_attention.cu:item_index`, `item_at`) and `packed_attention` its
algorithm, so they can fail only on the design they restate. What they
hold is that design: every (batch, KV head, row tile) exactly once; with
more items than resident blocks, in pairs of one (batch, KV head)'s
longest and shortest tiles left, so the blocks' causal work evens out
and the grid works on a few (batch, KV head)s at a time.

`packed_attention` below computes attention the way the kernel does:
q's G heads of a KV head gathered position-major into packed rows (row r
is position r // G of head kvh * G + r % G), items of the plan's rows,
keys in tiles of its BK with the online softmax in base 2 (-1e30 for a
masked score, the causal mask at position r // G, out = acc / max(l,
1e-30)), scattered back. It is held to `plain_gqa_attention` within 1e-6
(f32: the online softmax reorders the sums) and to the JAX kernel
`repro.kernels.flash_attention.flash_attention` in interpret mode within
2e-5 (the CUDA kernel's f32 tolerance). Inputs come from numpy with a
seed. The CUDA kernel itself is held against its plain version on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.kernels import flash_attention as jflash

from repro_torch.kernels import flash_attention as fa

SMEM_LIMIT = 232_448          # dynamic shared memory of one H100 block
SM_SMEM = 233_472             # of one SM (1 KB of it reserved per block)
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 100, 128, 256)
# (name, Sq = Sk, G, causal)
SHAPES = (("web", 32, 4, True), ("serving", 2048, 1, True),
          ("minitron-4b", 2048, 3, True), ("grok-1", 2048, 6, True),
          ("whisper", 1500, 1, False), ("ragged", 41, 3, True))


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plan_fits_the_card(dtype, dh, shape):
    _, s, g, causal = shape
    b, kvh = 4, 2
    plan = fa.flash_plan(b, s, s, g * kvh, kvh, dh, dtype, causal)
    assert plan["group"] == g
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SM_SMEM
    assert plan["rows_per_item"] % 64 == 0
    assert plan["rows_per_item"] == 64 * plan["warpgroups"]
    assert plan["head_dim"] >= dh and plan["head_dim"] % 64 == 0
    assert plan["items"] == b * kvh * -(-s * g // plan["rows_per_item"])
    resident = plan["blocks_per_sm"] * fa.H100_SMS
    assert plan["paired"] == (causal and plan["items"] > resident)
    assert plan["grid"] == min(-(-plan["items"] // 2) if plan["paired"]
                               else plan["items"], resident)
    assert plan["bk"] == (32 if dh <= 64 and s <= 32 else plan["bk"])
    assert plan["config"].startswith("bf16" if dtype == torch.bfloat16
                                     else "f32")
    for f, key in enumerate(fa.PLAN_FIELDS):
        got = fa.flash_plan_field(int(dtype == torch.bfloat16), b, s, s,
                                  g * kvh, kvh, dh, int(causal),
                                  fa.H100_SMS, f)
        assert got == plan[key], key


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plan_at_the_web_shape_fills_every_row(dtype):
    """256 clients x 8 neighbours x B 8 folded to B 16,384, S 32, 4 query
    heads over 1 KV head, dh 64: one item of 128 live rows per sequence,
    one 32-key tile, no zero-filled keys."""
    plan = fa.flash_plan(16_384, 32, 32, 4, 1, 64, dtype, True)
    assert plan["items"] == 16_384
    assert plan["rows_per_item"] == 128 == 32 * plan["group"]
    assert plan["bk"] == 32
    assert plan["grid"] == plan["blocks_per_sm"] * fa.H100_SMS
    if dtype == torch.bfloat16:
        assert plan["config"] == "bf16-d64-short"
        assert plan["blocks_per_sm"] == 2


def test_plan_keeps_one_head_per_item_without_gqa():
    plan = fa.flash_plan(1, 2048, 2048, 96, 96, 128, torch.float32, True)
    assert plan["group"] == 1 and plan["items"] == 96 * 16
    assert plan["config"] == "f32-d128"


def test_plan_rejects_heads_that_do_not_divide():
    with pytest.raises(ValueError):
        fa.flash_plan(1, 8, 8, 6, 4, 64, torch.float32, True)
    assert fa.flash_plan_field(0, 1, 8, 8, 4, 2, 64, 1, 132,
                               len(fa.PLAN_FIELDS)) == -1


def item_tile(i: int, tiles: int) -> tuple:
    """Item i as (batch * KV + KV head, row tile): (batch, KV head)
    i // tiles, its row tiles in the order tiles - 1, 0, tiles - 2, 1, ...
    (the kernel's `item_at`)."""
    k = i % tiles
    return i // tiles, (k // 2 if k % 2 else tiles - 1 - k // 2)


def item_schedule(b: int, kvh: int, tiles: int, grid: int,
                  paired: bool) -> list:
    """The persistent blocks' static schedule: block x's items, each as
    (batch, KV head, row tile), in the order it computes them. Paired,
    block x takes the pairs of items x, x + grid, ... (items 2q, 2q + 1 of
    pair q), else items x, x + grid, ..."""
    items = b * kvh * tiles
    out = []
    for x in range(grid):
        idx = list(range(x, items, grid)) if not paired else [
            i for q in range(x, -(-items // 2), grid)
            for i in (2 * q, 2 * q + 1) if i < items]
        mine = []
        for i in idx:
            bk, t = item_tile(i, tiles)
            mine.append((bk // kvh, bk % kvh, t))
        out.append(mine)
    return out


@pytest.mark.parametrize("b,kvh,tiles,grid,paired", [
    (16_384, 1, 1, 264, True), (4, 8, 16, 132, True), (3, 2, 5, 7, True),
    (1, 1, 1, 1, False), (2, 3, 4, 24, False), (5, 1, 9, 132, True),
    (96, 1, 16, 132, True), (4, 12, 12, 132, False)])
def test_schedule_covers_every_item_once(b, kvh, tiles, grid, paired):
    items = b * kvh * tiles
    grid = min(grid, -(-items // 2) if paired else items)
    blocks = item_schedule(b, kvh, tiles, grid, paired)
    seen = [it for blk in blocks for it in blk]
    assert len(seen) == len(set(seen)) == items
    assert set(seen) == {(i, j, t) for i in range(b) for j in range(kvh)
                         for t in range(tiles)}
    if not paired:                  # round robin: counts differ by <= 1
        sizes = [len(blk) for blk in blocks]
        assert max(sizes) - min(sizes) <= 1
        return
    for blk in blocks:
        for a, c in zip(blk[::2], blk[1::2]):
            if tiles % 2 == 0:         # a pair: one (batch, KV head), the
                assert a[:2] == c[:2]  # longest tile left and the shortest
                assert a[2] + c[2] == tiles - 1 and a[2] > c[2]
    # the blocks' j-th pairs run together: a few (batch, KV head)s at once
    for j in range(0, len(blocks[0]), 2):
        live = {blk[j][:2] for blk in blocks if j < len(blk)}
        assert len(live) <= -(-grid // max(1, tiles // 2)) + 1


@pytest.mark.parametrize("b,kvh,tiles", [(96, 1, 16), (4, 8, 16),
                                         (4, 48, 16)])
def test_schedule_evens_out_the_causal_work(b, kvh, tiles):
    """At the serving prefill's items (16 row tiles of 128 over 2,048
    positions, row tile t causally 2t + 2 key tiles of 64) the block with
    the most key tiles has at most 5 % over the mean: a pair's two tiles
    always hold 2 * 16 + 2 key tiles."""
    plan_grid = min(b * kvh * tiles // 2, fa.H100_SMS)
    blocks = item_schedule(b, kvh, tiles, plan_grid, True)
    work = [sum(2 * t + 2 for _, _, t in blk) for blk in blocks]
    assert max(work) <= 1.05 * sum(work) / len(work)


def packed_attention(q, k, v, causal: bool, rows: int, bk: int,
                     scale: float = 0.0) -> torch.Tensor:
    """The kernel's algorithm over packed rows (see the module docstring):
    q (B, Sq, H, dh), k/v (B, Sk, KV, dh) -> (B, Sq, H, dh) in q's dtype,
    in f32."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    s2 = (scale or dh ** -0.5) * 1.4426950408889634
    kf, vf = (t.float().movedim(2, 1) for t in (k, v))   # (B, KV, Sk, dh)
    # gather: (B, KV, Sq * G, dh), packed row r = (position r // G, head
    # kvh * G + r % G)
    packed = q.float().reshape(b, sq, kvh, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, kvh, sq * g, dh)
    pos = torch.arange(sq * g) // g
    res = torch.empty_like(packed)
    for r0 in range(0, sq * g, rows):
        qr, pr = packed[:, :, r0:r0 + rows], pos[r0:r0 + rows]
        m = torch.full(qr.shape[:3], -1e30)
        l = torch.zeros(qr.shape[:3])
        acc = torch.zeros(qr.shape)
        nk = -(-sk // bk)
        if causal:
            nk = min(nk, int(pr[-1]) // bk + 1)
        for k0 in range(0, nk * bk, bk):
            kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            x = torch.einsum("bhrd,bhkd->bhrk", qr, kt) * s2
            if causal:
                kj = torch.arange(k0, k0 + kt.shape[2])
                x = x.masked_fill(kj[None, :] > pr[:, None], -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhrk,bhkd->bhrd",
                                                       p, vt)
            m = m_new
        res[:, :, r0:r0 + rows] = acc / l.clamp_min(1e-30)[..., None]
    out = res.reshape(b, kvh, sq, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, sq, h, dh)
    return out.to(q.dtype)


def _inputs(b, s, h, kvh, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh), dtype=np.float32)
    k = rng.standard_normal((b, s, kvh, dh), dtype=np.float32)
    v = rng.standard_normal((b, s, kvh, dh), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("b,s,h,kvh,dh,causal", [
    (2, 32, 4, 1, 64, True), (1, 48, 6, 2, 32, False),
    (2, 41, 6, 2, 100, True), (1, 100, 3, 1, 64, True),
    (1, 70, 2, 2, 128, True), (2, 33, 8, 2, 16, False),
    (1, 130, 12, 12, 64, False), (1, 96, 6, 1, 256, True),
    (1, 57, 7, 1, 64, True)])
def test_packed_rows_match_the_plain_version(b, s, h, kvh, dh, causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, s, h, kvh, dh, s))
    plan = fa.flash_plan(b, s, s, h, kvh, dh, torch.float32, causal)
    got = packed_attention(q, k, v, causal, plan["rows_per_item"],
                           plan["bk"])
    want = fa.plain_gqa_attention(q, k, v, causal, 0.0)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("b,s,h,kvh,dh,causal", [
    (2, 32, 4, 1, 64, True), (1, 48, 6, 2, 32, False)])
def test_packed_rows_match_the_jax_kernel(b, s, h, kvh, dh, causal):
    """The JAX Pallas kernel (interpret mode) on the (N, S, dh) layout,
    KV heads repeated to H as its GQA wrapper does."""
    q, k, v = _inputs(b, s, h, kvh, dh, 7 * s)
    g = h // kvh

    def heads_first(a, rep):
        a = np.repeat(a, rep, axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, dh))

    out = np.asarray(jflash.flash_attention(
        heads_first(q, 1), heads_first(k, g), heads_first(v, g),
        causal=causal, interpret=True))
    want = torch.from_numpy(out.reshape(b, h, s, dh).transpose(0, 2, 1, 3)
                            .copy())
    plan = fa.flash_plan(b, s, s, h, kvh, dh, torch.float32, causal)
    got = packed_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal, plan["rows_per_item"], plan["bk"])
    assert (got - want).abs().max().item() <= 2e-5
