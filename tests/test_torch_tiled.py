"""The port's tiled regime held against the JAX package on the CPU: the
column-tiled selection, the streamed exchange, the tiling resolver and a
tiled federation.

Inputs are made with numpy from a seed. On the CPU the port's wrappers
take their plain versions (`ref.fused_select_tiled_ref`,
`ref.streamed_exchange_ref`); the JAX side runs its jnp oracles and its
Pallas kernels in interpret mode. Tolerances:

* selection ids: equal to JAX's `fused_select_tiled(interpret=True)` and
  `ref.fused_select_ref`; weights within 2 ulps of them (torch's and
  XLA's f32 exp give table entries 1 ulp apart, and the product with the
  score rounds once more), and bit-equal to the port's own
  `fused_select_ref`;
* streamed exchange: l_ij and target within rtol 2e-5, atol 1e-5 (the
  JAX contract of `tests/test_tiled_kernels.py`), valid and has_target
  equal.

The CUDA kernels themselves are held against these plain versions on
the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.exchange import fused_exchange_streamed as jax_streamed
from repro.kernels.selection import fused_select_tiled as jax_select_tiled

from repro_torch.configs.paper_models import FedConfig
from repro_torch.core import all_in_one_exchange, backends
from repro_torch.core.neighbor import select_partners
from repro_torch.kernels import exchange, ref, selection
from repro_torch.kernels.build import MAX_SHARED_BYTES
from repro_torch.launch.fed import run_federation


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _codes(rs, m, w):
    """Random packed codes: (uint32 for JAX, int32 view for the port)."""
    u = rs.randint(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


def _ulps(a, b):
    """Distance in f32 ulps between same-sign finite arrays (inf == inf)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ai, bi = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    return np.where(a == b, 0, np.abs(ai - bi))


# ---------------------------------------------------------------------------
# column-tiled selection (Pallas row 4)
# ---------------------------------------------------------------------------
def _select_all(cu, ci, scores, *, words, n, bm, bk, gamma=1.0, **flags):
    """(JAX tiled kernel, JAX oracle, port tiled plain, port one-shot
    plain) on the same codes and scores."""
    kw = dict(bits=words * 32, gamma=gamma, num_neighbors=n, **flags)
    jk = jax_select_tiled(jnp.asarray(cu), jnp.asarray(scores), **kw,
                          block_m=bm, block_k=bk, interpret=True)
    jo = jref.fused_select_ref(jnp.asarray(cu), jnp.asarray(scores), **kw)
    lut = ref.selection_lut(words, words * 32, gamma)
    pk = ref.fused_select_tiled_ref(_t(ci), _t(scores), lut, num_neighbors=n,
                                    block_m=bm, block_k=bk, **flags)
    po = ref.fused_select_ref(_t(ci), _t(scores), lut, num_neighbors=n,
                              **flags)
    return jk, jo, pk, po


def _assert_selection_agrees(jk, jo, pk, po):
    pi, pw = (a.numpy() for a in pk)
    assert pi.dtype == np.int32
    for ji, jw in (jk, jo):
        assert np.array_equal(pi, np.asarray(ji))
        assert np.all(_ulps(pw, jw) <= 2)
    assert torch.equal(pk[0], po[0]) and torch.equal(pk[1], po[1])


@pytest.mark.parametrize("m,words,n,bm,bk", [
    (6, 4, 3, 8, 128),        # single tile both axes
    (37, 8, 5, 8, 128),       # ragged M on both grids
    (9, 4, 8, 8, 128),        # N = M-1 clamp edge
    (130, 4, 7, 32, 128),     # ragged across two column tiles
    (257, 4, 12, 64, 128),    # one past a tile boundary
])
def test_tiled_selection_matches_jax_ragged(m, words, n, bm, bk):
    rs = np.random.RandomState(m * words)
    cu, ci = _codes(rs, m, words)
    scores = rs.rand(m).astype(np.float32)
    _assert_selection_agrees(*_select_all(cu, ci, scores, words=words, n=n,
                                          bm=bm, bk=bk))


def test_tiled_selection_cross_tile_ties():
    """Three distinct codes and scores on a 0.25 grid: equal weights
    straddle every column-tile boundary, and round 0's all-zero scores
    tie every weight."""
    rs = np.random.RandomState(2)
    m, n = 300, 12
    base_u, _ = _codes(rs, 3, 4)
    cu = base_u[rs.randint(0, 3, m)]
    ci = cu.view(np.int32)
    for scores in (np.round(rs.rand(m) * 4).astype(np.float32) / 4,
                   np.zeros(m, np.float32)):
        _assert_selection_agrees(*_select_all(cu, ci, scores, words=4, n=n,
                                              bm=64, bk=128))


@pytest.mark.parametrize("flags", [dict(use_lsh=False), dict(use_rank=False)])
def test_tiled_selection_ablation_switches(flags):
    rs = np.random.RandomState(42)
    m, words = 150, 4
    cu, ci = _codes(rs, m, words)
    scores = rs.choice([0.0, 0.5, 1.0], m).astype(np.float32)
    _assert_selection_agrees(*_select_all(cu, ci, scores, words=words, n=6,
                                          bm=32, bk=128, gamma=0.5, **flags))


def test_tiled_selection_wrapper_degenerate_and_clamped():
    rs = np.random.RandomState(1)
    _, ci = _codes(rs, 4, 2)
    ids, w = selection.fused_select_tiled(_t(ci), torch.zeros(4), bits=64,
                                          gamma=1.0, num_neighbors=12)
    assert ids.shape == (4, 3) and torch.isfinite(w).all()
    ids1, w1 = selection.fused_select_tiled(_t(ci[:1]), torch.zeros(1),
                                            bits=64, gamma=1.0,
                                            num_neighbors=3)
    assert ids1.shape == (1, 0) and w1.shape == (1, 0)


# ---------------------------------------------------------------------------
# streamed exchange (Pallas row 7)
# ---------------------------------------------------------------------------
def _exchange_inputs(m, n, r, c, seed, sel_p=0.7):
    rs = np.random.RandomState(seed)
    own = (rs.randn(m, r, c) * 3).astype(np.float32)
    nb = (rs.randn(m, n, r, c) * 3).astype(np.float32)
    y = rs.randint(0, c, size=(m, r)).astype(np.int32)
    sel = rs.rand(m, n) < sel_p
    return own, nb, y, sel


def _assert_exchange_close(got, want, name):
    gl, gv, gt, gh = (np.asarray(a) for a in got)
    wl, wv, wt, wh = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gl, wl, rtol=2e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(gt, wt, rtol=2e-5, atol=1e-5, err_msg=name)
    assert gv.dtype == np.bool_ and np.array_equal(gv, wv), name
    assert np.array_equal(gh, wh), name


@functools.lru_cache(maxsize=None)
def _jax_streamed_ref(lsh_verification, block_r, block_c):
    return jax.jit(functools.partial(
        jref.streamed_exchange_ref, lsh_verification=lsh_verification,
        block_r=block_r, block_c=block_c))


@pytest.mark.parametrize("m,n,r,c,br,bc", [
    (5, 3, 9, 17, 4, 128),     # ragged M, R; single C tile
    (7, 5, 12, 70, 8, 128),    # ragged everything
    (4, 2, 8, 513, 8, 128),    # one past a C-tile boundary
    (6, 4, 16, 40, 8, 128),    # two R tiles
    (3, 4, 5, 300, 8, 128),    # three C tiles, ragged R
    (9, 1, 3, 4, 8, 128),      # single neighbour, tiny tail shapes
    (1, 4, 4, 5, 8, 128),      # single client
])
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_streamed_exchange_matches_jax(m, n, r, c, br, bc, lsh_verification):
    own, nb, y, sel = _exchange_inputs(m, n, r, c, seed=m * n + r)
    jin = tuple(jnp.asarray(a) for a in (own, nb, y, sel))
    port = ref.streamed_exchange_ref(_t(own), _t(nb), _t(y), _t(sel),
                                     lsh_verification=lsh_verification,
                                     block_r=br, block_c=bc)
    j_ref = _jax_streamed_ref(lsh_verification, br, bc)(*jin)
    j_kernel = jax_streamed(*jin, lsh_verification=lsh_verification,
                            block_r=br, block_c=bc, interpret=True)
    _assert_exchange_close(port, j_ref, "port vs JAX streamed_exchange_ref")
    _assert_exchange_close(port, j_kernel, "port vs JAX streamed kernel")
    one_shot = ref.all_in_one_exchange_ref(_t(own), _t(nb), _t(y), _t(sel),
                                           lsh_verification=lsh_verification)
    _assert_exchange_close(port, one_shot, "port streamed vs port one-shot")


def test_streamed_tiles_clamps_small_shapes():
    br, pr, bc, pc = ref.streamed_tiles(5, 17)
    assert br == 8 and (5 + pr) % br == 0
    assert bc == 128 and (17 + pc) % bc == 0
    assert ref.streamed_tiles(64, 4096) == (8, 0, 512, 0)


def test_streamed_exchange_upper_half_keep_count():
    own, nb, y, sel = _exchange_inputs(8, 5, 6, 4, seed=11, sel_p=0.6)
    _, valid, _, has = exchange.fused_exchange_streamed(
        _t(own), _t(nb), _t(y), _t(sel))
    kept = valid.sum(1).numpy()
    assert (kept == (sel.sum(1) + 1) // 2).all()
    assert not (valid.numpy() & ~sel).any()
    assert np.array_equal(has.numpy(), kept > 0)


# ---------------------------------------------------------------------------
# the entry points and the resolver
# ---------------------------------------------------------------------------
def test_select_partners_tiling_paths_agree():
    rs = np.random.RandomState(7)
    m = 37
    _, ci = _codes(rs, m, 4)
    scores = _t(rs.rand(m).astype(np.float32))
    fed = FedConfig(num_clients=m, num_neighbors=5, top_k=2, lsh_bits=128)
    outs = {t: select_partners(_t(ci), scores, fed, backend="oracle",
                               tiling=t)
            for t in ("oneshot", "tiled", "auto")}
    for t in ("tiled", "auto"):
        assert torch.equal(outs[t][0], outs["oneshot"][0]), t
        assert torch.equal(outs[t][1], outs["oneshot"][1]), t
    with pytest.raises(ValueError, match="unknown tiling: 'huge'"):
        select_partners(_t(ci), scores, fed, tiling="huge")


def test_exchange_entry_point_tiling_paths():
    own, nb, y, sel = (_t(a) for a in _exchange_inputs(10, 4, 6, 5,
                                                       seed=23))
    fed = FedConfig(num_clients=10, num_neighbors=4, top_k=2, lsh_bits=128)
    base = all_in_one_exchange(own, nb, y, sel, fed, backend="oracle",
                               tiling="oneshot")
    tiled = all_in_one_exchange(own, nb, y, sel, fed, backend="oracle",
                                tiling="tiled")
    _assert_exchange_close(tuple(tiled), tuple(base), "tiled vs oneshot")
    want = ref.streamed_exchange_ref(own, nb, y, sel)
    for a, b in zip(tiled, want):               # oracle+tiled is the twin
        assert torch.equal(a, b)
    auto = all_in_one_exchange(own, nb, y, sel, fed, backend="oracle")
    for a, b in zip(auto, base):                # small shape: auto == oneshot
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown tiling: 'mega'"):
        all_in_one_exchange(own, nb, y, sel, fed, tiling="mega")


def test_resolve_tiling_at_the_limits():
    sel = backends.selection_oneshot_smem_bytes
    exc = backends.exchange_oneshot_smem_bytes
    assert MAX_SHARED_BYTES == 232_448
    assert backends.resolve_tiling("auto", sel(46_489)) == "oneshot"
    assert backends.resolve_tiling("auto", sel(46_490)) == "tiled"
    assert backends.resolve_tiling("auto", exc(512, 1)) == "oneshot"
    assert backends.resolve_tiling("auto", exc(513, 1)) == "tiled"
    assert exc(9, 64) == 4 * (2 * 64 + 2 * 9 * 64 + 2 * 9)
    r_max = (MAX_SHARED_BYTES // 4 - 2 * 16) // (2 + 2 * 16)
    assert backends.resolve_tiling("auto", exc(16, r_max)) == "oneshot"
    assert backends.resolve_tiling("auto", exc(16, r_max + 1)) == "tiled"
    assert backends.resolve_tiling("auto", 100, budget_bytes=10) == "tiled"
    assert backends.resolve_tiling("oneshot", 1 << 60) == "oneshot"
    assert backends.resolve_tiling("tiled", 0) == "tiled"
    with pytest.raises(ValueError, match=r"unknown tiling: 'huge' \(expected "
                                         r"one of \('auto', 'oneshot', "
                                         r"'tiled'\)\)"):
        backends.resolve_tiling("huge", 0)


def test_tiled_wrappers_take_the_plain_version_on_cpu_without_launching():
    before = (selection.TILED_KERNEL.launches,
              exchange.STREAMED_KERNEL.launches)
    rs = np.random.RandomState(0)
    _, ci = _codes(rs, 5, 2)
    selection.fused_select_tiled(_t(ci), torch.rand(5), bits=64, gamma=1.0,
                                 num_neighbors=2)
    own, nb, y, sel = _exchange_inputs(3, 2, 4, 5, seed=0)
    exchange.fused_exchange_streamed(_t(own), _t(nb), _t(y), _t(sel))
    assert (selection.TILED_KERNEL.launches,
            exchange.STREAMED_KERNEL.launches) == before


def test_tiled_federation_runs_on_cpu():
    """Two aecg rounds with tiling="tiled" on the CPU: the selections
    equal the one-shot run's (the tiled selection is bit-equal), the
    masks and accuracies agree (the streamed exchange agrees with the
    one-shot one within f32 rounding)."""
    runs = {t: run_federation("aecg", num_clients=4, rounds=2, tiling=t,
                              device="cpu", log=None)[1]
            for t in ("oneshot", "tiled")}
    for a, b in zip(runs["tiled"], runs["oneshot"]):
        assert a["neighbor_ids"] == b["neighbor_ids"]
        assert a["valid_mask"] == b["valid_mask"]
        assert abs(a["acc"] - b["acc"]) <= 0.02
        assert np.isfinite(a["mean_loss"])
