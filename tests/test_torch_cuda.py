"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the wrappers' input checks there. Every test needs a CUDA
device and skips without one (the decision is made in a fixture).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; `tests/conftest.py` imports JAX, so run
it there without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in `chip_smoke.py`: LSH sums within
1e-5 * (|plain| + ||x_row||_2), code bits equal off |sum| <= 1e-3, and
the single-client kernel's sums equal to the batched kernel's row;
selection ids and weights equal (one-shot, column-tiled and ANN);
Hamming distances equal; one-shot exchange l_ij and target rtol 1e-5
(atol 1e-5 for target); streamed exchange l_ij and target rtol 2e-5,
atol 1e-5; masks equal (and l_ij NaN where the plain version's is, for
labels outside [-C, C)); flash attention max abs error 2e-5 in f32 and
2e-2 in bf16 on unit-normal inputs.
"""
import ctypes

import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch.kernels import (exchange, flash_attention, hamming,
                                 lsh_projection, ops, ref, selection)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(10, 8192), (37, 4096)])
def test_lsh_kernel_matches_plain(cuda, m, p):
    x = torch.randn((m, p), generator=_gen(m), device=cuda) * 0.05
    k = lsh_projection.lsh_project_sums_batched(x, 3, bits=256)
    pl = ref.lsh_project_sums_batched_ref(x, 3, bits=256)
    err = (k - pl).abs()
    assert bool((err <= 1e-5 * (pl.abs() + x.norm(dim=1, keepdim=True)))
                .all()), err.max()
    off = pl.abs() > 1e-3
    assert torch.equal((k > 0)[off], (pl > 0)[off])


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_selection_kernel_matches_plain(cuda, ties):
    g = _gen(2)
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (40, 8), generator=g,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    codes[5:9] = codes[4]
    scores = (torch.zeros(40, device=cuda) if ties else
              torch.rand(40, generator=g, device=cuda).round(decimals=1))
    lut = ref.selection_lut(8, 256, 1.0, device=cuda)
    for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
        ki, kw = selection.fused_select(codes, scores, bits=256, gamma=1.0,
                                        num_neighbors=9, **flags)
        pi, pw = ref.fused_select_ref(codes, scores, lut, num_neighbors=9,
                                      **flags)
        assert torch.equal(ki, pi) and torch.equal(kw, pw), flags


@pytest.mark.cuda
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_exchange_kernel_matches_plain(cuda, lsh_verification):
    g = _gen(4)
    own = torch.randn((10, 64, 10), generator=g, device=cuda) * 3
    nb = torch.randn((10, 9, 64, 10), generator=g, device=cuda) * 3
    nb[:, 3] = nb[:, 1]                     # an exact KL tie
    y = torch.randint(0, 10, (10, 64), generator=g, device=cuda)
    sel = torch.rand((10, 9), generator=g, device=cuda) < 0.8
    kl, kv, kt, kh = exchange.fused_exchange(
        own, nb, y, sel, lsh_verification=lsh_verification)
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(
        own, nb, y, sel, lsh_verification=lsh_verification)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="P %"):
        lsh_projection.lsh_project_sums_batched(
            torch.zeros((2, 1000), device=cuda), 0)
    with pytest.raises(ValueError, match="int32"):
        selection.fused_select(torch.zeros((4, 2), device=cuda),
                               torch.zeros(4, device=cuda), bits=64,
                               gamma=1.0, num_neighbors=2)
    with pytest.raises(ValueError, match="shape"):
        exchange.fused_exchange(torch.zeros((2, 3, 4), device=cuda),
                                torch.zeros((2, 1, 3, 5), device=cuda),
                                torch.zeros((2, 3), dtype=torch.int32,
                                            device=cuda),
                                torch.ones((2, 1), dtype=torch.bool,
                                           device=cuda))


@pytest.mark.cuda
def test_kernel_backed_round_matches_plain_round(cuda):
    """Two aecg rounds through the kernels and through the plain
    versions on the card: same selections and masks, close metrics."""
    from repro_torch.launch.fed import run_federation
    _, hk = run_federation("aecg", rounds=2, num_clients=6, backend="kernel",
                           device=cuda, log=None)
    _, ho = run_federation("aecg", rounds=2, num_clients=6, backend="oracle",
                           device=cuda, log=None)
    for a, b in zip(hk, ho):
        assert a["neighbor_ids"] == b["neighbor_ids"]
        assert a["valid_mask"] == b["valid_mask"]
        assert abs(a["mean_loss"] - b["mean_loss"]) <= 1e-4 * abs(
            b["mean_loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("m,words,n", [(40, 8, 9), (700, 4, 16), (300, 3, 20),
                                       (130, 32, 128)])
def test_tiled_selection_kernel_matches_plain(cuda, m, words, n):
    """Ragged row blocks and column tiles, the registers path (W = 4, 8)
    and the shared-memory path (W = 3, 32), the largest N, ties."""
    g = _gen(m)
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, words), generator=g,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    codes[5:9] = codes[4]
    bits = words * 32
    lut = ref.selection_lut(words, bits, 1.0, device=cuda)
    for scores in (torch.zeros(m, device=cuda),
                   torch.rand(m, generator=g, device=cuda).round(decimals=1)):
        for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
            ki, kw = selection.fused_select_tiled(
                codes, scores, bits=bits, gamma=1.0, num_neighbors=n, **flags)
            pi, pw = ref.fused_select_tiled_ref(
                codes, scores, lut, num_neighbors=n, block_m=64, block_k=128,
                **flags)
            oi, ow = selection.fused_select(codes, scores, bits=bits,
                                            gamma=1.0, num_neighbors=n,
                                            **flags)
            assert torch.equal(ki, pi) and torch.equal(kw, pw), flags
            assert torch.equal(ki, oi) and torch.equal(kw, ow), flags


# exact selection (select_plan): one 32-row CTA (M <= 32), single-warp
# CTAs split over clusters of 2-8 (M = 129..4,097), W padded to KW
# (1, 3, 4 -> 8; 32 in four 256-bit steps), N up to 128, ragged tiles
EXACT_CASES = [(2, 1, 1), (10, 8, 9), (17, 3, 16), (40, 4, 9), (40, 32, 16),
               (130, 32, 128), (700, 4, 16), (700, 8, 128), (1024, 8, 16),
               (1024, 1, 9), (4097, 8, 16), (4097, 3, 1)]


def _exact_inputs(m, w, seed):
    g = _gen(seed)
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, w), generator=g,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    if m > 9:
        codes[5:9] = codes[4]
    return codes, (torch.zeros(m, device="cuda"),
                   torch.rand(m, generator=g, device="cuda").round(decimals=1))


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,n", EXACT_CASES)
def test_exact_selection_kernels_match_plain_twin_and_repeat(cuda, m, w, n):
    """Both entry points equal the plain version, each other and (up to
    M = 1,024) the order twin at the plan, ids and weights bit for bit,
    with ties, each Table-3 switch, and a second launch bit-identical."""
    codes, score_sets = _exact_inputs(m, w, 31 * m + w)
    bits = w * 32
    lut = ref.selection_lut(w, bits, 1.0, device=cuda)
    plan = selection.select_plan(m, w, n)
    assert plan["instance"] == "mma"
    for scores in score_sets:
        for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
            kw = dict(bits=bits, gamma=1.0, num_neighbors=n, **flags)
            oi, ow = selection.fused_select(codes, scores, **kw)
            ti, tw = selection.fused_select_tiled(codes, scores, **kw)
            pi, pw = ref.fused_select_ref(codes, scores, lut, num_neighbors=n,
                                          **flags)
            assert torch.equal(oi, pi) and torch.equal(ow, pw), flags
            assert torch.equal(ti, pi) and torch.equal(tw, pw), flags
            if m <= 1024:
                qi, qw = ref.fused_select_split_ref(
                    codes, scores, lut, num_neighbors=n, rows=plan["rows"],
                    splits=plan["splits"], split_len=plan["split_len"],
                    block_k=plan["block_k"], **flags)
                assert torch.equal(oi, qi) and torch.equal(ow, qw), flags
            ri, rw = selection.fused_select(codes, scores, **kw)
            si, sw = selection.fused_select_tiled(codes, scores, **kw)
            assert torch.equal(ri, oi) and torch.equal(rw, ow), flags
            assert torch.equal(si, ti) and torch.equal(sw, tw), flags


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,n", [(300, 8, 200), (50, 40, 9), (64, 33, 63),
                                   (200, 8, 129)])
def test_oneshot_knockout_instance_matches_plain(cuda, m, w, n):
    """N > 128 or W > 32: the one-shot wrapper's knockout instance; the
    tiled wrapper refuses them."""
    codes, score_sets = _exact_inputs(m, w, m + w)
    lut = ref.selection_lut(w, w * 32, 1.0, device=cuda)
    assert selection.select_plan(m, w, n)["instance"] == "knockout"
    for scores in score_sets:
        ki, kw = selection.fused_select(codes, scores, bits=w * 32,
                                        gamma=1.0, num_neighbors=n)
        pi, pw = ref.fused_select_ref(codes, scores, lut, num_neighbors=n)
        assert torch.equal(ki, pi) and torch.equal(kw, pw)
    with pytest.raises(ValueError, match="tiled selection kernel takes"):
        selection.fused_select_tiled(codes, scores, bits=w * 32, gamma=1.0,
                                     num_neighbors=n)


@pytest.mark.cuda
def test_knockout_instance_launches_at_the_route_limit(cuda):
    """M = 46,489, the largest M "auto" sends to the one-shot kernel: the
    knockout block (N = 129) fits with its static shared memory, and its
    first 128 slots equal the tiled kernel's N = 128."""
    codes, score_sets = _exact_inputs(46_489, 8, 5)
    for scores in score_sets:
        ki, kw = selection.fused_select(codes, scores, bits=256, gamma=1.0,
                                        num_neighbors=129)
        ti, tw = selection.fused_select_tiled(codes, scores, bits=256,
                                              gamma=1.0, num_neighbors=128)
        assert torch.equal(ki[:, :128], ti) and torch.equal(kw[:, :128], tw)


@pytest.mark.cuda
def test_select_plan_smem_matches_the_kernel(cuda):
    """The plan's shared bytes (select_smem_bytes) equal the kernel's
    layout, at every instance width and list length."""
    size = selection.KERNEL.helper("select_smem_bytes", [ctypes.c_int] * 3)
    for kw in (8, 16, 32):
        for rows in (32, 64, 128):
            for nsel in (1, 9, 16, 128):
                assert size(kw, rows, nsel) == \
                    selection.select_smem_bytes(kw, rows, nsel)
    for m, w, n in EXACT_CASES + [(65_536, 8, 16), (46_489, 16, 128)]:
        plan = selection.select_plan(m, w, n)
        assert size(plan["kw"], plan["rows"], min(n, m - 1)) == \
            plan["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,c", [(10, 9, 64, 10), (5, 3, 9, 17),
                                     (4, 8, 16, 4096), (3, 600, 5, 30)])
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_streamed_exchange_kernel_matches_plain(cuda, m, n, r, c,
                                                lsh_verification):
    """C below a warp (idle lanes), ragged R blocks, C past a tile, and
    N past the one-shot kernel's 512 threads."""
    g = _gen(c)
    own = torch.randn((m, r, c), generator=g, device=cuda) * 3
    nb = torch.randn((m, n, r, c), generator=g, device=cuda) * 3
    nb[:, 2] = nb[:, 1]                     # an exact KL tie
    y = torch.randint(0, c, (m, r), generator=g, device=cuda)
    sel = torch.rand((m, n), generator=g, device=cuda) < 0.8
    kl, kv, kt, kh = exchange.fused_exchange_streamed(
        own, nb, y, sel, lsh_verification=lsh_verification)
    for plain in (ref.streamed_exchange_ref, ref.all_in_one_exchange_ref):
        pl, pv, pt, ph = plain(own, nb, y, sel,
                               lsh_verification=lsh_verification)
        torch.testing.assert_close(kl, pl, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(kt, pt, rtol=2e-5, atol=1e-5)
        assert torch.equal(kv, pv) and torch.equal(kh, ph)


@pytest.mark.cuda
def test_tiled_kernel_round_matches_tiled_plain_round(cuda):
    """Two aecg rounds with tiling="tiled" through the kernels and
    through the plain versions on the card."""
    from repro_torch.launch.fed import run_federation
    selection.TILED_KERNEL.launches = exchange.STREAMED_KERNEL.launches = 0
    _, hk = run_federation("aecg", rounds=2, num_clients=6, backend="kernel",
                           tiling="tiled", device=cuda, log=None)
    assert selection.TILED_KERNEL.launches > 0
    assert exchange.STREAMED_KERNEL.launches > 0
    _, ho = run_federation("aecg", rounds=2, num_clients=6, backend="oracle",
                           tiling="tiled", device=cuda, log=None)
    for a, b in zip(hk, ho):
        assert a["neighbor_ids"] == b["neighbor_ids"]
        assert a["valid_mask"] == b["valid_mask"]
        assert abs(a["mean_loss"] - b["mean_loss"]) <= 1e-4 * abs(
            b["mean_loss"])


def _random_codes(g, m, words, device):
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (m, words), generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,words,n,pb,probes", [
    (40, 8, 9, 3, 2), (700, 4, 16, 6, 4), (300, 3, 20, 5, 3),
    (130, 32, 128, 2, 2)])
def test_ann_selection_kernel_matches_plain(cuda, m, words, n, pb, probes):
    """The registers path (W = 4, 8), the shared-memory path (W = 3, 32),
    the largest N, duplicate codes, all-tie and gridded scores."""
    from repro_torch.core import ann
    g = _gen(m + 1)
    codes = _random_codes(g, m, words, cuda)
    codes[5:9] = codes[4]
    bits = words * 32
    lut = ref.selection_lut(words, bits, 1.0, device=cuda)
    for scores in (torch.zeros(m, device=cuda),
                   torch.rand(m, generator=g, device=cuda).round(decimals=1)):
        cand = ann.ann_candidates(codes, scores, seed=m, prefix_bits=pb,
                                  probes=probes, num_neighbors=n)
        for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
            ki, kw = selection.fused_select_ann(
                codes, scores, cand.ids, bits=bits, gamma=1.0,
                num_neighbors=n, **flags)
            pi, pw = ref.ann_select_ref(codes, scores, cand.ids, lut,
                                        num_neighbors=n, block_m=64, **flags)
            assert torch.equal(ki, pi) and torch.equal(kw, pw), flags


@pytest.mark.cuda
def test_ann_prefix_zero_equals_the_exact_kernel(cuda):
    """One bucket of capacity M: the ANN kernel gives the one-shot
    kernel's ids and weights bit for bit."""
    from repro_torch.core import ann
    g = _gen(9)
    codes = _random_codes(g, 500, 8, cuda)
    scores = torch.rand(500, generator=g, device=cuda).round(decimals=1)
    cand = ann.ann_candidates(codes, scores, seed=0, prefix_bits=0,
                              probes=0, num_neighbors=16)
    ai, aw = selection.fused_select_ann(codes, scores, cand.ids, bits=256,
                                        gamma=1.0, num_neighbors=16)
    oi, ow = selection.fused_select(codes, scores, bits=256, gamma=1.0,
                                    num_neighbors=16)
    assert torch.equal(ai, oi) and torch.equal(aw, ow)


PER_ROW_CASES = [  # (M, W, K, N)
    (45, 4, 29, 6),       # M past 32 slots and no power of two; K % 8 != 0
    (45, 8, 6, 6),        # K = N
    (300, 3, 70, 20),     # W = 3: word-by-word staging
    (130, 32, 131, 128),  # the largest N and W; K past two id tiles
    (200, 8, 1000, 16),   # many id tiles, 8-column steps of sentinels
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,k,n", PER_ROW_CASES)
def test_per_row_ann_kernel_on_arbitrary_lists(cuda, m, w, k, n):
    """The per-row function (the grouped kernel, one slot a row) on
    lists no bucket gives (`torch_ann_lists.arbitrary_lists`: repeated
    ids, the row itself anywhere, scattered sentinels, a row of
    sentinels only) against `ann_select_ref`, ids and weights bit for
    bit, under gridded, departed (-inf) and all-zero scores and each
    Table-3 switch; a second launch gives the same bits, and every
    launch goes through the per-row handle."""
    from torch_ann_lists import arbitrary_lists
    g = _gen(m * k + w)
    codes = _random_codes(g, m, w, cuda)
    codes[5:9] = codes[4]
    ids = torch.from_numpy(arbitrary_lists(m, k, seed=m + k)).to(cuda)
    lut = ref.selection_lut(w, w * 32, 1.0, device=cuda)
    grid = torch.rand(m, generator=g, device=cuda).round(decimals=1)
    for scores in (grid, _depart(grid, 0.3, m), torch.zeros(m, device=cuda)):
        for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
            before = (selection.ANN_KERNEL.launches,
                      selection.GROUPED_KERNEL.launches)
            call = dict(bits=w * 32, gamma=1.0, num_neighbors=n, **flags)
            ki, kw = selection.fused_select_ann(codes, scores, ids, **call)
            ai, aw = selection.fused_select_ann(codes, scores, ids, **call)
            pi, pw = ref.ann_select_ref(codes, scores, ids, lut,
                                        num_neighbors=n, block_m=64, **flags)
            assert torch.equal(ki, pi) and torch.equal(kw, pw), flags
            assert torch.equal(ai, ki) and torch.equal(aw, kw), flags
            assert (selection.ANN_KERNEL.launches,
                    selection.GROUPED_KERNEL.launches) == (before[0] + 2,
                                                           before[1])
            assert bool((ki[3] == 0).all()) and bool(kw[3].isinf().all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4097, 46_489])
def test_per_row_ann_kernel_with_a_slot_per_client(cuda, m):
    """S = M slots, M no power of two and far past 32: the tile-to-slot
    search finds every client's slot (the last slot's included), at
    K = 64, against `ann_select_ref` bit for bit."""
    from torch_ann_lists import arbitrary_lists
    g = _gen(m)
    codes = _random_codes(g, m, 8, cuda)
    scores = torch.rand(m, generator=g, device=cuda).round(decimals=1)
    ids = torch.from_numpy(arbitrary_lists(m, 64, seed=m)).to(cuda)
    ki, kw = selection.fused_select_ann(codes, scores, ids, bits=256,
                                        gamma=1.0, num_neighbors=16)
    lut = ref.selection_lut(8, 256, 1.0, device=cuda)
    pi, pw = ref.ann_select_ref(codes, scores, ids, lut, num_neighbors=16)
    assert torch.equal(ki, pi) and torch.equal(kw, pw)
    assert bool(kw[-1].isfinite().any())


def _grouped_inputs(kind, m, w, seed):
    """Codes and score sets on the card: random codes with duplicates,
    half the clients on one code (a bucket far past a tile and its cap),
    clustered codes (centres of 32 clients, 2 % of bits flipped), or
    random codes whose prefix bits at prefix 10 and permutation seed m
    put every client in a bucket of its own; all tie (round 0) and
    gridded scores."""
    g = _gen(seed)
    if kind == "distinct":
        from repro_torch.core import ann
        codes = _random_codes(g, m, w, "cuda")
        own = torch.randperm(1 << 10, generator=g, device="cuda")[:m]
        for t, b in enumerate(ann.prefix_bit_indices(w * 32, 10, m).tolist()):
            col = codes[:, b // 32].long() & 0xFFFFFFFF
            col = (col & ~(1 << (b % 32))) | (((own >> t) & 1) << (b % 32))
            codes[:, b // 32] = torch.where(col >= 1 << 31, col - (1 << 32),
                                            col).to(torch.int32)
    elif kind == "clustered":
        centers = torch.rand((max(m // 32, 1), w * 32), generator=g,
                             device="cuda") < 0.5
        assign = torch.randint(0, centers.shape[0], (m,), generator=g,
                               device="cuda")
        flips = torch.rand((m, w * 32), generator=g, device="cuda") < 0.02
        codes = ops.pack_bits((centers[assign] ^ flips).float() * 2 - 1)
    else:
        codes = _random_codes(g, m, w, "cuda")
        codes[5:9] = codes[4]
        if kind == "skewed":
            codes[: m // 2] = codes[0]
    scores = (torch.zeros(m, device="cuda"),
              torch.rand(m, generator=g, device="cuda").round(decimals=1))
    return codes, scores


GROUPED_CASES = [  # (kind, m, w, n, prefix_bits, probes)
    ("random", 40, 8, 9, 3, 2),       # K = 78, not a multiple of 64
    ("random", 300, 3, 20, 5, 3),     # W = 3: word-by-word staging
    ("random", 130, 32, 128, 2, 2),   # the largest N and W
    ("random", 300, 8, 16, 2, 2),     # 4 slots: a cluster of 8 splits
    ("clustered", 2000, 2, 16, 4, 3),
    ("clustered", 4096, 8, 16, 10, 8),
    ("skewed", 1500, 8, 16, 4, 2),    # a bucket of 750+ past its cap
    # S = M > 32 live slots: the tile-to-slot search's last 32-way round
    # steps by more than one
    ("distinct", 33, 8, 16, 10, 8),
    ("distinct", 37, 4, 9, 10, 8),
    ("distinct", 63, 8, 16, 10, 4),
    ("distinct", 67, 2, 16, 10, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,w,n,pb,probes", GROUPED_CASES)
def test_grouped_ann_kernel_matches_plain_and_repeats(cuda, kind, m, w, n, pb,
                                                      probes):
    """The grouped kernel equals its plain version and the per-row kernel
    on `ann_candidates`, ids and weights bit for bit, under each Table-3
    switch, and a second launch gives the same bits."""
    from repro_torch.core import ann
    codes, score_sets = _grouped_inputs(kind, m, w, 7 * m + w)
    bits = w * 32
    lut = ref.selection_lut(w, bits, 1.0, device=cuda)
    for scores in score_sets:
        kw = dict(seed=m, prefix_bits=pb, probes=probes, num_neighbors=n)
        cand = ann.bucket_candidates(codes, scores, **kw)
        rows = ann.ann_candidates(codes, scores, **kw)
        assert torch.equal(cand.lists[cand.slot.long()], rows.ids)
        if kind == "skewed":
            assert int(cand.dropped) > 0
            assert int(cand.counts.max()) > 128
        if kind == "distinct":
            assert cand.lists.shape[0] == m
            assert int((cand.counts > 0).sum()) == m
        for flags in ({}, {"use_lsh": False}, {"use_rank": False}):
            call = dict(bits=bits, gamma=1.0, num_neighbors=n, **flags)
            gi, gw = selection.fused_select_ann_grouped(codes, scores, cand,
                                                        **call)
            pi, pw = ref.ann_select_grouped_ref(codes, scores, cand, lut,
                                                num_neighbors=n, block_m=256,
                                                **flags)
            assert torch.equal(gi, pi) and torch.equal(gw, pw), flags
            ri, rw = selection.fused_select_ann(codes, scores, rows.ids,
                                                **call)
            assert torch.equal(gi, ri) and torch.equal(gw, rw), flags
            ai, aw = selection.fused_select_ann_grouped(codes, scores, cand,
                                                        **call)
            assert torch.equal(ai, gi) and torch.equal(aw, gw), flags


@pytest.mark.cuda
@pytest.mark.parametrize("m", [500, 3000])
def test_grouped_prefix_zero_equals_the_exact_kernel(cuda, m):
    """prefix_bits=0: one slot of every client, so the grouped kernel
    gives `fused_select`'s ids and weights bit for bit (at M = 3,000
    through a cluster of 8 splits, the sentinel teaser skipped)."""
    from repro_torch.core import ann
    codes, score_sets = _grouped_inputs("random", m, 8, m)
    for scores in score_sets:
        cand = ann.bucket_candidates(codes, scores, seed=0, prefix_bits=0,
                                     probes=0, num_neighbors=16)
        gi, gw = selection.fused_select_ann_grouped(
            codes, scores, cand, bits=256, gamma=1.0, num_neighbors=16)
        oi, ow = selection.fused_select(codes, scores, bits=256, gamma=1.0,
                                        num_neighbors=16)
        assert torch.equal(gi, oi) and torch.equal(gw, ow)
    assert selection.ann_plan(m, 8, 16, cand.lists.shape[1],
                              1)["splits"] == (8 if m == 3000 else 5)


@pytest.mark.cuda
def test_ann_plan_smem_matches_the_kernel(cuda):
    """The plan's shared bytes (ann_smem_bytes) equal the grouped
    kernel's layout."""
    size = selection.GROUPED_KERNEL.helper("ann_smem_bytes",
                                           [ctypes.c_int] * 3)
    for kw in (8, 16, 32):
        for rows in (32, 64, 128):
            for nsel in (1, 9, 16, 128):
                assert size(kw, rows, nsel) == \
                    selection.ann_smem_bytes(kw, rows, nsel)


@pytest.mark.cuda
def test_grouped_route_has_no_host_sync(cuda):
    """Candidate generation and the grouped launch, and the whole ANN
    `select_partners`, run with CUDA sync debugging set to raise: nothing
    between the codes and the launch waits for the device."""
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core import ann, neighbor
    codes, (_, scores) = _grouped_inputs("clustered", 4096, 8, 3)
    fed = FedConfig(num_clients=4096, num_neighbors=16, lsh_bits=256)
    want, _ = neighbor.select_partners(codes, scores, fed, backend="ann",
                                       seed=1)     # builds, warms the table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cand = ann.bucket_candidates(codes, scores, seed=1, prefix_bits=10,
                                     probes=8, num_neighbors=16)
        gi, _ = selection.fused_select_ann_grouped(
            codes, scores, cand, bits=256, gamma=fed.gamma, num_neighbors=16)
        ids, mask = neighbor.select_partners(codes, scores, fed,
                                             backend="ann", seed=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(gi, want) and torch.equal(ids, want)
    assert bool(mask.all())


@pytest.mark.cuda
def test_grouped_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.core import ann
    codes, (scores, _) = _grouped_inputs("random", 300, 8, 2)
    cand = ann.bucket_candidates(codes, scores, seed=0, prefix_bits=3,
                                 probes=1, num_neighbors=16)
    call = dict(bits=256, gamma=1.0)
    with pytest.raises(ValueError, match="N <= 128"):
        selection.fused_select_ann_grouped(codes, scores, cand,
                                           num_neighbors=150, **call)
    short = cand._replace(lists=cand.lists[:, :8])
    with pytest.raises(ValueError, match="N <= K"):
        selection.fused_select_ann_grouped(codes, scores, short,
                                           num_neighbors=9, **call)
    with pytest.raises(ValueError, match="cand.order"):
        selection.fused_select_ann_grouped(
            codes, scores, cand._replace(order=cand.order.long()),
            num_neighbors=9, **call)
    with pytest.raises(ValueError, match="cand.starts"):
        selection.fused_select_ann_grouped(
            codes, scores, cand._replace(starts=cand.starts[:-1]),
            num_neighbors=9, **call)
    wide = _random_codes(_gen(3), 300, 33, cuda)
    with pytest.raises(ValueError, match="at most 1024 bits"):
        selection.fused_select_ann_grouped(wide, scores, cand, bits=33 * 32,
                                           gamma=1.0, num_neighbors=4)
    with pytest.raises(ValueError, match="int32"):
        selection.fused_select_ann_grouped(codes.long(), scores, cand,
                                           num_neighbors=4, **call)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,words", [(10, 10, 8), (70, 33, 33),
                                       (1000, 300, 8), (5, 1, 1)])
def test_hamming_kernel_matches_plain(cuda, m, n, words):
    g = _gen(m + n)
    a = _random_codes(g, m, words, cuda)
    b = _random_codes(g, n, words, cuda)
    b[0] = a[0]
    assert torch.equal(hamming.hamming_all_pairs(a, b),
                       ref.hamming_all_pairs_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,path", [(64, 64, "small"), (65, 64, "tiled"),
                                      (1, 4096, "small"),
                                      (4097, 1, "tiled")])
@pytest.mark.parametrize("words", [1, 4, 5, 32, 33])
def test_hamming_kernel_on_both_paths(cuda, m, n, path, words):
    """Both sides of the small/tiled switch (4,096 outputs), at word
    counts with and without 16-byte rows and past one 32-word step."""
    assert hamming.launch_path(m, n) == path
    g = _gen(m * 7 + n + words)
    a = _random_codes(g, m, words, cuda)
    b = _random_codes(g, n, words, cuda)
    b[0] = a[0]
    assert torch.equal(hamming.hamming_all_pairs(a, b),
                       ref.hamming_all_pairs_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4096, 8192, 421_888])
def test_lsh_single_kernel_matches_plain_and_the_batched_row(cuda, p):
    x = torch.randn((3, p), generator=_gen(p), device=cuda) * 0.05
    rows = lsh_projection.lsh_project_sums_batched(x, 5, bits=256)
    for i in range(3):
        k = lsh_projection.lsh_project_sums(x[i].contiguous(), 5, bits=256)
        pl = ref.lsh_project_sums_ref(x[i], 5, bits=256)
        err = (k - pl).abs()
        assert bool((err <= 1e-5 * (pl.abs() + x[i].norm())).all())
        off = pl.abs() > 1e-3
        assert torch.equal((k > 0)[off], (pl > 0)[off])
        assert torch.equal(k, rows[i])


# every instance of the LSH kernels (single / few / many rows), both sides
# of each split-length switch and of the 128-bit tile
LSH_SPLIT_CASES = sorted(
    {(m, 12_288, 256) for m in (1, 3, 16, 17, 35, 63, 64, 129, 256)}
    | {(m, p, 256) for m in (1, 17, 129)
       for p in (2048, 4096, 12_288, 268_288, 270_336)}
    | {(m, 4096, bits) for m in (1, 17, 129) for bits in (32, 64, 256, 512)}
    | {(256, 421_888, 256)})


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,bits", LSH_SPLIT_CASES)
def test_lsh_kernels_equal_the_split_order_twin(cuda, m, p, bits):
    x = torch.randn((m, p), generator=_gen(m + p + bits), device=cuda) * 0.05
    twin = ref.lsh_project_sums_split_order(
        x, 9, bits=bits, chunk=lsh_projection.split_len(p))
    k = lsh_projection.lsh_project_sums_batched(x, 9, bits=bits)
    assert torch.equal(k, twin)
    assert torch.equal(lsh_projection.lsh_project_sums_batched(x, 9,
                                                               bits=bits), k)
    one = torch.stack([lsh_projection.lsh_project_sums(x[i], 9, bits=bits)
                       for i in range(m)])
    assert torch.equal(one, k)


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(300, 4096), (129, 270_336)])
def test_lsh_row_groups_equal_one_launch(cuda, monkeypatch, m, p):
    """A scratch cap of one 128-row group makes the batched wrapper
    launch 128-row groups one by one; the sums stay the order twin's."""
    x = torch.randn((m, p), generator=_gen(m + p), device=cuda) * 0.05
    one = lsh_projection.lsh_project_sums_batched(x, 9)
    row_bytes = 4 * (p // lsh_projection.split_len(p)) * 256
    monkeypatch.setattr(lsh_projection, "PARTIAL_BYTES", 128 * row_bytes)
    groups = lsh_projection.row_groups(m, p, 256)
    assert groups[0] == (0, 128) and len(groups) > 1
    n0 = lsh_projection.KERNEL.launches
    k = lsh_projection.lsh_project_sums_batched(x, 9)
    assert lsh_projection.KERNEL.launches - n0 == len(groups)
    assert torch.equal(k, one)
    assert torch.equal(k, ref.lsh_project_sums_split_order(
        x, 9, bits=256, chunk=lsh_projection.split_len(p)))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4096, 270_336])
@pytest.mark.parametrize("offset", [0, 2048 * 37, 2 ** 31 + 4096,
                                    2 ** 32 - 5000, 3_142_732_800])
def test_lsh_single_row_offset_equals_the_split_order_twin(cuda, p, offset):
    """The row offset hashes x[i] as row offset + i (mod 2^32): bit for
    bit the order twin's sums at that offset, and the plain version's
    within tolerance."""
    x = torch.randn(p, generator=_gen(p + offset % 97), device=cuda) * 0.05
    k = lsh_projection.lsh_project_sums(x, 4, bits=256, row_offset=offset)
    twin = ref.lsh_project_sums_split_order(
        x[None], 4, bits=256, chunk=lsh_projection.split_len(p),
        row_offset=offset)[0]
    assert torch.equal(k, twin)
    pl = ref.lsh_project_sums_ref(x, 4, bits=256, row_offset=offset)
    assert bool(((k - pl).abs() <= 1e-5 * (pl.abs() + x.norm())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("start", [2048 * 200, 2 ** 31 + 2048 * 3])
def test_lsh_single_offset_equals_the_vector_with_a_zero_prefix(cuda, start):
    """A shard at offset a gives, bit for bit, the sums of the whole
    vector that is zero outside it (zeros add exact zeros, and both split
    at 2,048). At a = 2^31 + 6,144 the unsharded launch runs past P =
    2^31: its x offsets and hash rows are 64-bit / wrapped correctly."""
    n = 270_336
    y = torch.randn(n, generator=_gen(start % 1009), device=cuda) * 0.05
    p = start + n + 2048 * 5
    x = torch.zeros(p, device=cuda)
    x[start:start + n] = y
    assert lsh_projection.split_len(p) == lsh_projection.split_len(n)
    whole = lsh_projection.lsh_project_sums(x, 6, bits=256)
    del x
    shard = lsh_projection.lsh_project_sums(y, 6, bits=256, row_offset=start)
    assert torch.equal(whole, shard)
    assert torch.equal(shard, ref.lsh_project_sums_split_order(
        y[None], 6, bits=256, chunk=2048, row_offset=start)[0])


@pytest.mark.cuda
def test_lsh_wrappers_reject_x_off_a_16_byte_boundary(cuda):
    x = torch.zeros(2049, device=cuda)[1:]        # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        lsh_projection.lsh_project_sums(x, 0)
    with pytest.raises(ValueError, match="16-byte"):
        lsh_projection.lsh_project_sums_batched(x[None], 0)


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = _gen(1)
    codes = _random_codes(g, 300, 8, cuda)
    scores = torch.zeros(300, device=cuda)
    cand = torch.zeros((300, 200), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="N <= 128"):
        selection.fused_select_ann(codes, scores, cand, bits=256, gamma=1.0,
                                   num_neighbors=150)
    wide = _random_codes(g, 300, 33, cuda)
    with pytest.raises(ValueError, match="at most 1024 bits"):
        selection.fused_select_ann(wide, scores, cand, bits=33 * 32,
                                   gamma=1.0, num_neighbors=4)
    with pytest.raises(ValueError, match="int32"):
        selection.fused_select_ann(codes, scores, cand.long(), bits=256,
                                   gamma=1.0, num_neighbors=4)
    with pytest.raises(ValueError, match="int32"):
        hamming.hamming_all_pairs(codes.long(), codes.long())
    with pytest.raises(ValueError, match=r"\(N, W\)"):
        hamming.hamming_all_pairs(codes, wide)
    with pytest.raises(ValueError, match="1-D"):
        lsh_projection.lsh_project_sums(torch.zeros((2, 2048), device=cuda),
                                        0)
    with pytest.raises(ValueError, match="P %"):
        lsh_projection.lsh_project_sums(torch.zeros(1000, device=cuda), 0)


@pytest.mark.cuda
def test_ann_round_launches_the_ann_kernel(cuda):
    """Two aecg rounds with backend="ann": one grouped ANN selection per
    round, no per-row ANN or exact selection, the same ids on a second
    run."""
    from repro_torch.launch.fed import run_federation
    runs = []
    for _ in range(2):
        selection.ANN_KERNEL.launches = selection.KERNEL.launches = 0
        selection.GROUPED_KERNEL.launches = 0
        _, hist = run_federation("aecg", rounds=2, num_clients=6,
                                 backend="ann", ann_prefix_bits=2,
                                 ann_probes=1, device=cuda, log=None)
        assert selection.GROUPED_KERNEL.launches == 2
        assert selection.ANN_KERNEL.launches == 0
        assert selection.KERNEL.launches == 0
        runs.append([h["neighbor_ids"] for h in hist])
        for h in hist:
            assert all(i not in row for i, row in
                       enumerate(h["neighbor_ids"]))
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_exchange_kernel_reads_out_of_range_labels_as_plain(cuda):
    """Labels -1, C and -C-1: -1 wraps to C-1; C and -C-1 make that
    client's l_ij NaN for every neighbour, as the JAX package does."""
    g = _gen(8)
    c = 6
    own = torch.randn((4, 5, c), generator=g, device=cuda) * 3
    nb = torch.randn((4, 3, 5, c), generator=g, device=cuda) * 3
    y = torch.randint(0, c, (4, 5), generator=g, device=cuda)
    y[0, 1], y[1, 2], y[2, 0] = -1, c, -c - 1
    sel = torch.rand((4, 3), generator=g, device=cuda) < 0.8
    kl, kv, kt, kh = exchange.fused_exchange(own, nb, y, sel)
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(own, nb, y, sel)
    assert bool(kl[1:3].isnan().all()) and bool(kl[[0, 3]].isfinite().all())
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0, equal_nan=True)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)


def _exchange_case(m, n, r, c, seed, tie=True):
    """Inputs on the card: logits * 3, an exact KL tie (neighbour 1
    repeated in slot 3, or 0 in slot 1 at N = 2), 80 % selected."""
    g = _gen(seed)
    own = torch.randn((m, r, c), generator=g, device="cuda") * 3
    nb = torch.randn((m, n, r, c), generator=g, device="cuda") * 3
    if tie and n >= 2:
        nb[:, min(3, n - 1)] = nb[:, min(1, n - 2)]
    y = torch.randint(0, c, (m, r), generator=g, device="cuda")
    sel = torch.rand((m, n), generator=g, device="cuda") < 0.8
    return own, nb, y, sel


def _same_bits(a, b):
    return all(torch.equal(x.nan_to_num(), z.nan_to_num())
               and torch.equal(x.isnan(), z.isnan()) if x.is_floating_point()
               else torch.equal(x, z) for x, z in zip(a, b))


# one-shot shapes: (M, N, R, C), and the path each takes
# (oneshot_plan: cluster, staged, lanes; TMA where R*C % 4 == 0; the
# target from the owners' pieces in a staged cluster, else flat)
ONESHOT_CASES = [
    (10, 9, 64, 10),      # main: cluster 8, staged, 2 lanes, C % 4 != 0
    (6, 1, 33, 17),       # N = 1: 2 CTAs over one neighbour's rows
    (5, 16, 64, 10),      # N = 16, cluster 8
    (600, 16, 64, 10),    # M fills the card: one CTA a client, staged,
                          # one lane a row (unrolled)
    (600, 3, 5, 3),       # one CTA, R*C % 4 != 0: flat scalar target
    (3, 512, 5, 30),      # the N = 512 limit
    (4, 9, 7, 3),         # R*C % 4 != 0: staged by a plain copy
    (600, 16, 64, 16),    # C = 16: one lane, unrolled, float4 target
    (3, 9, 16, 32),       # C = 32: 2 lanes, float4
    (3, 9, 16, 100),      # C > 32, float4, staged
    (2, 3, 40, 1001),     # C > 32, C % 4 != 0
    (8, 16, 64, 1024),    # unstaged (the slab is 512 KB a CTA), float4
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,c", ONESHOT_CASES)
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_oneshot_exchange_paths_match_plain_and_repeat(cuda, m, n, r, c,
                                                       lsh_verification):
    """Every path of the one-shot kernel against the plain version, and
    a second launch bit-identical to the first."""
    own, nb, y, sel = _exchange_case(m, n, r, c, seed=m + n + c)
    got = exchange.fused_exchange(own, nb, y, sel,
                                  lsh_verification=lsh_verification)
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(
        own, nb, y, sel, lsh_verification=lsh_verification)
    kl, kv, kt, kh = got
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)
    assert _same_bits(got, exchange.fused_exchange(
        own, nb, y, sel, lsh_verification=lsh_verification))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,c", [(10, 9, 64, 10), (5, 16, 64, 12),
                                     (4, 9, 7, 3), (600, 16, 64, 10)])
def test_oneshot_exchange_staged_equals_unstaged(cuda, monkeypatch, m, n, r,
                                                 c):
    """Rows held in shared memory (TMA or plain copy) and rows read from
    device memory give the same bits."""
    own, nb, y, sel = _exchange_case(m, n, r, c, seed=c)
    assert exchange.oneshot_plan(m, n, r, c)["staged"]
    staged = exchange.fused_exchange(own, nb, y, sel)
    plan = exchange.oneshot_plan
    monkeypatch.setattr(exchange, "oneshot_plan",
                        lambda *a: {**plan(*a), "staged": False})
    assert _same_bits(staged, exchange.fused_exchange(own, nb, y, sel))


@pytest.mark.cuda
def test_oneshot_layout_matches_the_kernel(cuda):
    """The wrapper decides staging from `oneshot_layout_bytes`; the
    kernel lays out its shared memory by its own `layout`."""
    size = exchange.KERNEL.helper(
        "fused_exchange_smem_bytes", [ctypes.c_int] * 6)
    for n, r, c, q in ((9, 64, 10, 72), (16, 64, 1024, 128),
                       (16, 64, 10, 1024), (512, 5, 30, 320), (1, 3, 7, 3)):
        for staged in (True, False):
            for lsh in (True, False):
                assert size(n, r, c, q, staged, lsh) == \
                    exchange.oneshot_layout_bytes(n, r, c, q, staged, lsh)


# streamed shapes (streamed_plan): lanes < 32 with packed rows (C <= 128),
# one chunk of 4 columns a lane, 512-column chunks from C = 512 (ragged,
# C % 4 != 0), neighbours split over warps, rows of 16 chunks or more
# merged in a launch of their own (C >= 8,192), the target in the mask
# launch (R*C <= 4,096) or in its own, 16 bytes a load or not
STREAMED_CASES = [(10, 9, 64, 10), (5, 1, 9, 3), (4, 16, 33, 32),
                  (3, 9, 16, 100), (3, 16, 8, 513), (2, 9, 5, 2048),
                  (2, 3, 7, 1001), (2, 2, 3, 8192), (2, 3, 4, 8200)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,c", STREAMED_CASES)
@pytest.mark.parametrize("lsh_verification", [True, False])
def test_streamed_exchange_paths_match_plain_and_repeat(cuda, m, n, r, c,
                                                        lsh_verification):
    own, nb, y, sel = _exchange_case(m, n, r, c, seed=m * c + n)
    got = exchange.fused_exchange_streamed(
        own, nb, y, sel, lsh_verification=lsh_verification)
    kl, kv, kt, kh = got
    for plain in (ref.streamed_exchange_ref, ref.all_in_one_exchange_ref):
        pl, pv, pt, ph = plain(own, nb, y, sel,
                               lsh_verification=lsh_verification)
        torch.testing.assert_close(kl, pl, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(kt, pt, rtol=2e-5, atol=1e-5)
        assert torch.equal(kv, pv) and torch.equal(kh, ph)
    assert _same_bits(got, exchange.fused_exchange_streamed(
        own, nb, y, sel, lsh_verification=lsh_verification))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 40, 1024])
def test_exchange_kernels_read_out_of_range_labels_as_plain(cuda, c):
    """Labels -1, C and -C-1 on the packed, the warp-per-row and the
    unstaged one-shot paths, and on the streamed kernel (a label outside
    [0, C) matches no column there, as in `streamed_exchange_ref`)."""
    own, nb, y, sel = _exchange_case(8, 16, 64, c, seed=c)
    y[0, 1], y[1, 2], y[2, 0] = -1, c, -c - 1
    kl, kv, kt, kh = exchange.fused_exchange(own, nb, y, sel)
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(own, nb, y, sel)
    assert bool(kl[1:3].isnan().all()) and bool(kl[[0, 3]].isfinite().all())
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0, equal_nan=True)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)
    kl, kv, kt, kh = exchange.fused_exchange_streamed(own, nb, y, sel)
    pl, pv, pt, ph = ref.streamed_exchange_ref(own, nb, y, sel)
    torch.testing.assert_close(kl, pl, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(kt, pt, rtol=2e-5, atol=1e-5)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [False, True])
def test_exchange_kernels_on_empty_and_unselected_clients(cuda, streamed):
    """M = 0 and N = 0 launch nothing; a client with no selected
    neighbour gets no valid slot, a zero target and has_target False."""
    fn = (exchange.fused_exchange_streamed if streamed
          else exchange.fused_exchange)
    kernel = exchange.STREAMED_KERNEL if streamed else exchange.KERNEL
    before = kernel.launches
    for m, n in ((0, 9), (4, 0)):
        own, nb, y, sel = _exchange_case(m, n, 8, 10, seed=1, tie=False)
        l_ij, valid, target, has = fn(own, nb, y, sel)
        assert l_ij.shape == (m, n) and valid.shape == (m, n)
        assert not bool(target.any()) and not bool(has.any())
    assert kernel.launches == before
    own, nb, y, sel = _exchange_case(4, 9, 64, 10, seed=2)
    sel[2] = False
    got = fn(own, nb, y, sel)
    plain = (ref.streamed_exchange_ref if streamed
             else ref.all_in_one_exchange_ref)(own, nb, y, sel)
    assert not bool(got[1][2].any()) and not bool(got[2][2].any())
    assert not bool(got[3][2]) and bool(got[3][[0, 1, 3]].all())
    torch.testing.assert_close(got[0], plain[0], rtol=2e-5, atol=1e-5)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[3], plain[3])


@pytest.mark.cuda
@pytest.mark.parametrize("n,sq,sk,dh", [
    (2, 256, 256, 128), (1, 1024, 512, 64), (2, 256, 512, 128),
    (3, 1000, 1000, 128), (2, 77, 130, 80), (1, 200, 200, 256),
    (1, 200, 200, 100), (2, 1, 300, 128), (1, 100, 333, 64),
    (2, 300, 520, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, n, sq, sk, dh, causal,
                                              dtype):
    g = _gen(sq + dh)
    q, k, v = (torch.randn((n, s, dh), generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    before = flash_attention.KERNEL.launches
    o = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.KERNEL.launches == before + 1
    pl = ref.flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == (n, sq, dh)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", [(24, 8), (4, 4), (6, 1)])
def test_gqa_flash_kernel_matches_plain(cuda, h, kv):
    """The kernel reads KV head i // (H // KV) through strides, on the
    model's (B, S, H, dh) layout, and the plain repeat gives the same."""
    g = _gen(h * 10 + kv)
    q = torch.randn((2, 300, h, 128), generator=g, device=cuda)
    k = torch.randn((2, 300, kv, 128), generator=g, device=cuda)
    v = torch.randn((2, 300, kv, 128), generator=g, device=cuda)
    o = ops.gqa_flash_attention(q, k, v, causal=True)
    pl = ops.gqa_flash_attention(q, k, v, causal=True, use_kernel=False)
    assert (o - pl).abs().max().item() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_unaligned_rows(cuda, dtype):
    """Views whose rows start one element past a 16-byte boundary take
    the kernel's element-by-element staging."""
    g = _gen(7)
    q, k, v = (torch.randn((2, s, 129), generator=g, device=cuda)
               .to(dtype)[:, :, 1:] for s in (150, 150, 150))
    o = flash_attention.flash_attention(q, k, v, causal=True)
    pl = ref.flash_attention_ref(q, k, v, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_a_fused_qkv_projection(cuda, dtype):
    """q, k and v as non-contiguous slices of one (B, S, 3, H, dh)
    projection go in through their strides."""
    g = _gen(8)
    qkv = torch.randn((2, 300, 3, 4, 128), generator=g,
                      device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o = ops.gqa_flash_attention(q, k, v, causal=True)
    pl = ops.gqa_flash_attention(q, k, v, causal=True, use_kernel=False)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_flash_kernel_at_the_serving_length(cuda, dtype):
    """Minitron-4B's head layout (24 query heads, 8 KV heads) at a
    2048-token prompt."""
    g = _gen(9)
    q = torch.randn((1, 2048, 24, 128), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, 2048, 8, 128), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    o = ops.gqa_flash_attention(q, k, v, causal=True)
    pl = ops.gqa_flash_attention(q, k, v, causal=True, use_kernel=False)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,dh,causal", [
    (4, 1500, 12, 12, 64, False),      # whisper-small's encoder
    (4, 2048, 48, 8, 128, True)])      # grok-1's GQA
def test_gqa_flash_kernel_at_the_families_shapes(cuda, b, s, h, kv, dh,
                                                 causal):
    g = _gen(s + h)
    q = torch.randn((b, s, h, dh), generator=g, device=cuda)
    k, v = (torch.randn((b, s, kv, dh), generator=g, device=cuda)
            for _ in range(2))
    before = flash_attention.KERNEL.launches
    o = ops.gqa_flash_attention(q, k, v, causal=causal)
    assert flash_attention.KERNEL.launches == before + 1
    pl = ops.gqa_flash_attention(q, k, v, causal=causal, use_kernel=False)
    assert (o - pl).abs().max().item() < 2e-5


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """One MoE layer (kimi-k2's reduced config widened to 16 experts, top
    8) on the card against its CPU run on the same weights: the same
    expert ids, positions and keep mask, the output within rtol 1e-5,
    atol 1e-5, the aux terms within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_leaves
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              num_experts=16, experts_per_token=8)
    p = init_leaves(moe.moe_shapes(cfg), torch.Generator().manual_seed(0),
                    torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    x[0, 3] = 0.0                      # a tie over every expert
    pc = {k: v.to(cuda) for k, v in p.items()}
    out, aux = moe.apply_moe(cfg, p, x)
    got, gaux = moe.apply_moe(cfg, pc, x.to(cuda))
    torch.testing.assert_close(got.cpu(), out, rtol=1e-5, atol=1e-5)
    for key in aux:
        assert abs(gaux[key].item() - aux[key].item()) <= 1e-6, key
    _, _, ids = moe.route(cfg, p, x.reshape(-1, cfg.d_model))
    _, _, gids = moe.route(cfg, pc, x.to(cuda).reshape(-1, cfg.d_model))
    assert torch.equal(gids.cpu(), ids)
    assert ids[3].tolist() == list(range(8))
    pos = moe._position_in_expert(ids.reshape(-1))
    assert torch.equal(moe._position_in_expert(gids.reshape(-1)).cpu(), pos)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 1, 320), device=cuda)
    with pytest.raises(ValueError, match="head dim 320"):
        flash_attention.gqa_attention(q, q, q)
    x = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="one device"):
        flash_attention.flash_attention(x, x.cpu(), x)
    with pytest.raises(ValueError, match="one device"):
        flash_attention.flash_attention(x.cpu(), x, x)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention.flash_attention(x, x.half(), x)


@pytest.mark.cuda
def test_served_tokens_equal_with_and_without_the_kernel(cuda):
    """The reduced minitron served through the kernel ("auto": one launch
    per layer in the prefill, none in decode) and through the naive
    attention gives the same tokens."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention
    flash_attention.KERNEL.launches = 0
    a = serve("minitron-4b", batch=2, prompt_len=64, max_new=6, device=cuda)
    assert flash_attention.KERNEL.launches == 2
    try:
        attention.set_attn_impl("naive")
        b = serve("minitron-4b", batch=2, prompt_len=64, max_new=6,
                  device=cuda, params=a["params"])
    finally:
        attention.set_attn_impl("auto")
    assert flash_attention.KERNEL.launches == 2
    torch.testing.assert_close(a["logits"][0], b["logits"][0], rtol=1e-4,
                               atol=1e-4)
    assert (a["generated"] == b["generated"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_under_vmap_launches_once_and_matches_plain(cuda, dtype, tol):
    """A nested vmap over (clients, neighbours) of the GQA wrapper, as the
    federation's neighbour web calls it: one launch on the folded batch,
    equal to the plain version within the kernel's tolerance."""
    from torch.func import vmap
    g = _gen(3)
    q = torch.randn((3, 2, 4, 32, 4, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((3, 2, 4, 32, 1, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((3, 2, 4, 32, 1, 64), generator=g, device=cuda).to(dtype)
    before = flash_attention.KERNEL.launches
    with torch.no_grad():
        out = vmap(vmap(lambda a, b, c: flash_attention.gqa_attention(
            a, b, c, causal=True)))(q, k, v)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.plain_gqa_attention(
        q.reshape(24, 32, 4, 64), k.reshape(24, 32, 1, 64),
        v.reshape(24, 32, 1, 64), True, 0.0).reshape(out.shape)
    assert (out.float() - want.float()).abs().max() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_the_web_shape_packs_every_row(cuda, dtype, tol):
    """The federation's neighbour web folded to B 2,048 (S 32, 4 query
    heads over 1 KV head, dh 64, causal): one item of 128 packed rows per
    sequence, one launch, within the kernel's tolerance."""
    g = _gen(11)
    q = torch.randn((2048, 32, 4, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2048, 32, 1, 64), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    plan = flash_attention.flash_plan(2048, 32, 32, 4, 1, 64, dtype, True)
    assert plan["items"] == 2048 and plan["bk"] == 32
    before = flash_attention.KERNEL.launches
    o = flash_attention.gqa_attention(q, k, v, causal=True)
    assert flash_attention.KERNEL.launches == before + 1
    pl = flash_attention.plain_gqa_attention(q, k, v, True, 0.0)
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_ragged_packed_rows(cuda, causal):
    """6 query heads over 2 KV heads packed 3 to a position at S 41, bf16
    dh 100 (rows of 200 bytes: the element-by-element staging), and the
    same heads on views one element past a 16-byte boundary in f32."""
    g = _gen(12)
    q = torch.randn((2, 41, 6, 100), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, 41, 2, 100), generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    o = flash_attention.gqa_attention(q, k, v, causal=causal)
    pl = flash_attention.plain_gqa_attention(q, k, v, causal, 0.0)
    assert (o.float() - pl.float()).abs().max().item() < 2e-2
    q, k, v = (torch.randn((2, 41, h, 65), generator=g, device=cuda)
               [..., 1:] for h in (6, 2, 2))
    o = flash_attention.gqa_attention(q, k, v, causal=causal)
    pl = flash_attention.plain_gqa_attention(q, k, v, causal, 0.0)
    assert (o - pl).abs().max().item() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_with_more_items_than_resident_blocks(cuda, causal,
                                                           dtype, tol):
    """8 x 4 KV heads x 12 row tiles of 3 packed heads = 384 items over at
    most 132 resident blocks: the persistent blocks walk several items
    each (in causal pairs), their K/V ring running on across items."""
    g = _gen(13)
    q = torch.randn((8, 512, 12, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((8, 512, 4, 64), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    plan = flash_attention.flash_plan(8, 512, 512, 12, 4, 64, dtype, causal)
    assert plan["items"] == 384 and plan["grid"] <= 2 * 132
    assert plan["items"] > plan["grid"]
    o = flash_attention.gqa_attention(q, k, v, causal=causal)
    pl = flash_attention.plain_gqa_attention(q, k, v, causal, 0.0)
    assert (o.float() - pl.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_flash_nested_vmap_over_many_items_launches_once(cuda):
    """The neighbour web's nested vmap at 16 clients x 8 neighbours of 8
    sequences (1,024 items): still one launch, equal to the plain version
    on the folded batch within bf16's tolerance."""
    from torch.func import vmap
    g = _gen(14)
    q = torch.randn((16, 8, 8, 32, 4, 64), generator=g,
                    device=cuda).bfloat16()
    k, v = (torch.randn((16, 8, 8, 32, 1, 64), generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    before = flash_attention.KERNEL.launches
    with torch.no_grad():
        out = vmap(vmap(lambda a, b, c: flash_attention.gqa_attention(
            a, b, c, causal=True)))(q, k, v)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.plain_gqa_attention(
        q.reshape(1024, 32, 4, 64), k.reshape(1024, 32, 1, 64),
        v.reshape(1024, 32, 1, 64), True, 0.0).reshape(out.shape)
    assert (out.float() - want.float()).abs().max() < 2e-2


@pytest.mark.cuda
def test_flash_plan_matches_its_c_mirror(cuda):
    """`flash_attention.flash_plan_field` against the kernel's exported
    `flash_plan_field` over both dtypes, every configuration and both
    masks, on the H100's SMs and on a small card's."""
    mirror = flash_attention.KERNEL.helper("flash_plan_field",
                                           [ctypes.c_int] * 10)
    shapes = [(16_384, 32, 32, 4, 1, 64), (4, 2048, 2048, 24, 8, 128),
              (4, 2048, 2048, 48, 8, 128), (4, 1500, 1500, 12, 12, 64),
              (2, 41, 41, 6, 2, 100), (2, 512, 512, 2, 2, 256),
              (3, 7, 300, 3, 1, 32), (1, 1, 1, 1, 1, 1)]
    for bf16 in (0, 1):
        for b, sq, sk, h, kv, dh in shapes:
            for causal in (0, 1):
                for sms in (132, 8):
                    for f in range(len(flash_attention.PLAN_FIELDS) + 1):
                        args = (bf16, b, sq, sk, h, kv, dh, causal, sms, f)
                        assert mirror(*args) == \
                            flash_attention.flash_plan_field(*args), args


@pytest.mark.cuda
def test_flash_wrapper_raises_where_a_gradient_would_drop(cuda):
    """The kernel has no backward: with grad mode on and q, k or v
    requiring grad the wrappers raise and name the training route,
    rather than return an output that carries no gradient."""
    q = torch.randn((1, 16, 2, 32), device=cuda, requires_grad=True)
    k = torch.randn((1, 16, 1, 32), device=cuda)
    before = flash_attention.KERNEL.launches
    with pytest.raises(RuntimeError, match="differentiable=True"):
        flash_attention.gqa_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention(q[:, :, 0], k[:, :, 0], k[:, :, 0])
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.gqa_attention(q.detach(), k.requires_grad_(), k)
    assert flash_attention.KERNEL.launches == before
    with torch.no_grad():
        out = flash_attention.gqa_attention(q, k, k)
    assert out.shape == q.shape and not out.requires_grad
    assert flash_attention.gqa_attention(q.detach(), k.detach(),
                                         k.detach()).shape == q.shape
    assert flash_attention.KERNEL.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "block"])
def test_train_step_on_the_card_gives_every_leaf_a_gradient(cuda, remat):
    """The reduced minitron's train step on the card: every parameter leaf
    gets a non-zero gradient, no flash launch, finite metrics, every leaf
    moved by the update."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.train import (init_train_state, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import tree_leaves, tree_paths
    cfg = get_config("minitron-4b").reduced()
    opt = adamw(1e-3, weight_decay=0.1)
    params, state = init_train_state(cfg, opt, _gen(0))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             TokenStream(cfg, 2, 64, seed=0).next_batch().items()}
    flash_attention.KERNEL.launches = 0
    _, grads = loss_and_grads(cfg, params, batch, remat=remat)
    zero = ["/".join(p) for p, g in tree_paths(grads) if not bool(g.any())]
    assert zero == []
    before = [t.clone() for t in tree_leaves(params)]
    params, state, metrics = make_train_step(cfg, opt, remat=remat)(
        params, state, batch)
    assert flash_attention.KERNEL.launches == 0
    assert all(bool(v.isfinite()) for v in metrics.values())
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))


# ---------------------------------------------------------------------------
# the service's churn: departed clients' score columns at -inf, and the
# exchange rows whose ranks they mask
# ---------------------------------------------------------------------------
def _depart(scores, share, seed):
    """`scores` with max(1, round(share * M)) columns at -inf."""
    m = scores.shape[0]
    gone = torch.randperm(m, generator=_gen(seed), device="cuda")[
        :max(1, round(share * m))]
    return scores.index_fill(0, gone, float("-inf"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,n", [(10, 8, 9), (17, 3, 16), (40, 4, 9),
                                   (700, 8, 128), (4097, 8, 16),
                                   (300, 8, 200), (64, 33, 63)])
@pytest.mark.parametrize("share", [0.2, 0.9])
def test_selection_kernels_masked_ranks_equal_plain(cuda, m, w, n, share):
    """With departed clients (-inf score columns, tied and gridded
    scores) both exact entry points give the plain version's ids and
    weights on every rank: the masked ranks hold the row and the departed
    clients in ascending id (the knockout instance, N > 128 or W > 32,
    through the one-shot entry point only)."""
    codes, score_sets = _exact_inputs(m, w, 5 * m + w)
    lut = ref.selection_lut(w, w * 32, 1.0, device=cuda)
    tiled = selection.select_plan(m, w, n)["instance"] == "mma"
    for scores in score_sets:
        scores = _depart(scores, share, m)
        kw = dict(bits=w * 32, gamma=1.0, num_neighbors=n)
        pi, pw = ref.fused_select_ref(codes, scores, lut, num_neighbors=n)
        oi, ow = selection.fused_select(codes, scores, **kw)
        assert torch.equal(oi, pi) and torch.equal(ow, pw)
        if tiled:
            ti, tw = selection.fused_select_tiled(codes, scores, **kw)
            assert torch.equal(ti, pi) and torch.equal(tw, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,w,n,pb,probes", [
    ("random", 40, 8, 9, 3, 2), ("random", 130, 32, 128, 2, 2),
    ("clustered", 4096, 8, 16, 10, 8), ("distinct", 37, 4, 9, 10, 8)])
def test_grouped_ann_kernel_masked_ranks_equal_plain(cuda, kind, m, w, n, pb,
                                                     probes):
    """The grouped ANN kernel with half the clients departed equals its
    plain version on every rank (id 0 where the weight is not finite, as
    `ann_select_ref`) and the per-row kernel."""
    from repro_torch.core import ann
    codes, score_sets = _grouped_inputs(kind, m, w, 3 * m + w)
    lut = ref.selection_lut(w, w * 32, 1.0, device=cuda)
    for scores in score_sets:
        scores = _depart(scores, 0.5, m)
        kw = dict(seed=m, prefix_bits=pb, probes=probes, num_neighbors=n)
        cand = ann.bucket_candidates(codes, scores, **kw)
        rows = ann.ann_candidates(codes, scores, **kw)
        call = dict(bits=w * 32, gamma=1.0, num_neighbors=n)
        gi, gw = selection.fused_select_ann_grouped(codes, scores, cand,
                                                    **call)
        pi, pw = ref.ann_select_grouped_ref(codes, scores, cand, lut,
                                            num_neighbors=n)
        assert torch.equal(gi, pi) and torch.equal(gw, pw)
        assert bool((gi[~gw.isfinite()] == 0).all())
        ri, rw = selection.fused_select_ann(codes, scores, rows.ids, **call)
        assert torch.equal(gi, ri) and torch.equal(gw, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,c", [(10, 9, 64, 10), (6, 16, 64, 12),
                                     (600, 16, 64, 10), (8, 8, 32, 2048)])
def test_exchange_kernels_on_masked_rows_equal_plain(cuda, m, n, r, c):
    """Rows under churn: every third row all masked (no valid neighbour,
    has_target False), every third only rank 0 selected (N-1 of N
    masked). Both exchange kernels against both plain versions."""
    own, nb, y, sel = _exchange_case(m, n, r, c, seed=m * c)
    rows = torch.arange(m, device="cuda") % 3
    sel[rows == 0] = False
    sel[rows == 1] = False
    sel[rows == 1, 0] = True
    for fn, rtol in ((exchange.fused_exchange, 1e-5),
                     (exchange.fused_exchange_streamed, 2e-5)):
        kl, kv, kt, kh = got = fn(own, nb, y, sel)
        assert not kh[0] and not kv[0].any()
        for plain in (ref.all_in_one_exchange_ref, ref.streamed_exchange_ref):
            pl, pv, pt, ph = plain(own, nb, y, sel)
            torch.testing.assert_close(kl, pl, rtol=rtol, atol=1e-5)
            torch.testing.assert_close(kt, pt, rtol=rtol, atol=1e-5)
            assert torch.equal(kv, pv) and torch.equal(kh, ph)
        assert _same_bits(got, fn(own, nb, y, sel))


@pytest.mark.cuda
def test_analysis_gate_on_the_card(cuda):
    """`repro_torch.analysis` on the card: every registry entry launched
    against its twin, the shared-memory mirrors equal to their Python
    functions, the 16 taint targets clean through the kernels (whose
    wrapper rule fired), the lint and completeness clean."""
    from repro_torch.analysis.__main__ import run_gate
    gate = run_gate("cuda")
    assert gate["findings"] == [], [str(f) for f in gate["findings"]]
    assert sorted(gate["contracts"]) == sorted(gate["entries"])
    assert all(c["launches"] >= 1 for c in gate["contracts"].values())
    assert gate["estimator_checks"] > 0
    assert {"lsh_projection", "selection", "exchange"} <= set(
        gate["taint_kernels"])


@pytest.mark.cuda
def test_fed_dryrun_segment_matches_the_cpu(cuda, monkeypatch):
    """The federation dry run's segment at 16 clients, weights and data
    drawn on the CPU, on the card and on the CPU: the same ids, flops and
    has_target; flash launched 2 * 2 times (2 layers of the exchange's
    two vmapped forward calls, the own forwards and the neighbour web,
    each one launch through the op's vmap rule) and never in the update. Within the limits
    `chip_smoke.py` holds the same pair to (FED16_LIMITS, set from sound
    runs on an H100): the relative L2 distance ||card - cpu|| / ||cpu||
    of the worst leaf of the new Adam moments m and v (after a first
    step they hold the gradient: m = (1 - b1) g, v = (1 - b2) g^2) and
    of the params' update p1 - p0; the share of valid-mask entries that
    differ; the distance of target_ref over the clients whose masks
    agree, of l_ij and of mean_neighbor_loss."""
    from repro_torch.core import protocol
    from repro_torch.launch import fed as fed_launch
    limits = {"m": 0.05, "v": 0.05, "update": 0.5, "valid_mask_differ": 0.05,
              "target_ref": 0.02, "l_ij": 1e-3, "mean_neighbor_loss": 1.5e-4}
    real, seen = protocol.exchange_phase, []

    def exchange_phase(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(protocol, "exchange_phase", exchange_phase)
    runs = {}
    for dev in ("cuda", "cpu"):
        dr = fed_launch.prepare_fed_dryrun(16, device=dev, draw_device="cpu")
        n0 = flash_attention.KERNEL.launches
        state, metrics = dr.segment_fn(dr.state, dr.data)
        runs[dev] = (dr, state, metrics[0], seen[-1],
                     flash_attention.KERNEL.launches - n0)
    (dc, sc, mc, ec, lc), (dp, sp, mp, ep, lp) = runs["cuda"], runs["cpu"]
    assert (lc, lp) == (2 * 2, 0)
    assert torch.equal(mc["neighbor_ids"].cpu(), mp["neighbor_ids"])
    assert fed_launch.segment_flops(dc) == fed_launch.segment_flops(dp)
    assert torch.equal(ec.has_target.cpu(), ep.has_target)

    def rel(a, b):
        a, b = a.detach().cpu().float(), b.detach().float()
        return float((a - b).norm() / b.norm())

    p0 = dp.state.params
    got = {part: max(rel(sc.opt_state[part][k], v)
                     for k, v in sp.opt_state[part].items())
           for part in ("m", "v")}
    got["update"] = max(rel(sc.params[k].cpu().float() - p0[k].float(),
                            v.float() - p0[k].float())
                        for k, v in sp.params.items())
    same = ec.valid_mask.cpu() == ep.valid_mask
    got["valid_mask_differ"] = 1.0 - float(same.float().mean())
    rows = same.all(-1)
    got["target_ref"] = rel(ec.target_ref.cpu()[rows], ep.target_ref[rows])
    got["l_ij"] = rel(ec.l_ij, ep.l_ij)
    got["mean_neighbor_loss"] = rel(mc["mean_neighbor_loss"],
                                    mp["mean_neighbor_loss"])
    assert all(got[k] <= lim for k, lim in limits.items()), got
