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
import pytest
import torch

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
    """Two aecg rounds with backend="ann": one ANN selection per round,
    no exact selection, the same ids on a second run."""
    from repro_torch.launch.fed import run_federation
    runs = []
    for _ in range(2):
        selection.ANN_KERNEL.launches = selection.KERNEL.launches = 0
        _, hist = run_federation("aecg", rounds=2, num_clients=6,
                                 backend="ann", ann_prefix_bits=2,
                                 ann_probes=1, device=cuda, log=None)
        assert selection.ANN_KERNEL.launches == 2
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
