"""The port's ANN partner selection held against the JAX package, on the
CPU.

Same inputs, made with numpy from a seed (or, for the recall case, with
the JAX ANN tests' own clustered-code recipe), go through
`repro.core.ann` / `repro.kernels.ref.ann_select_ref` and through the
port's `repro_torch.core.ann` / `ref.ann_select_ref` (the plain version
of the ANN selection kernel, which the wrapper takes for CPU tensors).
Tolerances:

* bit-exact: candidate ids, buckets, counts, dropped, the prefix
  permutation and the bucket table; selection ids always; selection
  weights when both sides gather from the same exp table (the JAX one,
  handed to the port's plain version);
* selection weights through the port's own table: within 2 ulp
  (torch's and XLA's f32 exp differ in the last bit on a few entries,
  and the Eq. 8 product rounds once more).

The reference's recall is below its own 0.95 bar on the JAX test's
inputs (`tests/test_ann_selection.py::
test_recall_at_n_clustered_codes_paper_config`); the port is held equal
to the reference's ids and recall there, not to that constant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs.paper_models as jcfg
from repro.core import ann as jann
from repro.core import backends as jbackends
from repro.core import neighbor as jneighbor
from repro.kernels import ops as jops
from repro.kernels import ref as jref

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import ann, backends, neighbor
from repro_torch.kernels import ref, selection

GAMMA = 1.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(m, w, seed):
    """Random packed codes: (uint32 for JAX, int32 view for the port)."""
    u = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


def _scores(m, seed, grid=False):
    rs = np.random.RandomState(seed)
    if grid:                     # Eq. 7-like: few values, many ties
        return rs.choice([0.0, 0.25, 0.5, 1.0], m).astype(np.float32)
    return rs.rand(m).astype(np.float32)


def _jax_lut(w, bits, gamma=GAMMA):
    return _t(np.asarray(jnp.exp(-gamma * (
        jnp.arange(w * 32 + 1, dtype=jnp.float32) / float(bits)))))


def _candidates_both(cu, ci, scores, **kw):
    j = jann.ann_candidates(jnp.asarray(cu), jnp.asarray(scores), **kw)
    p = ann.ann_candidates(_t(ci), _t(scores), **kw)
    return j, p


def _assert_candidates_equal(j, p):
    for field in j._fields:
        a, b = np.asarray(getattr(j, field)), getattr(p, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,pb,seed", [(256, 10, 0), (256, 10, 3),
                                          (128, 5, 123_456),
                                          (64, 16, 2 ** 31 - 5),
                                          (256, 0, 1)])
def test_prefix_bit_indices_equal_jax(bits, pb, seed):
    j = np.asarray(jann.prefix_bit_indices(bits, pb, seed))
    p = ann.prefix_bit_indices(bits, pb, seed).numpy()
    assert p.dtype == np.int32 and np.array_equal(p, j)


@pytest.mark.parametrize("m,pb,probes", [
    (13, 0, 0), (13, 2, 1), (13, 5, 5), (37, 0, 0), (37, 2, 2), (37, 5, 3),
    (64, 0, 0), (64, 2, 1), (64, 5, 5)])
@pytest.mark.parametrize("seed", [0, 7])
def test_candidates_equal_jax(m, pb, probes, seed):
    cu, ci = _codes(m, 4, seed=m)
    scores = _scores(m, seed=m + 1, grid=True)
    j, p = _candidates_both(cu, ci, scores, seed=seed, prefix_bits=pb,
                            probes=probes, num_neighbors=5)
    _assert_candidates_equal(j, p)
    assert p.ids.shape == (m, ann.candidate_count(m, pb, probes, 5, 128))


def test_bucket_table_equal_jax_with_skew_and_overflow():
    """One giant bucket, singletons and empty buckets; the cap drops part
    of the giant bucket from the candidate side."""
    bucket = np.array([3] * 20 + [0, 5, 5, 7, 1, 3, 3], np.int32)
    m, nb, cap = len(bucket), 8, 6
    j = jann.build_bucket_table(jnp.asarray(bucket), m, nb, cap)
    p = ann.build_bucket_table(_t(bucket), m, nb, cap)
    for a, b in zip(j, p):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_all_identical_codes_candidates_and_selection():
    """Every client in one bucket at any prefix: candidates equal the
    reference's and the selection equals the exact top-N."""
    m, w, n = 24, 4, 6
    cu, ci = _codes(1, w, seed=3)
    cu, ci = np.repeat(cu, m, 0), np.repeat(ci, m, 0)
    scores = _scores(m, seed=4)
    lut = ref.selection_lut(w, w * 32, GAMMA)
    ei, ew = ref.fused_select_ref(_t(ci), _t(scores), lut, num_neighbors=n)
    for pb, probes in [(0, 0), (4, 2), (6, 6)]:
        j, p = _candidates_both(cu, ci, scores, seed=11, prefix_bits=pb,
                                probes=probes, num_neighbors=n)
        _assert_candidates_equal(j, p)
        ai, aw = selection.fused_select_ann(_t(ci), _t(scores), p.ids,
                                            bits=w * 32, gamma=GAMMA,
                                            num_neighbors=n)
        assert torch.equal(ai, ei) and torch.equal(aw, ew)


def test_tiny_m_empty_probe_buckets():
    """M=10 against 64 buckets: most probes hit empty buckets, yet the
    cap and the teaser still give the exact top-N."""
    m, w, n = 10, 4, 4
    cu, ci = _codes(m, w, seed=9)
    scores = _scores(m, seed=10)
    j, p = _candidates_both(cu, ci, scores, seed=5, prefix_bits=6, probes=6,
                            num_neighbors=n)
    _assert_candidates_equal(j, p)
    assert int(p.counts.sum()) == m and int((p.counts == 0).sum()) >= 54
    lut = ref.selection_lut(w, w * 32, GAMMA)
    ei, ew = ref.fused_select_ref(_t(ci), _t(scores), lut, num_neighbors=n)
    ai, aw = ref.ann_select_ref(_t(ci), _t(scores), p.ids, lut,
                                num_neighbors=n)
    assert torch.equal(ai, ei) and torch.equal(aw, ew)


def test_candidate_count_at_the_auto_thresholds():
    """K at the paper's defaults (prefix 10, probes 8, 256 bits, N=16)."""
    k = lambda m: ann.candidate_count(m, 10, 8, 16, 256)   # noqa: E731
    assert k(4096) == 185 and k(65_536) == 2_336
    for m in (10, 4095, 4096, 65_536):
        assert k(m) == jann.candidate_count(m, 10, 8, 16, 256)


def test_occupancy_stats_equal_jax():
    cu, ci = _codes(300, 8, seed=2)
    scores = _scores(300, seed=3)
    j, p = _candidates_both(cu, ci, scores, seed=1, prefix_bits=4, probes=2,
                            num_neighbors=12)
    assert ann.occupancy_stats(p) == jann.occupancy_stats(j)


# ---------------------------------------------------------------------------
# the plain version of the ANN selection kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,w,pb,probes,n", [
    (13, 2, 0, 0, 4), (37, 4, 2, 2, 5), (64, 8, 4, 3, 12),
    (130, 4, 6, 6, 12), (9, 2, 3, 1, 8)])
@pytest.mark.parametrize("case", ["random", "zero_scores", "no_lsh",
                                  "no_rank"])
def test_ann_select_ref_bit_exact_vs_jax(m, w, pb, probes, n, case):
    cu, ci = _codes(m, w, seed=m)
    scores = _scores(m, seed=m + 1, grid=case == "no_lsh")
    if case == "zero_scores":     # round 0: every weight ties
        scores[:] = 0.0
    flags = {"no_lsh": dict(use_lsh=False),
             "no_rank": dict(use_rank=False)}.get(case, {})
    j, p = _candidates_both(cu, ci, scores, seed=7, prefix_bits=pb,
                            probes=probes, num_neighbors=n)
    ji, jw = jref.ann_select_ref(jnp.asarray(cu), jnp.asarray(scores), j.ids,
                                 bits=w * 32, gamma=GAMMA, num_neighbors=n,
                                 **flags)
    pi, pw = ref.ann_select_ref(_t(ci), _t(scores), p.ids,
                                _jax_lut(w, w * 32), num_neighbors=n,
                                block_m=16, **flags)
    assert pi.dtype == torch.int32 and np.array_equal(pi.numpy(),
                                                      np.asarray(ji))
    assert np.array_equal(pw.numpy(), np.asarray(jw))
    # through the wrapper and the port's own exp table: ids equal,
    # weights within 2 ulp (a table entry 1 ulp off, then the product's
    # own rounding)
    wi, ww = selection.fused_select_ann(_t(ci), _t(scores), p.ids,
                                        bits=w * 32, gamma=GAMMA,
                                        num_neighbors=n, **flags)
    assert np.array_equal(wi.numpy(), np.asarray(ji))
    ulps = np.abs(ww.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jw).view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


@pytest.mark.parametrize("m,n", [(13, 4), (37, 12), (64, 5)])
def test_prefix_zero_fallback_equals_the_exact_selection(m, n):
    """prefix_bits=0: one bucket of capacity M, candidates in ascending
    id order, so the ANN selection equals the exact one bit for bit."""
    w = 4
    cu, ci = _codes(m, w, seed=m)
    scores = _scores(m, seed=m + 2)
    cand = ann.ann_candidates(_t(ci), _t(scores), seed=0, prefix_bits=0,
                              probes=0, num_neighbors=n)
    lut = ref.selection_lut(w, w * 32, GAMMA)
    ai, aw = ref.ann_select_ref(_t(ci), _t(scores), cand.ids, lut,
                                num_neighbors=n)
    ei, ew = ref.fused_select_ref(_t(ci), _t(scores), lut, num_neighbors=n)
    assert torch.equal(ai, ei) and torch.equal(aw, ew)
    ji, _ = jref.fused_select_ref(jnp.asarray(cu), jnp.asarray(scores),
                                  bits=w * 32, gamma=GAMMA, num_neighbors=n)
    assert np.array_equal(ai.numpy(), np.asarray(ji))


def test_ann_select_ref_degenerate_shapes():
    _, ci = _codes(1, 2, seed=0)
    ids, w = ref.ann_select_ref(_t(ci), torch.zeros(1),
                                torch.zeros((1, 16), dtype=torch.int32),
                                ref.selection_lut(2, 64, GAMMA),
                                num_neighbors=4)
    assert ids.shape == (1, 0) and w.shape == (1, 0)


# ---------------------------------------------------------------------------
# routing and the protocol entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("pb,probes", [(3, 2), (5, 1)])
def test_select_partners_ann_equals_jax(seed, pb, probes):
    m, w, n = 40, 8, 6
    cu, ci = _codes(m, w, seed=seed + 20)
    scores = _scores(m, seed=seed + 21, grid=True)
    jfed = jcfg.FedConfig(num_clients=m, num_neighbors=n, lsh_bits=w * 32,
                          ann_prefix_bits=pb, ann_probes=probes)
    pfed = pcfg.FedConfig(num_clients=m, num_neighbors=n, lsh_bits=w * 32,
                          ann_prefix_bits=pb, ann_probes=probes)
    ji, jm = jneighbor.select_partners(jnp.asarray(cu), jnp.asarray(scores),
                                       jfed, backend="ann", seed=seed)
    pi, pm = neighbor.select_partners(_t(ci), _t(scores), pfed,
                                      backend="ann", seed=seed)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    with pytest.raises(ValueError, match="unknown tiling"):
        neighbor.select_partners(_t(ci), _t(scores), pfed, backend="ann",
                                 tiling="huge")


def test_select_partners_ann_excludes_self_and_clamps_n():
    m = 6
    _, ci = _codes(m, 4, seed=0)
    fed = pcfg.FedConfig(num_clients=m, num_neighbors=50, lsh_bits=128,
                         ann_prefix_bits=3, ann_probes=2)
    ids, mask = neighbor.select_partners(_t(ci), _t(_scores(m, 1)), fed,
                                         backend="ann")
    assert ids.shape == (m, m - 1) and bool(mask.all())
    assert not bool((ids == torch.arange(m)[:, None]).any())


def test_resolve_selection_routing_mirrors_jax():
    flops = dict(exact_flops=100.0, ann_flops=1.0)
    cases = [("ann", 10, flops), ("auto", backends.ANN_AUTO_MIN_M, flops),
             ("auto", backends.ANN_AUTO_MIN_M - 1, flops),
             ("auto", backends.ANN_AUTO_MIN_M,
              dict(exact_flops=100.0, ann_flops=99.0)),
             ("oracle", 10 ** 6, flops)]
    for b, m, f in cases:
        assert backends.resolve_selection(b, m, device="cpu", **f) == \
            jbackends.resolve_selection(b, m, **f)
    assert backends.resolve_selection("auto", 10, device="cuda",
                                      **flops) == "kernel"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        backends.resolve_selection("kernel", 10, device="cpu", **flops)
    with pytest.raises(ValueError,
                       match=r"unknown selection backend: 'annn' \(expected"):
        backends.resolve_selection("annn", 10, device="cpu", **flops)
    assert (backends.SELECTION_BACKENDS, backends.ANN_AUTO_MIN_M,
            backends.ANN_AUTO_MIN_RATIO) == (
        jbackends.SELECTION_BACKENDS, jbackends.ANN_AUTO_MIN_M,
        jbackends.ANN_AUTO_MIN_RATIO)
    for m, k in ((10, 100), (4096, 185)):
        assert backends.selection_flops(m, 256) == \
            jbackends.selection_flops(m, 256)
        assert backends.ann_selection_flops(m, 256, k) == \
            jbackends.ann_selection_flops(m, 256, k)


@pytest.mark.parametrize("m,want", [(4095, "oracle"), (4096, "ann")])
def test_auto_takes_ann_where_the_jax_package_does(m, want):
    """At the defaults (prefix 10, probes 8, 256 bits, N=16) "auto" takes
    the ANN path from M=4096 on, as the JAX package resolves it."""
    fed = pcfg.FedConfig(num_clients=m, num_neighbors=16)
    k = ann.candidate_count(m, fed.ann_prefix_bits, fed.ann_probes, 16, 256)
    kw = dict(exact_flops=backends.selection_flops(m, 256),
              ann_flops=backends.ann_selection_flops(m, 256, k))
    got = backends.resolve_selection("auto", m, device="cpu", **kw)
    assert got == jbackends.resolve_selection("auto", m, **kw) == want


def test_auto_select_partners_at_4096_is_the_ann_selection():
    """select_partners(backend="auto") at M=4096 gives the explicit ANN
    selection's ids, which differ from the exact ones."""
    m, n = 4096, 16
    _, ci = _codes(m, 8, seed=1)
    scores = _t(_scores(m, seed=2, grid=True))
    fed = pcfg.FedConfig(num_clients=m, num_neighbors=n)
    auto, _ = neighbor.select_partners(_t(ci), scores, fed, seed=2)
    ann_ids, _ = neighbor.select_partners(_t(ci), scores, fed,
                                          backend="ann", seed=2)
    exact, _ = neighbor.select_partners(_t(ci), scores, fed,
                                        backend="oracle")
    assert torch.equal(auto, ann_ids) and not torch.equal(auto, exact)


def test_exchange_resolve_rejects_ann():
    with pytest.raises(ValueError, match=r"unknown backend: 'ann' \(expected"):
        backends.resolve("ann", "cpu")


# ---------------------------------------------------------------------------
# recall against the exact selection
# ---------------------------------------------------------------------------
def _clustered_codes(m, words, n_clusters, flip, seed):
    """The JAX ANN tests' clustered codes (cluster centres + bit flips)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    bits = words * 32
    centers = jax.random.bernoulli(k1, 0.5, (n_clusters, bits))
    assign = jax.random.randint(k2, (m,), 0, n_clusters)
    flips = jax.random.bernoulli(k3, flip, (m, bits))
    raw = jnp.logical_xor(centers[assign], flips)
    return np.asarray(jops.pack_bits(jnp.where(raw, 1.0, -1.0)))


def test_recall_on_clustered_codes_equals_the_reference():
    m, bits, n = 512, 256, 12
    cu = _clustered_codes(m, bits // 32, n_clusters=16, flip=0.02, seed=0)
    ci = cu.view(np.int32)
    scores = np.asarray(0.75 + 0.25 * jax.random.uniform(
        jax.random.PRNGKey(1), (m,)))
    ji_exact, _ = jref.fused_select_ref(jnp.asarray(cu), jnp.asarray(scores),
                                        bits=bits, gamma=GAMMA,
                                        num_neighbors=n)
    jc = jann.ann_candidates(jnp.asarray(cu), jnp.asarray(scores), seed=3,
                             prefix_bits=5, probes=5, num_neighbors=n)
    ji_ann, _ = jref.ann_select_ref(jnp.asarray(cu), jnp.asarray(scores),
                                    jc.ids, bits=bits, gamma=GAMMA,
                                    num_neighbors=n)
    pc = ann.ann_candidates(_t(ci), _t(scores), seed=3, prefix_bits=5,
                            probes=5, num_neighbors=n)
    lut = ref.selection_lut(bits // 32, bits, GAMMA)
    pi_ann, _ = selection.fused_select_ann(_t(ci), _t(scores), pc.ids,
                                           bits=bits, gamma=GAMMA,
                                           num_neighbors=n)
    pi_exact, _ = ref.fused_select_ref(_t(ci), _t(scores), lut,
                                       num_neighbors=n)

    def recall(exact, approx):
        return sum(len(set(exact[i]) & set(approx[i]))
                   for i in range(m)) / float(m * n)

    j_recall = recall(np.asarray(ji_exact), np.asarray(ji_ann))
    p_recall = recall(pi_exact.numpy(), pi_ann.numpy())
    assert np.array_equal(pi_ann.numpy(), np.asarray(ji_ann))
    assert p_recall == j_recall
    assert int(pc.dropped) == int(jc.dropped)
    print(f"recall@{n}: port {p_recall:.4f}, reference {j_recall:.4f}, "
          f"K={pc.ids.shape[1]}, dropped {int(pc.dropped)}")


def test_ann_wrapper_takes_the_plain_version_on_cpu_without_launching():
    _, ci = _codes(20, 4, seed=5)
    scores = _t(_scores(20, seed=6))
    cand = ann.ann_candidates(_t(ci), scores, seed=1, prefix_bits=2,
                              probes=1, num_neighbors=4)
    before = selection.ANN_KERNEL.launches
    ids, w = selection.fused_select_ann(_t(ci), scores, cand.ids, bits=128,
                                        gamma=GAMMA, num_neighbors=4)
    pi, pw = ref.ann_select_ref(_t(ci), scores, cand.ids,
                                ref.selection_lut(4, 128, GAMMA),
                                num_neighbors=4)
    assert torch.equal(ids, pi) and torch.equal(w, pw)
    assert selection.ANN_KERNEL.launches == before
