"""The PyTorch port's kernel modules held against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX function
(its `kernels/ref.py` oracle, or the Pallas kernel in interpret mode at
one small shape) and through the port's counterpart on the CPU, where
each kernel wrapper takes its plain PyTorch version. Tolerances:

* bit-exact: the Rademacher hash, pack/unpack, the flatten order,
  Hamming distances, selection ids (all-ties and ablations included),
  the exchange's valid mask and has_target;
* LSH sums: |port - jax| <= 1e-5 * (|jax| + ||x_row||_2), the f32
  rounding of a length-P dot product taken in another order; codes
  equal except on bits whose JAX sum is within 1e-3 of zero;
* selection weights: within 1 ulp (torch's and XLA's f32 exp in the
  table may differ in the last bit);
* exchange l_ij and target: rtol 1e-5 (log-softmax, exp and mean in
  another order).

The CUDA kernels themselves are held against their plain versions on
the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import ClientModelConfig as JaxModelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lsh_projection import lsh_project_sums_batched as jax_lsh
from repro.kernels.lsh_projection import rademacher_block as jax_rademacher
from repro.kernels.selection import fused_select as jax_fused_select
from repro.models import init_client_model as jax_init

from repro_torch.configs.paper_models import ClientModelConfig
from repro_torch.kernels import exchange, lsh_projection, ops, ref, selection
from repro_torch.models.convert import params_from_jax

SMALL_MODELS = {
    "cnn": dict(name="t-cnn", kind="cnn", input_shape=(8, 8, 1),
                num_classes=3, hidden=(4, 8), kernel_size=3),
    "tcn": dict(name="t-tcn", kind="tcn", input_shape=(12, 1),
                num_classes=2, hidden=(4, 4), kernel_size=3),
    "mlp": dict(name="t-mlp", kind="mlp", input_shape=(6,), num_classes=3,
                hidden=(5,)),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _codes(rs, m, w):
    """Random packed codes: (uint32 for JAX, int32 view for the port)."""
    u = rs.randint(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


def _ulps(a, b):
    """Distance in f32 ulps between same-sign finite arrays (inf == inf)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    same = a == b
    ai, bi = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    return np.where(same, 0, np.abs(ai - bi))


def _assert_sums_close(port, jax_sums, x):
    scale = np.linalg.norm(x, axis=1, keepdims=True)
    err = np.abs(port - jax_sums)
    assert np.all(err <= 1e-5 * (np.abs(jax_sums) + scale)), err.max()


def _assert_codes_equal_off_zero(port_codes, jax_codes, jax_sums, bits):
    """Equal except bits whose JAX sum is within 1e-3 of 0; returns the
    number of such near-zero bits."""
    pb = ops.unpack_bits(_t(port_codes), bits).numpy()
    jb = np.asarray(jops.unpack_bits(jnp.asarray(jax_codes), bits))
    near = np.abs(jax_sums) <= 1e-3
    assert np.array_equal(pb[~near], jb[~near])
    return int(near.sum())


# ---------------------------------------------------------------------------
# hashing, packing, flattening
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i0,chunk,bits,seed", [
    (0, 64, 256, 0), (4096, 32, 128, 7), (2 ** 31 + 5, 16, 64, 2 ** 32 - 1)])
def test_rademacher_block_bit_exact(i0, chunk, bits, seed):
    j = np.asarray(jax_rademacher(i0, chunk, bits, seed))
    p = ops.rademacher_block(i0, chunk, bits, seed).numpy()
    assert p.dtype == np.float32 and np.array_equal(p, j)


@pytest.mark.parametrize("bits,lead", [(128, (5,)), (256, (2, 3))])
def test_pack_unpack_bit_exact(bits, lead):
    rs = np.random.RandomState(bits)
    sums = rs.randn(*lead, bits).astype(np.float32)
    sums[..., ::7] = 0.0                       # exact zeros pack as 0
    j = np.asarray(jops.pack_bits(jnp.asarray(sums)))
    p = ops.pack_bits(_t(sums))
    assert p.dtype == torch.int32
    assert np.array_equal(p.numpy().view(np.uint32), j)
    assert np.array_equal(ops.unpack_bits(p, bits).numpy(),
                          np.asarray(jops.unpack_bits(jnp.asarray(j), bits)))


@pytest.mark.parametrize("kind", sorted(SMALL_MODELS))
def test_flatten_params_batched_in_jax_leaf_order(kind):
    spec = SMALL_MODELS[kind]
    shapes = jax.eval_shape(lambda k: jax_init(JaxModelConfig(**spec), k),
                            jax.random.PRNGKey(3))
    rs = np.random.RandomState(3)
    tree = jax.tree.map(
        lambda s: rs.randn(4, *s.shape).astype(np.float32), shapes)
    j = np.asarray(jops.flatten_params_batched(tree))
    params = params_from_jax(ClientModelConfig(**spec),
                             jax.tree.map(np.asarray, tree))
    p = ops.flatten_params_batched(params).numpy()
    assert p.shape == j.shape and p.shape[1] % ops.CHUNK == 0
    assert np.array_equal(p, j)


def test_flatten_order_of_the_paper_cnn():
    """mnist-cnn: b1, b2, bf1, bf2, conv1, conv2, fc1, fc2 — 421,642
    values padded to 206 * 2048."""
    from repro_torch.configs.paper_models import mnist_cnn
    from repro_torch.models.client import client_template
    named = dict(client_template(mnist_cnn()).named_parameters())
    order = sorted(named, key=ops.leaf_key)
    assert order == ["b1", "b2", "bf1", "bf2", "conv1", "conv2", "fc1",
                     "fc2"]
    total = sum(named[k].numel() for k in order)
    assert total == 421_642 and -(-total // ops.CHUNK) == 206


def test_hamming_all_pairs_bit_exact():
    rs = np.random.RandomState(11)
    ua, ia = _codes(rs, 9, 8)
    ub, ib = _codes(rs, 5, 8)
    j = np.asarray(jref.hamming_all_pairs_ref(jnp.asarray(ua),
                                              jnp.asarray(ub)))
    p = ref.hamming_all_pairs_ref(_t(ia), _t(ib)).numpy()
    assert np.array_equal(p, j)


# ---------------------------------------------------------------------------
# LSH projection (Pallas row 1)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,p,bits,seed", [(5, 4096, 256, 3),
                                           (12, 2048, 128, 2 ** 31 + 9)])
def test_lsh_sums_and_codes_match_jax_oracle(m, p, bits, seed):
    rs = np.random.RandomState(m)
    x = (rs.randn(m, p) * 0.05).astype(np.float32)
    j = np.asarray(jref.lsh_project_sums_batched_ref(jnp.asarray(x), seed,
                                                     bits=bits))
    s = lsh_projection.lsh_project_sums_batched(_t(x), seed,
                                                bits=bits).numpy()
    _assert_sums_close(s, j, x)
    jc = np.asarray(jops.batched_lsh_codes(jnp.asarray(x), seed, bits=bits,
                                           use_kernel=False))
    pc = ops.batched_lsh_codes(_t(x), seed, bits=bits).numpy()
    _assert_codes_equal_off_zero(pc, jc, j, bits)
    assert np.array_equal(pc.view(np.uint32), jc)   # no sum near 0 here


def test_lsh_matches_pallas_kernel_interpret():
    rs = np.random.RandomState(0)
    x = rs.randn(8, 4096).astype(np.float32)
    k = np.asarray(jax_lsh(jnp.asarray(x), 7, bits=256, interpret=True))
    p = lsh_projection.lsh_project_sums_batched(_t(x), 7, bits=256).numpy()
    _assert_sums_close(p, k, x)
    _assert_codes_equal_off_zero(ops.pack_bits(_t(p)).numpy(),
                                 np.asarray(jops.pack_bits(jnp.asarray(k))),
                                 k, 256)


# ---------------------------------------------------------------------------
# fused selection (Pallas row 3)
# ---------------------------------------------------------------------------
def _select_both(codes_u, codes_i, scores, *, bits, gamma, n, use_lsh=True,
                 use_rank=True):
    ji, jw = jref.fused_select_ref(jnp.asarray(codes_u), jnp.asarray(scores),
                                   bits=bits, gamma=gamma, num_neighbors=n,
                                   use_lsh=use_lsh, use_rank=use_rank)
    pi, pw = selection.fused_select(_t(codes_i), _t(scores), bits=bits,
                                    gamma=gamma, num_neighbors=n,
                                    use_lsh=use_lsh, use_rank=use_rank)
    return (np.asarray(ji), np.asarray(jw)), (pi.numpy(), pw.numpy())


@pytest.mark.parametrize("case", ["random", "all_ties", "no_lsh", "no_rank",
                                  "duplicate_codes"])
def test_selection_matches_jax_oracle(case):
    rs = np.random.RandomState(len(case))
    m, w, n, gamma = 13, 8, 5, 1.5
    cu, ci = _codes(rs, m, w)
    scores = rs.rand(m).astype(np.float32)
    kw = {}
    if case == "all_ties":          # round 0: every Eq. 7 score is 0
        scores[:] = 0.0
    elif case == "no_lsh":
        kw = dict(use_lsh=False)
        scores = rs.choice([0.0, 0.5, 1.0], m).astype(np.float32)
    elif case == "no_rank":
        kw = dict(use_rank=False)
    elif case == "duplicate_codes":  # equal distances, equal scores
        cu[5:9], ci[5:9] = cu[4], ci[4]
        scores[4:9] = 0.25
    (ji, jw), (pi, pw) = _select_both(cu, ci, scores, bits=w * 32,
                                      gamma=gamma, n=n, **kw)
    assert pi.dtype == np.int32 and np.array_equal(pi, ji)
    assert np.all(_ulps(pw, jw) <= 1)
    if case == "all_ties":
        want = [[j for j in range(m) if j != i][:n] for i in range(m)]
        assert pi.tolist() == want


def test_selection_matches_pallas_kernel_interpret():
    rs = np.random.RandomState(5)
    cu, ci = _codes(rs, 16, 4)
    scores = rs.choice([0.0, 0.25, 1.0], 16).astype(np.float32)
    ki, kw_ = jax_fused_select(jnp.asarray(cu), jnp.asarray(scores),
                               bits=128, gamma=1.0, num_neighbors=6,
                               interpret=True)
    pi, pw = selection.fused_select(_t(ci), _t(scores), bits=128, gamma=1.0,
                                    num_neighbors=6)
    assert np.array_equal(pi.numpy(), np.asarray(ki))
    assert np.all(_ulps(pw.numpy(), np.asarray(kw_)) <= 1)


def test_selection_clamps_n_and_handles_single_client():
    rs = np.random.RandomState(1)
    _, ci = _codes(rs, 4, 2)
    ids, w = selection.fused_select(_t(ci), torch.zeros(4), bits=64,
                                    gamma=1.0, num_neighbors=12)
    assert ids.shape == (4, 3) and torch.isfinite(w).all()
    ids1, _ = selection.fused_select(_t(ci[:1]), torch.zeros(1), bits=64,
                                     gamma=1.0, num_neighbors=3)
    assert ids1.shape == (1, 0)


# ---------------------------------------------------------------------------
# fused exchange (Pallas row 6)
# ---------------------------------------------------------------------------
def _exchange_inputs(m, n, r, c, seed):
    rs = np.random.RandomState(seed)
    own = (rs.randn(m, r, c) * 3).astype(np.float32)
    nb = (rs.randn(m, n, r, c) * 3).astype(np.float32)
    y = rs.randint(0, c, size=(m, r)).astype(np.int32)
    sel = rs.rand(m, n) < 0.7
    return own, nb, y, sel


@pytest.mark.parametrize("m,n,r,c,lsh_verification,tie", [
    (6, 3, 12, 3, True, False), (7, 5, 8, 10, False, False),
    (16, 8, 16, 7, True, False), (5, 6, 4, 5, True, True)])
def test_exchange_matches_jax_oracle(m, n, r, c, lsh_verification, tie):
    own, nb, y, sel = _exchange_inputs(m, n, r, c, seed=m * n)
    if tie:                    # equal KL: the stable rank keeps slot order
        nb[:, 3] = nb[:, 1]
        sel[:, :] = True
    j = jref.all_in_one_exchange_ref(
        jnp.asarray(own), jnp.asarray(nb), jnp.asarray(y), jnp.asarray(sel),
        lsh_verification=lsh_verification)
    p = exchange.fused_exchange(_t(own), _t(nb), _t(y), _t(sel),
                                lsh_verification=lsh_verification)
    jl, jv, jt, jh = (np.asarray(a) for a in j)
    pl, pv, pt, ph = (a.numpy() for a in p)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pt, jt, rtol=1e-5, atol=1e-6)
    assert pv.dtype == np.bool_ and np.array_equal(pv, jv)
    assert np.array_equal(ph, jh)


# ---------------------------------------------------------------------------
# wrapper dispatch
# ---------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_cpu_without_launching():
    before = [k.launches for k in (lsh_projection.KERNEL, selection.KERNEL,
                                   exchange.KERNEL)]
    x = torch.randn(3, 2048)
    codes = ops.batched_lsh_codes(x, 1, bits=64)
    selection.fused_select(codes, torch.rand(3), bits=64, gamma=1.0,
                           num_neighbors=2)
    own, nb, y, sel = _exchange_inputs(3, 2, 4, 5, seed=0)
    exchange.fused_exchange(_t(own), _t(nb), _t(y), _t(sel))
    assert [k.launches for k in (lsh_projection.KERNEL, selection.KERNEL,
                                 exchange.KERNEL)] == before
