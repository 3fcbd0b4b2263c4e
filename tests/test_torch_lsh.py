"""The port's per-client LSH code and the unfused Eq. 6-8 selection held
against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX package's
`use_kernel=False` paths (its `kernels/ref.py` oracles; the Pallas
kernels in interpret mode at one small shape each) and through the
port, whose kernel wrappers take their plain versions for CPU tensors.
Tolerances:

* bit-exact: the single-client flatten order, Hamming distances, the
  normalized distance, selection ids, and the unfused composition
  against the port's fused selection (both gather exp of the same f32
  inputs from torch);
* LSH sums: |port - jax| <= 1e-5 * (|jax| + ||x||_2); codes equal
  except on bits whose JAX sum is within 1e-3 of zero;
* unfused Eq. 8 weights against JAX's: within 2 ulp (torch's and XLA's
  f32 exp differ in the last bit on a few inputs, and the product with
  the score rounds once more).

The CUDA kernels themselves are held against their plain versions on
the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.configs.paper_models import ClientModelConfig as JaxModelConfig
from repro.core import lsh as jlsh
from repro.core import neighbor as jneighbor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lsh_projection import lsh_project_sums as jax_lsh_single
from repro.models import init_client_model as jax_init

from repro_torch.configs.paper_models import ClientModelConfig
from repro_torch.core import lsh, neighbor
from repro_torch.kernels import hamming, lsh_projection, ops, ref, selection
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
    return torch.from_numpy(np.array(a))


def _codes(m, w, seed):
    u = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    return u, u.view(np.int32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ai, bi = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    return np.where(a == b, 0, np.abs(ai - bi))


def _assert_codes_equal_off_zero(port_codes, jax_codes, jax_sums, bits):
    pb = ops.unpack_bits(port_codes, bits).numpy()
    jb = np.asarray(jops.unpack_bits(jnp.asarray(jax_codes), bits))
    near = np.abs(np.asarray(jax_sums)) <= 1e-3
    assert np.array_equal(pb[~near], jb[~near])


def _client_tree(kind, seed):
    """One client's random weights: (JAX pytree, the port's dict)."""
    spec = SMALL_MODELS[kind]
    shapes = jax.eval_shape(lambda k: jax_init(JaxModelConfig(**spec), k),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda s: (rs.randn(1, *s.shape) * 0.1).astype(np.float32), shapes)
    stacked = params_from_jax(ClientModelConfig(**spec), tree)
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), tree),
            {k: v[0] for k, v in stacked.items()})


# ---------------------------------------------------------------------------
# the single-client code (Pallas row 2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(SMALL_MODELS))
def test_flatten_params_equals_jax(kind):
    jtree, ptree = _client_tree(kind, seed=1)
    j = np.asarray(jops.flatten_params(jtree))
    p = ops.flatten_params(ptree).numpy()
    assert p.shape == j.shape and p.shape[0] % ops.CHUNK == 0
    assert np.array_equal(p, j)


@pytest.mark.parametrize("kind", sorted(SMALL_MODELS))
@pytest.mark.parametrize("seed", [0, 3])
def test_client_lsh_code_matches_jax(kind, seed):
    jtree, ptree = _client_tree(kind, seed=seed + 5)
    bits = 256
    j = np.asarray(jlsh.client_lsh_code(jtree, seed, bits=bits,
                                        use_kernel=False))
    sums = jref.lsh_project_sums_ref(jops.flatten_params(jtree), seed,
                                     bits=bits)
    for use_kernel in (True, False):
        p = lsh.client_lsh_code(ptree, seed, bits=bits,
                                use_kernel=use_kernel)
        assert p.dtype == torch.int32 and p.shape == (bits // 32,)
        _assert_codes_equal_off_zero(p, j, sums, bits)


@pytest.mark.parametrize("p,bits,seed", [(4096, 256, 7), (8192, 256, 7),
                                         (2048, 128, 2 ** 31 + 9)])
def test_lsh_project_sums_plain_matches_jax(p, bits, seed):
    x = (np.random.RandomState(p).randn(p) * 0.05).astype(np.float32)
    j = np.asarray(jref.lsh_project_sums_ref(jnp.asarray(x), seed,
                                             bits=bits))
    s = ref.lsh_project_sums_ref(_t(x), seed, bits=bits).numpy()
    assert np.all(np.abs(s - j) <= 1e-5 * (np.abs(j) + np.linalg.norm(x)))
    # the single-client sums are the batched plain version's row
    b = ref.lsh_project_sums_batched_ref(_t(x)[None], seed, bits=bits)
    assert torch.equal(_t(s), b[0])


def test_lsh_project_sums_matches_pallas_kernel_interpret():
    x = np.random.RandomState(2).randn(4096).astype(np.float32)
    k = np.asarray(jax_lsh_single(jnp.asarray(x), 7, bits=256,
                                  interpret=True))
    p = lsh_projection.lsh_project_sums(_t(x), 7, bits=256).numpy()
    assert np.all(np.abs(p - k) <= 1e-5 * (np.abs(k) + np.linalg.norm(x)))


def test_client_code_is_the_stacked_row():
    """Client i's own code equals row i of the batched codes the round
    publishes (same flatten order, same projection)."""
    trees = [_client_tree("cnn", seed=s)[1] for s in range(4)]
    stacked = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    rows = lsh.stacked_lsh_codes(stacked, seed=2, bits=128)
    for i, tree in enumerate(trees):
        assert torch.equal(lsh.client_lsh_code(tree, 2, bits=128), rows[i])
    assert torch.equal(lsh.stacked_lsh_codes(stacked, seed=2, bits=128,
                                             backend="ann"), rows)


# ---------------------------------------------------------------------------
# all-pairs Hamming and the unfused Eq. 6-8 (Pallas row 8)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,w", [(1, 8), (13, 8), (40, 3), (70, 33)])
def test_distance_matrix_matches_jax(m, w):
    cu, ci = _codes(m, w, seed=m + w)
    j = np.asarray(jlsh.distance_matrix(jnp.asarray(cu), use_kernel=False))
    for use_kernel in (True, False):
        p = lsh.distance_matrix(_t(ci), use_kernel=use_kernel)
        assert p.dtype == torch.int32 and np.array_equal(p.numpy(), j)
    d = lsh.normalized_distance(_t(j), w * 32)
    assert np.array_equal(d.numpy(), np.asarray(
        jlsh.normalized_distance(jnp.asarray(j), w * 32)))


def test_distance_matrix_matches_pallas_kernel_interpret():
    cu, ci = _codes(40, 4, seed=3)
    j = np.asarray(jlsh.distance_matrix(jnp.asarray(cu), use_kernel=True))
    assert np.array_equal(lsh.distance_matrix(_t(ci)).numpy(), j)


def test_hamming_rectangular_and_cpu_wrapper_does_not_launch():
    _, a = _codes(9, 5, seed=1)
    _, b = _codes(4, 5, seed=2)
    before = hamming.KERNEL.launches
    d = hamming.hamming_all_pairs(_t(a), _t(b))
    assert d.shape == (9, 4) and hamming.KERNEL.launches == before
    assert torch.equal(d, ref.hamming_all_pairs_ref(_t(a), _t(b)))


@pytest.mark.parametrize("flags", [{}, dict(use_lsh=False),
                                   dict(use_rank=False)])
@pytest.mark.parametrize("ties", [False, True])
def test_unfused_selection_matches_jax(flags, ties):
    m, w, n, gamma = 17, 8, 6, 1.5
    cu, ci = _codes(m, w, seed=4)
    rs = np.random.RandomState(5)
    scores = (np.zeros(m, np.float32) if ties else
              rs.choice([0.0, 0.25, 0.5, 1.0], m).astype(np.float32))
    jd = jlsh.normalized_distance(
        jlsh.distance_matrix(jnp.asarray(cu), use_kernel=False), w * 32)
    jw = jneighbor.selection_weights(jnp.asarray(scores), jd, gamma, **flags)
    ji, jm = jneighbor.select_neighbors(jw, n)
    pd = lsh.normalized_distance(lsh.distance_matrix(_t(ci)), w * 32)
    pw = neighbor.selection_weights(_t(scores), pd, gamma, **flags)
    pi, pm = neighbor.select_neighbors(pw, n)
    assert np.all(_ulps(pw.numpy(), np.asarray(jw)) <= 2)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    # the fused selection equals the unfused composition bit for bit
    fi, fw = selection.fused_select(_t(ci), _t(scores), bits=w * 32,
                                    gamma=gamma, num_neighbors=n, **flags)
    assert torch.equal(fi, pi)
    assert torch.equal(fw, torch.gather(pw, 1, pi.to(torch.int64)))


def test_random_selection_weights_draw_from_the_generator():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    d = torch.zeros((5, 5))
    a = neighbor.selection_weights(torch.zeros(5), d, 1.0, use_lsh=False,
                                   use_rank=False, generator=g1)
    b = neighbor.selection_weights(torch.zeros(5), d, 1.0, use_lsh=False,
                                   use_rank=False, generator=g2)
    assert torch.equal(a, b) and bool(torch.isinf(a.diagonal()).all())
    with pytest.raises(ValueError, match="Generator"):
        neighbor.selection_weights(torch.zeros(5), d, 1.0, use_lsh=False,
                                   use_rank=False)
