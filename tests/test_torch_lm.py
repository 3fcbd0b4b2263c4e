"""The port's LM serving path held against the JAX package on the CPU.

Inputs are made with numpy from a seed; JAX weights (`init_params`) are
carried across by `models.convert.lm_params_from_jax`, so both packages
compute on the same numbers. On the CPU the flash-attention wrapper
takes its plain version (`kernels/ref.py:flash_attention_ref`), which is
held against the JAX Pallas kernel in interpret mode and its oracle.
Tolerances:

* flash attention: max abs error 2e-5 in f32 and 2e-2 in bf16 on
  unit-normal inputs (`tests/test_kernels.py`'s bound);
* model logits (forward, prefill, decode): rtol 1e-4, atol 1e-4 (f32
  matmuls, softmax and RoPE in another summation order);
* KV cache tensors: within 1e-5;
* generated tokens and configs: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.launch.serve import serve as jax_serve
from repro.models import attention as jattn
from repro.models import transformer as jtf

from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.launch.serve import serve
from repro_torch.models import attention, transformer
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.train import make_serve_step

def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture
def attn_impl(monkeypatch):
    """Set the attention policy of both packages, with 8-wide chunks so
    the chunked paths run at these lengths; restored afterwards."""
    for mod in (jattn, attention):
        monkeypatch.setattr(mod, "_CHUNK_Q", 8)
        monkeypatch.setattr(mod, "_CHUNK_K", 8)
        monkeypatch.setattr(mod, "_ATTN_IMPL", mod.get_attn_impl())

    def set_impl(impl):
        jattn.set_attn_impl(impl)
        attention.set_attn_impl(impl)
    return set_impl


# ---------------------------------------------------------------------------
# the kernel's plain version (Pallas row 9) and the GQA wrapper
# ---------------------------------------------------------------------------
def _qkv(n, sq, sk, dh, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, sq, dh).astype(np.float32),
            rs.randn(n, sk, dh).astype(np.float32),
            rs.randn(n, sk, dh).astype(np.float32))


@pytest.mark.parametrize("n,sq,sk,dh,causal", [
    (2, 256, 256, 128, True), (2, 256, 256, 128, False),
    (1, 512, 512, 64, True), (1, 512, 512, 64, False),
    (2, 256, 512, 128, True), (2, 256, 512, 128, False),
    (1, 1024, 512, 64, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_kernel_and_oracle(n, sq, sk, dh, causal,
                                                      dtype):
    """`ref.flash_attention_ref` (and the wrapper on CPU tensors) against
    the JAX kernel in interpret mode and its oracle; causal with Sq != Sk
    is aligned top-left on every side."""
    q, k, v = _qkv(n, sq, sk, dh, seed=n * sq + sk + dh)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [_t(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    port = ref.flash_attention_ref(*tx, causal=causal)
    assert port.dtype == tx[0].dtype and port.shape == (n, sq, dh)
    assert torch.equal(flash_attention.flash_attention(*tx, causal=causal),
                       port)
    tol = 2e-5 if dtype == "float32" else 2e-2
    p = _np(port.float())
    for want in (jax_flash(*jx, causal=causal, interpret=True),
                 jref.flash_attention_ref(*jx, causal=causal)):
        err = np.abs(p - np.asarray(want.astype(jnp.float32))).max()
        assert err < tol, err


@pytest.mark.parametrize("n,sq,sk,dh", [
    (1, 200, 200, 100), (2, 1, 300, 128), (1, 100, 333, 64),
    (1, 40, 72, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_oracle_at_the_kernel_edges(n, sq, sk, dh,
                                                        causal, dtype):
    """The plain version against the JAX oracle at the CUDA kernel's tile
    and alignment edges: dh = 100 (bf16 rows not 16-byte aligned), one
    query over 300 keys, Sq < Sk with the top-left causal mask, dh =
    256."""
    q, k, v = _qkv(n, sq, sk, dh, seed=n + sq + sk + dh)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [_t(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    port = flash_attention.flash_attention(*tx, causal=causal)
    assert port.dtype == tx[0].dtype and port.shape == (n, sq, dh)
    want = jref.flash_attention_ref(*jx, causal=causal)
    err = np.abs(_np(port.float())
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err < (2e-5 if dtype == "float32" else 2e-2), err


@pytest.mark.parametrize("h,kv,s,causal,use_kernel", [
    (4, 2, 256, True, True), (4, 1, 256, False, True),
    (6, 3, 40, True, False), (4, 4, 40, False, False)])
def test_gqa_wrapper_matches_jax(h, kv, s, causal, use_kernel):
    """`ops.gqa_flash_attention` against the JAX wrapper (through the
    Pallas kernel in interpret mode where the length is a tile multiple,
    else through its oracle); query head i reads KV head i // (H // KV)."""
    rs = np.random.RandomState(h * 10 + kv)
    q = rs.randn(2, s, h, 32).astype(np.float32)
    k = rs.randn(2, s, kv, 32).astype(np.float32)
    v = rs.randn(2, s, kv, 32).astype(np.float32)
    want = jops.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    use_kernel=use_kernel)
    for flag in (True, False):
        got = ops.gqa_flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                      use_kernel=flag)
        assert got.shape == (2, s, h, 32)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_flash_wrapper_on_cpu_launches_nothing_and_rejects_mixed_devices():
    q, k, v = (_t(a) for a in _qkv(1, 8, 8, 16, seed=0))
    before = flash_attention.KERNEL.launches
    flash_attention.flash_attention(q, k, v)
    ops.gqa_flash_attention(q[:, :, None], k[:, :, None], v[:, :, None])
    assert flash_attention.KERNEL.launches == before
    with pytest.raises(ValueError, match="H a multiple of KV"):
        flash_attention.gqa_attention(q.reshape(1, 8, 2, 8),
                                      k.reshape(1, 8, 4, 4),
                                      v.reshape(1, 8, 4, 4))


# ---------------------------------------------------------------------------
# whole model steps on carried-across weights
# ---------------------------------------------------------------------------
def _model(arch, seed=0):
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, lm_params_from_jax(cfg, tree)


def _assert_cache_close(jcache, pcache):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jcache)
    for path, leaf in leaves:
        node = pcache
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(_np(node), np.asarray(leaf), atol=1e-5,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _assert_logits_close(p, j):
    np.testing.assert_allclose(_np(p), np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["auto", "chunked", "naive"])
@pytest.mark.parametrize("arch,window", [
    ("minitron-4b", 0), ("phi3-medium-14b", 0), ("qwen1.5-32b", 0),
    ("phi3-medium-14b", 16)])
def test_model_steps_match_jax(arch, window, impl, attn_impl):
    """forward, prefill (logits and cache) and three decode steps; with
    `window_override` the ring cache wraps (24 prompt tokens, window 16)."""
    attn_impl(impl)
    jcfg, cfg, jparams, params = _model(arch)
    b, s, new = 2, 24, 3
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, s))
    jtok, ptok = jnp.asarray(tokens, jnp.int32), _t(tokens)
    jl, _ = jtf.forward(jcfg, jparams, jtok, window_override=window)
    pl, _ = transformer.forward(cfg, params, ptok, window_override=window)
    _assert_logits_close(pl, jl)

    jl, jcache = jtf.prefill(jcfg, jparams, jtok, window_override=window,
                             cache_len=s + new)
    pl, pcache = transformer.prefill(cfg, params, ptok,
                                     window_override=window,
                                     cache_len=s + new)
    _assert_logits_close(pl, jl)
    _assert_cache_close(jcache, pcache)
    tok = np.asarray(jnp.argmax(jl, -1))
    for i in range(new):
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                     jnp.asarray(tok, jnp.int32), s + i,
                                     window_override=window)
        pl, pcache = transformer.decode_step(cfg, params, pcache, _t(tok),
                                             s + i, window_override=window)
        _assert_logits_close(pl, jl)
        _assert_cache_close(jcache, pcache)
        tok = np.asarray(jnp.argmax(jl, -1))


def test_init_cache_matches_jax_and_decodes_from_empty():
    jcfg, cfg, jparams, params = _model("minitron-4b")
    jcache = jtf.init_cache(jcfg, jparams, 2, 6, window_override=4)
    pcache = transformer.init_cache(cfg, params, 2, 6, window_override=4)
    _assert_cache_close(jcache, pcache)
    tok = np.array([3, 5])
    for pos in range(6):                      # the ring wraps at 4
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                     jnp.asarray(tok, jnp.int32), pos,
                                     window_override=4)
        pl, pcache = transformer.decode_step(cfg, params, pcache, _t(tok),
                                             pos, window_override=4)
        _assert_logits_close(pl, jl)
        _assert_cache_close(jcache, pcache)
        tok = np.asarray(jnp.argmax(jl, -1))


@pytest.mark.parametrize("arch,window", [
    ("minitron-4b", 0), ("phi3-medium-14b", 0), ("phi3-medium-14b", 16),
    ("grok-1-314b", 0), ("kimi-k2-1t-a32b", 0), ("recurrentgemma-2b", 0),
    ("xlstm-350m", 0), ("whisper-small", 0), ("llama-3.2-vision-90b", 0)])
def test_serve_matches_jax(arch, window):
    """The slice as a whole: the port's `serve` on the JAX package's
    weights gives the JAX `serve`'s generated tokens (the audio and vision
    stubs drawn from the same seed on both sides)."""
    kw = dict(batch=2, prompt_len=24, max_new=8, seed=0,
              window_override=window)
    want = jax_serve(arch, **kw)["generated"]
    _, cfg, _, params = _model(arch, seed=0)
    got = serve(arch, device="cpu", params=params, **kw)
    assert got["generated"].shape == (2, 8)
    assert np.array_equal(got["generated"], want)
    assert got["logits"].shape == (8, 2, cfg.vocab_size)
    assert np.array_equal(_np(got["logits"].argmax(-1)).T, want)


def test_serve_with_its_own_weights_is_seeded():
    a = serve("minitron-4b", batch=2, prompt_len=8, max_new=4, device="cpu")
    b = serve("minitron-4b", batch=2, prompt_len=8, max_new=4, device="cpu")
    c = serve("minitron-4b", batch=2, prompt_len=8, max_new=4, device="cpu",
              seed=1)
    assert np.array_equal(a["generated"], b["generated"])
    assert not torch.equal(a["params"]["embed"]["tok"],
                           c["params"]["embed"]["tok"])
    assert a["prefill_s"] > 0 and a["decode_tok_per_s"] > 0


def test_sampling_is_seeded_and_needs_a_generator():
    """temperature > 0 samples through an explicit generator: same seed,
    same tokens (JAX's draws cannot be matched, only their shape)."""
    _, cfg, _, params = _model("phi3-medium-14b")
    _, cache0 = transformer.prefill(cfg, params, torch.arange(8)[None],
                                    cache_len=12)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        step = make_serve_step(cfg, temperature=0.8, generator=gen)
        cache = jax.tree.map(lambda t: t.clone(), cache0)
        tok, logits, _ = step(params, cache, torch.tensor([1]), 8)
        assert tok.shape == (1,) and tok.dtype == torch.int32
        assert 0 <= int(tok) < cfg.vocab_size
        outs.append(int(tok))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="Generator"):
        make_serve_step(cfg, temperature=0.8)


def test_lm_params_from_jax_checks_names_and_shapes():
    jcfg, cfg, jparams, params = _model("qwen1.5-32b")
    tree = jax.tree.map(np.asarray, jparams)
    assert params["layers"][0]["attn"]["bq"].shape == (2, 256)
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["tok"] = bad["embed"]["tok"][:, :8]
    with pytest.raises(ValueError, match="embed.tok"):
        lm_params_from_jax(cfg, bad)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_jax(cfg, tree)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------
def test_configs_equal_field_by_field():
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    for arch in jconfigs.list_archs():
        j, p = jconfigs.get_config(arch), configs.get_config(arch)
        for jc, pc in ((j, p), (j.reduced(), p.reduced())):
            assert dataclasses.asdict(pc) == dataclasses.asdict(jc), arch
            assert (pc.param_count(), pc.active_param_count(),
                    pc.resolved_head_dim, pc.pattern_reps, pc.pattern_tail) \
                == (jc.param_count(), jc.active_param_count(),
                    jc.resolved_head_dim, jc.pattern_reps, jc.pattern_tail)
            assert [pc.layer_type(i) for i in range(pc.num_layers)] == \
                [jc.layer_type(i) for i in range(jc.num_layers)]
        for name, shape in jconfigs.SHAPES.items():
            assert dataclasses.asdict(configs.SHAPES[name]) == \
                dataclasses.asdict(shape)
            assert configs.supports_shape(p, configs.SHAPES[name]) == \
                jconfigs.supports_shape(j, shape)


@pytest.mark.parametrize("arch", ["minitron-4b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_synthetic_data_matches_jax(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    js = jsynthetic.TokenStream(jcfg, 2, 16, seed=3)
    ps = synthetic.TokenStream(cfg, 2, 16, seed=3)
    for _ in range(2):
        jb, pb = js.next_batch(), ps.next_batch()
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert np.array_equal(jb[k], pb[k]), k
    jm = jsynthetic.modality_stub(jcfg, 2, np.random.RandomState(0))
    pm = synthetic.modality_stub(cfg, 2, np.random.RandomState(0))
    assert sorted(jm) == sorted(pm)
    assert all(np.array_equal(jm[k], pm[k]) for k in jm)
