"""The port's other LM families held against the JAX package on the CPU,
whole models at their reduced configs: MoE (grok-1, kimi-k2), the RG-LRU
hybrid (recurrentgemma), xLSTM, the Whisper encoder-decoder and
Llama-3.2-Vision's cross-attention.

Inputs (tokens, audio frames, vision patches) are made with numpy from a
seed; JAX weights (`init_params`) are carried across by
`models.convert.lm_params_from_jax`. Tolerances:

* logits (forward, prefill, decode) and forward's aux loss: rtol 1e-4,
  atol 1e-4 (f32 matmuls, softmax and RoPE in another summation order);
* every cache leaf (K/V, cross K/V, recurrent states): rtol 1e-5, atol
  1e-5 (the sLSTM normaliser grows to about 10);
* the port's own sequential decode against its full forward: 2e-4, the
  JAX package's bound in `tests/test_decode_consistency.py`;
* init: zeros, ones and the uniform range exactly where JAX has them,
  every other leaf's std within 10 % of JAX's.
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
from repro.models import transformer as jtf

from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.models import transformer
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.tree import tree_map

FAMILIES = ("grok-1-314b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
            "xlstm-350m", "whisper-small", "llama-3.2-vision-90b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def model():
    """arch -> (JAX cfg, port cfg, JAX params, port params), built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get_config(arch).reduced()
            cfg = configs.get_config(arch).reduced()
            jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
            built[arch] = (jcfg, cfg, jp, lm_params_from_jax(
                cfg, jax.tree.map(np.asarray, jp)))
        return built[arch]
    return get


def _inputs(cfg, b, s, seed):
    """Tokens and the modality stub (audio frames or vision patches) as
    (numpy tokens, JAX extra, port extra)."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, (b, s))
    extra = synthetic.modality_stub(cfg, b, rs)
    return (tokens, {k: jnp.asarray(v) for k, v in extra.items()} or None,
            {k: _t(v) for k, v in extra.items()} or None)


def _assert_cache_close(jcache, pcache):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jcache)
    assert len(leaves) == len(jax.tree.leaves(
        tree_map(lambda t: np.zeros(0), pcache)))
    for path, leaf in leaves:
        node = pcache
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(_np(node), np.asarray(leaf), rtol=1e-5,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_logits_close(p, j):
    np.testing.assert_allclose(_np(p), np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_steps_match_jax(model, arch):
    """forward (logits and the MoE aux), prefill (logits and every cache
    leaf) and four decode steps from the prefill's cache."""
    jcfg, cfg, jp, params = model(arch)
    b, s, new = 2, 24, 4
    tokens, jex, pex = _inputs(cfg, b, s, seed=1)
    jtok, ptok = jnp.asarray(tokens, jnp.int32), _t(tokens)
    jl, jaux = jtf.forward(jcfg, jp, jtok, jex)
    pl, paux = transformer.forward(cfg, params, ptok, pex)
    _assert_logits_close(pl, jl)
    _assert_logits_close(paux, jaux)
    if cfg.is_moe:
        assert float(paux) > 0

    jl, jcache = jtf.prefill(jcfg, jp, jtok, jex, cache_len=s + new)
    pl, pcache = transformer.prefill(cfg, params, ptok, pex,
                                     cache_len=s + new)
    _assert_logits_close(pl, jl)
    _assert_cache_close(jcache, pcache)
    tok = np.asarray(jnp.argmax(jl, -1))
    for i in range(new):
        jl, jcache = jtf.decode_step(jcfg, jp, jcache,
                                     jnp.asarray(tok, jnp.int32), s + i)
        pl, pcache = transformer.decode_step(cfg, params, pcache, _t(tok),
                                             s + i)
        _assert_logits_close(pl, jl)
        _assert_cache_close(jcache, pcache)
        tok = np.asarray(jnp.argmax(jl, -1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_jax_and_decodes_from_empty(model, arch):
    """The empty cache (recurrent states at their start, cross K/V
    precomputed from the audio or vision context) and two decode steps
    from position 0."""
    jcfg, cfg, jp, params = model(arch)
    tokens, jex, pex = _inputs(cfg, 2, 2, seed=2)
    jcache = jtf.init_cache(jcfg, jp, 2, 4, extra=jex)
    pcache = transformer.init_cache(cfg, params, 2, 4, extra=pex)
    _assert_cache_close(jcache, pcache)
    for pos in range(2):
        jl, jcache = jtf.decode_step(jcfg, jp, jcache,
                                     jnp.asarray(tokens[:, pos], jnp.int32),
                                     pos)
        pl, pcache = transformer.decode_step(cfg, params, pcache,
                                             _t(tokens[:, pos]), pos)
        _assert_logits_close(pl, jl)
        _assert_cache_close(jcache, pcache)


def _consistency_setup(arch, seed):
    """The port alone, as `tests/test_decode_consistency.py` sets up the
    JAX side: MoE without drops (capacity factor 100), so forward and
    decode route every token."""
    cfg = configs.get_config(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=100.0)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(seed))
    tokens, _, extra = _inputs(cfg, 2, 10, seed)
    return cfg, params, _t(tokens), extra


@pytest.mark.parametrize("arch", FAMILIES)
def test_sequential_decode_matches_forward(arch):
    cfg, params, tokens, extra = _consistency_setup(arch, seed=0)
    full, _ = transformer.forward(cfg, params, tokens, extra)
    cache = transformer.init_cache(cfg, params, 2, 10, extra=extra)
    for pos in range(10):
        lg, cache = transformer.decode_step(cfg, params, cache,
                                            tokens[:, pos], pos)
        err = (lg - full[:, pos]).abs().max().item()
        assert err < 2e-4, f"{arch} pos {pos}: {err}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_hands_off_to_decode(arch):
    cfg, params, tokens, extra = _consistency_setup(arch, seed=1)
    full, _ = transformer.forward(cfg, params, tokens, extra)
    lg, cache = transformer.prefill(cfg, params, tokens[:, :9], extra,
                                    cache_len=10)
    assert (lg - full[:, 8]).abs().max().item() < 2e-4
    lg, _ = transformer.decode_step(cfg, params, cache, tokens[:, 9], 9)
    assert (lg - full[:, 9]).abs().max().item() < 2e-4


@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_init_params_follows_the_jax_rules(arch):
    """Leaf by leaf against the JAX init: the same names and shapes (the
    port's `param_shapes` too), zeros and ones where JAX has them (the
    f32 `b_if` in f32), the uniform `lam` inside [0.9, 0.999] and
    spread over it, every other leaf's std within 10 %."""
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    jleaves, _ = jax.tree_util.tree_flatten_with_path(
        jtf.init_params(jcfg, jax.random.PRNGKey(3)))
    port = transformer.init_params(cfg, torch.Generator().manual_seed(3))
    shapes = transformer.param_shapes(cfg)
    assert len(jax.tree.leaves(tree_map(lambda t: np.zeros(0), port))) \
        == len(jleaves)
    for path, leaf in jleaves:
        name = jax.tree_util.keystr(path)
        node, shape = port, shapes
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            node, shape = node[k], shape[k]
        want, got = np.asarray(leaf), _np(node)
        assert got.shape == want.shape == tuple(shape), name
        assert got.dtype == want.dtype, name
        if not want.any():
            assert not got.any(), name
        elif (want == 1).all():
            assert (got == 1).all(), name
        elif name.endswith("['lam']"):
            for a in (want, got):
                assert 0.9 <= a.min() < 0.91 and 0.989 < a.max() < 0.999
        else:
            assert abs(got.std() / want.std() - 1) < 0.1, name


def test_lm_params_from_jax_checks_the_new_leaves(model):
    jcfg, cfg, jp, params = model("whisper-small")
    tree = jax.tree.map(np.asarray, jp)
    assert params["encoder"]["layers"][0]["attn"]["wq"].shape == \
        (2, 256, 256)
    assert params["layers"][0]["xattn"]["bq"].shape == (2, 256)
    bad = jax.tree.map(lambda a: a, tree)
    bad["encoder"]["pos"] = bad["encoder"]["pos"][:8]
    with pytest.raises(ValueError, match="encoder.pos"):
        lm_params_from_jax(cfg, bad)
    del tree["layers"][0]["xattn"]
    with pytest.raises(ValueError, match="xattn"):
        lm_params_from_jax(cfg, tree)


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-small"])
def test_serve_cuts_the_depth(arch):
    """`serve(num_layers=)` keeps the widths and cuts the (decoder) depth;
    the encoder keeps its own."""
    from repro_torch.launch.serve import serve
    res = serve(arch, batch=1, prompt_len=6, max_new=2, num_layers=1,
                device="cpu")
    full = configs.get_config(arch).reduced()
    stacked = res["params"]["layers"][0]
    assert next(iter(stacked["ln"].values())).shape[0] == 1
    assert res["generated"].shape == (1, 2)
    if full.is_encdec:
        assert res["params"]["encoder"]["layers"][0]["ln"]["scale"].shape \
            == (full.encoder_layers, full.d_model)


def test_stubs_match_jax():
    for arch in ("whisper-small", "llama-3.2-vision-90b"):
        jm = jsynthetic.modality_stub(jconfigs.get_config(arch).reduced(), 2,
                                      np.random.RandomState(5))
        pm = synthetic.modality_stub(configs.get_config(arch).reduced(), 2,
                                     np.random.RandomState(5))
        assert sorted(jm) == sorted(pm)
        assert all(np.array_equal(jm[k], pm[k]) for k in jm)
