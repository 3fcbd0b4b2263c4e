"""The port's recurrent blocks held against the JAX package's on the CPU:
RG-LRU (`models/rglru.py`, RecurrentGemma's "R") and both xLSTM cells
(`models/xlstm.py`, "S" and "M").

Inputs are made with numpy from a seed; the JAX `init_*` weights are
carried across as numpy. Each case runs the prefill form over a
sequence, then three decode steps from its final state. Tolerances:
outputs and states within rtol 1e-5, atol 1e-5 (f32; the sLSTM's
normaliser n grows to about 10 over 24 steps, where one rounding of its
recurrence's matrix product is 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm

from repro_torch import configs
from repro_torch.models import rglru, xlstm
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    """Trees (tuples, dicts) of port tensors and JAX arrays, leaf by
    leaf; dict leaves in sorted key order on both sides."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.fixture(scope="module")
def cells():
    """kind -> (JAX cfg, port cfg, JAX params, port params), built once."""
    built = {}
    make = {"R": ("recurrentgemma-2b", jrglru.init_rglru),
            "S": ("xlstm-350m", jxlstm.init_slstm),
            "M": ("xlstm-350m", jxlstm.init_mlstm)}

    def get(kind):
        if kind not in built:
            arch, init = make[kind]
            jcfg = jconfigs.get_config(arch).reduced()
            cfg = configs.get_config(arch).reduced()
            jp = init(jcfg, jax.random.PRNGKey(ord(kind)), jnp.float32)
            built[kind] = (jcfg, cfg, jp, {k: _t(v) for k, v in jp.items()})
        return built[kind]
    return get


def _xs(cfg, s, seed, steps=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, s, cfg.d_model).astype(np.float32)
    return x, [rs.randn(2, 1, cfg.d_model).astype(np.float32)
               for _ in range(steps)]


@pytest.mark.parametrize("s", [24, 37])
def test_rglru_forward_and_decode_match_jax(cells, s):
    """The log-depth scan against `lax.associative_scan` at two lengths
    (the last doubling step partial at both); the state's conv window
    holds the raw x @ w_in tail, so decode picks up where it ends."""
    jcfg, cfg, jp, pp = cells("R")
    x, steps = _xs(cfg, s, seed=s)
    want, jstate = jrglru.rglru_forward(jcfg, jp, jnp.asarray(x))
    got, state = rglru.rglru_forward(cfg, pp, _t(x))
    _close(got, want)
    _close(state, jstate)
    for xt in steps:
        want, jstate = jrglru.rglru_decode(jcfg, jp, jnp.asarray(xt), jstate)
        got, state = rglru.rglru_decode(cfg, pp, _t(xt), state)
        _close(got, want)
        _close(state, jstate)


def test_rglru_decode_from_the_empty_state(cells):
    jcfg, cfg, jp, pp = cells("R")
    jstate = jrglru.init_rglru_state(jcfg, 2, jnp.float32)
    state = rglru.init_rglru_state(cfg, 2, torch.float32)
    _close(state, jstate)
    for xt in _xs(cfg, 1, seed=5, steps=4)[1]:
        want, jstate = jrglru.rglru_decode(jcfg, jp, jnp.asarray(xt), jstate)
        got, state = rglru.rglru_decode(cfg, pp, _t(xt), state)
        _close(got, want)
        _close(state, jstate)


def test_slstm_forward_and_decode_match_jax(cells):
    jcfg, cfg, jp, pp = cells("S")
    x, steps = _xs(cfg, 24, seed=1)
    jinit = jxlstm.init_slstm_state(jcfg, 2)
    _close(xlstm.init_slstm_state(cfg, 2), jinit)
    want, jstate = jxlstm.slstm_forward(jcfg, jp, jnp.asarray(x))
    got, state = xlstm.slstm_forward(cfg, pp, _t(x))
    _close(got, want)
    _close(state, jstate)
    for xt in steps:
        want, jstate = jxlstm.slstm_decode(jcfg, jp, jnp.asarray(xt), jstate)
        got, state = xlstm.slstm_decode(cfg, pp, _t(xt), state)
        _close(got, want)
        _close(state, jstate)


@pytest.mark.parametrize("chunk,s", [(8, 24), (8, 20), (256, 24)])
def test_mlstm_forward_and_decode_match_jax(cells, monkeypatch, chunk, s):
    """MLSTM_CHUNK set on both sides: 8 at S = 24 runs three chunks and
    carries the (C, n, m) state between them; S = 20 is no multiple of 8
    and takes the one-chunk fallback, as does the default 256 at S = 24."""
    monkeypatch.setattr(jxlstm, "MLSTM_CHUNK", chunk)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", chunk)
    jcfg, cfg, jp, pp = cells("M")
    x, steps = _xs(cfg, s, seed=s + chunk)
    _close(xlstm.init_mlstm_state(cfg, 2), jxlstm.init_mlstm_state(jcfg, 2))
    want, jstate = jxlstm.mlstm_forward(jcfg, jp, jnp.asarray(x))
    got, state = xlstm.mlstm_forward(cfg, pp, _t(x))
    _close(got, want)
    _close(state, jstate)
    for xt in steps:
        want, jstate = jxlstm.mlstm_decode(jcfg, jp, jnp.asarray(xt), jstate)
        got, state = xlstm.mlstm_decode(cfg, pp, _t(xt), state)
        _close(got, want)
        _close(state, jstate)


def test_mlstm_chunking_only_moves_rounding(cells, monkeypatch):
    """The port's three 8-token chunks against its own one-chunk run: the
    same function, another order of the sums."""
    _, cfg, _, pp = cells("M")
    x = _t(_xs(cfg, 24, seed=9)[0])
    one, s1 = xlstm.mlstm_forward(cfg, pp, x)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 8)
    three, s3 = xlstm.mlstm_forward(cfg, pp, x)
    torch.testing.assert_close(three, one, **TOL)
    for k in s1:
        torch.testing.assert_close(s3[k], s1[k], **TOL)


@pytest.mark.parametrize("kind,shapes", [
    ("R", rglru.rglru_shapes), ("S", xlstm.slstm_shapes),
    ("M", xlstm.mlstm_shapes)])
def test_shapes_match_the_jax_init(cells, kind, shapes):
    _, cfg, jp, _ = cells(kind)
    assert {k: tuple(v.shape) for k, v in jp.items()} == shapes(cfg)
