"""The port's MoE layer (`models/moe.py`) held against the JAX package's
(`repro/models/moe.py`) on the CPU.

Inputs are made with numpy from a seed and the JAX `init_moe` weights are
carried across as numpy, so both packages compute on the same numbers.
Tolerances:

* top-k expert ids, positions in expert and the keep mask: equal;
* the layer's output: rtol 1e-5, atol 1e-5 (f32 GEMMs in another
  summation order);
* `load_balance` and `dropped_frac`: within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.models import moe as jmoe

from repro_torch import configs
from repro_torch.models import moe

# (arch, the reduced config's changes): grok's reduced config (E 4, k 2,
# geglu); kimi-k2's widened to E 16, k 8 (swiglu); grok's at capacity
# factor 0.5, which drops tokens.
CASES = {
    "grok": ("grok-1-314b", {}),
    "kimi16": ("kimi-k2-1t-a32b", {"num_experts": 16,
                                   "experts_per_token": 8}),
    "grok_cap05": ("grok-1-314b", {"moe_capacity_factor": 0.5}),
}


def _cfgs(name):
    arch, changes = CASES[name]
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                **changes),
            dataclasses.replace(configs.get_config(arch).reduced(),
                                **changes))


@pytest.fixture(scope="module")
def layer():
    """name -> (JAX cfg, port cfg, JAX params, port params), built once."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, cfg = _cfgs(name)
            jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(len(name)),
                               jnp.float32)
            pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
            built[name] = (jcfg, cfg, jp, pp)
        return built[name]
    return get


def _x(cfg, b=2, s=24, seed=0, zero_rows=()):
    x = np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)
    for i, j in zero_rows:
        x[i, j] = 0.0
    return x


def _jax_routing(jcfg, jp, x):
    """The JAX layer's top-k ids, positions in expert and keep mask, by
    the JAX package's own functions (G = 1)."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jp["router"].astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, jcfg.experts_per_token)
    pos = jmoe._position_in_expert(topi.reshape(-1))
    cap = jmoe._capacity(jcfg, xt.shape[0])
    return np.asarray(topi), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_moe_matches_jax(layer, name):
    jcfg, cfg, jp, pp = layer(name)
    x = _x(cfg, seed=3)
    want, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = moe.apply_moe(cfg, pp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key in ("load_balance", "dropped_frac"):
        assert abs(float(aux[key]) - float(jaux[key])) <= 1e-6, key
    if name == "grok_cap05":
        assert float(aux["dropped_frac"]) > 0.2     # the case drops tokens
    else:
        assert float(aux["dropped_frac"]) < 0.2

    ids, pos, keep = _jax_routing(jcfg, jp, x)
    _, _, topi = moe.route(cfg, pp, torch.from_numpy(x).reshape(-1, 256))
    assert np.array_equal(topi.numpy(), ids)
    ppos = moe._position_in_expert(topi.reshape(-1))
    assert np.array_equal(ppos.numpy(), pos)
    assert np.array_equal((ppos < moe._capacity(cfg, 48)).numpy(), keep)
    assert moe._capacity(cfg, 48) == jmoe._capacity(jcfg, 48)


@pytest.mark.parametrize("name", ["grok", "kimi16"])
def test_a_zero_row_routes_to_the_lowest_experts(layer, name):
    """A zero input row gives equal router logits, a tie over every
    expert: `lax.top_k` takes experts 0..k-1, and so must the port."""
    jcfg, cfg, jp, pp = layer(name)
    x = _x(cfg, seed=4, zero_rows=((0, 0), (1, 5)))
    ids, pos, keep = _jax_routing(jcfg, jp, x)
    _, topw, topi = moe.route(cfg, pp, torch.from_numpy(x).reshape(-1, 256))
    k = cfg.experts_per_token
    for row in (0, 24 + 5):
        assert topi[row].tolist() == list(range(k)) == ids[row].tolist()
        assert torch.allclose(topw[row], torch.full((k,), 1.0 / k))
    assert np.array_equal(topi.numpy(), ids)
    want, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = moe.moe_forward(cfg, pp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux["load_balance"]) - float(jaux["load_balance"])) \
        <= 1e-6


@pytest.mark.parametrize("n,e,seed", [(1, 4, 0), (7, 3, 1), (96, 4, 2),
                                      (384, 16, 3), (256, 1, 4)])
def test_position_in_expert_matches_jax(n, e, seed):
    """Ranks within each expert, ties kept in slot order, on id lists
    with many repeats."""
    ids = np.random.RandomState(seed).randint(0, e, n)
    want = jmoe._position_in_expert(jnp.asarray(ids, jnp.int32))
    got = moe._position_in_expert(torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tokens", [1, 4, 48, 8192])
@pytest.mark.parametrize("name", sorted(CASES))
def test_capacity_matches_jax(name, tokens):
    jcfg, cfg = _cfgs(name)
    assert moe._capacity(cfg, tokens) == jmoe._capacity(jcfg, tokens)


def test_moe_shapes_match_the_jax_init(layer):
    for name in CASES:
        _, cfg, jp, _ = layer(name)
        assert {k: tuple(v.shape) for k, v in jp.items()} == \
            moe.moe_shapes(cfg)
