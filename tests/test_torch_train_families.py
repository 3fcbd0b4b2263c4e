"""The port's LM training of the other families held against the JAX
package on the CPU: MoE (grok-1 top 2, kimi-k2 top 2 and top 8 of 16),
the RG-LRU hybrid (recurrentgemma, its local attention's window also cut
to 8 tokens), xLSTM, the Whisper encoder-decoder
and Llama-3.2-Vision's cross-attention, all at their reduced configs.

Weights are carried across by `models.convert.lm_params_from_jax`;
batches (tokens, and audio frames or vision patches) come from the JAX
package's `TokenStream`. Tolerances, as `tests/test_torch_train.py`
states them:

* `lm_loss`'s loss, ce and MoE aux: rtol 1e-5; aux nonzero for the MoE
  families and exactly 0 for the others;
* grads: rtol 1e-4, atol 1e-4 x the leaf's largest |g|, with one stated
  exception: parameters whose true gradient is 0, where both packages
  return rounding that the leaf's largest |g| cannot scale. A key bias
  `bk` adds the same q . bk to every score of a softmax row; the sLSTM's
  input-gate bias (row 0 of `rec/b`) scales its unnormalised c and n
  alike, and h = o c / n. For the elements in `ZERO_GRAD` the test
  asserts that JAX's value is below 1e-6 x the tree's largest |g|, and
  holds the port to atol 1e-6 x that largest;
* remat "block" equal to "none" bit for bit;
* three `make_train_step` steps (AdamW under warm-up cosine, weight
  decay 0.1, clip 1.0): loss, ce, moe_aux and grad_norm within rtol
  1e-5; params within rtol 1e-5, atol 1e-6 under the small-gradient
  exception of `tests/test_torch_train.py` (elements whose JAX gradient
  is nonzero and below 1e-3 of its leaf's largest are held to 2 x the
  sum of the learning rates so far), which covers the `ZERO_GRAD`
  elements whole: Adam turns their rounding (JAX's often exactly 0, the
  port's not, or the other way) into steps of up to lr.
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
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import steps as jsteps

from repro_torch import configs
from repro_torch.models import attention, transformer
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.optim import optimizers, schedules
from repro_torch.train import lm_loss, loss_and_grads, make_train_step
from repro_torch.tree import tree_leaves, tree_paths

LR = 1e-3
SMALL_G = 1e-3
MOE = ("grok-1-314b", "kimi-k2-1t-a32b", "kimi-k2-top8")
FAMILIES = MOE + ("recurrentgemma-2b", "recurrentgemma-window8",
                  "xlstm-350m", "whisper-small", "llama-3.2-vision-90b")
# kimi-k2's reduced config keeps 2 of 4 experts; this case routes each
# token to 8 of 16, as the published config does to 8 of 384. The
# reduced recurrentgemma's "L" window (64) spans the 16 tokens; at 8 the
# window's mask cuts each row
VARIANTS = {"kimi-k2-top8": ("kimi-k2-1t-a32b",
                             dict(num_experts=16, experts_per_token=8)),
            "recurrentgemma-window8": ("recurrentgemma-2b", dict(window=8))}
# elements whose true gradient is 0 (the module docstring), by leaf:
# the key biases whole, and the sLSTM's input-gate row of its gate
# biases (reps, gate i f z o, D)
ZERO_GRAD = {"whisper-small": {"d:encoder/d:layers/s:0/d:attn/d:bk": ...,
                               "d:layers/s:0/d:attn/d:bk": ...,
                               "d:layers/s:0/d:xattn/d:bk": ...},
             "xlstm-350m": {"d:layers/s:0/d:rec/d:b": np.s_[:, 0]}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _cfgs(name):
    arch, changes = VARIANTS.get(name, (name, {}))
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                **changes),
            dataclasses.replace(configs.get_config(arch).reduced(),
                                **changes))


@pytest.fixture(scope="module")
def family():
    """name -> configs, JAX weights, a jitted JAX (loss, grads) and three
    batches of 4 x 16 tokens from the JAX stream, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, cfg = _cfgs(name)
            jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
            stream = jsynthetic.TokenStream(jcfg, 4, 16, seed=1)
            built[name] = dict(
                jcfg=jcfg, cfg=cfg, jparams=jparams,
                tree=jax.tree.map(np.asarray, jparams),
                batches=[stream.next_batch() for _ in range(3)],
                jgrad=jax.jit(jax.value_and_grad(
                    lambda p, b, jcfg=jcfg: jsteps.lm_loss(jcfg, p, b,
                                                           remat="none"),
                    has_aux=True)))
        return built[name]
    return get


def _jax_grads(mod, jparams, batch, grad_accum):
    """JAX's gradients as its step takes them: the f32 mean over
    `grad_accum` microbatches of consecutive rows (`steps.py`'s scan)."""
    if grad_accum == 1:
        return mod["jgrad"](jparams, _jb(batch))[1]
    n = batch["tokens"].shape[0] // grad_accum
    acc = None
    for i in range(grad_accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        g = mod["jgrad"](jparams, _jb(mb))[1]
        g = jax.tree.map(lambda a: a.astype(jnp.float32) / grad_accum, g)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return acc


def _zero_mask(name, path, shape):
    """The `ZERO_GRAD` elements of the leaf at `path`."""
    mask = np.zeros(shape, bool)
    index = ZERO_GRAD.get(name, {}).get("/".join(path))
    if index is not None:
        mask[index] = True
    return mask


def _assert_grads_close(name, pgrads, jgrads):
    jl = [np.asarray(b) for b in jax.tree.leaves(jgrads)]
    top = max(np.abs(b).max() for b in jl)
    seen = []
    for (path, a), b in zip(tree_paths(pgrads), jl):
        key, a = "/".join(path), _np(a)
        zero = _zero_mask(name, path, b.shape)
        if zero.any():
            assert np.abs(b[zero]).max() < 1e-6 * top, (key, top)
            np.testing.assert_allclose(a[zero], b[zero], rtol=0,
                                       atol=1e-6 * top, err_msg=key)
            seen.append(key)
        np.testing.assert_allclose(a[~zero], b[~zero], rtol=1e-4,
                                   atol=1e-4 * np.abs(b[~zero]).max(initial=0),
                                   err_msg=key)
    assert sorted(seen) == sorted(ZERO_GRAD.get(name, {}))


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_loss_and_grads_match_jax(family, name):
    """Loss, ce and aux of the training route; every leaf's gradient
    (the `ZERO_GRAD` leaves as stated); remat "block" gives "none"'s
    bits."""
    mod = family(name)
    params = lm_params_from_jax(mod["cfg"], mod["tree"])
    batch = mod["batches"][0]
    (jl, (jce, jaux)), jg = mod["jgrad"](mod["jparams"], _jb(batch))
    loss, (ce, aux) = lm_loss(mod["cfg"], params, _pb(batch), remat="none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    if name in MOE:
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(aux) == float(jaux) == 0.0
    (l0, c0, a0), g0 = loss_and_grads(mod["cfg"], params, _pb(batch),
                                      remat="none")
    (l1, c1, a1), g1 = loss_and_grads(mod["cfg"], params, _pb(batch),
                                      remat="block")
    _assert_grads_close(name, g0, jg)
    assert torch.equal(l0, loss) and torch.equal(a0, aux)
    assert torch.equal(l0, l1) and torch.equal(c0, c1) and \
        torch.equal(a0, a1)
    for (path, a), b in zip(tree_paths(g0), tree_leaves(g1)):
        assert torch.equal(a, b), "/".join(path)


@pytest.mark.parametrize("name,remat,grad_accum", [
    ("grok-1-314b", "none", 1), ("kimi-k2-1t-a32b", "block", 2),
    ("kimi-k2-top8", "none", 2), ("recurrentgemma-2b", "block", 1),
    ("xlstm-350m", "none", 2), ("whisper-small", "block", 2),
    ("llama-3.2-vision-90b", "none", 1)])
def test_train_steps_match_jax(family, name, remat, grad_accum):
    """Three steps of AdamW (warm-up then cosine, weight decay 0.1, clip
    1.0) on three batches: the step's grads against JAX's (accumulated
    the same way), its metrics, and the params after each step."""
    mod = family(name)
    jsch = jsched.linear_warmup_cosine(LR, 2, 10)
    jo = jopt.adamw(jsch, weight_decay=0.1)
    po = optimizers.adamw(schedules.linear_warmup_cosine(LR, 2, 10),
                          weight_decay=0.1)
    jstep = jax.jit(jsteps.make_train_step(mod["jcfg"], jo, remat=remat,
                                           grad_accum=grad_accum))
    pstep = make_train_step(mod["cfg"], po, remat=remat,
                            grad_accum=grad_accum)
    jp = mod["jparams"]
    js = jo.init(jp)
    pp = lm_params_from_jax(mod["cfg"], mod["tree"])
    ps = po.init(pp)
    small, lr_sum, exceptions = None, 0.0, 0
    for i, batch in enumerate(mod["batches"]):
        jg = _jax_grads(mod, jp, batch, grad_accum)
        _, pg = loss_and_grads(mod["cfg"], pp, _pb(batch), remat=remat,
                               grad_accum=grad_accum)
        _assert_grads_close(name, pg, jg)
        now = []
        for (path, _), g in zip(tree_paths(pg), jax.tree.leaves(jg)):
            a = np.abs(np.asarray(g))
            now.append(_zero_mask(name, path, a.shape)
                       | ((a > 0) & (a < SMALL_G * a.max())))
        small = now if small is None else [a | b for a, b in zip(small, now)]
        lr_sum += float(jsch(jnp.int32(i + 1)))

        jp, js, jm = jstep(jp, js, _jb(batch))
        pp, ps, pm = pstep(pp, ps, _pb(batch))
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert (float(pm["moe_aux"]) > 0) == (name in MOE)
        for (path, a), b, exc in zip(tree_paths(pp), jax.tree.leaves(jp),
                                     small):
            a, b = _np(a), np.asarray(b)
            err = np.abs(a - b)
            ok = err <= 1e-6 + 1e-5 * np.abs(b)
            assert ok[~exc].all(), ("/".join(path), i, err[~exc].max())
            assert (err[exc] <= 2 * lr_sum).all(), ("/".join(path), i)
            exceptions += int((exc & ~ok).sum())
    assert int(ps["step"]) == 3
    print(f"{name} remat={remat} grad_accum={grad_accum}: {exceptions} "
          "element-steps outside 1e-6 under the small-gradient exception")


@pytest.mark.parametrize("name", ["grok-1-314b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_training_route_never_takes_the_flash_kernel(family, monkeypatch,
                                                     name):
    """The flash kernel has no backward: the training route (the
    encoder's bidirectional blocks and the cross-attention included)
    never calls it, while the serving forward does."""
    mod = family(name)
    params = lm_params_from_jax(mod["cfg"], mod["tree"])
    batch = _pb(mod["batches"][0])
    calls = []
    monkeypatch.setattr(attention, "_flash_attn",
                        lambda *a: calls.append(a) or 1 / 0)
    for remat in ("none", "block"):
        loss_and_grads(mod["cfg"], params, batch, remat=remat)
    assert calls == []
    extra = {k: batch[k] for k in ("audio", "vision") if k in batch}
    with pytest.raises(ZeroDivisionError):
        transformer.forward(mod["cfg"], params, batch["tokens"],
                            extra or None)
