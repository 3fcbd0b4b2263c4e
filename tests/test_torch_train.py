"""The port's LM training held against the JAX package on the CPU:
schedules, SGD, AdamW under a schedule, global-norm clipping, `lm_loss`,
three `make_train_step` steps, the chunked training route, checkpoints
in the JAX store's layout and the launcher's resume.

Inputs are made with numpy from a seed; transformer weights are carried
across by `models.convert.lm_params_from_jax`. Tolerances:

* schedules, SGD and AdamW updates and clipping on the same inputs:
  rtol 1e-6 (cos and pow in two libraries); the in-place `apply` equal
  to `update` + `apply_updates` bit for bit;
* `lm_loss` / the steps' loss, ce and grad_norm: rtol 1e-5;
* grads: rtol 1e-4, atol 1e-4 x the leaf's largest |g| (f32 matmuls and
  softmax reduced in another order);
* params after each step: rtol 1e-5, atol 1e-6 (1e-3 x lr), with one
  documented exception. Adam divides by |g| + eps, so where a gradient
  is small its relative error (up to ~5e-4 at 1e-3 of the leaf's
  largest) moves the update by that fraction of lr, and by up to 2 lr (a
  sign flip) where |g| is near eps. Elements whose JAX gradient in some
  step so far is nonzero and below 1e-3 of its leaf's largest |g| are
  held to 2 x the sum of the learning rates so far instead; they are
  counted and printed. An exactly zero gradient (an embedding row no
  token used) is no exception;
* checkpoints: leaves equal; a resumed run equal to an uninterrupted one
  bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.checkpoint import store as jckpt
from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import steps as jsteps

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models import attention, transformer
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.optim import optimizers, schedules
from repro_torch.train import (init_train_state, lm_loss, loss_and_grads,
                               make_train_step)
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from test_torch_lm import attn_impl  # noqa: F401

LR = 1e-3
SMALL_G = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def models():
    """Per arch: configs, JAX weights, a jitted JAX (loss, grads) and
    three token batches from the synthetic stream."""
    out = {}
    for arch in ("minitron-4b", "phi3-medium-14b"):
        jcfg = jconfigs.get_config(arch).reduced()
        cfg = configs.get_config(arch).reduced()
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        stream = jsynthetic.TokenStream(jcfg, 4, 16, seed=1)
        out[arch] = dict(
            jcfg=jcfg, cfg=cfg, jparams=jparams,
            tree=jax.tree.map(np.asarray, jparams),
            batches=[stream.next_batch() for _ in range(3)],
            jgrad=jax.jit(jax.value_and_grad(
                lambda p, b, jcfg=jcfg: jsteps.lm_loss(jcfg, p, b,
                                                       remat="none"),
                has_aux=True)))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _assert_grads_close(pgrads, jgrads):
    for (path, a), b in zip(tree_paths(pgrads), jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (1e-3, 15)),
    ("cosine_decay", (1e-3, 12, 0.3)),
    ("linear_warmup_cosine", (1e-3, 5, 15)),
    ("linear_warmup_cosine", (2e-3, 0, 8, 0.0))])
def test_schedules_match_jax(name, args):
    jfn, pfn = getattr(jsched, name)(*args), getattr(schedules, name)(*args)
    for s in range(21):
        got = pfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jfn(jnp.int32(s))),
                                   rtol=1e-6)


def _tree(rs, scale=1.0):
    """A nested dict / tuple tree of numpy arrays (the LM params' form)."""
    return {"b": {"w": rs.randn(3, 4).astype(np.float32) * scale,
                  "a": rs.randn(5).astype(np.float32) * scale},
            "layers": (rs.randn(2, 3).astype(np.float32) * scale,
                       {"k": rs.randn(4, 2, 2).astype(np.float32) * scale})}


def _run_both(jo, po, steps=3, seed=0):
    """`steps` updates of the JAX optimizer and the port's (`update` +
    `apply_updates`, and `apply` in place) on the same grads."""
    rs = np.random.RandomState(seed)
    params = _tree(rs)
    jp = jax.tree.map(jnp.asarray, params)
    pp = tree_map(_t, params)
    ip = tree_map(torch.clone, pp)
    js, ps, ist = jo.init(jp), po.init(pp), po.init(ip)
    for i in range(steps):
        grads = _tree(rs, 10.0 ** -i)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = jopt.apply_updates(jp, ju)
        pu, ps = po.update(tree_map(_t, grads), ps, pp)
        pp = optimizers.apply_updates(pp, pu)
        ist = po.apply(tree_map(_t, grads), ist, ip)
        for (path, u), j in zip(tree_paths(pu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(_np(u), np.asarray(j), rtol=1e-6,
                                       atol=1e-12, err_msg="/".join(path))
        for a, b in zip(tree_leaves(ip), tree_leaves(pp)):
            assert torch.equal(a, b)
    assert int(ps["step"]) == int(ist["step"]) == int(js["step"]) == steps


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("sched", [False, True])
def test_sgd_matches_jax(momentum, sched):
    lr = (0.1, 0.1)
    if sched:
        lr = (jsched.linear_warmup_cosine(0.1, 1, 3),
              schedules.linear_warmup_cosine(0.1, 1, 3))
    _run_both(jopt.sgd(lr[0], momentum), optimizers.sgd(lr[1], momentum))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_with_a_schedule_matches_jax(monkeypatch, weight_decay):
    """Under a schedule; the in-place `apply` in pieces of 4 elements
    along the leading axis gives `update`'s bits."""
    monkeypatch.setattr(optimizers, "_PIECE", 4)
    _run_both(jopt.adamw(jsched.cosine_decay(1e-2, 4),
                         weight_decay=weight_decay),
              optimizers.adamw(schedules.cosine_decay(1e-2, 4),
                               weight_decay=weight_decay))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.RandomState(3))
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    pg, pn = optimizers.clip_by_global_norm(tree_map(_t, grads), max_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(pg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    inplace = tree_map(_t, grads)
    assert torch.equal(optimizers.clip_by_global_norm_(inplace, max_norm), pn)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(inplace),
                                                 tree_leaves(pg)))


def test_float_lr_adam_is_unchanged():
    """The federation's `adam(lr)`: the update written out as the port
    computed it before schedules, bit for bit."""
    rs = np.random.RandomState(5)
    p = {k: _t(rs.randn(6, 7).astype(np.float32)) for k in "ab"}
    opt = optimizers.adam(1e-3)
    s = opt.init(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    for step in range(1, 4):
        g = {k: _t(rs.randn(6, 7).astype(np.float32)) for k in "ab"}
        u, s = opt.update(g, s, p)
        f = torch.tensor(step, dtype=torch.float32)
        c1 = 1 - torch.pow(torch.tensor(0.9, dtype=torch.float32), f)
        c2 = 1 - torch.pow(torch.tensor(0.999, dtype=torch.float32), f)
        for k in p:
            m[k] = 0.9 * m[k] + (1 - 0.9) * g[k]
            v[k] = 0.999 * v[k] + (1 - 0.999) * torch.square(g[k])
            want = -(1e-3 * (m[k] / c1) / (torch.sqrt(v[k] / c2) + 1e-8))
            assert torch.equal(u[k], want) and torch.equal(s["m"][k], m[k])


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["minitron-4b", "phi3-medium-14b"])
def test_lm_loss_and_grads_match_jax(models, arch):
    """The training route's loss and gradients; remat "block" gives
    "none"'s bits, and the route never takes the flash kernel."""
    mod = models[arch]
    params = lm_params_from_jax(mod["cfg"], mod["tree"])
    batch = mod["batches"][0]
    (jl, (jce, jaux)), jg = mod["jgrad"](mod["jparams"], _jb(batch))
    loss, (ce, aux) = lm_loss(mod["cfg"], params, _pb(batch), remat="none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    assert float(aux) == float(jaux) == 0.0
    (l0, _, _), g0 = loss_and_grads(mod["cfg"], params, _pb(batch),
                                    remat="none")
    (l1, _, _), g1 = loss_and_grads(mod["cfg"], params, _pb(batch),
                                    remat="block")
    _assert_grads_close(g0, jg)
    assert torch.equal(l0, l1) and torch.equal(l0, loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_training_route_never_takes_the_flash_kernel(models, monkeypatch):
    mod = models["minitron-4b"]
    params = lm_params_from_jax(mod["cfg"], mod["tree"])
    calls = []
    monkeypatch.setattr(attention, "_flash_attn",
                        lambda *a: calls.append(a) or 1 / 0)
    loss_and_grads(mod["cfg"], params, _pb(mod["batches"][0]))
    assert calls == []
    with pytest.raises(ZeroDivisionError):
        transformer.forward(mod["cfg"], params,
                            _t(mod["batches"][0]["tokens"]))


@pytest.mark.parametrize("arch,remat,grad_accum", [
    ("minitron-4b", "none", 1), ("minitron-4b", "block", 2),
    ("phi3-medium-14b", "block", 1), ("phi3-medium-14b", "none", 2)])
def test_train_steps_match_jax(models, arch, remat, grad_accum):
    """Three steps of AdamW (warm-up then cosine, weight decay 0.1, clip
    1.0) on three batches: metrics, the step's grads against JAX's, and
    the params after each step (with the documented exception)."""
    mod = models[arch]
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
        _, jg = mod["jgrad"](jp, _jb(batch))
        _, pg = loss_and_grads(mod["cfg"], pp, _pb(batch), remat=remat,
                               grad_accum=grad_accum)
        _assert_grads_close(pg, jg)
        mags = [np.abs(np.asarray(g)) for g in jax.tree.leaves(jg)]
        now = [(a > 0) & (a < SMALL_G * a.max()) for a in mags]
        small = now if small is None else [a | b for a, b in zip(small, now)]
        lr_sum += float(jsch(jnp.int32(i + 1)))

        jp, js, jm = jstep(jp, js, _jb(batch))
        pp, ps, pm = pstep(pp, ps, _pb(batch))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(pm["moe_aux"]) == 0.0
        for (path, a), b, exc in zip(tree_paths(pp), jax.tree.leaves(jp),
                                     small):
            a, b = _np(a), np.asarray(b)
            err = np.abs(a - b)
            ok = err <= 1e-6 + 1e-5 * np.abs(b)
            assert ok[~exc].all(), ("/".join(path), i, err[~exc].max())
            assert (err[exc] <= 2 * lr_sum).all(), ("/".join(path), i)
            exceptions += int((exc & ~ok).sum())
    assert int(ps["step"]) == 3
    print(f"{arch} remat={remat} grad_accum={grad_accum}: {exceptions} "
          "element-steps outside 1e-6 under the small-gradient exception")


def test_chunked_training_route_matches_jax(models, attn_impl):  # noqa: F811
    """"chunked" at 8-wide chunks (2 x 2 over 16 tokens), "causal"
    included, on both sides."""
    attn_impl("chunked")
    mod = models["phi3-medium-14b"]
    jcfg, batch = mod["jcfg"], mod["batches"][1]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jsteps.lm_loss(jcfg, p, _jb(batch), remat="none"),
        has_aux=True))(mod["jparams"])
    params = lm_params_from_jax(mod["cfg"], mod["tree"])
    (loss, _, _), grads = loss_and_grads(mod["cfg"], params, _pb(batch),
                                         remat="block")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(grads, jg)


def test_init_train_state_is_seeded():
    cfg = configs.get_config("minitron-4b").reduced()
    opt = optimizers.adamw(1e-3)
    a, sa = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    b, _ = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert int(sa["step"]) == 0 and sa["step"].dtype == torch.int32
    assert all(not bool(m.any()) and m.dtype == torch.float32
               for m in tree_leaves(sa["m"]))


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------
def _jax_state(mod, seed=0):
    """JAX params and an AdamW state with nonzero moments."""
    rs = np.random.RandomState(seed)
    jp = mod["jparams"]
    js = {"step": jnp.int32(7),
          "m": jax.tree.map(lambda a: jnp.asarray(
              rs.randn(*a.shape).astype(np.float32)), jp),
          "v": jax.tree.map(lambda a: jnp.asarray(
              rs.rand(*a.shape).astype(np.float32)), jp)}
    return jp, js


def test_checkpoints_cross_between_the_packages(models, tmp_path):
    """A JAX-written `.npz` restores into the port with the same leaves,
    and a port-written one into the JAX store."""
    mod = models["minitron-4b"]
    jstate = _jax_state(mod)
    jckpt.save(str(tmp_path / "j"), 7, jstate)
    like = init_train_state(mod["cfg"], optimizers.adamw(1e-3),
                            torch.Generator().manual_seed(9))
    got = ckpt.restore(str(tmp_path / "j"), 7, like)
    assert got is like
    want = jax.tree.leaves(jstate)
    assert len(tree_leaves(got)) == len(want)
    for (path, a), b in zip(tree_paths(got), want):
        assert a.dtype == (torch.int32 if path[-1] == "d:step"
                           else torch.float32)
        assert np.array_equal(_np(a), np.asarray(b)), "/".join(path)

    ckpt.save(str(tmp_path / "p"), 3, got)
    back = jckpt.restore(str(tmp_path / "p"), 3, jstate)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(back), want))


def test_checkpoint_store_keeps_the_jax_layout(tmp_path):
    """Keys, bf16 stored as f32, pruning, and the errors."""
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "t": (torch.ones(2), None, {"s": torch.tensor(3)})}
    jtree = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
             "t": (jnp.ones(2), None, {"s": jnp.asarray(3)})}
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    for step in (1, 2, 3, 4):
        ckpt.save(pdir, step, tree, keep_last_k=2)
        jckpt.save(jdir, step, jtree, keep_last_k=2)
    assert ckpt.steps(pdir) == jckpt.steps(jdir) == [3, 4]
    assert ckpt.latest_step(pdir) == 4 and ckpt.latest_step(
        str(tmp_path / "none")) is None
    with np.load(os.path.join(pdir, "step_00000004.npz")) as p, \
            np.load(os.path.join(jdir, "step_00000004.npz")) as j:
        assert sorted(p.files) == sorted(j.files) == [
            "d:t/s:0", "d:t/s:2/d:s", "d:w"]
        assert p["d:w"].dtype == j["d:w"].dtype == np.float32
    like = tree_map(torch.zeros_like, tree)
    got = ckpt.restore(pdir, 4, like)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                             tree["w"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(pdir, 4, {"w": torch.zeros(3, 2), "t": like["t"]})
    with pytest.raises(KeyError, match="d:x"):
        ckpt.restore(pdir, 4, {"x": torch.zeros(1)})
    with pytest.raises(ValueError, match="keep_last_k"):
        ckpt.save(pdir, 5, tree, keep_last_k=0)


@pytest.mark.parametrize("arch", ["minitron-4b", "kimi-k2-1t-a32b",
                                  "whisper-small"])
def test_train_resumes_bitwise(tmp_path, arch):
    """`train()` resumed from its step-2 snapshot equals the
    uninterrupted run: the same losses and the same final params; for
    kimi-k2 with the MoE aux term in the loss, for whisper with the
    stream's audio frames in every batch."""
    kw = dict(steps=4, batch=2, seq=8, log_every=1, device="cpu", log=None)
    want, hist = train(arch, **kw)
    d = str(tmp_path / "ck")
    train(arch, ckpt_dir=d, ckpt_every=2, **kw)
    assert ckpt.steps(d) == [2, 4]
    os.remove(os.path.join(d, "step_00000004.npz"))
    got, resumed = train(arch, ckpt_dir=d, **kw)
    assert [h["step"] for h in resumed] == [2, 3]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in hist[2:]]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert hist[-1]["loss"] < hist[0]["loss"]
