"""The PyTorch port's protocol modules and one whole WPFed round held
against the JAX package, on the CPU.

Inputs are made with numpy from a seed or carried across from the JAX
package (`params_from_jax`; the JAX round's minibatch indices are
injected through `batch_idx`). Tolerances:

* bit-exact: configs, the synthetic datasets, FNV-1a and SHA-256
  commitments, rankings, Eq. 7 scores (with and without dedupe), and in
  the round: ids, sel_mask, valid mask, rankings, commitments;
* LSH codes in the round: equal except bits whose JAX projection sum is
  within 1e-3 of zero (counted);
* model forwards on the same weights: rtol 1e-5 (f32 convolutions and
  matmuls reduce in another order);
* one Adam step: rtol 1e-6;
* the round's l_ij, params and metrics: rtol 1e-4 (three local Adam
  steps compound the forward tolerance), atol 1e-6 for params near 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

import repro.configs.paper_models as jcfg
import repro.data.federated as jdata
from repro.core import exchange_phase as jax_exchange_phase
from repro.core import (init_state as jax_init_state,
                        make_wpfed_round as jax_make_round,
                        select_phase as jax_select_phase)
from repro.core import chain as jchain
from repro.core import ranking as jranking
from repro.core import verify as jverify
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import apply_client_model as jax_apply
from repro.models import init_client_model as jax_init
from repro.optim import adam as jax_adam

import repro_torch.configs.paper_models as pcfg
import repro_torch.data.federated as pdata
from repro_torch.core import chain, ranking, rounds, verify
from repro_torch.core import protocol as P
from repro_torch.core.backends import (resolve, resolve_selection,
                                      resolve_tiling)
from repro_torch.kernels import ops
from repro_torch.launch.fed import run_federation
from repro_torch.models.client import apply_client_model, client_template
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam

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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# configs and data: the port's copies
# ---------------------------------------------------------------------------
def test_config_copies_equal():
    assert dataclasses.asdict(pcfg.FedConfig()) == \
        dataclasses.asdict(jcfg.FedConfig())
    for name in ("mnist_cnn", "aecg_tcn", "seeg_tcn"):
        assert dataclasses.asdict(getattr(pcfg, name)()) == \
            dataclasses.asdict(getattr(jcfg, name)())
    assert pcfg.PAPER_FED_OPTIMA == jcfg.PAPER_FED_OPTIMA
    for mode in ("personal", "public"):
        assert pcfg.recommended_dedupe(mode) == jcfg.recommended_dedupe(mode)


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(num_clients=3, per_client=40)),
    ("aecg", dict(num_clients=3, per_subject=20)),
    ("seeg", dict(num_clients=4, per_subject=20))])
def test_dataset_copy_is_array_identical(name, kw):
    fn = {"mnist": "make_mnist_federated", "aecg": "make_aecg_federated",
          "seeg": "make_seeg_federated"}[name]
    a = getattr(pdata, fn)(seed=5, **kw)
    b = getattr(jdata, fn)(seed=5, **kw)
    assert set(pdata.DATASETS) == set(jdata.DATASETS)
    sa, sb = a.stacked(), b.stacked()
    for k in sb:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k
    assert np.array_equal(a.shared_ref_x, b.shared_ref_x)
    assert np.array_equal(a.shared_ref_y, b.shared_ref_y)


# ---------------------------------------------------------------------------
# commitments, rankings, scores
# ---------------------------------------------------------------------------
def _rankings(rs, m, n):
    r = np.stack([rs.permutation(m)[:n] for _ in range(m)]).astype(np.int32)
    r[rs.rand(m, n) < 0.2] = -1
    return r


def test_fnv1a_and_reveal_check_bit_exact():
    rs = np.random.RandomState(0)
    r = _rankings(rs, 9, 5)
    j = np.asarray(jchain.fnv1a_commit(jnp.asarray(r), salt=3))
    p = chain.fnv1a_commit(_t(r), salt=3).numpy()
    assert np.array_equal(p.astype(np.uint64), j.astype(np.uint64))
    commits = jchain.fnv1a_commit(jnp.asarray(r), salt=0)
    tampered = r.copy()
    tampered[2, 0] = 8 - max(tampered[2, 0], 0)
    jm = np.asarray(jverify.verify_rankings_fnv(jnp.asarray(tampered),
                                                commits))
    pm = verify.verify_rankings_fnv(
        _t(tampered), _t(np.asarray(commits).astype(np.int64))).numpy()
    assert np.array_equal(pm, jm) and not pm[2] and pm.sum() == 8


def test_sha256_commit_and_code_hex_byte_identical():
    rs = np.random.RandomState(1)
    for row in _rankings(rs, 6, 4):
        assert chain.canonical_ranking_bytes(_t(row)) == \
            jchain.canonical_ranking_bytes(row)
        assert chain.sha256_commit(_t(row), salt=9) == \
            jchain.sha256_commit(row, salt=9)
        assert chain.verify_reveal(jchain.sha256_commit(row), _t(row))
    u = rs.randint(0, 2 ** 32, size=8, dtype=np.uint64).astype(np.uint32)
    assert chain.lsh_code_hex(_t(u.view(np.int32))) == jchain.lsh_code_hex(u)


def test_make_ranking_bit_exact_with_ties_and_mask():
    rs = np.random.RandomState(2)
    m, n = 7, 5
    ids = np.stack([rs.permutation(m)[:n] for _ in range(m)]).astype(
        np.int32)
    losses = rs.choice([0.5, 1.0, 1.5], size=(m, n)).astype(np.float32)
    mask = rs.rand(m, n) < 0.8
    j = np.asarray(jax.vmap(jranking.make_ranking)(
        jnp.asarray(ids), jnp.asarray(losses), jnp.asarray(mask)))
    p = ranking.make_ranking(_t(ids), _t(losses), _t(mask)).numpy()
    assert p.dtype == np.int32 and np.array_equal(p, j)


@pytest.mark.parametrize("dedupe", [False, True])
def test_ranking_scores_bit_exact(dedupe):
    rs = np.random.RandomState(3)
    r = _rankings(rs, 10, 4)
    r[6] = r[1]                                  # duplicate reveal
    r[8] = r[1]
    rep = rs.rand(10) < 0.8
    rep[1] = True
    j = np.asarray(jranking.ranking_scores(jnp.asarray(r), 10, 2,
                                           jnp.asarray(rep), dedupe=dedupe))
    p = ranking.ranking_scores(_t(r), 10, 2, _t(rep), dedupe=dedupe).numpy()
    assert np.array_equal(p, j)
    jd = np.asarray(jranking.dedupe_reporter_mask(jnp.asarray(r),
                                                  jnp.asarray(rep)))
    assert np.array_equal(ranking.dedupe_reporter_mask(_t(r), _t(rep))
                          .numpy(), jd)


# ---------------------------------------------------------------------------
# models and optimizer on carried-over weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(SMALL_MODELS))
def test_model_forward_matches_jax(kind):
    spec = SMALL_MODELS[kind]
    jc, pc = jcfg.ClientModelConfig(**spec), pcfg.ClientModelConfig(**spec)
    rs = np.random.RandomState(0)
    tree = jax.tree.map(          # JAX-shaped weights, drawn with numpy
        lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda k: jax_init(jc, k), jax.random.PRNGKey(0)))
    x = rs.randn(5, *spec["input_shape"]).astype(np.float32)
    want = np.asarray(jax_apply(jc, tree, jnp.asarray(x)))
    got = apply_client_model(client_template(pc),
                             params_from_jax(pc, _np(tree)), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_adam_step_matches_jax():
    rs = np.random.RandomState(4)
    params = {"a": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    grads = {k: rs.randn(*v.shape).astype(np.float32) * 1e-2
             for k, v in params.items()}
    jopt, popt = jax_adam(1e-2), adam(1e-2)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    pstate = popt.init({k: _t(v) for k, v in params.items()})
    for _ in range(2):                           # second step: bias terms
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jax.tree.map(jnp.asarray, params))
        pu, pstate = popt.update({k: _t(v) for k, v in grads.items()},
                                 pstate, {k: _t(v) for k, v in params.items()})
        for k in params:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6)
    assert int(pstate["step"]) == int(jstate["step"]) == 2


# ---------------------------------------------------------------------------
# one whole round against make_wpfed_round
# ---------------------------------------------------------------------------
def _jax_batch_idx(state, fed, n_local):
    """The minibatch indices JAX's global round draws (protocol.py:236)."""
    _, _, rng_upd = jax.random.split(state.rng, 3)
    return _update_batch_idx(rng_upd, fed, n_local)


def _update_batch_idx(rng_upd, fed, n_local):
    """The minibatch indices JAX's update_phase draws from `rng_upd`."""
    mb = min(fed.local_batch, n_local)
    out = []
    for i in range(fed.num_clients):
        keys = jax.random.split(jax.random.fold_in(rng_upd, i),
                                fed.local_steps)
        out.append([np.asarray(jax.random.randint(k, (mb,), 0, n_local))
                    for k in keys])
    return torch.from_numpy(np.asarray(out))


def _port_state(jstate, pmodel_cfg):
    opt = {"step": _t(jstate.opt_state["step"]).to(torch.int32),
           "m": params_from_jax(pmodel_cfg, _np(jstate.opt_state["m"])),
           "v": params_from_jax(pmodel_cfg, _np(jstate.opt_state["v"]))}
    return P.FedState(
        params_from_jax(pmodel_cfg, _np(jstate.params)), opt,
        _t(np.asarray(jstate.codes).view(np.int32)),
        _t(jstate.rankings).to(torch.int32),
        _t(np.asarray(jstate.commitments).astype(np.int64)), 0,
        int(jstate.round))


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("ref_mode", ["personal", "public"])
@pytest.mark.parametrize("tiling", ["oneshot", "tiled", "ann"])
def test_round_matches_jax(tiny_fed, ref_mode, tiling):
    """One round on each side. With "tiled" the JAX CPU oracle runs
    `fused_select_ref` + `streamed_exchange_ref`, the port
    `fused_select_tiled_ref` + its `streamed_exchange_ref`. "ann" selects
    through the ANN path on both sides (2 prefix bits, 1 probe: each
    client probes 2 of 4 buckets, so candidate sets are partial), seeded
    by the round index, with the exchange on "auto"."""
    if tiling == "ann":
        path = dict(selection_backend="ann", ann_prefix_bits=2,
                    ann_probes=1)
    else:
        path = dict(selection_tiling=tiling, exchange_tiling=tiling)
    jfed = dataclasses.replace(
        tiny_fed["fed"], ref_mode=ref_mode,
        dedupe_rankings=jcfg.recommended_dedupe(ref_mode), **path)
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    jmc = tiny_fed["mcfg"]
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(jmc))
    jdata_ = tiny_fed["data"]
    pdata_ = {k: _t(v) for k, v in jdata_.items()}
    apply_fn = tiny_fed["apply_fn"]
    round_fn = jax.jit(jax_make_round(apply_fn, tiny_fed["opt"], jfed))
    program = P.wpfed_program(
        lambda p, x: apply_client_model(client_template(pmc), p, x),
        adam(pfed.lr), pfed)
    n_local = jdata_["x_train"].shape[1]

    jstate = jax_init_state(apply_fn, tiny_fed["init_fn"], tiny_fed["opt"],
                            jfed, jax.random.PRNGKey(0))
    near_zero = 0
    for _ in range(2):        # round 0 (all scores 0), then a ranked round
        pstate = _port_state(jstate, pmc)
        assert np.array_equal(pstate.codes.numpy().view(np.uint32),
                              np.asarray(jstate.codes))
        jsel = jax_select_phase(jstate, jfed)
        jexch = jax_exchange_phase(apply_fn, jfed, jstate.params, jdata_,
                                   jsel)
        psel = P.select_phase(pstate, pfed)
        pexch = P.exchange_phase(program_apply(pmc), pfed, pstate.params,
                                 pdata_, psel)
        _close(pexch.l_ij.numpy(), jexch.l_ij)

        jnew, jm = round_fn(jstate, jdata_)
        pnew, _, pm = program.global_round(
            pstate, pdata_, batch_idx=_jax_batch_idx(jstate, jfed, n_local))

        assert np.array_equal(pm["neighbor_ids"].numpy(),
                              np.asarray(jm["neighbor_ids"]))
        assert np.array_equal(psel.sel_mask.numpy(),
                              np.asarray(jsel.sel_mask))
        assert np.array_equal(pm["valid_mask"].numpy(),
                              np.asarray(jm["valid_mask"]))
        assert np.array_equal(pm["ranking_scores"].numpy(),
                              np.asarray(jm["ranking_scores"]))
        assert np.array_equal(pnew.rankings.numpy(), np.asarray(jnew.rankings))
        assert np.array_equal(pnew.commitments.numpy().astype(np.uint32),
                              np.asarray(jnew.commitments))
        jp = _np(jnew.params)
        for k, v in params_from_jax(pmc, jp).items():
            _close(pnew.params[k].numpy(), v.numpy())
        for k in ("mean_loss", "mean_local_loss", "mean_ref_loss",
                  "mean_neighbor_loss", "valid_neighbor_frac",
                  "honest_reporter_frac"):
            _close(float(pm[k]), float(jm[k]))
        sums = np.asarray(jref.lsh_project_sums_batched_ref(
            jops.flatten_params_batched(jnew.params), int(jstate.round) + 1,
            bits=jfed.lsh_bits))
        pbits = ops.unpack_bits(pnew.codes, jfed.lsh_bits).numpy()
        jbits = np.asarray(jops.unpack_bits(jnew.codes, jfed.lsh_bits))
        near = np.abs(sums) <= 1e-3
        assert np.array_equal(pbits[~near], jbits[~near])
        near_zero += int(near.sum())
        jstate = jnew
    print(f"{ref_mode}/{tiling}: {near_zero} code bits with |JAX sum| "
          "<= 1e-3")


@pytest.mark.parametrize("kind", ["cnn", "tcn"])
def test_update_phase_matches_jax(kind):
    """Two local Adam steps per client through update_phase on a narrowed
    CNN / TCN: convolution gradients through the SAME / causal padding,
    the combined loss with and without a distillation target."""
    from repro.core import update_phase as jax_update_phase
    from repro.core.exchange import ExchangeResult as JaxExchangeResult
    from repro_torch.core.exchange import ExchangeResult
    spec = SMALL_MODELS[kind]
    jc, pc = jcfg.ClientModelConfig(**spec), pcfg.ClientModelConfig(**spec)
    m, n_loc, r, classes = 3, 12, 5, spec["num_classes"]
    rs = np.random.RandomState(7)
    shapes = jax.eval_shape(lambda k: jax_init(jc, k), jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda s: (rs.randn(m, *s.shape) * 0.3).astype(np.float32), shapes)
    data = {"x_train": rs.randn(m, n_loc, *spec["input_shape"]),
            "y_train": rs.randint(0, classes, (m, n_loc)),
            "x_ref": rs.randn(m, r, *spec["input_shape"]),
            "y_ref": rs.randint(0, classes, (m, r))}
    data = {k: v.astype(np.float32 if k[0] == "x" else np.int32)
            for k, v in data.items()}
    target = rs.randn(m, r, classes).astype(np.float32)
    has = np.array([True, False, True])
    jfed = jcfg.FedConfig(num_clients=m, local_steps=2, local_batch=8,
                          lr=1e-2)
    jopt = jax_adam(jfed.lr)
    rng = jax.random.PRNGKey(5)
    jp, _, jm = jax_update_phase(
        lambda p, x: jax_apply(jc, p, x), jopt, jfed,
        jax.tree.map(jnp.asarray, params),
        jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params)),
        {k: jnp.asarray(v) for k, v in data.items()},
        JaxExchangeResult(None, None, jnp.asarray(target), jnp.asarray(has)),
        rng)
    pparams = params_from_jax(pc, params)
    popt = adam(jfed.lr)
    pstate = P.stack([popt.init(P.client(pparams, i)) for i in range(m)])
    pp, _, pm = P.update_phase(
        program_apply(pc), popt, pcfg.FedConfig(**dataclasses.asdict(jfed)),
        pparams, pstate, {k: _t(v) for k, v in data.items()},
        ExchangeResult(None, None, _t(target), _t(has)),
        batch_idx=_update_batch_idx(rng, jfed, n_loc))
    for k, v in params_from_jax(pc, _np(jp)).items():
        _close(pp[k].numpy(), v.numpy())
    for k in ("loss", "local_loss", "ref_loss"):
        _close(pm[k].numpy(), np.asarray(jm[k]))


def program_apply(pmc):
    template = client_template(pmc)
    return lambda p, x: apply_client_model(template, p, x)


# ---------------------------------------------------------------------------
# schedules, backends, the CPU entry point
# ---------------------------------------------------------------------------
def test_gossip_schedule_freezes_announcements(tiny_fed):
    pfed = pcfg.FedConfig(**dataclasses.asdict(tiny_fed["fed"]))
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(tiny_fed["mcfg"]))
    data = {k: _t(v) for k, v in tiny_fed["data"].items()}
    apply_fn = program_apply(pmc)
    from repro_torch.models.client import init_client_model
    state = P.init_state(lambda g: init_client_model(pmc, g), adam(pfed.lr),
                         pfed, seed=1)
    seen = []
    state, hist = rounds.run_rounds(
        P.wpfed_program(apply_fn, adam(pfed.lr), pfed), state, data,
        rounds=3, schedule=rounds.resolve_schedule("gossip", 2),
        on_reselect=lambda r0, st: seen.append((r0, st.round)))
    assert [h["round"] for h in hist] == [0, 1, 2]
    assert seen == [(0, 2), (2, 3)] and state.round == 3
    assert hist[0]["neighbor_ids"] == hist[1]["neighbor_ids"]
    assert all(h["seconds"] >= 0 for h in hist)
    with pytest.raises(ValueError, match="sync"):
        rounds.resolve_schedule("sync", 3)


def test_backend_resolution():
    assert resolve("auto", "cpu") == "oracle"
    assert resolve("oracle", "cpu") == "oracle"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve("kernel", "cpu")
    with pytest.raises(ValueError, match=r"unknown backend: 'tpu' \(expected"):
        resolve("tpu", "cpu")
    with pytest.raises(ValueError, match=r"unknown backend: 'ann' \(expected"):
        resolve("ann", "cpu")
    assert resolve_selection("ann", 10, exact_flops=1.0, ann_flops=1.0,
                             device="cpu") == "ann"
    assert resolve_tiling("auto", 0) == resolve_tiling("oneshot", 0) \
        == "oneshot"
    assert resolve_tiling("tiled", 0) == "tiled"
    assert resolve_tiling("auto", 10 ** 9) == "tiled"
    with pytest.raises(ValueError, match=r"unknown tiling: 'x' \(expected"):
        resolve_tiling("x", 0)


def test_random_ablation_draws_from_the_generator(tiny_fed):
    from repro_torch.core.neighbor import select_partners
    fed = pcfg.FedConfig(num_clients=8, num_neighbors=3, use_lsh=False,
                         use_rank=False)
    codes = torch.zeros((8, 4), dtype=torch.int32)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(4)
    g2.manual_seed(4)
    a, ma = select_partners(codes, torch.zeros(8), fed, generator=g1)
    b, _ = select_partners(codes, torch.zeros(8), fed, generator=g2)
    assert torch.equal(a, b) and ma.all()
    assert all(i not in row and len(set(row)) == 3
               for i, row in enumerate(a.tolist()))
    with pytest.raises(ValueError, match="Generator"):
        select_partners(codes, torch.zeros(8), fed)


def test_run_federation_cpu_smoke():
    state, hist = run_federation("aecg", rounds=2, num_clients=4,
                                 device="cpu", log=None)
    assert len(hist) == 2 and state.round == 2
    for h in hist:
        assert np.isfinite(h["mean_loss"]) and 0.0 <= h["acc"] <= 1.0
        ids = np.asarray(h["neighbor_ids"])
        assert ids.shape == (4, 3)
        assert all(i not in row for i, row in enumerate(ids.tolist()))
    assert state.codes.dtype == torch.int32 and state.codes.shape == (4, 8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        run_federation("aecg", rounds=1, num_clients=3, device="cpu",
                       backend="kernel", log=None)
