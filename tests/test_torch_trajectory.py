"""An accuracy trajectory of the port held against the JAX package: four
WPFed rounds on each side from one carried-across state, with no re-sync
between rounds.

The JAX state is built by `init_state` on the `tiny_fed` federation and
carried across once (`_port_state`); each round the port is given the
minibatch indices the JAX round draws from its own state (`batch_idx`).
From there each side runs on its own params, codes and rankings, so
small differences may grow. Tolerances (`PERF.md` §2's agreement bound):
round-0 neighbour ids equal; each round's mean test accuracy within
0.02.
"""
import dataclasses

import jax
import numpy as np

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.core import evaluate as jax_evaluate
from repro.core import (init_state as jax_init_state,
                        make_wpfed_round as jax_make_round)

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import protocol as P
from repro_torch.optim import adam
from test_torch_protocol import (_jax_batch_idx, _port_state, _t,
                                 program_apply)

ROUNDS = 4


def test_four_rounds_track_jax_without_resync(tiny_fed):
    jfed = tiny_fed["fed"]
    pfed = pcfg.FedConfig(**dataclasses.asdict(jfed))
    pmc = pcfg.ClientModelConfig(**dataclasses.asdict(tiny_fed["mcfg"]))
    jdata = tiny_fed["data"]
    pdata = {k: _t(v) for k, v in jdata.items()}
    apply_fn = tiny_fed["apply_fn"]
    papply = program_apply(pmc)
    round_fn = jax.jit(jax_make_round(apply_fn, tiny_fed["opt"], jfed))
    program = P.wpfed_program(papply, adam(pfed.lr), pfed)
    n_local = jdata["x_train"].shape[1]

    jstate = jax_init_state(apply_fn, tiny_fed["init_fn"], tiny_fed["opt"],
                            jfed, jax.random.PRNGKey(0))
    pstate = _port_state(jstate, pmc)
    jaccs, paccs = [], []
    for r in range(ROUNDS):
        batch_idx = _jax_batch_idx(jstate, jfed, n_local)
        jstate, jm = round_fn(jstate, jdata)
        pstate, _, pm = program.global_round(pstate, pdata,
                                             batch_idx=batch_idx)
        if r == 0:
            assert np.array_equal(pm["neighbor_ids"].numpy(),
                                  np.asarray(jm["neighbor_ids"]))
        jaccs.append(float(jax_evaluate(apply_fn, jstate, jdata)["mean_acc"]))
        paccs.append(float(P.evaluate(papply, pstate, pdata)["mean_acc"]))
    print("JAX", jaccs, "port", paccs)
    assert np.all(np.abs(np.array(paccs) - np.array(jaccs)) <= 0.02), \
        (jaccs, paccs)
    assert paccs[-1] > paccs[0]
