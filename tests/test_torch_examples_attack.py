"""The port's attack-resilience example (`examples/torch_attack_resilience.py`)
held against the JAX example (`examples/attack_resilience.py`) on the
CPU, at `scripts/ci.sh`'s smoke sizes.

The twin's `run` composes the threat model, the instrumented WPFed
program and the gossip schedule; `tests/test_torch_adversary.py` already
holds each instrumented round against JAX. Here the JAX state is carried
across (`_port_state`), each round gets the minibatch indices the JAX
round draws (`batch_idx`), and the attackers' "corrupt" gets the JAX
draw of fresh parameters. Tolerances (`PERF.md` §2's agreement bound):
round-0 ids equal, each round's honest accuracy within 0.02.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro.configs.paper_models import FedConfig as JaxFedConfig
from repro.configs.paper_models import mnist_cnn as jax_mnist_cnn
from repro.core import adversary as jadv
from repro.core import init_state as jax_init_state
from repro.core.protocol import select_phase as jax_select_phase
from repro.models import apply_client_model as jax_apply_client
from repro.models import init_client_model as jax_init_client
from repro.optim import adam as jax_adam

import repro_torch.configs.paper_models as pcfg
from repro_torch.core import protocol as P
from repro_torch.core.rounds import RoundProgram
from repro_torch.data.federated import make_mnist_federated
from repro_torch.models.convert import params_from_jax
from test_torch_examples import _clone, load
from test_torch_protocol import _np, _port_state, _update_batch_idx

# ci.sh's attack-resilience smoke sizes
ATTACK_SMOKE = dict(clients=6, rounds=3, per_client=48, reselect_every=3)


class Injected:
    """The twin's round program with the JAX rounds' minibatch indices
    injected, one set a round in order; records each round's metrics."""

    def __init__(self, batches):
        self.batches, self.metrics = list(batches), []

    def program(self, apply_fn, opt, fed):
        prog = P.wpfed_program(apply_fn, opt, fed)

        def global_round(state, data):
            out = prog.global_round(state, data,
                                    batch_idx=self.batches.pop(0))
            self.metrics.append(out[2])
            return out

        def gossip_round(state, data, cache):
            out = prog.gossip_round(state, data, cache,
                                    batch_idx=self.batches.pop(0))
            self.metrics.append(out[2])
            return out

        return RoundProgram(prog.name, global_round, gossip_round)


@pytest.fixture(scope="module")
def attack_jax():
    return load("examples/attack_resilience.py")


@pytest.mark.parametrize("verified", [True, False],
                         ids=["verified", "unverified"])
def test_attack_resilience_tracks_jax(attack_jax, verified, monkeypatch):
    """`run` at ci.sh's smoke sizes (6 clients, 3 rounds, 48 a client,
    G 3: one global round, two gossip epochs, the attack from round 2)
    from the JAX state, with the JAX rounds' minibatches and the JAX
    attackers' fresh draws: round-0 ids equal the JAX selection's, each
    round's honest accuracy within 0.02 of the JAX `run`'s."""
    jaccs = attack_jax.run(verified, **ATTACK_SMOKE)

    clients = ATTACK_SMOKE["clients"]
    fed = JaxFedConfig(
        num_clients=clients, num_neighbors=4, top_k=3, local_steps=2,
        lsh_bits=128, lsh_verification=verified)
    mcfg = jax_mnist_cnn()
    init_fn = lambda k: jax_init_client(mcfg, k)  # noqa: E731
    jstate = jax_init_state(functools.partial(jax_apply_client, mcfg),
                            init_fn, jax_adam(fed.lr), fed,
                            jax.random.PRNGKey(0))
    rng = jstate.rng
    rng, _, upd = jax.random.split(rng, 3)
    upds = [upd]
    for _ in range(ATTACK_SMOKE["rounds"] - 1):
        rng, upd = jax.random.split(rng)
        upds.append(upd)
    n_local = make_mnist_federated(
        num_clients=clients, per_client=ATTACK_SMOKE["per_client"],
        ref_per_client=16).stacked()["x_train"].shape[1]
    inject = Injected([_update_batch_idx(u, fed, n_local) for u in upds])
    pmc = pcfg.mnist_cnn()
    fresh = jax.vmap(init_fn)(jax.random.split(
        jadv.attack_key(jax.random.PRNGKey(9), 0, 2), clients))
    fresh = params_from_jax(pmc, _np(fresh))
    draws = [P.client(fresh, i) for i in range(clients)]

    twin = load("examples/torch_attack_resilience.py")
    carried = _port_state(jstate, pmc)
    monkeypatch.setattr(twin, "init_state", lambda *a: _clone(carried))
    monkeypatch.setattr(twin, "wpfed_program", inject.program)
    monkeypatch.setattr(twin, "init_client_model",
                        lambda *a: draws.pop(0))
    paccs = twin.run(verified, device=torch.device("cpu"), **ATTACK_SMOKE)
    assert inject.batches == [] and draws == []

    jids = jax_select_phase(jstate, fed).ids
    assert np.array_equal(inject.metrics[0]["neighbor_ids"].numpy(),
                          np.asarray(jids))
    print("JAX", jaccs, "port", paccs)
    assert np.all(np.abs(np.array(paccs) - np.array(jaccs)) <= 0.02), \
        (jaccs, paccs)
