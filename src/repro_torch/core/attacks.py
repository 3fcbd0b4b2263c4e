"""Adversarial primitives of the paper's robustness studies: state
transforms. Counterpart of `repro/core/attacks.py`; the schedulable layer
on top (`ThreatModel`, `Attack`, `instrument_program`) is
`core.adversary`.

§4.7 LSH cheating: attackers controlling half of a target's potential
neighbours publish the target's LSH code as their own (maximal apparent
similarity) while their models are garbage.

§4.8 poison: a fraction of clients re-initialise their parameters every
3 rounds after a 50-round honest warm-up.

Commit and reveal (§3.6): a client reveals a ranking other than the one
it committed to.

The port's rounds run eagerly with a Python round index, so the schedule
is a plain `if` on `attack_active`; the JAX package gates under
`lax.cond` only because its rounds are traced.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.protocol import FedState, stack, tree_map


def attack_active(round_idx, start_round: int = 0, every: int = 1):
    """Active from `start_round`, every `every` rounds. Python ints give a
    bool; integer tensors give the elementwise mask."""
    return (round_idx >= start_round) & ((round_idx - start_round) % every
                                         == 0)


def forge_lsh_codes(state: FedState, attacker_mask: torch.Tensor,
                    target_id: int) -> FedState:
    """Attackers republish the target's LSH code as their own (Eq. 5
    forgery). attacker_mask: (M,) bool."""
    forged = torch.where(attacker_mask[:, None], state.codes[target_id][None],
                         state.codes)
    return state._replace(codes=forged)


def corrupt_params(state: FedState, attacker_mask: torch.Tensor,
                   init_fn: Optional[Callable] = None,
                   generator: Optional[torch.Generator] = None, *,
                   fresh: Optional[Dict[str, torch.Tensor]] = None
                   ) -> FedState:
    """Replace the attackers' params with fresh initialisations. `fresh`
    is the stacked (M, ...) draw; by default M clients are drawn in order
    by `init_fn(generator)`. The optimizer state is kept."""
    m = attacker_mask.shape[0]
    if fresh is None:
        fresh = stack([init_fn(generator) for _ in range(m)])

    def mix(old, new):
        mask = attacker_mask.reshape((m,) + (1,) * (old.ndim - 1))
        return torch.where(mask, new.to(device=old.device, dtype=old.dtype),
                           old)

    return state._replace(params=tree_map(mix, state.params, fresh))


def poison_step(state: FedState, attacker_mask: torch.Tensor, init_fn,
                generator: Optional[torch.Generator], round_idx: int, *,
                start_round: int = 50, every: int = 3,
                fresh: Optional[Dict[str, torch.Tensor]] = None) -> FedState:
    """§4.8: periodic re-initialisation after the warm-up."""
    if attack_active(round_idx, start_round, every):
        return corrupt_params(state, attacker_mask, init_fn, generator,
                              fresh=fresh)
    return state


def lie_in_reveal(state: FedState, liar_mask: torch.Tensor) -> FedState:
    """Reveal a ranking that surely differs from the committed one: rotate
    it and add 1 to its first entry (a shuffle could be the identity, and
    the +1 makes width-1 rankings differ too). The §3.6 check must flag
    these reporters."""
    lied = torch.roll(state.rankings, 1, dims=1)
    if lied.shape[1]:
        lied[:, 0] += 1
    return state._replace(rankings=torch.where(liar_mask[:, None], lied,
                                               state.rankings))
