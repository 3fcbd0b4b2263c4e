"""Threat models composed with the round-program engine. Counterpart of
`repro/core/adversary.py`.

  Attack        one scheduled behaviour: a transform `(state,
                attacker_mask, round_idx, generator) -> state` with
                `start_round` / `every` gating (`attacks.attack_active`).
  ThreatModel   a named attacker mask, its Attacks and an integer seed;
                attack i at round r draws from `attack_key(seed, i, r)`.
  resolve_attack  the one place that validates attack names and
                arguments: "forge_codes", "corrupt", "poison" (§4.8
                defaults start_round=50, every=3), "lie_in_reveal".
  instrument_program  runs a ThreatModel's attacks on the state before
                each global round and each gossip epoch of a
                `RoundProgram`, and adds threat telemetry (attacker
                admission rate, honest and attacker ranking scores) to
                the round's metrics where the base metrics hold the
                arrays it needs.

The JAX package's PRNG key becomes an integer seed here, and its
in-graph `lax.cond` a Python `if`: the port's rounds run eagerly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import attacks as _attacks
from repro_torch.core.protocol import seeded_generator
from repro_torch.core.rounds import RoundProgram


class Attack(NamedTuple):
    """One scheduled adversarial behaviour."""
    name: str
    transform: Callable  # (state, mask, round_idx, generator) -> state
    start_round: int = 0
    every: int = 1


class ThreatModel(NamedTuple):
    """Who attacks (mask), how (attacks), and with what randomness."""
    name: str
    attacker_mask: torch.Tensor   # (M,) bool
    attacks: Tuple[Attack, ...]
    seed: int                     # base seed (see attack_key)


ATTACKS = ("forge_codes", "corrupt", "poison", "lie_in_reveal")
_NEEDS_INIT = ("corrupt", "poison")
_DEFAULT_SCHEDULE = {"poison": (50, 3)}   # §4.8: warm-up 50, re-init /3


def resolve_attack(name: str, *, start_round: Optional[int] = None,
                   every: Optional[int] = None, init_fn=None,
                   target_id: Optional[int] = None) -> Attack:
    """Build and validate one attack:

      "forge_codes"    §4.7 LSH forgery toward `target_id` (required)
      "corrupt"        replace attacker params with fresh
                       initialisations (`init_fn(generator)` required)
      "poison"         "corrupt" with the §4.8 schedule defaults
                       (start_round=50, every=3) unless overridden
      "lie_in_reveal"  §3.6 reveal that differs from the commitment
    """
    if name not in ATTACKS:
        raise ValueError(
            f"unknown attack: {name!r} (expected one of {ATTACKS})")
    d_start, d_every = _DEFAULT_SCHEDULE.get(name, (0, 1))
    start_round = d_start if start_round is None else start_round
    every = d_every if every is None else every
    if start_round < 0:
        raise ValueError(f"start_round must be >= 0, got {start_round}")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    if name in _NEEDS_INIT and init_fn is None:
        raise ValueError(f"attack {name!r} requires init_fn=")
    if name == "forge_codes" and target_id is None:
        raise ValueError("attack 'forge_codes' requires target_id=")

    if name == "forge_codes":
        def transform(state, mask, round_idx, generator):
            return _attacks.forge_lsh_codes(state, mask, target_id)
    elif name in _NEEDS_INIT:
        def transform(state, mask, round_idx, generator):
            return _attacks.corrupt_params(state, mask, init_fn, generator)
    else:  # lie_in_reveal
        def transform(state, mask, round_idx, generator):
            return _attacks.lie_in_reveal(state, mask)
    return Attack(name, transform, start_round, every)


def attacker_mask_tail(num_clients: int, frac: float) -> torch.Tensor:
    """The experiments' convention (Figs. 4-5): the LAST int(M * frac)
    clients are the attackers."""
    n_bad = int(num_clients * frac)
    if not 0 < n_bad < num_clients:
        raise ValueError(
            f"attacker_frac={frac} yields {n_bad} attackers out of "
            f"{num_clients} clients (need 0 < attackers < clients)")
    return torch.arange(num_clients) >= (num_clients - n_bad)


def threat_model(attack_list: Sequence[Attack], attacker_mask, *,
                 seed: Optional[int] = None,
                 name: str = "threat") -> ThreatModel:
    """Validated ThreatModel constructor (seed 0 by default)."""
    atks = tuple(attack_list)
    if not atks:
        raise ValueError("a ThreatModel needs at least one Attack")
    for a in atks:
        if not isinstance(a, Attack):
            raise TypeError(f"expected Attack, got {type(a).__name__} "
                            "(build attacks via resolve_attack)")
    attacker_mask = torch.as_tensor(attacker_mask)
    if attacker_mask.ndim != 1 or attacker_mask.dtype != torch.bool:
        raise ValueError("attacker_mask must be a 1-D bool mask, got "
                         f"{attacker_mask.dtype}{tuple(attacker_mask.shape)}")
    return ThreatModel(name, attacker_mask, atks, 0 if seed is None else seed)


def attack_key(seed: int, attack_index: int, round_idx: int
               ) -> torch.Generator:
    """The CPU generator of one (threat seed, attack index, round)."""
    return seeded_generator(seed, attack_index, round_idx)


def apply_attacks(state, tm: ThreatModel, round_idx: Optional[int] = None):
    """Apply every attack whose schedule is active at `round_idx`
    (default `state.round`), in ThreatModel order."""
    r = state.round if round_idx is None else round_idx
    mask = tm.attacker_mask.to(state.codes.device)
    for i, atk in enumerate(tm.attacks):
        if _attacks.attack_active(r, atk.start_round, atk.every):
            state = atk.transform(state, mask, r, attack_key(tm.seed, i, r))
    return state


def _threat_metrics(metrics, attacker_mask: torch.Tensor):
    """Threat telemetry from the per-round arrays the base program reports
    (WPFed's ranking_scores, neighbor_ids and valid_mask; the baselines
    report none, and gain nothing):

      rank_score_honest / rank_score_attacker   mean Eq. 7 score by
          cohort (Fig. 5: the crowd down-ranks poisoned clients).
      attacker_admission_rate   mean over honest clients of the share of
          their VALID distillation slots held by attackers (Figs. 4-5;
          what the §3.5 filter collapses).
    """
    out = dict(metrics)
    honest = ~attacker_mask
    if "ranking_scores" in metrics:
        s = metrics["ranking_scores"]
        hf = honest.to(device=s.device, dtype=s.dtype)
        af = attacker_mask.to(device=s.device, dtype=s.dtype)
        out["rank_score_honest"] = (s * hf).sum() / hf.sum().clamp(min=1)
        out["rank_score_attacker"] = (s * af).sum() / af.sum().clamp(min=1)
    if "neighbor_ids" in metrics and "valid_mask" in metrics:
        ids, valid = metrics["neighbor_ids"], metrics["valid_mask"]
        att_sel = attacker_mask.to(ids.device)[ids.long()]     # (M, N)
        admitted = ((att_sel & valid).to(torch.float32).sum(1)
                    / valid.to(torch.float32).sum(1).clamp(min=1.0))
        hf = honest.to(device=ids.device, dtype=torch.float32)
        out["attacker_admission_rate"] = ((admitted * hf).sum()
                                          / hf.sum().clamp(min=1.0))
    return out


def instrument_program(program: RoundProgram,
                       tm: ThreatModel) -> RoundProgram:
    """Run the ThreatModel's attacks on the state just before each global
    round and each gossip epoch, and add the threat telemetry to the
    round's metrics. Keywords (`batch_idx`, `peer_ids`) pass through to
    the wrapped bodies."""

    def global_round(state, data, **kw):
        state = apply_attacks(state, tm)
        state, cache, metrics = program.global_round(state, data, **kw)
        return state, cache, _threat_metrics(metrics, tm.attacker_mask)

    gossip_round = None
    if program.gossip_round is not None:
        def gossip_round(state, data, cache, **kw):
            state = apply_attacks(state, tm)
            state, cache, metrics = program.gossip_round(state, data, cache,
                                                         **kw)
            return state, cache, _threat_metrics(metrics, tm.attacker_mask)

    return RoundProgram(f"{program.name}+{tm.name}", global_round,
                        gossip_round)


# ---------------------------------------------------------------------------
# named threat models (the launcher's --attack)
# ---------------------------------------------------------------------------
THREATS = ("lsh_cheat", "poison", "lie_in_reveal")


def resolve_threat(name: str, *, num_clients: int, attacker_frac: float = 0.5,
                   init_fn=None, seed: Optional[int] = None,
                   start_round: Optional[int] = None,
                   every: Optional[int] = None,
                   target_id: int = 0) -> ThreatModel:
    """The paper's named threat models:

      "lsh_cheat"      §4.7: corrupt params and forge LSH codes toward
                       `target_id`, every round from `start_round`
      "poison"         §4.8: periodic re-initialisation (defaults
                       start_round=50, every=3)
      "lie_in_reveal"  §3.6: reveal a ranking other than the commitment

    The attackers are the last int(M * attacker_frac) clients
    (`attacker_mask_tail`).
    """
    if name not in THREATS:
        raise ValueError(
            f"unknown threat model: {name!r} (expected one of {THREATS})")
    mask = attacker_mask_tail(num_clients, attacker_frac)
    if name == "lsh_cheat":
        atks = [resolve_attack("corrupt", init_fn=init_fn,
                               start_round=start_round, every=every),
                resolve_attack("forge_codes", target_id=target_id,
                               start_round=start_round, every=every)]
    elif name == "poison":
        atks = [resolve_attack("poison", init_fn=init_fn,
                               start_round=start_round, every=every)]
    else:
        atks = [resolve_attack("lie_in_reveal", start_round=start_round,
                               every=every)]
    return threat_model(atks, mask, seed=seed, name=name)
