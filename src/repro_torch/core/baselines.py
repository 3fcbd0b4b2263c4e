"""Baseline methods of WPFed §4.2 (Table 2), on the same FedState and
data API as WPFed. Counterpart of `repro/core/baselines.py`.

SILO    (Lian et al. 17):  purely local training, no collaboration.
FedMD   (Li & Wang 19):    distillation toward the all-client consensus
                           on one SHARED reference set, no selection.
ProxyFL (Kalra et al. 23): uniform random gossip: each round every
                           client distils from a few random peers.
KD-PDFL (Jeong & K. 23):   similarity-only selection: neighbours chosen
                           by output-KL similarity, no rank score, no
                           verification.

Each is a `core.rounds.RoundProgram`. The global round is the method's
per-round body; the gossip epoch reuses its selection cache where it has
one (ProxyFL its peer draw, KD-PDFL its KL-similar ids, M*N forwards in
place of M*M). SILO and FedMD have nothing to re-select, so their gossip
epoch is their global body. Every body takes `batch_idx` (M,
local_steps, mb), the minibatch indices (the parity tests pass the JAX
package's), and ProxyFL's global round `peer_ids` (M, num_peers); by
default both are drawn from the round's generators
(`protocol.round_generator`). Each client-axis forward is one
`torch.func.vmap` over the stacked params, as the JAX package's
`jax.vmap`, and every update is `protocol.batched_local_update`. The
`make_*_round` constructors are the classic per-round adapters over the
programs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.func import vmap

from repro_torch.configs.paper_models import FedConfig
from repro_torch.core import verify
from repro_torch.core.protocol import (PICK_STREAM, UPDATE_STREAM, FedState,
                                       batched_local_update, neighbour_web,
                                       round_generator)
from repro_torch.core.rounds import RoundProgram, program_round

_TRAIN = ("x_train", "y_train", "x_ref")


def _update_round(apply_fn, optimizer, fed: FedConfig, state: FedState,
                  data_per, target, has_target, batch_idx
                  ) -> Tuple[FedState, Dict]:
    """Shared tail of every baseline round: the local updates toward
    (target, has_target), then the state's advance."""
    params, opt_state, tm = batched_local_update(
        apply_fn, optimizer, fed, state.params, state.opt_state, data_per,
        target, has_target, batch_idx=batch_idx,
        generator=round_generator(state.seed, state.round, UPDATE_STREAM))
    return (state._replace(params=params, opt_state=opt_state,
                           round=state.round + 1),
            {"mean_loss": tm["loss"].mean()})


def _own_data_per(data):
    return {k: data[k] for k in _TRAIN}


def _flag(m: int, value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.full((m,), value, dtype=torch.bool, device=like.device)


@torch.no_grad()
def _peer_mean(apply_fn, params, x_ref, ids: torch.Tensor) -> torch.Tensor:
    """(M, R, C): for each client i the mean of its peers' (ids[i])
    outputs on its own reference set x_ref[i], one nested vmap over the
    gathered peer params."""
    return neighbour_web(apply_fn, params, x_ref,
                         ids.to(torch.int64)).mean(1)


def silo_program(apply_fn, optimizer, fed: FedConfig) -> RoundProgram:
    m = fed.num_clients

    def round_body(state: FedState, data, batch_idx=None):
        # has_target all False: pure local CE (the zero target, which
        # broadcasts over (R, C), is masked out of the loss)
        dummy = data["x_train"].new_zeros((m, 1, 1))
        state, metrics = _update_round(
            apply_fn, optimizer, fed, state, _own_data_per(data), dummy,
            _flag(m, False, dummy), batch_idx)
        return state, (), metrics

    return RoundProgram(
        "silo", round_body,
        lambda state, data, cache, batch_idx=None: round_body(
            state, data, batch_idx))


def fedmd_program(apply_fn, optimizer, fed: FedConfig,
                  shared_ref_x) -> RoundProgram:
    """Consensus distillation on one shared reference set (R, ...)."""
    m = fed.num_clients

    def round_body(state: FedState, data, batch_idx=None):
        x = torch.as_tensor(shared_ref_x, device=data["x_train"].device)
        with torch.no_grad():
            logits = vmap(apply_fn, in_dims=(0, None))(state.params,
                                                       x)      # (M, R, C)
        data_per = {"x_train": data["x_train"], "y_train": data["y_train"],
                    "x_ref": x[None].expand(m, *x.shape)}
        state, metrics = _update_round(
            apply_fn, optimizer, fed, state, data_per,
            logits.mean(0)[None].expand_as(logits), _flag(m, True, x),
            batch_idx)
        return state, (), metrics

    # the consensus tracks the drifting params: no reusable cache
    return RoundProgram(
        "fedmd", round_body,
        lambda state, data, cache, batch_idx=None: round_body(
            state, data, batch_idx))


def draw_peers(m: int, num_peers: int, generator: torch.Generator
               ) -> torch.Tensor:
    """(M, num_peers) int64: for each client, num_peers distinct clients
    of all M, itself included, uniformly without replacement."""
    if not 0 < num_peers <= m:
        raise ValueError(f"num_peers={num_peers} must be in [1, {m}] "
                         "(peers are drawn without replacement)")
    return torch.rand((m, m), generator=generator).argsort(
        dim=1)[:, :num_peers]


def proxyfl_program(apply_fn, optimizer, fed: FedConfig,
                    num_peers: int = 3) -> RoundProgram:
    """Uniform random gossip distillation; the cache is the peer draw."""
    m = fed.num_clients

    def distill_from(state: FedState, data, ids, batch_idx):
        target = _peer_mean(apply_fn, state.params, data["x_ref"], ids)
        return _update_round(apply_fn, optimizer, fed, state,
                             _own_data_per(data), target,
                             _flag(m, True, target), batch_idx)

    def global_round(state: FedState, data, batch_idx=None, peer_ids=None):
        ids = peer_ids if peer_ids is not None else draw_peers(
            m, num_peers, round_generator(state.seed, state.round,
                                          PICK_STREAM))
        state, metrics = distill_from(state, data, ids, batch_idx)
        return state, ids, metrics

    def gossip_round(state: FedState, data, ids, batch_idx=None):
        state, metrics = distill_from(state, data, ids, batch_idx)
        return state, ids, metrics

    return RoundProgram("proxyfl", global_round, gossip_round)


def kdpdfl_program(apply_fn, optimizer, fed: FedConfig) -> RoundProgram:
    """Similarity-only selection: the top-N by output KL on each
    client's own reference set. The global round pays the M x M outputs
    (every model on every reference set, one nested vmap); gossip epochs
    reuse the cached ids at M*N forwards."""
    m = fed.num_clients
    n = min(fed.num_neighbors, m - 1)

    def global_round(state: FedState, data, batch_idx=None):
        with torch.no_grad():
            # y_all[i, j]: model j on client i's reference set (vmap
            # over reference sets i of vmap over models j)
            y_all = vmap(vmap(apply_fn, in_dims=(0, None)),
                         in_dims=(None, 0))(state.params, data["x_ref"])
        own = y_all.diagonal(dim1=0, dim2=1).movedim(-1, 0)  # (M, R, C)
        kls = verify.kl_divergence(own[:, None], y_all)       # (M, M)
        eye = torch.eye(m, dtype=torch.bool, device=kls.device)
        kls = torch.where(eye, torch.inf, kls)
        # the N smallest, ties by position (as lax.top_k of -kls)
        ids = torch.sort(kls, dim=1, stable=True).indices[:, :n]
        picked = torch.gather(
            y_all, 1, ids[:, :, None, None].expand(-1, -1,
                                                   *y_all.shape[2:]))
        state, metrics = _update_round(
            apply_fn, optimizer, fed, state, _own_data_per(data),
            picked.mean(1), _flag(m, True, kls), batch_idx)
        return state, ids, metrics

    def gossip_round(state: FedState, data, ids, batch_idx=None):
        target = _peer_mean(apply_fn, state.params, data["x_ref"], ids)
        state, metrics = _update_round(
            apply_fn, optimizer, fed, state, _own_data_per(data), target,
            _flag(m, True, target), batch_idx)
        return state, ids, metrics

    return RoundProgram("kdpdfl", global_round, gossip_round)


# ---------------------------------------------------------------------------
# classic per-round adapters
# ---------------------------------------------------------------------------
def make_silo_round(apply_fn, optimizer, fed: FedConfig):
    return program_round(silo_program(apply_fn, optimizer, fed))


def make_fedmd_round(apply_fn, optimizer, fed: FedConfig, shared_ref_x):
    return program_round(fedmd_program(apply_fn, optimizer, fed,
                                       shared_ref_x))


def make_proxyfl_round(apply_fn, optimizer, fed: FedConfig,
                       num_peers: int = 3):
    return program_round(proxyfl_program(apply_fn, optimizer, fed,
                                         num_peers=num_peers))


def make_kdpdfl_round(apply_fn, optimizer, fed: FedConfig):
    return program_round(kdpdfl_program(apply_fn, optimizer, fed))


BASELINES = {
    "silo": make_silo_round,
    "fedmd": make_fedmd_round,
    "proxyfl": make_proxyfl_round,
    "kdpdfl": make_kdpdfl_round,
}

BASELINE_PROGRAMS = {
    "silo": silo_program,
    "fedmd": fedmd_program,
    "proxyfl": proxyfl_program,
    "kdpdfl": kdpdfl_program,
}
