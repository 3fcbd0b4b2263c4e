"""The WPFed round (Algorithm 1) in four phases.
Counterpart of `repro/core/protocol.py`.

  select_phase    §3.6 reveal verification + Eq. 6-8 fused neighbour
                  selection (steps 1-3)
  exchange_phase  reference-set forwards, then the all-in-one Eq. 3 +
                  §3.5 + distillation-target pass (steps 4-6a)
  update_phase    local Adam steps on the combined objective (Alg. 1
                  l.19, step 6b)
  announce_phase  next round's LSH codes, rankings, commitments (step 7)

`wpfed_program` composes them into a `core.rounds.RoundProgram`: the
global round (all four phases) and the gossip epoch (exchange + update
against the cached `SelectResult`); each phase runs in a profiler span
named "wpfed.<phase>" (a no-op without an active profiler), which
`chip_smoke.py` reads for the per-phase breakdown. The M clients'
parameters are a dict of stacked (M, ...) tensors; forwards and updates
loop over clients with `apply_fn(params_i, x)`. Randomness comes from
`torch.Generator`s derived from the federation seed and the round index
(`round_generator`), drawn on the CPU so that a run draws the same
numbers on every device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.paper_models import FedConfig
from repro_torch.core import distill, lsh, neighbor, ranking, verify
from repro_torch.core.chain import fnv1a_commit
from repro_torch.core.exchange import ExchangeResult, all_in_one_exchange
from repro_torch.core.rounds import RoundProgram
from repro_torch.kernels.ops import MASK32
from repro_torch.optim.optimizers import Optimizer, apply_updates

REF_MODES = ("personal", "public")
# random streams of one round
SELECT_STREAM, UPDATE_STREAM = 0, 1


class FedState(NamedTuple):
    params: Dict[str, torch.Tensor]   # stacked (M, ...)
    opt_state: Any                    # stacked (M, ...)
    codes: torch.Tensor        # (M, W) int32 — published LSH codes
    rankings: torch.Tensor     # (M, N) int32 — this round's reveals
    commitments: torch.Tensor  # (M,) int64 in [0, 2^32) — FNV commitments
    seed: int                  # federation seed (round generators)
    round: int


class SelectResult(NamedTuple):
    """Output of select_phase: who talks to whom this round."""
    ids: torch.Tensor            # (M, N) int32
    sel_mask: torch.Tensor       # (M, N) bool
    scores: torch.Tensor         # (M,) f32 — Eq. 7 ranking scores
    reporter_mask: torch.Tensor  # (M,) bool — §3.6 honest reporters


class Announcement(NamedTuple):
    """Output of announce_phase: next round's published state."""
    codes: torch.Tensor
    rankings: torch.Tensor
    commitments: torch.Tensor


def round_generator(seed: int, round_idx: int, stream: int) -> torch.Generator:
    """The CPU generator of one (seed, round, stream)."""
    g = torch.Generator()
    g.manual_seed(((seed & MASK32) << 32) | ((4 * round_idx + stream)
                                             & MASK32))
    return g


def tree_map(fn, tree, *rest):
    """Map over the leaves of nested dicts (params, optimizer state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def client(tree, i: int):
    """Client i's slice of a stacked (M, ...) tree."""
    return tree_map(lambda t: t[i], tree)


def stack(trees):
    """Stack a list of per-client trees on a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def init_state(init_fn: Callable[[torch.Generator], Dict[str, torch.Tensor]],
               optimizer: Optimizer, fed: FedConfig, seed: int) -> FedState:
    """init_fn(generator) -> one client's params (on the run's device);
    the M clients are drawn in order from one generator seeded `seed`."""
    m = fed.num_clients
    g = torch.Generator()
    g.manual_seed(seed)
    clients = [init_fn(g) for _ in range(m)]
    params = stack(clients)
    opt_state = stack([optimizer.init(p) for p in clients])
    # round-0 codes use the round-0 LSH seed (see announce_phase)
    codes = lsh.stacked_lsh_codes(params, seed=0, bits=fed.lsh_bits,
                                  backend=fed.selection_backend)
    n = min(fed.num_neighbors, m - 1)
    rankings = torch.full((m, n), -1, dtype=torch.int32, device=codes.device)
    return FedState(params, opt_state, codes, rankings,
                    fnv1a_commit(rankings, salt=0), seed, 0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def select_phase(state: FedState, fed: FedConfig, *,
                 generator: torch.Generator = None) -> SelectResult:
    """Steps 1-3: §3.6 reveal verification -> Eq. 7 ranking scores ->
    fused Eq. 6-8 top-N partner selection. `generator` is consumed only
    by the random-selection ablation (use_lsh=False, use_rank=False);
    the round index seeds the ANN bucket permutation."""
    m = fed.num_clients
    if fed.rank_verification:
        reporter_mask = verify.verify_rankings_fnv(state.rankings,
                                                   state.commitments)
    else:
        reporter_mask = torch.ones((m,), dtype=torch.bool,
                                   device=state.codes.device)
    scores = ranking.ranking_scores(
        torch.where(reporter_mask[:, None], state.rankings, -1),
        m, fed.top_k, dedupe=fed.dedupe_rankings)
    ids, sel_mask = neighbor.select_partners(state.codes, scores, fed,
                                             generator=generator,
                                             seed=state.round)
    return SelectResult(ids, sel_mask, scores, reporter_mask)


@torch.no_grad()
def exchange_phase(apply_fn: Callable, fed: FedConfig, params,
                   data: Dict[str, torch.Tensor],
                   sel: SelectResult) -> ExchangeResult:
    """Steps 4-6a: evaluate reference sets and run the all-in-one
    exchange.

    ref_mode="personal": neighbours answer each client's OWN reference
    set (M*N neighbour forwards). ref_mode="public": every client
    evaluates the shared reference set (row 0 of data["x_ref"]) once and
    the (M, N, R, C) web is a gather of those M outputs."""
    if fed.ref_mode not in REF_MODES:
        raise ValueError(f"unknown ref_mode: {fed.ref_mode!r} "
                         f"(expected one of {REF_MODES})")
    m = fed.num_clients
    ids = sel.ids.tolist()
    if fed.ref_mode == "public":
        x_shared = data["x_ref"][0]
        own_ref = torch.stack([apply_fn(client(params, i), x_shared)
                               for i in range(m)])
        y_web = own_ref[sel.ids.to(torch.int64)]
        y_ref = data["y_ref"][0][None].expand(m, -1)
    else:
        x_ref = data["x_ref"]
        own_ref = torch.stack([apply_fn(client(params, i), x_ref[i])
                               for i in range(m)])
        rows = [[apply_fn(client(params, j), x_ref[i]) for j in ids[i]]
                for i in range(m)]
        y_web = (torch.stack([torch.stack(r) for r in rows]) if ids[0]
                 else own_ref.new_zeros((m, 0) + own_ref.shape[1:]))
        y_ref = data["y_ref"]
    return all_in_one_exchange(own_ref, y_web, y_ref, sel.sel_mask, fed)


def update_phase(apply_fn: Callable, optimizer: Optimizer, fed: FedConfig,
                 params, opt_state, data: Dict[str, torch.Tensor],
                 exch: ExchangeResult, generator: torch.Generator = None,
                 batch_idx: torch.Tensor = None):
    """Step 6b: `local_steps` minibatch Adam steps per client on the
    combined objective (Alg. 1 l.19), distilling toward the exchange's
    target. `batch_idx` (M, local_steps, mb) int fixes the minibatch
    indices (the parity tests pass the JAX package's); by default they
    are drawn from `generator`. Returns (params, opt_state,
    train_metrics) with the last step's losses per client."""
    m = fed.num_clients
    n_local = data["x_train"].shape[1]
    mb = min(fed.local_batch, n_local)
    if batch_idx is None:
        batch_idx = torch.randint(0, n_local, (m, fed.local_steps, mb),
                                  generator=generator)
    batch_idx = batch_idx.to(device=data["x_train"].device,
                             dtype=torch.int64)
    if fed.ref_mode == "public":        # distil on the shared set
        x_ref = data["x_ref"][0][None].expand(m, *data["x_ref"].shape[1:])
    else:
        x_ref = data["x_ref"]
    new_params, new_opt, losses = [], [], []
    for i in range(m):
        p, s = client(params, i), client(opt_state, i)
        for step in range(fed.local_steps):
            idx = batch_idx[i, step]
            batch = {"x": data["x_train"][i][idx],
                     "y": data["y_train"][i][idx]}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            loss, (l_loc, l_ref) = distill.combined_loss(
                apply_fn, leaves, batch, x_ref[i], exch.target_ref[i],
                exch.has_target[i], fed.alpha)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            updates, s = optimizer.update(grads, s, p)
            p = apply_updates(p, updates)
        new_params.append(p)
        new_opt.append(s)
        losses.append(torch.stack([loss, l_loc, l_ref]).detach())
    losses = torch.stack(losses)
    metrics = {"loss": losses[:, 0], "local_loss": losses[:, 1],
               "ref_loss": losses[:, 2]}
    return stack(new_params), stack(new_opt), metrics


def announce_phase(fed: FedConfig, params, sel: SelectResult,
                   exch: ExchangeResult, round_idx: int) -> Announcement:
    """Step 7: codes for round r+1 hash with the shared per-round seed
    r+1 (every client projects with the same matrix; the projection
    rotates each round), rankings by ascending l_ij, commitments."""
    codes = lsh.stacked_lsh_codes(params, seed=round_idx + 1,
                                  bits=fed.lsh_bits,
                                  backend=fed.selection_backend)
    rankings = ranking.make_ranking(sel.ids, exch.l_ij, sel.sel_mask)
    return Announcement(codes, rankings, fnv1a_commit(rankings, salt=0))


# ---------------------------------------------------------------------------
# the composed round program
# ---------------------------------------------------------------------------
def _round_metrics(sel: SelectResult, exch: ExchangeResult, train_metrics,
                   round_idx: int) -> Dict[str, Any]:
    n_sel = sel.sel_mask.to(torch.float32).sum()
    return {
        "round": round_idx,
        "mean_loss": train_metrics["loss"].mean(),
        "mean_local_loss": train_metrics["local_loss"].mean(),
        "mean_ref_loss": train_metrics["ref_loss"].mean(),
        # mean over the SELECTED slots only
        "mean_neighbor_loss": (
            torch.where(sel.sel_mask, exch.l_ij, 0.0).sum()
            / n_sel.clamp(min=1.0)),
        "valid_neighbor_frac": exch.valid_mask.to(torch.float32).mean(),
        "honest_reporter_frac": sel.reporter_mask.to(torch.float32).mean(),
        "neighbor_ids": sel.ids,
        "valid_mask": exch.valid_mask,
        "ranking_scores": sel.scores,
    }


def wpfed_program(apply_fn: Callable, optimizer: Optimizer,
                  fed: FedConfig) -> RoundProgram:
    """WPFed as a round program: global_round is Algorithm 1 (all four
    phases; its cache is the round's `SelectResult`), gossip_round the
    exchange + update epoch against the cached selection, with codes,
    rankings and commitments frozen. global_round accepts `batch_idx`
    (see update_phase)."""

    def global_round(state: FedState, data, batch_idx=None
                     ) -> Tuple[FedState, SelectResult, Dict]:
        with record_function("wpfed.select"):
            sel = select_phase(state, fed, generator=round_generator(
                state.seed, state.round, SELECT_STREAM))
        with record_function("wpfed.exchange"):
            exch = exchange_phase(apply_fn, fed, state.params, data, sel)
        with record_function("wpfed.update"):
            params, opt_state, train_metrics = update_phase(
                apply_fn, optimizer, fed, state.params, state.opt_state,
                data, exch, round_generator(state.seed, state.round,
                                            UPDATE_STREAM),
                batch_idx=batch_idx)
        with record_function("wpfed.announce"):
            ann = announce_phase(fed, params, sel, exch, state.round)
        metrics = _round_metrics(sel, exch, train_metrics, state.round)
        new_state = FedState(params, opt_state, ann.codes, ann.rankings,
                             ann.commitments, state.seed, state.round + 1)
        return new_state, sel, metrics

    def gossip_round(state: FedState, data, sel: SelectResult
                     ) -> Tuple[FedState, SelectResult, Dict]:
        with record_function("wpfed.exchange"):
            exch = exchange_phase(apply_fn, fed, state.params, data, sel)
        with record_function("wpfed.update"):
            params, opt_state, train_metrics = update_phase(
                apply_fn, optimizer, fed, state.params, state.opt_state,
                data, exch, round_generator(state.seed, state.round,
                                            UPDATE_STREAM))
        metrics = _round_metrics(sel, exch, train_metrics, state.round)
        return (state._replace(params=params, opt_state=opt_state,
                               round=state.round + 1), sel, metrics)

    return RoundProgram("wpfed", global_round, gossip_round)


@torch.no_grad()
def evaluate(apply_fn: Callable, state: FedState,
             data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-client test accuracy and its mean."""
    acc = torch.stack([
        distill.accuracy(apply_fn(client(state.params, i),
                                  data["x_test"][i]), data["y_test"][i])
        for i in range(state.codes.shape[0])])
    return {"per_client_acc": acc, "mean_acc": acc.mean()}
