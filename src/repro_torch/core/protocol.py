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
against the cached `SelectResult`); `make_wpfed_round` is the classic
sync adapter over it. The per-client update (`local_update`,
`batched_local_update`) is shared with `core.baselines`. Each phase
runs in a profiler span named "wpfed.<phase>" (a no-op without an
active profiler), which `chip_smoke.py` reads for the per-phase
breakdown. The M clients' parameters are a dict of stacked (M, ...)
tensors. As in the JAX round, the client axis is one batched call:
`apply_fn(params_i, x)` is one client's forward, and every phase maps it
over the stacked params with `torch.func.vmap` (the personal exchange's
(M, N) neighbour web as a nested vmap over gathered params); the local
update is one vmapped `torch.func.grad_and_value` and one vmapped
optimizer update per local step, over fixed chunks of the client axis
(`client_chunk`) where one call over all M would not fit. `apply_fn`
must therefore run under `vmap` and `grad`: no in-place write to a
captured tensor, no host read, no Python branch on a value. Randomness
comes from `torch.Generator`s derived from the federation seed and the
round index (`round_generator`), drawn on the CPU so that a run draws
the same numbers on every device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch.analysis.privacy import sink
from repro_torch.configs.paper_models import FedConfig
from repro_torch.core import distill, lsh, neighbor, ranking, verify
from repro_torch.core.chain import fnv1a_commit
from repro_torch.core.exchange import (ExchangeResult, all_in_one_exchange,
                                       public_ref_logits)
from repro_torch.core.rounds import RoundProgram, program_round
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

REF_MODES = ("personal", "public")
# random streams of one round (PICK_STREAM: ProxyFL's peer draw)
SELECT_STREAM, UPDATE_STREAM, PICK_STREAM = 0, 1, 2


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


MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def seeded_generator(*parts: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers. torch's CPU
    generator keeps only the low 32 bits of its seed, so the parts are
    mixed (splitmix64 steps) into one 32-bit seed, not packed side by
    side."""
    h = 0
    for part in parts:
        h = _splitmix64(h ^ (part & MASK64))
    g = torch.Generator()
    g.manual_seed(h >> 32)
    return g


def round_generator(seed: int, round_idx: int, stream: int) -> torch.Generator:
    """The CPU generator of one (seed, round, stream)."""
    return seeded_generator(seed, round_idx, stream)


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
                 generator: torch.Generator = None,
                 active: torch.Tensor = None,
                 score_scale: torch.Tensor = None) -> SelectResult:
    """Steps 1-3: §3.6 reveal verification -> Eq. 7 ranking scores ->
    fused Eq. 6-8 top-N partner selection. `generator` is consumed only
    by the random-selection ablation (use_lsh=False, use_rank=False);
    the round index seeds the ANN bucket permutation.

    The service threads two masks: `active` (M,) bool drops departed
    clients from both sides of the round (their rankings stop counting
    as Eq. 7 evidence, reporter_mask &= active, and
    `neighbor.select_partners` sets their score column to -inf);
    `score_scale` (M,) f32 multiplies the Eq. 7 scores (the staleness
    discount of re-joiners whose codes are periods old). Both default to
    no-ops."""
    m = fed.num_clients
    if fed.rank_verification:
        reporter_mask = verify.verify_rankings_fnv(state.rankings,
                                                   state.commitments)
    else:
        reporter_mask = torch.ones((m,), dtype=torch.bool,
                                   device=state.codes.device)
    if active is not None:
        reporter_mask = reporter_mask & active.to(reporter_mask.device)
    scores = ranking.ranking_scores(
        torch.where(reporter_mask[:, None], state.rankings, -1),
        m, fed.top_k, dedupe=fed.dedupe_rankings)
    if score_scale is not None:
        scores = scores * score_scale.to(scores.device)
    ids, sel_mask = neighbor.select_partners(state.codes, scores, fed,
                                             generator=generator,
                                             seed=state.round, active=active)
    return SelectResult(ids, sel_mask, scores, reporter_mask)


@torch.no_grad()
def exchange_phase(apply_fn: Callable, fed: FedConfig, params,
                   data: Dict[str, torch.Tensor],
                   sel: SelectResult) -> ExchangeResult:
    """Steps 4-6a: evaluate reference sets and run the all-in-one
    exchange.

    ref_mode="personal": neighbours answer each client's OWN reference
    set: the (M, N, R, C) web is one nested vmap over the gathered
    neighbour params (M, N, ...), the M * N forwards of the JAX round.
    ref_mode="public": every client evaluates the shared reference set
    (row 0 of data["x_ref"]) once and the web is a gather of those M
    outputs. The clients' own forwards are one vmap either way."""
    if fed.ref_mode not in REF_MODES:
        raise ValueError(f"unknown ref_mode: {fed.ref_mode!r} "
                         f"(expected one of {REF_MODES})")
    m = fed.num_clients
    ids = sel.ids.to(torch.int64)
    if fed.ref_mode == "public":
        own_ref = vmap(apply_fn, in_dims=(0, None))(params,
                                                    data["x_ref"][0])
        y_web = public_ref_logits(own_ref[ids])
        y_ref = data["y_ref"][0][None].expand(m, -1)
    else:
        x_ref = data["x_ref"]
        own_ref = vmap(apply_fn)(params, x_ref)
        y_web = public_ref_logits(
            neighbour_web(apply_fn, params, x_ref, ids) if ids.shape[1]
            else own_ref.new_zeros((m, 0) + own_ref.shape[1:]))
        y_ref = data["y_ref"]
    return all_in_one_exchange(own_ref, y_web, y_ref, sel.sel_mask, fed)


def neighbour_web(apply_fn: Callable, params, x_ref: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """(M, N, R, ...): neighbour ids[i, j]'s outputs on client i's
    reference set x_ref[i], one nested vmap over the gathered (M, N, ...)
    params (vmap over clients i of vmap over their neighbours j), over
    chunks of `client_chunk` rows i where all M would not fit (a row's
    share: its N gathered params and the bytes of N forwards)."""
    m, n = ids.shape
    one = tree_map(lambda t: t[0], params)
    row = n * (written_bytes(("forward", apply_fn), apply_fn, one, x_ref[0])
               + sum(t.numel() * t.element_size() for t in tree_leaves(one)))
    chunk = client_chunk(row)
    web = vmap(vmap(apply_fn, in_dims=(0, None)))
    return torch.cat([
        web(tree_map(lambda p: p[ids[c0:c0 + chunk]], params),
            x_ref[c0:c0 + chunk]) for c0 in range(0, m, chunk)])


def update_phase(apply_fn: Callable, optimizer: Optimizer, fed: FedConfig,
                 params, opt_state, data: Dict[str, torch.Tensor],
                 exch: ExchangeResult, generator: torch.Generator = None,
                 batch_idx: torch.Tensor = None,
                 participate: torch.Tensor = None):
    """Step 6b: `local_steps` minibatch Adam steps per client on the
    combined objective (Alg. 1 l.19), distilling toward the exchange's
    target (`batched_local_update`). `batch_idx` (M, local_steps, mb)
    int fixes the minibatch indices (the parity tests pass the JAX
    package's); by default they are drawn from `generator`. Returns
    (params, opt_state, train_metrics) with the last step's losses per
    client.

    `participate` (M,) bool freezes non-participants (the service's
    departed clients and spent gossip budgets): their params and
    optimizer state come back bitwise unchanged. As in the JAX package,
    every client's update is still computed and then masked out, so the
    loss metrics keep their meaning and the minibatch draws (one call
    for all M clients) do not depend on who participates; `None` (all
    participate) is the plain round."""
    m = fed.num_clients
    data_per = {k: data[k] for k in ("x_train", "y_train", "x_ref")}
    if fed.ref_mode == "public":        # distil on the shared set
        data_per["x_ref"] = data["x_ref"][0][None].expand(
            m, *data["x_ref"].shape[1:])
    new_params, new_opt, metrics = batched_local_update(
        apply_fn, optimizer, fed, params, opt_state, data_per,
        exch.target_ref, exch.has_target, generator=generator,
        batch_idx=batch_idx)
    if participate is not None:
        part = participate.to(exch.has_target.device)

        def keep(new, old):
            return torch.where(part.reshape((m,) + (1,) * (new.ndim - 1)),
                               new, old)

        new_params = tree_map(keep, new_params, params)
        new_opt = tree_map(keep, new_opt, opt_state)
    return new_params, new_opt, metrics


def announce_phase(fed: FedConfig, params, sel: SelectResult,
                   exch: ExchangeResult, round_idx: int) -> Announcement:
    """Step 7: codes for round r+1 hash with the shared per-round seed
    r+1 (every client projects with the same matrix; the projection
    rotates each round), rankings by ascending l_ij, commitments."""
    codes = lsh.stacked_lsh_codes(params, seed=round_idx + 1,
                                  bits=fed.lsh_bits,
                                  backend=fed.selection_backend)
    rankings = ranking.make_ranking(sel.ids, exch.l_ij, sel.sel_mask)
    # the round's disclosure point: every field crossing to the chain
    # must arrive declassified (repro_torch.analysis.taint checks it)
    return sink("chain-announcement",
                Announcement(codes, rankings, fnv1a_commit(rankings, salt=0)))


# ---------------------------------------------------------------------------
# local updates (shared with core.baselines)
# ---------------------------------------------------------------------------
# bytes that one vmapped call over a chunk of the client axis may write:
# a client's share is what the ops of its part of the call allocate
# (`written_bytes`, counted on meta from the call's shapes: an update's
# one local step, forward, backward and optimizer; a personal web row's
# N gathered params and N forwards). Written bytes over-count what is
# live at once, the more so without grad. Set where the readings on an
# H100 80GB hold: reduced-phi3 clients (mb 64, 8 reference sequences of
# 32 tokens) write 526 MiB a local step, so 64 a call (peak 68.1 GB
# beside 1,024 clients' params and Adam state; 128 read 79.3 GB), and
# 223 MiB a web row, so 256 rows a call (PERF.md, section 4)
CHUNK_BYTES = 64 << 30

_WRITTEN: Dict[Any, int] = {}


def written_bytes(key, fn: Callable, *args) -> int:
    """Bytes of the tensors that the ops of `fn(*args)` allocate (views
    and in-place results not counted), run on meta copies of `args`, so
    the shapes alone decide it. `key` names `fn`: with the shapes and
    dtypes of `args` it keys a cache, so each function and shape is
    traced once."""
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode
    leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    full = (key, tuple((tuple(t.shape), t.dtype) for t in leaves))
    if full not in _WRITTEN:
        class Count(TorchDispatchMode):
            total = 0

            def __torch_dispatch__(self, func, types, a=(), kw=None):
                out = func(*a, **(kw or {}))
                if not any(r.alias_info is not None
                           for r in func._schema.returns):
                    Count.total += sum(
                        t.numel() * t.element_size()
                        for t in pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
                return out

        with Count():
            fn(*tree_map(lambda t: torch.empty_like(t, device="meta")
                         if isinstance(t, torch.Tensor) else t, args))
        if len(_WRITTEN) >= 256:        # each key holds its fn alive
            _WRITTEN.clear()
        _WRITTEN[full] = Count.total
    return _WRITTEN[full]


def client_chunk(per_client: int) -> int:
    """Clients per vmapped call over a chunk of the client axis: the
    largest power of two (at least 1) whose clients' `per_client` bytes
    of temporaries fit in CHUNK_BYTES. It comes from the call's shapes
    alone, so that a run's numbers never depend on the device's free
    memory."""
    n = max(1, CHUNK_BYTES // max(per_client, 1))
    return 1 << (n.bit_length() - 1)


def local_update(apply_fn: Callable, optimizer: Optimizer, fed: FedConfig,
                 params, opt_state, data_i: Dict[str, torch.Tensor],
                 target_ref: torch.Tensor, has_target: torch.Tensor,
                 batch_idx: torch.Tensor):
    """`local_steps` minibatch steps on the combined loss for ONE client,
    the function `batched_local_update` vmaps over the client axis:
    params / opt_state one client's trees, data_i its x_train, y_train
    and x_ref, batch_idx (local_steps, mb) int64 on the data's device.
    Returns (params, opt_state, (loss, local_loss, ref_loss) of the last
    step)."""
    grad_fn = grad_and_value(
        lambda p, batch, x_ref, target, has: distill.combined_loss(
            apply_fn, p, batch, x_ref, target, has, fed.alpha), has_aux=True)
    p, s = params, opt_state
    for step in range(fed.local_steps):
        idx = batch_idx[step]
        grads, (loss, (l_loc, l_ref)) = grad_fn(
            p, {"x": data_i["x_train"][idx], "y": data_i["y_train"][idx]},
            data_i["x_ref"], target_ref, has_target)
        updates, s = optimizer.update(grads, s, p)
        p = apply_updates(p, updates)
    return p, s, torch.stack([loss, l_loc, l_ref])


def batched_local_update(apply_fn: Callable, optimizer: Optimizer,
                         fed: FedConfig, params, opt_state,
                         data_per: Dict[str, torch.Tensor],
                         target_ref: torch.Tensor, has_target: torch.Tensor,
                         *, generator: torch.Generator = None,
                         batch_idx: torch.Tensor = None):
    """`local_update` vmapped over the M clients of the stacked trees: per
    local step one batched `grad_and_value` of the combined loss, then
    the optimizer's update over the stacked state (a per-client `step`).
    data_per holds (M, ...) x_train, y_train and x_ref; target_ref (M,
    R, C), has_target (M,). `batch_idx` (M, local_steps, mb) fixes the
    minibatches, else they are drawn in one call from `generator`. The
    client axis runs in chunks of `client_chunk` clients (one client's
    share: the bytes its one local step writes), one after another, each
    chunk's new trees copied into the (M, ...) outputs; a client's steps
    do not depend on the chunk. Returns (params, opt_state, {"loss",
    "local_loss", "ref_loss"} (M,))."""
    m = fed.num_clients
    n_local = data_per["x_train"].shape[1]
    mb = min(fed.local_batch, n_local)
    if batch_idx is None:
        batch_idx = torch.randint(0, n_local, (m, fed.local_steps, mb),
                                  generator=generator)
    dev = data_per["x_train"].device
    batch_idx = batch_idx.to(device=dev, dtype=torch.int64)
    args = (params, opt_state, data_per, target_ref, has_target, batch_idx)
    one_step = dataclasses.replace(fed, local_steps=1)
    chunk = client_chunk(written_bytes(
        ("local_update", apply_fn, optimizer, one_step),
        functools.partial(local_update, apply_fn, optimizer, one_step),
        *tree_map(lambda t: t[0], args[:5]), batch_idx[0, :1]))
    update_fn = vmap(functools.partial(local_update, apply_fn, optimizer,
                                       fed))
    new, losses = None, []
    for c0 in range(0, m, chunk):
        part = slice(c0, c0 + chunk)
        p, s, loss = update_fn(*tree_map(lambda t: t[part], args))
        if chunk >= m:
            new = (p, s)
        else:
            if new is None:
                new = tree_map(lambda t: t.new_empty((m, *t.shape[1:])),
                               (p, s))
            tree_map(lambda out, t: out[part].copy_(t), new, (p, s))
        losses.append(loss)
    losses = torch.cat(losses)
    metrics = {"loss": losses[:, 0], "local_loss": losses[:, 1],
               "ref_loss": losses[:, 2]}
    return new[0], new[1], metrics


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
    rankings and commitments frozen. Both accept `batch_idx` (see
    update_phase)."""

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

    def gossip_round(state: FedState, data, sel: SelectResult,
                     batch_idx=None) -> Tuple[FedState, SelectResult, Dict]:
        with record_function("wpfed.exchange"):
            exch = exchange_phase(apply_fn, fed, state.params, data, sel)
        with record_function("wpfed.update"):
            params, opt_state, train_metrics = update_phase(
                apply_fn, optimizer, fed, state.params, state.opt_state,
                data, exch, round_generator(state.seed, state.round,
                                            UPDATE_STREAM),
                batch_idx=batch_idx)
        metrics = _round_metrics(sel, exch, train_metrics, state.round)
        return (state._replace(params=params, opt_state=opt_state,
                               round=state.round + 1), sel, metrics)

    return RoundProgram("wpfed", global_round, gossip_round)


def make_wpfed_round(apply_fn: Callable, optimizer: Optimizer,
                     fed: FedConfig):
    """Classic sync API: round_fn(state, data) -> (state, metrics), the
    adapter over `wpfed_program`'s global round."""
    return program_round(wpfed_program(apply_fn, optimizer, fed))


@torch.no_grad()
def evaluate(apply_fn: Callable, state: FedState,
             data: Dict[str, torch.Tensor],
             honest_mask: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """Per-client test accuracy and its mean; with `honest_mask` (M,)
    (bool or 0/1 floats) the mean runs over the honest clients only."""
    acc = vmap(distill.accuracy)(vmap(apply_fn)(state.params,
                                                data["x_test"]),
                                 data["y_test"])
    if honest_mask is None:
        return {"per_client_acc": acc, "mean_acc": acc.mean()}
    w = honest_mask.to(device=acc.device, dtype=torch.float32)
    return {"per_client_acc": acc,
            "mean_acc": (acc * w).sum() / w.sum().clamp(min=1.0)}
