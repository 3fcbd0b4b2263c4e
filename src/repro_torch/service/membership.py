"""Membership and churn over a fixed padded client axis.
Counterpart of `repro/service/membership.py`.

The client axis stays M wide and membership is a mask. A departed
client keeps its slot (params, codes, rankings stay in the tensors) but

  * is excluded from every peer's Eq. 6-8 top-N (its score column is
    forced to -inf: `neighbor.select_partners(active=...)`),
  * stops reporting rankings (reporter_mask &= active, §3.6),
  * stops training (`update_phase(participate=...)` freezes its params
    and optimizer state), and
  * stops announcing (codes, rankings, commitments frozen; its
    `code_age` grows one per period).

A joining client flips its bit back on: it re-enters with the codes it
last announced (possibly several periods stale) and `code_age > 0`,
which Eq. 8 discounts by exp(-staleness_lambda * age) until its next
announcement resets the age to 0. Churn is masking, never a reshape:
join and leave are host-side state edits between periods.

`gossip_count` is the per-client gossip budget G_i: in a period of
length L, client i trains in the global round and the first G_i - 1
gossip epochs, then idles (params frozen, still answering peers'
exchanges).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple

import torch

from repro_torch.core.protocol import FedState

EVENT_KINDS = ("join", "leave")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-layer knobs on top of FedConfig (which keeps the
    protocol's hyperparameters)."""
    reselect_every: int = 4        # period length L (rounds per segment)
    staleness_lambda: float = 0.5  # Eq. 8 discount exp(-lambda * age)
    checkpoint_every: int = 1      # periods between durable checkpoints
    keep_last_k: int = 3           # checkpoint retention

    def __post_init__(self):
        if self.reselect_every < 1:
            raise ValueError(
                f"reselect_every must be >= 1, got {self.reselect_every}")
        if self.staleness_lambda < 0:
            raise ValueError(
                f"staleness_lambda must be >= 0, got "
                f"{self.staleness_lambda}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got "
                f"{self.checkpoint_every}")
        if self.keep_last_k < 1:
            raise ValueError(
                f"keep_last_k must be >= 1, got {self.keep_last_k}")


class ServiceState(NamedTuple):
    """FedState plus the membership layer, one tree, so the whole state
    checkpoints through `checkpoint.store`."""
    fed: FedState
    active: torch.Tensor        # (M,) bool — current members
    code_age: torch.Tensor      # (M,) int32 — periods since last announce
    gossip_count: torch.Tensor  # (M,) int32 — per-client G_i in [1, L]
    period_start: int           # round of this period's global round


class ChurnEvent(NamedTuple):
    """A membership change applied at the start of `period`."""
    period: int
    kind: str                  # "join" | "leave"
    client: int


def init_service_state(fed_state: FedState, svc: ServiceConfig, *,
                       active=None, gossip_counts=None) -> ServiceState:
    """Wrap a freshly initialized FedState for the service driver.

    active: optional (M,) bool initial membership (default: everyone).
    gossip_counts: optional per-client G_i sequence, clamped to
    [1, reselect_every] (default: the full period for everyone)."""
    m = fed_state.codes.shape[0]
    dev = fed_state.codes.device
    if active is None:
        active = torch.ones((m,), dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active, dtype=torch.bool).to(dev)
        if tuple(active.shape) != (m,):
            raise ValueError(
                f"active mask shape {tuple(active.shape)} != ({m},)")
    if gossip_counts is None:
        counts = torch.full((m,), svc.reselect_every, dtype=torch.int32,
                            device=dev)
    else:
        counts = torch.as_tensor(gossip_counts, dtype=torch.int32).clamp(
            1, svc.reselect_every).to(dev)
        if tuple(counts.shape) != (m,):
            raise ValueError(
                f"gossip_counts shape {tuple(counts.shape)} != ({m},)")
    return ServiceState(fed_state, active,
                        torch.zeros((m,), dtype=torch.int32, device=dev),
                        counts, 0)


# ---------------------------------------------------------------------------
# churn events
# ---------------------------------------------------------------------------
def _set_active(state: ServiceState, client: int, on: bool) -> ServiceState:
    active = state.active.clone()
    active[client] = on
    return state._replace(active=active)


def join(state: ServiceState, client: int) -> ServiceState:
    """Flip a slot's membership on. Idempotent. The client re-enters
    with its last-announced (stale) codes and its accumulated code_age;
    selection discounts it until it announces again."""
    return _set_active(state, client, True)


def leave(state: ServiceState, client: int) -> ServiceState:
    """Flip a slot's membership off. Idempotent. Params stay in the
    padded slot (the client may rejoin; its model stays servable)."""
    return _set_active(state, client, False)


def validate_events(events: Iterable[ChurnEvent],
                    num_clients: int) -> List[ChurnEvent]:
    out = []
    for ev in events:
        ev = ChurnEvent(*ev)
        if ev.kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind: {ev.kind!r} "
                             f"(expected one of {EVENT_KINDS})")
        if not 0 <= ev.client < num_clients:
            raise ValueError(
                f"churn event client {ev.client} outside the padded "
                f"client axis [0, {num_clients})")
        if ev.period < 0:
            raise ValueError(f"churn event period must be >= 0, got "
                             f"{ev.period}")
        out.append(ev)
    return out


def apply_events(state: ServiceState, events: Iterable[ChurnEvent],
                 period: int) -> ServiceState:
    """Apply every event scheduled for `period`, in list order (the
    replay order kill/resume relies on)."""
    for ev in events:
        if ev.period != period:
            continue
        state = join(state, ev.client) if ev.kind == "join" \
            else leave(state, ev.client)
    return state


def parse_events(spec: str) -> List[ChurnEvent]:
    """Parse the CLI churn spec: "1:leave:4,2:join:5" ->
    [ChurnEvent(1, "leave", 4), ChurnEvent(2, "join", 5)]."""
    events = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        parts = item.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad churn event {item!r} (want period:kind:client)")
        events.append(ChurnEvent(int(parts[0]), parts[1], int(parts[2])))
    return events


# ---------------------------------------------------------------------------
# masks read by the service round program
# ---------------------------------------------------------------------------
def staleness_discount(code_age: torch.Tensor,
                       staleness_lambda: float) -> torch.Tensor:
    """Eq. 8 score multiplier exp(-lambda * age) per client: a client
    whose published code is `age` periods old carries less selection
    weight. Computed in f32 on the CPU and moved to the ages' device, as
    `kernels.ref.selection_lut` builds the Eq. 8 table, so the card and
    the CPU scale scores identically."""
    age = code_age.detach().to(  # analysis: host-ok exp on the CPU
        "cpu", torch.float32)
    return torch.exp(-staleness_lambda * age).to(code_age.device)


def participation_mask(state: ServiceState, epoch: int) -> torch.Tensor:
    """(M,) bool — who trains in gossip epoch `epoch` (0-based within the
    period): active members whose budget G_i covers the global round
    and `epoch + 1` gossip epochs."""
    return state.active & (epoch < state.gossip_count - 1)


# ---------------------------------------------------------------------------
# degraded rounds
# ---------------------------------------------------------------------------
def mask_stragglers(state: ServiceState, stragglers) -> ServiceState:
    """Treat this period's stragglers as departed for ONE segment: the
    round proceeds on partial announcements through the same -inf score /
    update freeze / announce freeze masking that join and leave use, so
    a round with k stragglers equals one where those k clients left and
    rejoined. The driver restores the real membership after the
    segment."""
    strag = torch.as_tensor(stragglers, dtype=torch.bool).to(
        state.active.device)
    return state._replace(active=state.active & ~strag)


def merge_delivery(state: ServiceState, pre_codes, pre_rankings,
                   pre_commitments, pre_age, *, failed,
                   delayed) -> ServiceState:
    """Reconcile the round's announcement merge with what the bulletin
    board accepted (`transport.collect` verdicts).

    `failed` clients (dropped or checksum-rejected): the board kept their
    last block, so their codes / rankings / commitments revert to the
    pre-segment snapshot and their code_age grows one period. `delayed`
    clients: the fresh announcement stands, but it landed past the
    selection deadline, so next period's Eq. 8 weight sees
    code_age >= 1. With all-False masks every `torch.where` is a bitwise
    no-op."""
    fed = state.fed
    dev = fed.codes.device
    failed = torch.as_tensor(failed, dtype=torch.bool).to(dev)
    delayed = torch.as_tensor(delayed, dtype=torch.bool).to(dev)
    codes = torch.where(failed[:, None], pre_codes, fed.codes)
    rankings = torch.where(failed[:, None], pre_rankings, fed.rankings)
    commitments = torch.where(failed, pre_commitments, fed.commitments)
    age = torch.where(failed, pre_age + 1, state.code_age)
    age = torch.where(delayed & ~failed, age.clamp(min=1), age)
    return state._replace(
        fed=fed._replace(codes=codes, rankings=rankings,
                         commitments=commitments),
        code_age=age)
