"""Personalized serving front. Counterpart of `repro/service/serving.py`.

WPFed's output is M personalized models stacked on the client axis of the
federation state. `PersonalizedServer` batches requests across clients:
it gathers the requested clients' rows of the stacked params and runs one
`torch.func.vmap` of the single-example forward over the whole batch
(`functional_call` under the hood), so requests for different clients
share one call.

The JAX server pads batches up to a ladder of bucket sizes to bound XLA
recompiles. Eager PyTorch compiles nothing per shape, so this server
does not pad: a queue is served in chunks of at most `max_batch`
requests, and the `padded_slots` statistic stays 0 (kept so both
servers report the same keys).

The server reads params by reference and `update_params` swaps them
between periods: the service serves period t's models while period t+1
trains.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis.privacy import declassifier, sink
from repro_torch.tree import tree_leaves, tree_map


@declassifier(
    name="served-logits", paper_eq="§2.1 (personalized model outputs)",
    justification="output of client i's OWN personalized model on the "
                  "requester's input — serving a client its own "
                  "predictions is the product of the federation, not a "
                  "cross-client disclosure")
def served_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits


class PersonalizedServer:
    """Batched inference over the federation's per-client models.

    apply_fn(params_i, x) -> logits: one client's forward over a batch of
    examples (the contract of `core.protocol`). `params` is the stacked
    (M, ...) dict of FedState."""

    def __init__(self, apply_fn: Callable, params: Any, *,
                 max_batch: int = 256):
        if max_batch < 1:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self._apply_fn = apply_fn
        self._max_batch = int(max_batch)
        self._params = params
        self._num_clients = tree_leaves(params)[0].shape[0]
        self._queue: List[Tuple[int, torch.Tensor]] = []
        self.stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "padded_slots": 0,
            "total_s": 0.0, "latency_s": []}

    # -- request path ------------------------------------------------------
    def submit(self, client_id: int, x) -> int:
        """Enqueue one request (a single example for `client_id`'s
        personalized model). Returns its position in the next flush."""
        if not 0 <= client_id < self._num_clients:
            raise ValueError(
                f"client_id {client_id} outside the client axis "
                f"[0, {self._num_clients})")
        self._queue.append((int(client_id), torch.as_tensor(x)))
        return len(self._queue) - 1

    def flush(self) -> List[np.ndarray]:
        """Serve every queued request; returns one logits array per
        request, in submit order, in chunks of at most `max_batch`."""
        out: List[np.ndarray] = []
        while self._queue:
            chunk = self._queue[:self._max_batch]
            del self._queue[:len(chunk)]
            out.extend(self._serve_chunk(chunk))
        return out

    @torch.no_grad()
    def _forward(self, ids: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Logits (B, C) of request b from client ids[b]'s model on x[b]:
        the clients' rows gathered, one vmapped single-example forward."""
        rows = tree_map(lambda p: p[ids], self._params)
        out = torch.func.vmap(
            lambda p, xi: self._apply_fn(p, xi[None])[0])(rows, x)
        return sink("serving-response", served_logits(out))

    def _serve_chunk(self, chunk):
        dev = tree_leaves(self._params)[0].device
        ids = torch.tensor([c for c, _ in chunk], device=dev)
        x = torch.stack([xi for _, xi in chunk]).to(dev)
        t0 = time.perf_counter()
        logits = self._forward(ids, x).cpu().numpy()  # analysis: host-ok reply
        dt = time.perf_counter() - t0
        self.stats["requests"] += len(chunk)
        self.stats["batches"] += 1
        self.stats["total_s"] += dt
        self.stats["latency_s"].append(dt)
        return [logits[i] for i in range(len(chunk))]

    # -- federation integration -------------------------------------------
    def update_params(self, params: Any) -> None:
        """Hot-swap to a new period's models. The client axis must not
        change (churn is masking)."""
        if tree_leaves(params)[0].shape[0] != self._num_clients:
            raise ValueError("client axis changed; build a new server")
        self._params = params

    def throughput(self) -> Dict[str, float]:
        """Summary statistics; a batch's latency is its host wall time
        around the forward and the copy of its logits to the host."""
        lat = self.stats["latency_s"]
        total = max(self.stats["total_s"], 1e-9)
        return {
            "requests": float(self.stats["requests"]),
            "batches": float(self.stats["batches"]),
            "padded_slots": float(self.stats["padded_slots"]),
            "requests_per_s": self.stats["requests"] / total,
            "mean_batch_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "p95_latency_s": float(np.percentile(lat, 95)) if lat else 0.0,
        }
