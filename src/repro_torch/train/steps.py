"""Train, prefill and serve step factories for the transformer zoo (the
port of `repro/train/steps.py`).

The train step runs as the JAX package's does: the loss and gradients
through the training route of `forward` (attention by `_naive_attn` /
`_chunked_attn`, never the flash kernel, which has no backward), f32
gradient accumulation over microbatches, global-norm clipping and the
optimizer. Unlike the JAX step it updates params and optimizer state in
place (`Optimizer.apply`) and returns the same trees: a new tree of each
would not fit beside the old one on the card at Minitron-4B's width. The
JAX package's `unroll` / `scan_unroll` are knobs of its `lax.scan`; the
port loops in Python and has no counterpart.

With placed params (`sharding.place_params`) the step is tensor-parallel
(`sharding.tp`): the loss reads the vocabulary-split logits without
gathering them (`tp.cross_entropy`: the row max and two sums over
"model"), each gradient is reduced to its parameter's placements (one
all-reduce over the batch axes per leaf), and clipping and the
optimizer work on each rank's shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, prefill)
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm_
from repro_torch.sharding import tp
from repro_torch.tree import tree_leaves, tree_unflatten

MOE_AUX_WEIGHT = 0.01


def lm_loss(cfg: ModelConfig, params, batch, *, remat: str = "block",
            window_override: int = 0):
    """Mean next-token NLL (f32 log-softmax) plus the MoE auxiliary loss
    -> (loss, (ce, aux)), through the training route of `forward`."""
    extra = {k: batch[k] for k in ("audio", "vision") if k in batch}
    logits, aux = forward(cfg, params, batch["tokens"], extra or None,
                          remat=remat, window_override=window_override,
                          differentiable=True)
    if tp.placed(logits):
        labels = batch["labels"]
        if not tp.placed(labels):
            labels = tp.place_batch(labels, logits.device_mesh)
        ce = tp.mean(tp.cross_entropy(logits, labels))
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.take_along_dim(logp, batch["labels"][..., None].long(),
                                    dim=-1)[..., 0]
        ce = torch.mean(nll)
    return ce + MOE_AUX_WEIGHT * aux / max(cfg.num_layers, 1), (ce, aux)


def loss_and_grads(cfg: ModelConfig, params, batch, *, remat: str = "block",
                   grad_accum: int = 1):
    """((loss, ce, aux), grads): the gradient of `lm_loss` with respect to
    every leaf of `params` (a tree like it). With grad_accum > 1 the batch
    splits along its first axis into grad_accum microbatches of
    consecutive rows (the JAX reshape), and the f32 sum of each
    microbatch's grads / grad_accum is returned, with the losses averaged
    the same way."""
    leaves = tree_leaves(params)

    def grad_fn(mb):
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in leaves]
            loss, (ce, aux) = lm_loss(cfg, tree_unflatten(params, xs), mb,
                                      remat=remat)
            gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True)
        # placed params: each gradient reduced over the batch axes
        gs = [tp.redistribute(g, p.placements) if tp.placed(p) else g
              for g, p in zip(gs, leaves)]
        return (loss.detach(), ce.detach(), aux.detach()), gs

    if grad_accum == 1:
        losses, grads = grad_fn(batch)
        return losses, tree_unflatten(params, grads)
    b = batch["tokens"].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} does not split into {grad_accum} "
                         "microbatches")
    n = b // grad_accum
    grads = [torch.zeros_like(p, dtype=torch.float32) if tp.placed(p) else
             torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    sums = [torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for _ in range(3)]
    for i in range(grad_accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        losses, gs = grad_fn(mb)
        for acc, g in zip(grads, gs):
            acc.add_(g.to(torch.float32) / grad_accum)
        for acc, x in zip(sums, losses):
            acc.add_(x / grad_accum)
        del gs
    return tuple(sums), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    remat: str = "block", grad_clip: float = 1.0,
                    grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), params
    and optimizer state updated in place. metrics: "loss", "ce",
    "moe_aux", "grad_norm" (0 without clipping), 0-dim tensors on the
    params' device; nothing is read back to the host."""

    def train_step(params, opt_state, batch):
        (loss, ce, aux), grads = loss_and_grads(cfg, params, batch,
                                                remat=remat,
                                                grad_accum=grad_accum)
        if grad_clip:
            gnorm = clip_by_global_norm_(grads, grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
        opt_state = optimizer.apply(grads, opt_state, params)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, optimizer: Optimizer,
                     gen: torch.Generator, dtype=torch.float32):
    """(params drawn from `gen` on its device, optimizer state)."""
    params = init_params(cfg, gen, dtype)
    return params, optimizer.init(params)


def make_prefill_step(cfg: ModelConfig, *, window_override: int = 0,
                      cache_len: int = 0):
    """(params, batch) -> (last logits (B,V), cache).

    `cache_len` sizes the returned KV cache beyond the prompt (0 =
    prompt length only): a server that decodes `max_new` tokens after
    the prompt passes prompt_len + max_new here."""

    def prefill_step(params, batch):
        extra = {k: batch[k] for k in ("audio", "vision") if k in batch}
        return prefill(cfg, params, batch["tokens"], extra or None,
                       window_override=window_override, cache_len=cache_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, window_override: int = 0,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """One decode step: (params, cache, token (B,), pos) ->
    (next_token (B,) int32, logits (B,V), cache).

    Greedy at temperature 0 (argmax, first index on ties, as
    `jnp.argmax`). With `temperature > 0` it samples from
    softmax(logits / temperature) by the Gumbel-max rule, with noise
    drawn from `generator` (required): the JAX package's
    `jax.random.categorical` has no torch counterpart, so samples agree
    with it in distribution only, and are reproducible under a seed."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs an explicit "
                         "torch.Generator")

    def serve_step(params, cache, token, pos):
        logits, cache = decode_step(cfg, params, cache, token, pos,
                                    window_override=window_override)
        if tp.placed(logits):
            if temperature > 0:
                raise ValueError("sampling needs unsplit logits; the "
                                 "tensor-parallel step is greedy")
            return tp.argmax(logits).to(torch.int32), logits, cache
        if temperature > 0:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            u = u.clamp_(min=torch.finfo(torch.float32).tiny)
            nxt = torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                               dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), logits, cache

    return serve_step


def make_decode_cache(cfg: ModelConfig, params, batch: int, cache_len: int,
                      dtype=torch.float32, extra=None, *,
                      window_override: int = 0):
    return init_cache(cfg, params, batch, cache_len, dtype, extra,
                      window_override=window_override)
