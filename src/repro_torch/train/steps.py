"""Prefill and serve step factories for the transformer zoo (the serving
half of `repro/train/steps.py`; `lm_loss` and `make_train_step` are a
later slice, ROADMAP.md A)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, init_cache, prefill


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
