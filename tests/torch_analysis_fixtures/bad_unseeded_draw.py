"""Seeded-bad fixture: `unseeded-draw` — a draw from the global
generator, so its numbers follow whatever drew before it, not the run's
seed (the port's form of the JAX `unseeded-key` bug class)."""
import torch


def noisy(x: torch.Tensor) -> torch.Tensor:
    return x + torch.randn(x.shape)    # BUG: no generator=


def seeded(x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    return x + torch.randn(x.shape, generator=g)
