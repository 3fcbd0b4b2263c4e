"""Optimizers with the JAX package's update formulas."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    apply_updates,
)
