"""Pytree checkpoints in the JAX package's `.npz` layout."""
from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step,
    restore,
    save,
    steps,
)
