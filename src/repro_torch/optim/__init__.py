"""Optimizers and learning-rate schedules with the JAX package's
formulas."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_decay,
    linear_warmup_cosine,
)
