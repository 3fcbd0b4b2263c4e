"""Step factories for the transformer zoo (the port of `repro.train`)."""
from repro_torch.train.steps import (  # noqa: F401
    init_train_state,
    lm_loss,
    loss_and_grads,
    make_decode_cache,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
