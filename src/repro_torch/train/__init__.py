"""Step factories for the transformer zoo (the serving half of
`repro.train`)."""
from repro_torch.train.steps import (  # noqa: F401
    make_decode_cache,
    make_prefill_step,
    make_serve_step,
)
