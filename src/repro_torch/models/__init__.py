"""Models in PyTorch, with the JAX package's parameter names and
layouts: the paper's client models (`client`) and the transformer zoo
(`transformer`), with each module's partition specs beside it."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    param_shapes,
    param_specs,
    prefill,
)
