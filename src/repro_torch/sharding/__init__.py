"""Partition-spec trees for params, optimizer state, batches and decode
caches, and their binding to a `DeviceMesh` (`rules`)."""
from repro_torch.sharding.rules import (  # noqa: F401
    batch_axes,
    batch_spec,
    cache_specs,
    local_shape,
    named,
    opt_state_specs,
    place,
    placements,
    to_local,
    train_batch_specs,
)
