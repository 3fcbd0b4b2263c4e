"""Partition-spec trees for params, optimizer state, batches and decode
caches, and their binding to a `DeviceMesh` (`rules`); the placements of
the tensor-parallel forward's activations (`tp`).

The models import `tp`, and `rules` imports the models' spec functions,
so `rules`' names are loaded on first use (PEP 562), not when the
package is: importing `repro_torch.sharding.tp` from a model module
must not import the models back.
"""
_RULES = ("batch_axes", "batch_spec", "cache_specs", "local_shape", "named",
          "opt_state_specs", "place", "place_params", "placements",
          "sanitize", "to_local", "train_batch_specs")


def __getattr__(name):
    if name in _RULES:
        from repro_torch.sharding import rules
        return getattr(rules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted((*globals(), *_RULES))
