import functools
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

# ---------------------------------------------------------------------------
# Optional-dependency shim: hypothesis is not installable in the offline
# environment. Several modules do `from hypothesis import given, settings,
# strategies as st` at import time; without this shim the whole module
# fails collection. The stub skips only the @given-decorated tests —
# plain tests in the same module still run.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")

    def _given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (offline environment)")(fn)
        return deco

    def _settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    def _strategy_stub(*_a, **_k):
        return None

    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    for _name in ("integers", "floats", "booleans", "lists", "tuples",
                  "sampled_from", "text", "composite", "just", "one_of"):
        setattr(_st, _name, _strategy_stub)
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

from repro.configs.paper_models import ClientModelConfig, FedConfig
from repro.models import apply_client_model, init_client_model
from repro.optim import adam


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def tiny_fed():
    """Small, fast federation fixture shared across protocol tests:
    6 MLP clients on 16-dim synthetic two-class data."""
    import numpy as np
    m, n_loc, n_ref, d, classes = 6, 40, 12, 16, 3
    rs = np.random.RandomState(0)
    mcfg = ClientModelConfig("test-mlp", "mlp", (d,), classes, hidden=(32,))
    fed = FedConfig(num_clients=m, num_neighbors=3, top_k=2, local_steps=3,
                    local_batch=16, lsh_bits=128, lr=1e-2)

    # class-structured data: FIXED global class centers (the task must be
    # learnable and consistent across train/ref/test); non-IID label skew
    # via per-client class proportions.
    centers = rs.randn(classes, d) * 2.5

    def gen(n, props):
        y = rs.choice(classes, size=n, p=props)
        x = centers[y] + rs.randn(n, d)
        return x.astype("f"), y.astype("i4")

    xs, ys, xr, yr, xt, yt = [], [], [], [], [], []
    for i in range(m):
        props = rs.dirichlet(np.ones(classes) * 0.8)      # label skew
        props = 0.7 * props + 0.3 / classes               # keep all classes
        x, y = gen(n_loc, props)
        xs.append(x); ys.append(y)
        x, y = gen(n_ref, np.ones(classes) / classes)     # shared-repo style
        xr.append(x); yr.append(y)
        x, y = gen(n_loc // 2, props)                     # test ~ local dist
        xt.append(x); yt.append(y)
    data = {"x_train": jnp.asarray(np.stack(xs)),
            "y_train": jnp.asarray(np.stack(ys)),
            "x_ref": jnp.asarray(np.stack(xr)),
            "y_ref": jnp.asarray(np.stack(yr)),
            "x_test": jnp.asarray(np.stack(xt)),
            "y_test": jnp.asarray(np.stack(yt))}

    apply_fn = functools.partial(apply_client_model, mcfg)
    init_fn = lambda k: init_client_model(mcfg, k)
    opt = adam(fed.lr)
    return {"fed": fed, "mcfg": mcfg, "apply_fn": apply_fn,
            "init_fn": init_fn, "opt": opt, "data": data}
