"""Intra-op threads of the port's CPU tests under pytest-xdist.

Each xdist worker is its own process, and torch starts one intra-op
thread per core in each, so `-n 6` on eight cores runs some forty threads
that fight for eight cores: a test that takes seconds alone can take
minutes. Every `tests/test_torch_*.py` imports `intra_op_threads`, a
module-scoped autouse fixture that caps torch's intra-op threads at the
worker's share of the cores for the module's tests and restores the
count after them. Outside xdist it changes nothing. Autouse fixtures of
a scope run before the others of that scope, and no port test file does
torch work when it is imported, so the cap holds from a module's first
torch call, in whatever order the files run.

`worker_env()` gives a subprocess the same cap (`OMP_NUM_THREADS`, which
torch reads when it starts).
"""
import os

import pytest
import torch


def worker_threads():
    """The intra-op threads of one xdist worker (its share of the cores,
    at least 1), or None outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 0:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


def worker_env():
    """Environment entries that cap a child process's threads likewise."""
    n = worker_threads()
    return {} if n is None else {"OMP_NUM_THREADS": str(n)}


@pytest.fixture(scope="module", autouse=True)
def intra_op_threads():
    n = worker_threads()
    before = torch.get_num_threads()
    if n is not None:
        torch.set_num_threads(min(n, before))
    try:
        yield
    finally:
        torch.set_num_threads(before)
