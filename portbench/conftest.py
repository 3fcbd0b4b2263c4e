"""The harness tests' marker and thread cap (no JAX here).

Under pytest-xdist each worker is a process with one intra-op thread per
core by default, so six workers oversubscribe the cores many times over;
each test module caps torch's threads at the worker's share of the cores
and restores the count after it (outside xdist nothing changes)."""
import os

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's kernels); "
        "skips without one")


def worker_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 0:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


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
