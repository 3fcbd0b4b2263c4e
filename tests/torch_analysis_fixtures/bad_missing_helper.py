"""Seeded-bad fixture: `estimator-missing` — a registered kernel that
declares a C helper (a shared-memory mirror) its source does not export,
so the estimator-drift check on the card would have nothing to hold the
Python function against. (Never built: the gate reads the source.)"""
import ctypes

from repro_torch.analysis.registry import Estimator, kernel_contract
from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel("fixture_missing_helper", "hamming.cu",
                    "hamming_all_pairs",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])


def hamming_smem_bytes(m: int) -> int:
    return 64 * m


@kernel_contract(
    kernel=KERNEL, stands_for="hamming", twin="hamming_all_pairs_ref",
    exactness="exact",
    helpers=("hamming_smem_bytes",),                      # BUG
    estimators=(Estimator("hamming_smem_bytes", hamming_smem_bytes,
                          lambda point: [(point["m"],)]),),
    points=({"m": 4, "n": 4, "bits": 32},),
    make_args=lambda point: ((), {}))
def fixture_hamming(codes_a, codes_b):
    raise NotImplementedError("a fixture: never called")
