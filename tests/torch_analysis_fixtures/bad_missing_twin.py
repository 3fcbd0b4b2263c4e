"""Seeded-bad fixture: `oracle-missing` — a registered kernel whose
plain twin is not in `kernels/ref.py`, so nothing on the CPU stands for
it. (Never built: the gate reads the file.)"""
import ctypes

from repro_torch.analysis.registry import kernel_contract
from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel("fixture_missing_twin", "hamming.cu",
                    "hamming_all_pairs",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])


@kernel_contract(
    kernel=KERNEL, stands_for="hamming",
    twin="hamming_all_pairs_twin_that_does_not_exist",   # BUG
    exactness="exact", points=({"m": 4, "n": 4, "bits": 32},),
    make_args=lambda point: ((), {}))
def fixture_hamming(codes_a, codes_b):
    raise NotImplementedError("a fixture: never called")
