"""Seeded-bad fixture: `unregistered-kernel` — a CudaKernel with NO
`kernel_contract` entry. The completeness check counts the CudaKernel
sites of a file against the kernels its entries hold, so a kernel added
without its entry fails the gate instead of skipping every contract
check. (Never built: the gate reads the file.)"""
import ctypes

from repro_torch.kernels.build import CudaKernel

# BUG: no kernel_contract entry holds this kernel
DOUBLE = CudaKernel("fixture_double", "hamming.cu", "hamming_all_pairs",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
