"""PyTorch/CUDA port of the WPFed reproduction (`repro`).

The package mirrors `repro`'s module names and is held against it on the
same inputs by `tests/test_torch_*.py`. It imports `torch` and numpy,
never `jax` and nothing of `repro`. Its entry points run on the CUDA
device unless the caller passes `device="cpu"`; the three kernels of the
federation's main path (batched LSH projection, fused selection, fused
exchange) are hand-written CUDA C++ for Hopper (`kernels/csrc/`), each
beside its plain PyTorch version (`kernels/ref.py`).
"""
