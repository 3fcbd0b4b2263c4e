"""LSH similarity layer (WPFed §3.2, Eq. 5-6). Counterpart of
`repro/core/lsh.py`.

Per-client and batched codes of parameter dicts, and the unfused
all-pairs distance matrix and normalized distance that stay the
semantic reference for the fused selection (the round selects through
`core.neighbor.select_partners`). Distances are the bit fraction
d / bits (DESIGN.md §1). `sharded_lsh_code` (a `torch.distributed`
all-reduce of partial sums) is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import backends
from repro_torch.kernels import ops


def client_lsh_code(params: Dict[str, torch.Tensor], seed: int,
                    bits: int = 256, use_kernel: bool = True) -> torch.Tensor:
    """Eq. (5): the (W,) int32 packed code (uint32 patterns) of one
    client's {name: tensor} params, through the single-client kernel."""
    return ops.lsh_code(params, seed, bits=bits, use_kernel=use_kernel)


def stacked_lsh_codes(stacked_params: Dict[str, torch.Tensor], seed: int,
                      bits: int = 256, backend: str = "auto") -> torch.Tensor:
    """(M, W) int32 codes (uint32 patterns) of {name: (M, ...)} params,
    projected with the shared per-round seed. "ann" changes only the
    selection, so the projection resolves it as "auto"."""
    flat2d = ops.flatten_params_batched(stacked_params)
    use_kernel = backends.resolve("auto" if backend == "ann" else backend,
                                  flat2d.device) == "kernel"
    return ops.batched_lsh_codes(flat2d, seed, bits=bits,
                                 use_kernel=use_kernel)


def distance_matrix(codes: torch.Tensor, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """Eq. (6) all pairs: (M, W) int32 codes -> (M, M) int32."""
    return ops.hamming_matrix(codes, use_kernel=use_kernel)


def normalized_distance(dist: torch.Tensor, bits: int) -> torch.Tensor:
    return dist.to(torch.float32) / float(bits)
