"""LSH similarity layer (WPFed §3.2, Eq. 5-6): codes of the stacked
client parameters, through the batched projection kernel.
Counterpart of `repro/core/lsh.py`."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import backends
from repro_torch.kernels import ops


def stacked_lsh_codes(stacked_params: Dict[str, torch.Tensor], seed: int,
                      bits: int = 256, backend: str = "auto") -> torch.Tensor:
    """(M, W) int32 codes (uint32 patterns) of {name: (M, ...)} params,
    projected with the shared per-round seed."""
    flat2d = ops.flatten_params_batched(stacked_params)
    use_kernel = backends.resolve(backend, flat2d.device) == "kernel"
    return ops.batched_lsh_codes(flat2d, seed, bits=bits,
                                 use_kernel=use_kernel)
