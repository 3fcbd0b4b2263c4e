"""Trust-free verification (WPFed §3.5, §3.6).
Counterpart of `repro/core/verify.py`. The §3.5 output-KL filter runs
inside the fused exchange (`core.exchange`); the §3.6 in-round
commit check is here."""
from __future__ import annotations

import torch

from repro_torch.core.chain import fnv1a_commit


def verify_rankings_fnv(revealed: torch.Tensor, commitments: torch.Tensor,
                        salt: int = 0) -> torch.Tensor:
    """revealed (M, N) int32, commitments (M,) from last round -> (M,)
    bool reporter mask."""
    return fnv1a_commit(revealed, salt) == commitments
