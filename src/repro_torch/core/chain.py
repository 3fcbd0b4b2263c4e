"""Blockchain announcement layer (WPFed §2.2, §3.6).
Counterpart of `repro/core/chain.py`.

1. Host ledger: an append-only hash-chained block list with SHA-256
   commitments over the canonical ranking bytes (byte-identical to the
   JAX package's, so both packages commit to the same hex strings).
2. In-round commitments (`fnv1a_commit`): FNV-1a over the 4 bytes of
   each ranking integer, with uint32 wraparound, on tensors, so the round
   verifies reveals without a host round trip.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import MASK32


def canonical_ranking_bytes(ranking) -> bytes:
    """int64 bytes of the ranking vector plus its shape's repr."""
    if isinstance(ranking, torch.Tensor):
        ranking = ranking.detach().cpu().numpy()
    arr = np.asarray(ranking, np.int64)
    return arr.tobytes() + arr.shape.__repr__().encode()


def sha256_commit(ranking, salt: int = 0) -> str:
    h = hashlib.sha256()
    h.update(salt.to_bytes(8, "little", signed=False))
    h.update(canonical_ranking_bytes(ranking))
    return h.hexdigest()


def fnv1a_commit(ranking: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """(..., N) int32 rankings -> (...,) int64 commitments in [0, 2^32),
    equal to the JAX package's uint32 `fnv1a_commit` values."""
    r = ranking.to(torch.int64) & MASK32
    h = torch.full(r.shape[:-1], 2166136261 ^ (salt & MASK32),
                   dtype=torch.int64, device=r.device)
    for idx in range(r.shape[-1]):
        x = r[..., idx]
        for shift in (0, 8, 16, 24):
            byte = (x >> shift) & 0xFF
            h = ((h ^ byte) * 16777619) & MASK32   # < 2^57: no overflow
    return h


@dataclass
class Block:
    index: int
    prev_hash: str
    payload: Dict[str, Any]            # round announcements + reveals
    timestamp: float = field(default_factory=lambda: 0.0)
    hash: str = ""

    def compute_hash(self) -> str:
        h = hashlib.sha256()
        h.update(self.prev_hash.encode())
        h.update(str(self.index).encode())
        h.update(repr(self.timestamp).encode())
        h.update(json.dumps(self.payload, sort_keys=True,
                            default=str).encode())
        return h.hexdigest()


class Blockchain:
    """Append-only announcement ledger shared by all clients."""

    def __init__(self):
        genesis = Block(0, "0" * 64, {"genesis": True})
        genesis.hash = genesis.compute_hash()
        self.blocks: List[Block] = [genesis]

    def publish_round(self, round_idx: int,
                      announcements: Dict[int, Dict[str, Any]],
                      reveals: Optional[Dict[int, Any]] = None) -> Block:
        """announcements: client_id -> {"lsh": hex, "commit": sha256hex};
        reveals: client_id -> ranking list (for round_idx - 1)."""
        payload = {
            "round": round_idx,
            "announcements": {str(k): v for k, v in announcements.items()},
            "reveals": {str(k): list(map(int, v))
                        for k, v in (reveals or {}).items()},
        }
        blk = Block(len(self.blocks), self.blocks[-1].hash, payload,
                    timestamp=time.time())
        blk.hash = blk.compute_hash()
        self.blocks.append(blk)
        return blk

    def verify_chain(self) -> bool:
        for i in range(1, len(self.blocks)):
            b = self.blocks[i]
            if b.prev_hash != self.blocks[i - 1].hash:
                return False
            if b.hash != b.compute_hash():
                return False
        return True


def verify_reveal(commitment_hex: str, revealed_ranking, salt: int = 0) -> bool:
    """Eq. (10): recompute the hash of the revealed ranking."""
    return sha256_commit(revealed_ranking, salt) == commitment_hex


def lsh_code_hex(code) -> str:
    """Hex of a packed code's uint32 words (int32 bit patterns in the
    port), as the JAX package writes it."""
    if isinstance(code, torch.Tensor):
        code = code.detach().cpu().numpy()
    return np.asarray(code).astype(np.int32).view(np.uint32).tobytes().hex()
