"""The bulletin board, plainly: each block's hash is SHA-256 over its
predecessor's hash, its index, the repr of its timestamp and its payload
as sorted JSON; an announcement is the hex of a code's uint32 words and
the SHA-256 commitment to a ranking (an 8-byte little-endian salt, the
int64 bytes of the ranking, the repr of its shape)."""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List

import numpy as np


def block_hash(prev_hash: str, index: int, timestamp: float,
               payload: Dict[str, Any]) -> str:
    h = hashlib.sha256()
    h.update(prev_hash.encode())
    h.update(str(index).encode())
    h.update(repr(timestamp).encode())
    h.update(json.dumps(payload, sort_keys=True, default=str).encode())
    return h.hexdigest()


def commit(ranking, salt: int = 0) -> str:
    arr = np.asarray(ranking, np.int64)
    h = hashlib.sha256()
    h.update(salt.to_bytes(8, "little", signed=False))
    h.update(arr.tobytes() + arr.shape.__repr__().encode())
    return h.hexdigest()


def code_hex(code) -> str:
    return np.asarray(code).astype(np.int32).view(np.uint32).tobytes().hex()


def check_blocks(blocks: List[Dict[str, Any]]) -> int:
    """Broken links and hashes in a list of blocks (dicts with index,
    prev_hash, payload, timestamp, hash), genesis first."""
    bad = 0
    for i, b in enumerate(blocks):
        if b["index"] != i:
            bad += 1
        if i and b["prev_hash"] != blocks[i - 1]["hash"]:
            bad += 1
        if b["hash"] != block_hash(b["prev_hash"], b["index"],
                                   b["timestamp"], b["payload"]):
            bad += 1
    return bad


def check_announcements(payload: Dict[str, Any], codes, rankings) -> int:
    """Clients whose published code, commitment or reveal is not the one
    the state holds (codes (M, W) int32, rankings (M, N) int, numpy)."""
    ann, rev = payload.get("announcements", {}), payload.get("reveals", {})
    bad = 0
    for i in range(len(codes)):
        a = ann.get(str(i))
        if (a is None or a.get("lsh") != code_hex(codes[i])
                or a.get("commit") != commit(rankings[i])
                or rev.get(str(i)) != [int(v) for v in rankings[i]]):
            bad += 1
    return bad + max(0, len(ann) - len(codes))
