"""Synthetic LM token pipeline for the transformer zoo (the port's copy
of `repro/data/synthetic.py`, numpy only). Deterministic, restartable,
shardable.

The stream is a Zipf-distributed token source with short-range Markov
structure (so a model can actually reduce loss) plus the modality stubs
for audio/VLM archs (frame/patch embeddings per the task carve-out).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenStream:
    """Deterministic batched token stream. State = (seed, step)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0
        v = cfg.vocab_size
        rs = np.random.RandomState(seed)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._zipf = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse bigram preference: each token has a favorite successor
        self._succ = rs.randint(0, v, size=v)

    def _draw(self, rs, n):
        v = self.cfg.vocab_size
        base = rs.choice(v, size=n, p=self._zipf)
        out = np.empty(n, np.int64)
        out[0] = base[0]
        follow = rs.rand(n) < 0.35
        for i in range(1, n):
            out[i] = self._succ[out[i - 1]] if follow[i] else base[i]
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        rs = np.random.RandomState((self.seed * 9176 + self.step) % 2**31)
        self.step += 1
        toks = self._draw(rs, self.batch * (self.seq_len + 1)).reshape(
            self.batch, self.seq_len + 1)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        extra = modality_stub(self.cfg, self.batch, rs)
        batch.update(extra)
        return batch


def modality_stub(cfg: ModelConfig, batch: int,
                  rs: Optional[np.random.RandomState] = None):
    """Frame/patch embeddings for the stubbed audio/vision frontends."""
    rs = rs or np.random.RandomState(0)
    out: Dict[str, np.ndarray] = {}
    if cfg.is_encdec:
        out["audio"] = rs.randn(batch, cfg.encoder_seq_len,
                                cfg.d_model).astype(np.float32) * 0.1
    if cfg.vision_tokens:
        out["vision"] = rs.randn(batch, cfg.vision_tokens,
                                 cfg.vision_dim or cfg.d_model
                                 ).astype(np.float32) * 0.1
    return out
