"""Deterministic synthetic token streams for LM training and serving.

A seeded order-1 Markov chain over the vocabulary with a small number of
high-probability transitions gives a stream with learnable structure
(loss drops quickly below uniform entropy), with O(1) memory.  Batches are
(tokens, labels) next-token pairs.

The port's own copy of ``repro.data.tokens`` (numpy only): the same config
and seed give bit-identical batches in both packages (one
``RandomState`` per call, drawn in the same order).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int = 1024
    branch: int = 4               # likely successors per token
    p_follow: float = 0.9         # prob of taking a likely successor
    seed: int = 0


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        self.successors = rng.randint(
            0, cfg.vocab, size=(cfg.vocab, cfg.branch)).astype(np.int32)

    def sample(self, batch: int, seq_len: int, seed: int
               ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(seed)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, cfg.vocab, size=batch)
        for t in range(seq_len):
            follow = rng.rand(batch) < cfg.p_follow
            pick = rng.randint(0, cfg.branch, size=batch)
            nxt = self.successors[toks[:, t], pick]
            rand = rng.randint(0, cfg.vocab, size=batch)
            toks[:, t + 1] = np.where(follow, nxt, rand)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, batch: int, seq_len: int, n_steps: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(n_steps):
            yield self.sample(batch, seq_len, seed * 100_003 + step)
