"""Deterministic synthetic protein sequences (the protein half of
``repro/data/pipeline.py``).  Every sample is a pure function of
(seed, index) via counter-based RNG (numpy Philox)."""
from __future__ import annotations

import numpy as np

AA_VOCAB = 21   # 20 amino acids + unknown


class ProteinSampler:
    """Synthetic amino-acid sequences, CASP-like length mix."""

    def __init__(self, seed: int = 0, min_len: int = 64, max_len: int = 2048):
        self.seed, self.min_len, self.max_len = seed, min_len, max_len

    def sample(self, idx: int, length: int | None = None) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=np.array([idx, 0, 0, 0], np.uint64)))
        if length is None:
            # log-uniform length: CASP targets span 2 orders of magnitude
            lo, hi = np.log(self.min_len), np.log(self.max_len)
            length = int(np.exp(rng.uniform(lo, hi)))
        # locally correlated composition (secondary-structure-ish runs)
        seq = rng.integers(0, AA_VOCAB, size=length)
        runs = rng.random(length) < 0.35
        for i in range(1, length):
            if runs[i]:
                seq[i] = seq[i - 1]
        return seq.astype(np.int32)

    def batch(self, idx: int, batch: int, length: int) -> np.ndarray:
        return np.stack([self.sample(idx * batch + i, length)
                         for i in range(batch)])
