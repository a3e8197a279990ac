"""Deterministic, shard-aware synthetic data (port of
``repro/data/pipeline.py``; numpy only, so batches are bitwise the
reference's).

Every batch is a pure function of (seed, step, shard) via counter-based
RNG (numpy Philox):
  * restart-from-checkpoint replays the exact token stream (bitwise resume),
  * re-sharding (rank/world change) re-partitions the SAME global stream,
    so no sample is lost or duplicated.

The LM stream is an order-1 Markov chain over the vocab (learnable
structure, so a few training steps show the loss falling); the protein
sampler emits amino-acid sequences with CASP-like length distributions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

AA_VOCAB = 21   # 20 amino acids + unknown


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    rank: int = 0
    world: int = 1

    def reshard(self, rank: int, world: int) -> "ShardInfo":
        return ShardInfo(rank, world)


class SyntheticLM:
    """Markov-chain token stream: batch(step) -> {'tokens','labels'}."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard: ShardInfo = ShardInfo()):
        if global_batch % shard.world:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{shard.world} shards")
        self.vocab, self.seq_len = vocab, seq_len
        self.global_batch = global_batch
        self.shard = shard
        self.seed = seed
        rng = np.random.Generator(np.random.Philox(key=seed))
        v = min(vocab, 512)      # transition structure over a head of vocab
        self._v = v
        # sparse-ish row-stochastic transition matrix
        logits = rng.normal(size=(v, v)).astype(np.float32)
        logits[rng.random((v, v)) > 0.03] = -1e9
        self._trans = np.exp(logits - logits.max(1, keepdims=True))
        self._trans /= self._trans.sum(1, keepdims=True)

    def _rows(self, step: int, row_ids: np.ndarray) -> np.ndarray:
        out = np.empty((len(row_ids), self.seq_len + 1), np.int64)
        cum = np.cumsum(self._trans, axis=1)
        for i, rid in enumerate(row_ids):
            rng = np.random.Generator(np.random.Philox(
                key=self.seed, counter=np.array([step, rid, 0, 0], np.uint64)))
            seq = np.empty(self.seq_len + 1, np.int64)
            seq[0] = rng.integers(0, self._v)
            u = rng.random(self.seq_len)
            for t in range(self.seq_len):
                seq[t + 1] = np.searchsorted(cum[seq[t]], u[t])
            out[i] = np.minimum(seq, self.vocab - 1)
        return out

    def batch(self, step: int) -> dict[str, np.ndarray]:
        per = self.global_batch // self.shard.world
        row_ids = np.arange(per) + self.shard.rank * per
        rows = self._rows(step, row_ids)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


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
