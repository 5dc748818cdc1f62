"""Deterministic sharded token pipeline: the port's own copy of
``repro.data.pipeline`` (numpy only).

Batches are a pure function of ``(seed, step, shard)`` so:

* restart-from-checkpoint resumes the exact data stream (cursor = step);
* **elastic rescale** is exact: re-sharding to a different data-parallel
  extent partitions the same global batch differently but yields identical
  global content (tested);
* a configurable per-host delay hook simulates stragglers for the
  watchdog tests.

The generator mixes a counter-based hash (SplitMix64-style) so there is no
RNG state to checkpoint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    shard: int = 0
    n_shards: int = 1
    seed: int = 0
    delay_s: float = 0.0   # straggler-injection hook (tests)

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0
        self.local_batch = self.global_batch // self.n_shards

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len) int32 for this shard at ``step``."""
        if self.delay_s:
            time.sleep(self.delay_s)
        rows = (np.arange(self.local_batch, dtype=np.uint64)
                + np.uint64(self.shard * self.local_batch))
        cols = np.arange(self.seq_len, dtype=np.uint64)
        base = (np.uint64(self.seed) * np.uint64(0x100000001)
                + np.uint64(step) * np.uint64(self.global_batch * self.seq_len))
        idx = base + rows[:, None] * np.uint64(self.seq_len) + cols[None, :]
        return (_splitmix64(idx) % np.uint64(self.vocab_size)).astype(np.int32)

    def global_batch_at(self, step: int) -> np.ndarray:
        full = TokenPipeline(self.vocab_size, self.seq_len, self.global_batch,
                             shard=0, n_shards=1, seed=self.seed)
        return full.batch_at(step)

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.seed}

    def resharded(self, shard: int, n_shards: int) -> "TokenPipeline":
        return TokenPipeline(self.vocab_size, self.seq_len, self.global_batch,
                             shard=shard, n_shards=n_shards, seed=self.seed)
