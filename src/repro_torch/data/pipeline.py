"""Deterministic synthetic data pipeline with sequence packing.

A reproducible token stream (a per-shard seeded random walk over token ids:
enough structure that the LM loss decreases) is packed into fixed-length
training rows with EOS between documents.  numpy only: the streams are bit
for bit those of the reference for the same seed, shard and shard count.

Every host generates only its shard (``global_batch // n_shards`` rows).
The mesh-shaped batch specs and sharded batches of the reference wait for
the port's meshes (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 1
    pad_id: int = 0


class SyntheticLM:
    """Deterministic, shardable synthetic LM corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        n = int(rng.integers(c.mean_doc_len // 4, c.mean_doc_len * 2))
        # random walk over token ids: learnable bigrams
        base = rng.integers(2, c.vocab_size, dtype=np.int64)
        steps = rng.integers(-64, 65, size=n)
        toks = (base + np.cumsum(steps)) % (c.vocab_size - 2) + 2
        return toks.astype(np.int32)

    def packed_rows(self, shard: int, n_shards: int) -> Iterator[np.ndarray]:
        """Yields [rows_per_shard, seq_len+1] packed token rows forever."""
        c = self.cfg
        rows = max(1, c.global_batch // n_shards)
        rng = np.random.default_rng((c.seed, shard))
        buf = np.empty(0, np.int32)
        while True:
            out = np.empty((rows, c.seq_len + 1), np.int32)
            for r in range(rows):
                while buf.size < c.seq_len + 1:
                    buf = np.concatenate([buf, self._doc(rng), [c.eos_id]])
                out[r] = buf[:c.seq_len + 1]
                buf = buf[c.seq_len + 1:]
            yield out

    def batches(self, shard: int = 0, n_shards: int = 1
                ) -> Iterator[dict[str, np.ndarray]]:
        for rows in self.packed_rows(shard, n_shards):
            tokens = rows[:, :-1]
            labels = rows[:, 1:].copy()
            labels[tokens == self.cfg.pad_id] = -1
            yield {"tokens": tokens, "labels": labels}
