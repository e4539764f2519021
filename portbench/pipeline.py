"""Frozen copy of the port's packing pipeline (``data/pipeline.py``,
``SyntheticLM``): a seeded random walk over token ids, documents of
``mean_doc_len // 4`` to ``2 * mean_doc_len`` tokens packed into rows of
``seq_len + 1`` with an EOS between documents.  A copy, so that no later
change to the program moves the benchmark's inputs."""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _doc(rng: np.random.Generator, vocab: int, mean_doc_len: int
         ) -> np.ndarray:
    n = int(rng.integers(mean_doc_len // 4, mean_doc_len * 2))
    base = rng.integers(2, vocab, dtype=np.int64)
    steps = rng.integers(-64, 65, size=n)
    return ((base + np.cumsum(steps)) % (vocab - 2) + 2).astype(np.int32)


def packed_rows(seed: int, vocab: int, rows: int, seq_len: int, *,
                mean_doc_len: int = 512, eos_id: int = 1
                ) -> Iterator[np.ndarray]:
    """[rows, seq_len + 1] packed token rows, forever; every row differs."""
    rng = np.random.default_rng(seed)
    buf = np.empty(0, np.int32)
    while True:
        out = np.empty((rows, seq_len + 1), np.int32)
        for r in range(rows):
            while buf.size < seq_len + 1:
                buf = np.concatenate([buf, _doc(rng, vocab, mean_doc_len),
                                      [eos_id]])
            out[r] = buf[:seq_len + 1]
            buf = buf[seq_len + 1:]
        yield out


def batches(seed: int, vocab: int, rows: int, seq_len: int, *,
            mean_doc_len: int = 512, eos_id: int = 1, pad_id: int = 0
            ) -> Iterator[dict[str, np.ndarray]]:
    """{"tokens", "labels"} [rows, seq_len] int32; a label is -1 where its
    token is the pad id."""
    for r in packed_rows(seed, vocab, rows, seq_len,
                         mean_doc_len=mean_doc_len, eos_id=eos_id):
        tokens = r[:, :-1]
        labels = r[:, 1:].copy()
        labels[tokens == pad_id] = -1
        yield {"tokens": tokens, "labels": labels}
