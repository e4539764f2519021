"""The one general generator of traffic, driven by a mix's data file
(``traffic/<name>.json``).

Serving mixes: an open loop of ``round(rate_per_s * seconds)`` requests.
Their prompt and output lengths are log-normal (median, sigma, clipped)
and their gaps exponential with mean ``1 / rate_per_s``, all three drawn
from the mix's own ``shape_seed``.  Every ``--seed`` gets the same arrival
times and the same sizes in the same order, and token ids (and weights) of
its own: a seed changes what is computed, never how much nor when.  (Sizes
reordered by the seed, even within blocks of 8 arrivals, moved the TTFT
tail by a quarter from seed to seed while two runs of one seed agreed
within 2 %.)

Training mixes: rows of the frozen packing pipeline (``pipeline.py``)
drawn from ``--seed``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import pipeline


@dataclass
class Request:
    due_s: float           # offset from the window's start
    prompt: np.ndarray     # int32 token ids
    max_new: int


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def serve_shapes(mix: dict, seconds: float):
    """(prompt lengths, output lengths, gaps) of the window, in arrival
    order; the same for every ``--seed``."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    rng = np.random.default_rng(mix["shape_seed"])
    prompts = _lognormal(rng, mix["prompt_tokens"], n)
    outputs = _lognormal(rng, mix["output_tokens"], n)
    gaps = rng.exponential(1.0, size=n)
    gaps *= (1.0 / mix["rate_per_s"]) / gaps.mean()
    return prompts, outputs, gaps


def serve_requests(mix: dict, seed: int, seconds: float,
                   vocab: int) -> list[Request]:
    """The window's requests, sorted by due time."""
    prompts, outputs, gaps = serve_shapes(mix, seconds)
    rng = np.random.default_rng(seed)
    due = np.cumsum(gaps)
    lo = mix.get("token_min", 2)
    return [Request(float(d), rng.integers(lo, vocab, size=int(p),
                                           dtype=np.int64).astype(np.int32),
                    int(o)) for d, p, o in zip(due, prompts, outputs)]


def train_batches(mix: dict, seed: int, vocab: int, count: int) -> list:
    """``count`` batches ({"tokens", "labels"} int32 [rows, seq_len]) of
    the frozen pipeline; every row differs."""
    it = pipeline.batches(seed, vocab, mix["rows"], mix["seq_len"],
                          mean_doc_len=mix["mean_doc_len"])
    return [next(it) for _ in range(count)]
