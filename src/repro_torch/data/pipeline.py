"""Deterministic synthetic data pipeline with sequence packing.

A reproducible token stream (a per-shard seeded random walk over token ids:
enough structure that the LM loss decreases) is packed into fixed-length
training rows with EOS between documents.  numpy only: the streams are bit
for bit those of the reference for the same seed, shard and shard count.

Every host generates only its shard (``global_batch // n_shards`` rows).
``make_batch_specs`` gives one global batch as ``meta`` tensors (the
dry-run's inputs); ``sharded_batches`` gives the same shapes filled, laid
out over a mesh when a process group holds it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


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


def make_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                     dtype=torch.int32) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for one global batch (dry-run inputs)."""
    B, S = shape.global_batch, cfg.effective_seq(shape)

    def spec(shp, dt=dtype):
        return torch.empty(shp, dtype=dt, device="meta")

    if cfg.frontend == "patch_stub":
        return {"input_embeds": spec((B, S, cfg.d_model), torch.bfloat16),
                "labels": spec((B, S))}
    if cfg.frontend == "frame_stub":
        return {"frames": spec((B, cfg.max_source_positions, cfg.d_model),
                               torch.bfloat16),
                "tokens": spec((B, S)), "labels": spec((B, S))}
    return {"tokens": spec((B, S)), "labels": spec((B, S))}


def sharded_batches(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                    seed: int = 0, frontend_rng: Optional[int] = None, *,
                    device=None) -> Iterator[dict[str, torch.Tensor]]:
    """Batches of ``make_batch_specs``' shapes: tokens from the synthetic
    corpus, stub-frontend embeddings from a seeded rng (bf16), both as the
    reference draws them.  Token ids and labels come as int64 (the port's
    index dtype).  With a ``launch.mesh.Mesh`` under a process group each
    tensor is a DTensor laid out by ``launch.shardings.batch_shardings``
    (every rank draws the same global batch and keeps its part); else a
    tensor on ``device`` (None: the GPU)."""
    from repro_torch.models.common import resolve_device
    device = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                    seed=seed)
    src = SyntheticLM(dc).batches()
    rng = np.random.default_rng(frontend_rng if frontend_rng is not None
                                else seed + 1)
    place = batch_placer(mesh, device)
    while True:
        b = next(src)
        out: dict[str, np.ndarray] = {}
        if cfg.frontend == "patch_stub":
            out["input_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32) * 0.02
            out["labels"] = b["labels"]
        elif cfg.frontend == "frame_stub":
            out["frames"] = rng.standard_normal(
                (B, cfg.max_source_positions, cfg.d_model)
            ).astype(np.float32) * 0.02
            out["tokens"] = b["tokens"]
            out["labels"] = b["labels"]
        else:
            out = b
        yield place({k: torch.from_numpy(v).to(
            torch.bfloat16 if v.dtype == np.float32 else torch.int64)
            for k, v in out.items()})


def batch_placer(mesh, device):
    """batch dict -> the same on ``device``, as DTensors over ``mesh`` when
    a process group holds it."""
    import torch.distributed as dist
    if mesh is None or not (dist.is_available() and dist.is_initialized()):
        return lambda batch: {k: v.to(device) for k, v in batch.items()}
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models.sharding import placements
    dm = mesh.device_mesh(device.type)

    def place(batch):
        sh = batch_shardings(batch, mesh)
        return {k: distribute_tensor(v.to(device), dm,
                                     placements(sh[k].spec, mesh),
                                     src_data_rank=None)
                for k, v in batch.items()}

    return place
