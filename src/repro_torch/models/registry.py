"""Uniform model API (decoder-only half): dense, MoE, hybrid and xLSTM.

    init_model(cfg, seed=..., device=...)         -> params
    serve_prefill(params, cfg, batch, max_len)    -> (logits, caches)
    serve_decode(params, cfg, token, pos, caches) -> (logits, caches)

``batch`` is ``{"tokens": [B,S] int}``.  Encoder-decoder models, the VLM /
audio frontends and ``train_loss`` are not ported yet (ROADMAP A7, A8).
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

PyTree = Any


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters on ``device``; ``device=None`` means the GPU."""
    return transformer.init_lm(cfg, seed=seed, device=device)


def serve_prefill(params, cfg: ArchConfig, batch, *, max_len: int,
                  caches=None, slot: int = 0):
    return transformer.prefill(
        params, cfg, batch.get("tokens"),
        input_embeds=batch.get("input_embeds"), max_len=max_len,
        caches=caches, slot=slot)


def serve_decode(params, cfg: ArchConfig, token, pos_scalar, caches):
    return transformer.decode_step(params, cfg, token, pos_scalar, caches)
