"""Uniform model API over every config of the registry.

    init_model(cfg, seed=..., device=...)         -> params
    serve_prefill(params, cfg, batch, max_len)    -> (logits, caches)
    serve_decode(params, cfg, token, pos, caches) -> (logits, caches)

``batch`` contents by frontend (``configs.base.ArchConfig.frontend``):
    none        {"tokens": [B,S] int}
    patch_stub  {"input_embeds": [B,S,D]} (VLM: through ``vlm_proj``), or
                {"tokens": [B,S] int}
    frame_stub  {"frames": [B,S_src,D], "tokens": [B,St] int}   (enc-dec)

Decoder-only configs go to ``models/transformer.py``, encoder-decoder ones
to ``models/encdec.py``.  ``train_loss`` is not ported yet (ROADMAP A8).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer

PyTree = Any


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters on ``device``; ``device=None`` means the GPU."""
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(cfg, seed=seed, device=device)
    return transformer.init_lm(cfg, seed=seed, device=device)


def serve_prefill(params, cfg: ArchConfig, batch, *, max_len: int,
                  caches=None, slot: int = 0):
    """Prefill a batch into fresh caches (decoder-only: or into rows
    ``[slot, slot+B)`` of ``caches``).

    Encoder-decoder: encode the frames, build the decoder's caches and
    decode ``tokens[:, 0]`` alone at position 0, as the reference does
    (ROADMAP §C): the prompt's other tokens never reach the cache."""
    if cfg.is_encoder_decoder:
        if caches is not None:
            raise ValueError("an encoder-decoder prefill builds its own "
                             "caches")
        frames = batch["frames"]
        B = frames.shape[0]
        enc_out = encdec.encode(params, cfg, frames)
        caches = encdec.init_dec_caches(params, cfg, enc_out, B, max_len)
        tok0 = (batch["tokens"][:, 0] if "tokens" in batch else
                torch.zeros((B,), dtype=torch.long, device=frames.device))
        return encdec.decode_step(params, cfg, tok0, 0, caches)
    return transformer.prefill(
        params, cfg, batch.get("tokens"),
        input_embeds=batch.get("input_embeds"), max_len=max_len,
        caches=caches, slot=slot)


def serve_decode(params, cfg: ArchConfig, token, pos_scalar, caches):
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, cfg, token, pos_scalar, caches)
    return transformer.decode_step(params, cfg, token, pos_scalar, caches)
