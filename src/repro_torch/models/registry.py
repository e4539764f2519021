"""Uniform model API over every config of the registry.

    init_model(cfg, seed=..., device=...)         -> params
    train_loss(params, cfg, batch, **opts)        -> (loss, metrics)
    serve_prefill(params, cfg, batch, max_len)    -> (logits, caches)
    serve_decode(params, cfg, token, pos, caches) -> (logits, caches)

``batch`` contents by frontend (``configs.base.ArchConfig.frontend``);
training adds ``"labels"`` [B,S] int (-1: no target):
    none        {"tokens": [B,S] int}
    patch_stub  {"input_embeds": [B,S,D]} (VLM: through ``vlm_proj``), or
                {"tokens": [B,S] int}
    frame_stub  {"frames": [B,S_src,D], "tokens": [B,St] int}   (enc-dec)

Decoder-only configs go to ``models/transformer.py``, encoder-decoder ones
to ``models/encdec.py``.  The serving entry points run under
``torch.no_grad``; ``train_loss`` is differentiable.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.sharding import gather_last, logsumexp_last

PyTree = Any

AUX_LOSS_WEIGHTS = {"lb": 0.01, "z": 1e-3}   # Switch-style MoE aux weights


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters on ``device``; ``device=None`` means the GPU."""
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(cfg, seed=seed, device=device)
    return transformer.init_lm(cfg, seed=seed, device=device)


def train_loss(params, cfg: ArchConfig, batch, *, remat: str = "none",
               loss_chunk: int = 512, attn_block: int = 512):
    """Mean next-token CE plus the weighted MoE aux losses.  Returns (loss,
    {"ce", "lb_loss", "z_loss"}).  ``attn_block`` has no effect (the
    kernel's tile is fixed); ``remat`` applies to the decoder-only stack."""
    if cfg.is_encoder_decoder:
        h = encdec.forward(params, cfg, batch["frames"], batch["tokens"])
        lb = zl = torch.zeros((), dtype=torch.float32, device=h.device)
        ce = _encdec_loss(params, cfg, h, batch["labels"])
    else:
        h, (lb, zl) = transformer.forward(
            params, cfg, batch.get("tokens"),
            input_embeds=batch.get("input_embeds"), remat=remat,
            attn_block=attn_block)
        ce = transformer.lm_loss(params, cfg, h, batch["labels"],
                                 chunk=loss_chunk)
    loss = ce + AUX_LOSS_WEIGHTS["lb"] * lb + AUX_LOSS_WEIGHTS["z"] * zl
    return loss, {"ce": ce, "lb_loss": lb, "z_loss": zl}


def _encdec_loss(params, cfg: ArchConfig, h, labels):
    """Masked mean CE through the tied embedding, all positions at once
    (whisper's vocabulary is small), as the reference's."""
    logits = encdec.lm_logits(params, cfg, h)            # [B,S,V] f32
    lse = logsumexp_last(logits)
    gold = gather_last(logits, labels.clamp_min(0))
    mask = (labels >= 0).to(torch.float32)
    return (((lse - gold)[..., 0] * mask).sum()
            / mask.sum().clamp_min(1.0))


@torch.no_grad()
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


@torch.no_grad()
def serve_decode(params, cfg: ArchConfig, token, pos_scalar, caches):
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, cfg, token, pos_scalar, caches)
    return transformer.decode_step(params, cfg, token, pos_scalar, caches)
