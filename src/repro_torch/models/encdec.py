"""Encoder-decoder LM (Whisper-family backbone).

The conv / mel frontend is a stub, as in the reference: the caller hands in
precomputed frame embeddings ``[B, S_src, D]`` (30 s of audio = 1500 frames
after the conv).  This module is the transformer backbone:

* encoder: non-causal self-attention, learned positions, pre-LN, GELU MLP;
* decoder: causal self-attention, then cross-attention to the encoder's
  output, learned positions (448 rows), tied embedding head.

Params keep the reference's paths: ``enc_layers/...`` and ``dec_layers/...``
stacked with a leading ``[L]`` axis, applied by a Python loop over ``l``.
Attention goes to the hand-written kernels through ``models/attention.py``:
flash attention (non-causal in the encoder and for cross-attention, causal
for the decoder's self-attention) and decode attention (twice a decoder
layer at a decode step).  Whisper places no RoPE; every projection has a
bias.

Training differentiates ``forward`` (``encode`` and ``decoder_forward``,
whose attention takes the flash-attention kernel's autograd ``Function``);
serving runs under ``torch.no_grad`` (``models/registry.serve_prefill``).

Serving: ``encode`` once, ``init_dec_caches`` (self-attention K/V of
``max_len`` rows and the cross-attention K/V, computed once from the
encoder's output), then ``decode_step`` at a scalar position, which writes
the self-attention cache IN PLACE.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (dtype_of, einsum, make_generator,
                                       normal_init, resolve_device)
from repro_torch.models.layers import (apply_head, apply_mlp, apply_norm,
                                       embed_tokens, init_embed, init_mlp,
                                       init_norm)
from repro_torch.models.transformer import _layer, _residual

PyTree = Any

DEC_POSITIONS = 448               # whisper's decoder context


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_enc_layers(gen, cfg: ArchConfig, dt, stack: tuple) -> PyTree:
    d = cfg.d_model
    return {
        "ln1": init_norm(gen, d, cfg.norm, dt, stack),
        "attn": attn_lib.init_attention(gen, d, cfg.n_heads, cfg.n_heads,
                                        cfg.head_dim, dt, True, stack),
        "ln2": init_norm(gen, d, cfg.norm, dt, stack),
        "mlp": init_mlp(gen, d, cfg.d_ff, "gelu", dt, stack),
    }


def _init_dec_layers(gen, cfg: ArchConfig, dt, stack: tuple) -> PyTree:
    d = cfg.d_model
    return {
        "ln1": init_norm(gen, d, cfg.norm, dt, stack),
        "attn": attn_lib.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, dt, True, stack),
        "ln_x": init_norm(gen, d, cfg.norm, dt, stack),
        "xattn": attn_lib.init_attention(gen, d, cfg.n_heads, cfg.n_heads,
                                         cfg.head_dim, dt, True, stack),
        "ln2": init_norm(gen, d, cfg.norm, dt, stack),
        "mlp": init_mlp(gen, d, cfg.d_ff, "gelu", dt, stack),
    }


def init_encdec(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters drawn on ``device`` (None: the GPU) from a
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    dt = dtype_of(cfg.dtype)
    d = cfg.d_model
    params: dict = {
        "enc_pos": normal_init(gen, (cfg.max_source_positions, d), dt),
        "embed": init_embed(gen, cfg.vocab_size, d, dt),
        "dec_pos": normal_init(gen, (DEC_POSITIONS, d), dt),
        "enc_final_norm": init_norm(gen, d, cfg.norm, dt),
        "final_norm": init_norm(gen, d, cfg.norm, dt),
    }
    params["enc_layers"] = _init_enc_layers(gen, cfg, dt,
                                            (cfg.n_encoder_layers,))
    params["dec_layers"] = _init_dec_layers(gen, cfg, dt, (cfg.n_layers,))
    return params


# ---------------------------------------------------------------------------
# Attention sub-blocks (MHA, no RoPE: whisper has learned positions)
# ---------------------------------------------------------------------------

def _q_project(p, x):
    """The query projection alone (the reference projects k and v as well
    and drops them)."""
    return einsum("btd,dhk->bthk", x, p["wq"]) + p["bq"]


def _self_attn(p, x, *, causal: bool):
    q, k, v = attn_lib.qkv_project(p, x, None, 0.0, use_rope=False)
    o = attn_lib.prefill_attention(q, k, v, causal=causal)
    return attn_lib.out_project(p, o)


def _cross_attn(p, x, enc_kv):
    k, v = enc_kv
    o = attn_lib.prefill_attention(_q_project(p, x), k, v, causal=False)
    return attn_lib.out_project(p, o)


def _xattn_kv(p, enc_out):
    """Cross-attention K/V of the encoder's output (once per request)."""
    k = einsum("btd,dhk->bthk", enc_out, p["wk"]) + p["bk"]
    v = einsum("btd,dhk->bthk", enc_out, p["wv"]) + p["bv"]
    return k, v


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params, cfg: ArchConfig, frames) -> torch.Tensor:
    """frames [B, S_src, D] (precomputed embeddings) -> encoder states."""
    x = frames + params["enc_pos"][:frames.shape[1]]
    for l in range(cfg.n_encoder_layers):
        lp = _layer(params["enc_layers"], l)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        x = _residual(x, _self_attn(lp["attn"], h, causal=False))
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = _residual(x, apply_mlp(lp["mlp"], h, "gelu"))
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# Decoder: teacher-forced forward and serving
# ---------------------------------------------------------------------------

def decoder_forward(params, cfg: ArchConfig, tokens, enc_out) -> torch.Tensor:
    """Teacher-forced decoder pass -> final-norm hidden states [B,S,D]."""
    x = (embed_tokens(params["embed"], tokens)
         + params["dec_pos"][:tokens.shape[1]])
    for l in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], l)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        x = _residual(x, _self_attn(lp["attn"], h, causal=True))
        h = apply_norm(lp["ln_x"], x, cfg.norm)
        x = _residual(x, _cross_attn(lp["xattn"], h,
                                     _xattn_kv(lp["xattn"], enc_out)))
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = _residual(x, apply_mlp(lp["mlp"], h, "gelu"))
    return apply_norm(params["final_norm"], x, cfg.norm)


def forward(params, cfg: ArchConfig, frames, tokens) -> torch.Tensor:
    """(frames, target tokens) -> decoder hidden states [B,St,D]."""
    return decoder_forward(params, cfg, tokens, encode(params, cfg, frames))


def lm_logits(params, cfg: ArchConfig, h):
    """f32 logits through the tied embedding."""
    return apply_head(None, h, params["embed"], cfg.logit_softcap)


@torch.no_grad()
def init_dec_caches(params, cfg: ArchConfig, enc_out, batch: int,
                    max_len: int) -> dict:
    """Self-attention K/V ``k``, ``v`` [L,B,max_len,Hkv,D] (zeros, the
    config's dtype) and the cross-attention K/V ``xk``, ``xv``
    [L,B,S_src,H,D] of ``enc_out``."""
    dt = dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = [_xattn_kv(_layer(params["dec_layers"]["xattn"], l), enc_out)
          for l in range(cfg.n_layers)]
    return {"k": torch.zeros(shape, dtype=dt, device=enc_out.device),
            "v": torch.zeros(shape, dtype=dt, device=enc_out.device),
            "xk": torch.stack([k for k, _ in kv]),
            "xv": torch.stack([v for _, v in kv])}


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token, pos: int, caches):
    """One-token decode at the scalar position ``pos`` shared by every row.
    token: [B] int -> (logits [B,V] f32, caches); the self-attention cache
    is written in place at ``pos``.

    The reference reads ``dec_pos`` with ``dynamic_slice_in_dim``, which
    clamps the start: a position past its last row reads that row.  So does
    this port (ROADMAP §C)."""
    pos = int(pos)
    B = token.shape[0]
    row = min(max(pos, 0), params["dec_pos"].shape[0] - 1)
    x = (embed_tokens(params["embed"], token[:, None])
         + params["dec_pos"][row:row + 1][None])
    dev = x.device
    lens_self = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    lens_x = torch.full((B,), caches["xk"].shape[2], dtype=torch.int32,
                        device=dev)
    for l in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], l)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = attn_lib.qkv_project(lp["attn"], h, None, 0.0,
                                       use_rope=False)
        kc, vc = attn_lib.update_kv_cache(caches["k"][l], caches["v"][l], k,
                                          v, pos)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, lens_self)
        x = _residual(x, attn_lib.out_project(lp["attn"], o[:, None]))
        h = apply_norm(lp["ln_x"], x, cfg.norm)
        qx = _q_project(lp["xattn"], h)
        ox = attn_lib.decode_attention(qx[:, 0], caches["xk"][l],
                                       caches["xv"][l], lens_x)
        x = _residual(x, attn_lib.out_project(lp["xattn"], ox[:, None]))
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = _residual(x, apply_mlp(lp["mlp"], h, "gelu"))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x)[:, 0], caches
