"""Decoder-only LM: the dense (``("attn",)`` pattern) path.

Layer stacks keep the reference layout: params of the pattern position
``pos`` live under ``blocks/<pos>/...`` with a leading group axis ``[G, ...]``
(``G = n_layers // len(pattern)``); the remainder layers, unstacked, under
``rem/<i>/...``.  The stack is applied by a Python loop over ``g`` that
indexes the stacked leaves.

Entry points:
    init_lm(cfg, seed=..., device=...) -> params
    forward(params, cfg, tokens)       -> final hidden states [B,S,D]
    lm_logits                          -> f32 vocab projection
    prefill(...) / decode_step(...)    -> serving paths with KV caches

Serving caches are updated IN PLACE: ``prefill`` and ``decode_step`` write
into the cache tensors they are given and return the same objects.

MoE, hybrid / recurrent patterns, encoder-decoder and the VLM / audio
frontends are not ported yet; ``check_supported`` names the ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (dtype_of, make_generator,
                                       resolve_device, tree_map)
from repro_torch.models.layers import (apply_head, apply_mlp, apply_norm,
                                       embed_tokens, init_embed, init_head,
                                       init_mlp, init_norm, rope_table)

PyTree = Any


def check_supported(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP A7)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            "(ROADMAP A7)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts blocks are not ported yet "
            "(ROADMAP A5)")
    if cfg.hybrid is not None:
        raise NotImplementedError(
            f"{cfg.name}: hybrid / recurrent layer patterns are not ported "
            "yet (ROADMAP A6)")


def layer_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.hybrid is not None:
        return cfg.hybrid.pattern
    return ("attn",)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, kind: str, stack: tuple = ()) -> PyTree:
    """One block's params; ``stack=(G,)`` draws G layers at once with a
    leading group axis."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} (ROADMAP A6)")
    dt = dtype_of(cfg.dtype)
    d = cfg.d_model
    return {
        "ln1": init_norm(gen, d, cfg.norm, dt, stack),
        "attn": attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
            cfg.qkv_bias, stack),
        "ln2": init_norm(gen, d, cfg.norm, dt, stack),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.activation, dt, stack),
    }


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters drawn on ``device`` (None: the GPU) from a
    ``torch.Generator`` seeded with ``seed``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = make_generator(seed, device)
    dt = dtype_of(cfg.dtype)
    pat = layer_pattern(cfg)
    n_groups, n_rem = divmod(cfg.n_layers, len(pat))

    params: dict = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        params["head"] = init_head(gen, cfg.d_model, cfg.vocab_size, dt)
    params["final_norm"] = init_norm(gen, cfg.d_model, cfg.norm, dt)
    blocks = {}
    if n_groups:
        for pos, kind in enumerate(pat):
            blocks[str(pos)] = _init_block(gen, cfg, kind, (n_groups,))
    params["blocks"] = blocks
    if n_rem:
        params["rem"] = {str(i): _init_block(gen, cfg, pat[i])
                         for i in range(n_rem)}
    return params


def _n_groups(params) -> int:
    blocks = params.get("blocks")
    if not blocks:
        return 0
    leaf = blocks["0"]["attn"]["wq"]
    return leaf.shape[0]


def _layer(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[g], tree)


# ---------------------------------------------------------------------------
# Forward (prefill hidden states)
# ---------------------------------------------------------------------------

def _attn_mlp(bp, x, o, cfg: ArchConfig):
    x = x + attn_lib.out_project(bp["attn"], o)
    h = apply_norm(bp["ln2"], x, cfg.norm)
    return x + apply_mlp(bp["mlp"], h, cfg.activation)


def _apply_block(bp, x, cfg: ArchConfig, kind: str, positions, rope,
                 cache=None):
    """Residual block application on [B,S,D] activations.  With ``cache``
    (this block's {"k","v"} [B,S,Hk,D]) the prompt's K/V are also written
    into it, in place, from position 0."""
    h = apply_norm(bp["ln1"], x, cfg.norm)
    q, k, v = attn_lib.qkv_project(bp["attn"], h, positions, cfg.rope_theta,
                                   rope=rope)
    o = attn_lib.prefill_attention(q, k, v, causal=True)
    if cache is not None:
        attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, 0)
    return _attn_mlp(bp, x, o, cfg)


def _layers(params, cfg: ArchConfig, caches=None, rows=None):
    """Every layer in order as (kind, block params, block cache): the groups
    of the stacked leaves first, then the remainder layers.  The caches are
    views; ``rows`` narrows them to a slice of the batch (slot) axis."""
    pat = layer_pattern(cfg)

    def view(cache, g=None):
        if cache is None:
            return None
        out = cache if g is None else {n: t[g] for n, t in cache.items()}
        if rows is not None:
            out = {n: t[rows] for n, t in out.items()}
        return out

    for g in range(_n_groups(params)):
        for pos, kind in enumerate(pat):
            key = str(pos)
            yield (kind, _layer(params["blocks"][key], g),
                   view(caches["groups"][key] if caches else None, g))
    for i in sorted(params.get("rem", {})):
        yield (pat[int(i)], params["rem"][i],
               view(caches["rem"][i] if caches else None))


def embed_inputs(params, cfg: ArchConfig, tokens=None, input_embeds=None):
    if input_embeds is not None:
        raise NotImplementedError(
            "precomputed input embeddings belong to the VLM frontend "
            "(ROADMAP A7)")
    return embed_tokens(params["embed"], tokens)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


@torch.no_grad()
def forward(params, cfg: ArchConfig, tokens=None, *, input_embeds=None):
    """Token inputs -> final-norm hidden states [B,S,D]."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, input_embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    for kind, bp, _ in _layers(params, cfg):
        x = _apply_block(bp, x, cfg, kind, positions, rope)
    return apply_norm(params["final_norm"], x, cfg.norm)


def lm_logits(params, cfg: ArchConfig, h):
    head = params.get("head")
    emb = params["embed"] if head is None else None
    return apply_head(head, h, emb, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Serving: caches
# ---------------------------------------------------------------------------
# Cache structure (plain dict):
#   {"groups": {pos: {"k","v"} [G,B,S,Hk,D]}, "rem": {i: {"k","v"} [B,S,Hk,D]}}
# where pos indexes the layer pattern and rem the remainder layers.  The
# batch (slot) axis is axis 1 under "groups" and axis 0 under "rem".

def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      device, stack: tuple = ()):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} (ROADMAP A6)")
    dt = dtype_of(cfg.dtype)
    shape = stack + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    check_supported(cfg)
    device = resolve_device(device)
    pat = layer_pattern(cfg)
    G, n_rem = divmod(cfg.n_layers, len(pat))
    groups = {}
    if G:
        for pos, kind in enumerate(pat):
            groups[str(pos)] = _init_block_cache(cfg, kind, batch, max_len,
                                                 device, (G,))
    rem = {str(i): _init_block_cache(cfg, pat[i], batch, max_len, device)
           for i in range(n_rem)}
    return {"groups": groups, "rem": rem}


def _decode_block(bp, x, cfg, kind, pos, lens, rope, cache):
    """x: [B,1,D]; pos: [B] positions of the new token, lens = pos + 1;
    cache: this block's {"k","v"} [B,S,Hk,D], updated in place."""
    h = apply_norm(bp["ln1"], x, cfg.norm)
    q, k, v = attn_lib.qkv_project(bp["attn"], h, pos[:, None], cfg.rope_theta,
                                   rope=rope)
    kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, pos)
    o = attn_lib.decode_attention(q[:, 0], kc, vc, lens)
    return _attn_mlp(bp, x, o[:, None], cfg)


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token, pos, caches, *,
                input_embeds=None):
    """One-token decode.  token: [B] int.  ``pos`` may be an int or 0-d
    tensor (shared) or a [B] tensor of per-slot positions (continuous
    batching).

    Returns (logits [B,V] f32, caches); the caches are the tensors passed in,
    updated in place.
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, token[:, None] if token is not None else None,
                     input_embeds)
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.long).expand(B)
    lens = (pos + 1).to(torch.int32)
    rope = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for kind, bp, cache in _layers(params, cfg, caches):
        x = _decode_block(bp, x, cfg, kind, pos, lens, rope, cache)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_logits(params, cfg, x)[:, 0]
    return logits, caches


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, *, input_embeds=None,
            max_len: Optional[int] = None, caches=None, slot: int = 0):
    """Process a prompt, filling caches.  Returns (last-position logits,
    caches).

    With ``caches=None`` fresh zero caches of ``[B, max_len]`` are made.
    Otherwise K/V are written IN PLACE into batch rows ``[slot, slot+B)`` of
    the given caches, positions ``[0, S)``; entries beyond the prompt keep
    whatever they held (they are masked by the per-row lengths at decode).
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, input_embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    if caches is None:
        caches = init_caches(cfg, B, max_len or S, device=x.device)
        slot = 0
    for kind, bp, cache in _layers(params, cfg, caches,
                                   rows=slice(slot, slot + B)):
        x = _apply_block(bp, x, cfg, kind, positions, rope, cache)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_logits(params, cfg, x[:, -1:])[:, 0]
    return logits, caches
