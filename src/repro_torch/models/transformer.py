"""Decoder-only LM: dense, MoE, hybrid (RG-LRU + local attention), xLSTM and
the VLM backbone.

Layer stacks keep the reference layout: the per-arch layer pattern (e.g.
``("rec", "rec", "attn")`` for RecurrentGemma, ``("mlstm",)*7 + ("slstm",)``
for xLSTM, ``("attn",)`` for dense and MoE) is applied cyclically; params of
the pattern position ``pos`` live under ``blocks/<pos>/...`` with a leading
group axis ``[G, ...]`` (``G = n_layers // len(pattern)``); the remainder
layers, unstacked, under ``rem/<i>/...``.  The stack is applied by a Python
loop over ``g`` that indexes the stacked leaves.

Entry points:
    init_lm(cfg, seed=..., device=...) -> params
    forward(params, cfg, tokens)       -> (final hidden states [B,S,D],
                                           MoE aux losses (lb, z))
    lm_logits / lm_loss                -> f32 vocab projection / chunked
                                          next-token cross-entropy
    prefill(...) / decode_step(...)    -> serving paths with caches / states

``forward`` and ``lm_loss`` are differentiable (the training path): the
attention layers take the flash-attention kernel's autograd ``Function``,
and ``remat`` recomputes a group of the layer pattern in the backward
(``full``) or keeps only its matrix products (``dots``).  The serving paths
run under ``torch.no_grad``.

Serving caches are updated IN PLACE: ``prefill`` and ``decode_step`` write
into the cache tensors they are given and return the same objects.  A
prefill into a slot of shared caches starts that slot's recurrent state
from the initial values, as the reference's fresh caches do.

Every entry point takes token ids or, for the VLM (``frontend ==
"patch_stub"``), precomputed patch embeddings ``input_embeds`` ([B,S,D] for
a prompt, [B,1,D] for a decode step), which go through the multimodal
projector ``vlm_proj/w`` [D,D] first.  The encoder-decoder models have
their own module, ``models/encdec.py``; ``models/registry.py`` picks one.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (dot, dtype_of, make_generator,
                                       normal_init, resolve_device, tree_map,
                                       tree_paths)
from repro_torch.models.layers import (apply_head, apply_mlp, apply_norm,
                                       embed_tokens, init_embed, init_head,
                                       init_mlp, init_norm, rope_table)
from repro_torch.models.sharding import (gather_last, logsumexp_last,
                                         shard_act)

PyTree = Any


def layer_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.hybrid is not None:
        return cfg.hybrid.pattern
    return ("attn",)


def _window_for(cfg: ArchConfig, kind: str) -> int:
    if kind == "attn" and cfg.hybrid is not None:
        return cfg.hybrid.window
    return 0


def attention_layers(cfg: ArchConfig) -> int:
    """How many of the ``n_layers`` are attention layers (each launches
    attention once a prefill or decode step)."""
    pat = layer_pattern(cfg)
    G, n_rem = divmod(cfg.n_layers, len(pat))
    return G * pat.count("attn") + pat[:n_rem].count("attn")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _ffn_params(gen, cfg: ArchConfig, stack: tuple) -> dict:
    dt = dtype_of(cfg.dtype)
    if cfg.moe is not None:
        return {"moe": moe_lib.init_moe(gen, cfg.d_model, cfg.moe, dt, stack)}
    return {"mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                            stack)}


def _init_block(gen, cfg: ArchConfig, kind: str, stack: tuple = ()) -> PyTree:
    """One block's params; ``stack=(G,)`` draws G layers at once with a
    leading group axis."""
    dt = dtype_of(cfg.dtype)
    d = cfg.d_model
    p: dict = {"ln1": init_norm(gen, d, cfg.norm, dt, stack)}
    if kind == "attn":
        p["attn"] = attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
            cfg.qkv_bias, stack)
        p["ln2"] = init_norm(gen, d, cfg.norm, dt, stack)
        p.update(_ffn_params(gen, cfg, stack))
    elif kind == "rec":
        h = cfg.hybrid
        p["rec"] = rglru_lib.init_rglru_block(gen, d, h.lru_width or d,
                                              h.conv_width, dt, stack)
        p["ln2"] = init_norm(gen, d, cfg.norm, dt, stack)
        p.update(_ffn_params(gen, cfg, stack))
    elif kind == "mlstm":
        p["mlstm"] = ssm_lib.init_mlstm_block(gen, d, cfg.n_heads,
                                              cfg.hybrid.conv_width, dt, stack)
    elif kind == "slstm":
        p["slstm"] = ssm_lib.init_slstm_block(gen, d, cfg.n_heads, dt, stack)
    else:
        raise ValueError(kind)
    return p


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> PyTree:
    """Random parameters drawn on ``device`` (None: the GPU) from a
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    dt = dtype_of(cfg.dtype)
    pat = layer_pattern(cfg)
    n_groups, n_rem = divmod(cfg.n_layers, len(pat))

    params: dict = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        params["head"] = init_head(gen, cfg.d_model, cfg.vocab_size, dt)
    params["final_norm"] = init_norm(gen, cfg.d_model, cfg.norm, dt)
    if cfg.frontend == "patch_stub":
        params["vlm_proj"] = {"w": normal_init(gen, (cfg.d_model, cfg.d_model),
                                               dt)}
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
    return tree_paths(blocks["0"])[0][1].shape[0]


def _layer(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[g], tree)


# ---------------------------------------------------------------------------
# Blocks: prompt-length (forward / prefill) and one-token (decode)
# ---------------------------------------------------------------------------

def _no_aux(x):
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    return z, z


def _residual(x, y):
    """``x + y``, the residual stream.  Over a mesh it is constrained to
    ``act_btd`` (batch over data, whole rows on every model rank): a block's
    output projection leaves a partial sum over ``model``, which is reduced
    here, so the next block's products shard over ``model`` instead of
    gathering their weights (DTensor picks the layout that moves the fewest
    bytes, whatever it costs in compute)."""
    return shard_act(x + y, "act_btd")


def _ffn(bp, x, cfg: ArchConfig, kind: str):
    """The block's second half: norm, then the MLP or (attention blocks of
    MoE configs) the experts, residual added.  Returns (x, (lb, z)): the
    MoE's auxiliary losses (zeros without experts), a training signal that
    serving drops."""
    h = apply_norm(bp["ln2"], x, cfg.norm)
    if kind == "attn" and cfg.moe is not None:
        out, aux = moe_lib.apply_moe(bp["moe"], h, cfg.moe)
        return _residual(x, out), aux
    return _residual(x, apply_mlp(bp["mlp"], h, cfg.activation)), _no_aux(x)


def _store(cache: dict, new: dict) -> None:
    """Write a block's new state into its cache view, in place."""
    for name, t in new.items():
        cache[name].copy_(t)


def _apply_block(bp, x, cfg: ArchConfig, kind: str, positions, rope,
                 cache=None):
    """Residual block application on [B,S,D] activations -> (x, MoE aux
    losses (lb, z)).  With ``cache`` (this block's cache / state view) the
    prompt's K/V, or the recurrent state at its end, are also written into
    it, in place; a recurrent block starts from the initial state, never
    from what the cache held."""
    window = _window_for(cfg, kind)
    h = apply_norm(bp["ln1"], x, cfg.norm)
    if kind == "attn":
        q, k, v = attn_lib.qkv_project(bp["attn"], h, positions,
                                       cfg.rope_theta, rope=rope)
        q = shard_act(q, "act_bthd")
        o = attn_lib.prefill_attention(q, k, v, causal=True, window=window)
        if cache is not None:
            S = k.shape[1]
            keep = min(window, S) if window else S
            attn_lib.update_kv_cache(cache["k"], cache["v"], k[:, S - keep:],
                                     v[:, S - keep:], S - keep, window=window)
        x = _residual(x, attn_lib.out_project(bp["attn"], o))
        return _ffn(bp, x, cfg, kind)
    if kind == "rec":
        if cache is None:
            o = rglru_lib.apply_rglru_block(bp["rec"], h)
        else:
            o, (hN, conv) = rglru_lib.apply_rglru_block(
                bp["rec"], h, conv_state=torch.zeros_like(cache["conv"]),
                return_state=True)
            _store(cache, {"h": hN, "conv": conv})
        return _ffn(bp, _residual(x, o), cfg, kind)
    if kind == "mlstm":
        if cache is None:
            o = ssm_lib.apply_mlstm_block(bp["mlstm"], h)
        else:
            o, (st, tail) = ssm_lib.apply_mlstm_block(bp["mlstm"], h,
                                                      return_state=True)
            _store(cache, {**st, "conv": tail})
        return _residual(x, o), _no_aux(x)
    if kind == "slstm":
        if cache is None:
            o = ssm_lib.apply_slstm_block(bp["slstm"], h)
        else:
            o, st = ssm_lib.apply_slstm_block(bp["slstm"], h,
                                              return_state=True)
            _store(cache, st)
        return _residual(x, o), _no_aux(x)
    raise ValueError(kind)


def _decode_block(bp, x, cfg, kind, pos, lens, rope, cache):
    """x: [B,1,D]; pos: [B] positions of the new token, lens = pos + 1;
    cache: this block's cache / state view, updated in place."""
    window = _window_for(cfg, kind)
    h = apply_norm(bp["ln1"], x, cfg.norm)
    if kind == "attn":
        q, k, v = attn_lib.qkv_project(bp["attn"], h, pos[:, None],
                                       cfg.rope_theta, rope=rope)
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, pos,
                                          window=window)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, lens, window=window)
        x = _residual(x, attn_lib.out_project(bp["attn"], o[:, None]))
        return _ffn(bp, x, cfg, kind)[0]
    if kind == "rec":
        o, hN, conv = rglru_lib.decode_rglru_block(bp["rec"], h, cache["h"],
                                                   cache["conv"])
        _store(cache, {"h": hN, "conv": conv})
        return _ffn(bp, _residual(x, o), cfg, kind)[0]
    if kind == "mlstm":
        st = {n: cache[n] for n in ("C", "n", "m")}
        o, st, conv = ssm_lib.decode_mlstm_block(bp["mlstm"], h, st,
                                                 cache["conv"])
        _store(cache, {**st, "conv": conv})
        return _residual(x, o)
    if kind == "slstm":
        o, st = ssm_lib.decode_slstm_block(bp["slstm"], h, dict(cache))
        _store(cache, st)
        return _residual(x, o)
    raise ValueError(kind)


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
    """Token ids through the embedding table, or precomputed embeddings
    through the VLM's projector (where the model has one)."""
    if input_embeds is None:
        return embed_tokens(params["embed"], tokens)
    if "vlm_proj" in params:
        return dot(input_embeds, params["vlm_proj"]["w"])
    return input_embeds


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


REMAT = ("none", "full", "dots")
# matrix products whose outputs ``remat="dots"`` keeps (the counterpart of
# jax's ``checkpoint_dots_with_no_batch_dims``): everything else of a group
# is recomputed in the backward
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` under the activation-checkpoint policy ``remat``."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be one of {REMAT}, not {remat!r}")


def _unstack(tree, n: int) -> list:
    """A stacked tree [G, ...] as G trees of its slices.  ``unbind`` makes
    the backward stack the G gradients once, where indexing would add a
    whole-stack gradient a layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[g] for k, p in parts.items()} for g in range(n)]
    return list(tree.unbind(0))


def forward(params, cfg: ArchConfig, tokens=None, *, input_embeds=None,
            remat: str = "none", attn_block: int = 512):
    """Token (or embedding) inputs -> (final-norm hidden states [B,S,D],
    (lb, z) MoE aux losses summed over layers, f32).  ``remat`` applies to
    each group of the layer pattern, as the reference's scan body;
    ``attn_block`` is accepted for the reference's signature and has no
    effect (the kernel's q tile is ``flash_attention.ops.BLOCK_Q``)."""
    del attn_block
    x = shard_act(embed_inputs(params, cfg, tokens, input_embeds), "act_btd")
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    pat = layer_pattern(cfg)

    def group(x, gp):
        lb, zl = _no_aux(x)
        for pos, kind in enumerate(pat):
            x, (a_lb, a_zl) = _apply_block(gp[str(pos)], x, cfg, kind,
                                           positions, rope)
            lb, zl = lb + a_lb, zl + a_zl
        return shard_act(x, "act_btd"), lb, zl

    body = _remat(group, remat)
    lb, zl = _no_aux(x)
    G = _n_groups(params)
    for gp in (_unstack(params["blocks"], G) if G else ()):
        x, a_lb, a_zl = body(x, gp)
        lb, zl = lb + a_lb, zl + a_zl
    for i in sorted(params.get("rem", {})):
        x, (a_lb, a_zl) = _apply_block(params["rem"][i], x, cfg, pat[int(i)],
                                       positions, rope)
        lb, zl = lb + a_lb, zl + a_zl
    return apply_norm(params["final_norm"], x, cfg.norm), (lb, zl)


def lm_logits(params, cfg: ArchConfig, h):
    head = params.get("head")
    emb = params["embed"] if head is None else None
    return apply_head(head, h, emb, cfg.logit_softcap)


def _chunk_loss(params, cfg, hx, lx, mx):
    """(sum of masked NLL, mask count) of one chunk: [B,c,D] -> f32."""
    logits = shard_act(lm_logits(params, cfg, hx), "act_btv")  # [B,c,V] f32
    lse = logsumexp_last(logits)
    gold = gather_last(logits, lx.clamp_min(0))
    return ((lse - gold)[..., 0] * mx).sum(), mx.sum()


def lm_loss(params, cfg: ArchConfig, h, labels, *, chunk: int = 512,
            mask=None):
    """Mean next-token cross-entropy over the labels >= 0 (or ``mask``),
    with the vocab projection taken ``chunk`` positions at a time.  Each
    chunk is checkpointed, so its [B,chunk,V] f32 logits are recomputed in
    the backward rather than kept for every chunk."""
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        lx = labels[:, c0:c0 + chunk]
        mx = (lx >= 0) if mask is None else mask[:, c0:c0 + chunk]
        s, c = ckpt.checkpoint(_chunk_loss, params, cfg, h[:, c0:c0 + chunk],
                               lx, mx.to(torch.float32), use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / cnt.clamp_min(1.0)


# ---------------------------------------------------------------------------
# Serving: caches and states
# ---------------------------------------------------------------------------
# Cache structure (plain dict): {"groups": {pos: cache [G,B,...]}, "rem":
# {i: cache [B,...]}} where pos indexes the layer pattern and rem the
# remainder layers; the batch (slot) axis is axis 1 under "groups" and
# axis 0 under "rem".  A block's cache is one dict of named tensors:
#   attn   {"k","v"} [B,S,Hk,D]   (S = min(max_len, window) for windowed
#                                  layers, whose cache is a ring buffer)
#   rec    {"h" [B,W], "conv" [B,cw-1,W]}                  (cfg.dtype)
#   mlstm  {"C" [B,H,hd,hd], "n" [B,H,hd], "m" [B,H]} f32, "conv" [B,cw-1,Di]
#   slstm  {"c","n","h","m"} [B,H,hd] f32

def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      device, stack: tuple = ()):
    dt = dtype_of(cfg.dtype)

    def stacked(tree):
        return {n: t.expand(stack + t.shape).clone() for n, t in tree.items()}

    if kind == "attn":
        w = _window_for(cfg, kind)
        S = min(max_len, w) if w else max_len
        shape = stack + (batch, S, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    cw = cfg.hybrid.conv_width
    if kind == "rec":
        width = cfg.hybrid.lru_width or cfg.d_model
        return {"h": torch.zeros(stack + (batch, width), dtype=dt,
                                 device=device),
                "conv": torch.zeros(stack + (batch, cw - 1, width), dtype=dt,
                                    device=device)}
    if kind == "mlstm":
        di = int(ssm_lib.MLSTM_EXPANSION * cfg.d_model)
        st = ssm_lib.init_mlstm_state(batch, cfg.n_heads, di // cfg.n_heads,
                                      device)
        st["conv"] = torch.zeros((batch, cw - 1, di), dtype=dt, device=device)
        return stacked(st)
    if kind == "slstm":
        return stacked(ssm_lib.init_slstm_state(
            batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device))
    raise ValueError(kind)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
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


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token, pos, caches, *,
                input_embeds=None):
    """One-token decode.  token: [B] int (or ``input_embeds`` [B,1,D] with
    ``token=None``).  ``pos`` may be an int or 0-d
    tensor (shared) or a [B] tensor of per-slot positions (continuous
    batching).

    Returns (logits [B,V] f32, caches); the caches are the tensors passed in,
    updated in place.
    """
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
    """Process a prompt (token ids [B,S], or ``input_embeds`` [B,S,D] with
    ``tokens=None``), filling caches.  Returns (last-position logits,
    caches).

    With ``caches=None`` fresh caches of ``[B, max_len]`` are made.
    Otherwise the prompt's K/V and recurrent states are written IN PLACE
    into batch rows ``[slot, slot+B)`` of the given caches: K/V at
    positions ``[0, S)`` (a windowed layer: its last ``window`` positions,
    each at ``pos % window``), entries beyond the prompt keeping whatever
    they held (masked by the per-row lengths at decode); the recurrent
    states are computed from their initial values and replace the slot's.
    """
    x = embed_inputs(params, cfg, tokens, input_embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    rope = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    if caches is None:
        caches = init_caches(cfg, B, max_len or S, device=x.device)
        slot = 0
    for kind, bp, cache in _layers(params, cfg, caches,
                                   rows=slice(slot, slot + B)):
        x = _apply_block(bp, x, cfg, kind, positions, rope, cache)[0]
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_logits(params, cfg, x[:, -1:])[:, 0]
    return logits, caches
