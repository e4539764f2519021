"""Attention: GQA with RoPE, routed to the hand-written kernels.

* ``naive_attention``   O(S^2) oracle for tests.
* ``prefill_attention`` causal attention over a prompt, optionally within a
                        sliding window: the flash-attention kernel wrapper
                        (``kernels/flash_attention``), with its backward
                        kernel under autograd.
* ``decode_attention``  one new token against the KV cache with per-row
                        lengths: the decode-attention kernel wrapper
                        (``kernels/decode_attention``).  A sliding-window
                        layer's cache is a ring buffer of ``window`` slots,
                        every slot below ``min(cur_len, window)`` valid.

The wrappers launch the CUDA kernels for tensors on the card and take their
plain PyTorch versions only for tensors on the CPU.  All math accumulates in
f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as _decode_ops
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.models.common import (einsum, fan_in_init, normal_init,
                                       zeros_init)
from repro_torch.models.layers import apply_rope


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype, qkv_bias: bool = False, stack: tuple = ()):
    n = len(stack)
    p = {
        "wq": normal_init(gen, stack + (d, n_heads, head_dim), dtype),
        "wk": normal_init(gen, stack + (d, n_kv, head_dim), dtype),
        "wv": normal_init(gen, stack + (d, n_kv, head_dim), dtype),
        "wo": fan_in_init(gen, stack + (n_heads, head_dim, d), dtype,
                          fan_axis=n),
    }
    if qkv_bias:
        p["bq"] = zeros_init(gen, stack + (n_heads, head_dim), dtype)
        p["bk"] = zeros_init(gen, stack + (n_kv, head_dim), dtype)
        p["bv"] = zeros_init(gen, stack + (n_kv, head_dim), dtype)
    return p


def qkv_project(params, x, positions, rope_theta: float, use_rope: bool = True,
                rope=None):
    """x: [B,S,D] -> q [B,S,Hq,Dh], k,v [B,S,Hkv,Dh] (RoPE applied).
    ``rope`` is the precomputed ``layers.rope_table`` of ``positions``."""
    q = einsum("btd,dhk->bthk", x, params["wq"])
    k = einsum("btd,dhk->bthk", x, params["wk"])
    v = einsum("btd,dhk->bthk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if use_rope:
        q = apply_rope(q, positions, rope_theta, rope)
        k = apply_rope(k, positions, rope_theta, rope)
    return q, k, v


def out_project(params, attn_out):
    """attn_out: [B,S,Hq,Dh] -> [B,S,D]."""
    return einsum("bthk,hkd->btd", attn_out, params["wo"])


# ---------------------------------------------------------------------------
# Reference (oracle) attention
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B,Sq,Hq,Dh], k/v: [B,Sk,Hkv,Dh].  GQA via head grouping."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Sq, Hk, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / Dh ** 0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Model-facing calls into the kernel wrappers
# ---------------------------------------------------------------------------

def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,Hq,Dh] against k/v [B,Sk,Hkv,Dh]; the causal mask is aligned
    to the end of the keys (chunked prefill when Sq < Sk); ``window > 0``:
    each query sees only its last ``window`` keys.  When autograd records
    (grad enabled and an input requires grad) the call goes through
    ``FlashAttention``, whose backward is the backward kernel; serving
    launches the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_ops.FlashAttention.apply(q, k, v, causal, window)
    return _flash_ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cur_len, *, window: int = 0):
    """q: [B,Hq,Dh]; caches: [B,Smax,Hkv,Dh]; cur_len: int, 0-d or per-slot
    [B] tensor (tokens valid per batch row: continuous batching).  With
    ``window`` the cache is a ring buffer and ``min(cur_len, window)`` of
    its slots are valid: softmax does not depend on the keys' order, and
    RoPE was applied before caching."""
    B = q.shape[0]
    lens = torch.as_tensor(cur_len, device=q.device).to(torch.int32)
    lens = lens.expand(B)
    if window:
        lens = torch.clamp(lens, max=window)
    return _decode_ops.decode_attention(q, k_cache, v_cache,
                                        lens.contiguous())


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos, *, window: int = 0):
    """Insert k/v at ``pos`` ([B,1,Hkv,Dh] or [B,S,Hkv,Dh] prefill), IN PLACE;
    returns the same cache tensors.

    ``pos`` may be a scalar (shared position) or a [B] tensor (per-slot
    positions, continuous batching; requires S == 1).  With ``window`` the
    cache is a ring buffer: position ``p`` goes to slot ``p % window``.  The
    new entries are cast to the cache dtype first, so the insert never
    promotes the cache.
    """
    k_new = k_new.to(k_cache.dtype)
    v_new = v_new.to(v_cache.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if k_new.shape[1] != 1:
            raise ValueError("per-slot insert is decode-only (S must be 1)")
        rows = torch.arange(k_new.shape[0], device=k_cache.device)
        idx = pos.to(device=k_cache.device, dtype=torch.long)
        if window:
            idx = idx % window
        k_cache[rows, idx] = k_new[:, 0]
        v_cache[rows, idx] = v_new[:, 0]
        return k_cache, v_cache
    pos = int(pos)
    S = k_new.shape[1]
    if window:
        idx = (pos + torch.arange(S, device=k_cache.device)) % window
        k_cache[:, idx] = k_new
        v_cache[:, idx] = v_new
        return k_cache, v_cache
    k_cache[:, pos:pos + S] = k_new
    v_cache[:, pos:pos + S] = v_new
    return k_cache, v_cache
