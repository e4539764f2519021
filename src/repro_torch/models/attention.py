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
from repro_torch.kernels.sharded import local_attention
from repro_torch.models.common import (einsum, fan_in_init, is_dtensor,
                                       normal_init, zeros_init)
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
        def fn(a, b, c):
            return _flash_ops.FlashAttention.apply(a, b, c, causal, window)
    else:
        def fn(a, b, c):
            return _flash_ops.flash_attention(a, b, c, causal=causal,
                                              window=window)
    return local_attention(fn, q, k, v)


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
    return local_attention(_decode_ops.decode_attention, q, k_cache,
                           v_cache, lens.contiguous(), head_dim_q=1,
                           kind="act_bhd")


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
        idx = pos.to(device=k_cache.device, dtype=torch.long)
        if window:
            idx = idx % window
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            if is_dtensor(cache):
                _insert_per_slot_sharded(cache, new[:, 0], idx)
            else:
                rows = torch.arange(new.shape[0], device=cache.device)
                cache[rows, idx] = new[:, 0]
        return k_cache, v_cache
    pos = int(pos)
    S = k_new.shape[1]
    if window and is_dtensor(k_cache):
        slots = [(pos + j) % window for j in range(S)]
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            _insert_positions_sharded(cache, new, slots)
        return k_cache, v_cache
    if window:
        idx = (pos + torch.arange(S, device=k_cache.device)) % window
        k_cache[:, idx] = k_new
        v_cache[:, idx] = v_new
        return k_cache, v_cache
    k_cache[:, pos:pos + S] = k_new
    v_cache[:, pos:pos + S] = v_new
    return k_cache, v_cache


def _laid_out_as_cache(t, cache, dims):
    """This rank's block of ``t`` split as the DTensor ``cache`` is on the
    cache dims that ``dims`` maps to dims of ``t``, whole elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.sharding import as_dtensor
    dm = cache.device_mesh
    pl = [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
          else Replicate() for p in cache.placements]
    return as_dtensor(t, dm).redistribute(dm, pl).to_local()


def _seq_offset(cache) -> int:
    """The first sequence position of this rank's block of ``cache``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)[1][1]


def _insert_positions_sharded(cache, new, slots):
    """``cache[:, slots] = new`` for a DTensor cache [B,S,Hkv,Dh] and new
    [B,len(slots),Hkv,Dh] (distinct slots, a prefill into a ring buffer):
    each rank writes the slots that fall in its part of the sequence."""
    n = _laid_out_as_cache(new, cache, {0: 0, 2: 2, 3: 3})
    c = cache.to_local()
    lo = _seq_offset(cache)
    mine = [(j, p - lo) for j, p in enumerate(slots)
            if lo <= p < lo + c.shape[1]]
    if mine:
        src, dst = (torch.tensor(x, device=c.device) for x in zip(*mine))
        c[:, dst] = n[:, src].to(c.dtype)


def _insert_per_slot_sharded(cache, new, idx):
    """``cache[b, idx[b]] = new[b]`` for a DTensor cache [B,S,Hkv,Dh] (an
    in-place index write has no DTensor rule when the cache's sequence is
    split): on each rank's shard, ``new`` [B,Hkv,Dh] laid out as the cache's
    batch and heads, each row written where its position falls in the
    rank's part of the sequence and left as it was elsewhere."""
    # cache dim -> new's dim (the sequence, dim 1, has no counterpart)
    n = _laid_out_as_cache(new, cache, {0: 0, 2: 1, 3: 2})
    i = _laid_out_as_cache(idx, cache, {0: 0})
    c = cache.to_local()
    local = i - _seq_offset(cache)
    inside = (local >= 0) & (local < c.shape[1])
    local = local.clamp(0, c.shape[1] - 1)
    rows = torch.arange(c.shape[0], device=c.device)
    c[rows, local] = torch.where(inside[:, None, None], n.to(c.dtype),
                                 c[rows, local])
