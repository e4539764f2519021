"""Plain PyTorch version of flash attention (GQA, causal or not, f32 math).

Same function as the CUDA kernel, atom form included.  The causal mask is
aligned to the END of the keys (``kpos <= Sk - Sq + qrow``), which covers
self-attention (Sq == Sk) and chunked prefill (Sq < Sk).  ``window > 0``
also masks keys at or before ``qpos - window`` (sliding-window attention).
A query row with no unmasked key gives zeros (the ``l == 0 -> 1`` guard of
the kernel), never NaN.
"""
from __future__ import annotations

import torch


def _attend(q, k, v, qpos, *, causal: bool, sm_scale: float,
            window: int = 0):
    """q [B,Sq,Hk,G,D], k/v [B,Sk,Hk,D], qpos [Sq] (position of each query
    row among the keys) -> f32 [B,Sq,Hk,G,D]."""
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * sm_scale
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((qpos.shape[0], Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos[:, None]
    if window > 0:
        mask &= kpos > qpos[:, None] - window
    if causal or window > 0:
        s = s.masked_fill(~mask[None, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                       # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())


def attention_ref(q, k, v, *, causal: bool = True, sm_scale=None,
                  window: int = 0):
    """q: [B,Sq,Hq,D]; k/v: [B,Sk,Hk,D] -> [B,Sq,Hq,D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    o = _attend(q.reshape(B, Sq, Hk, Hq // Hk, D), k, v, qpos, causal=causal,
                sm_scale=scale, window=window)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_atom_ref(q, k, v, o, *, start: int, num_tiles: int,
                             causal: bool = True, block_q: int = 64,
                             window: int = 0):
    """Tiles ``[start, start+num_tiles)`` of the flat tile space
    ``(B*Hq) x ceil(Sq/block_q)`` (tile ``t`` is head ``bh = t // n_qblocks``,
    q rows ``[qi*block_q, (qi+1)*block_q)`` with ``qi = t % n_qblocks``),
    written in place into the running output ``o`` [B,Sq,Hq,D]; every other
    tile is left as it is."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    n_qblocks = -(-Sq // block_q)
    assert 0 <= start and start + num_tiles <= B * Hq * n_qblocks
    scale = 1.0 / D ** 0.5
    t, end = start, start + num_tiles
    while t < end:                              # one q head at a time
        bh, qi0 = divmod(t, n_qblocks)
        qi1 = min(n_qblocks, qi0 + end - t)
        b, h = divmod(bh, Hq)
        r0, r1 = qi0 * block_q, min(Sq, qi1 * block_q)
        qpos = (Sk - Sq) + torch.arange(r0, r1, device=q.device)
        hk = h // G
        out = _attend(q[b:b + 1, r0:r1, h:h + 1, None],
                      k[b:b + 1, :, hk:hk + 1], v[b:b + 1, :, hk:hk + 1],
                      qpos, causal=causal, sm_scale=scale, window=window)
        o[b, r0:r1, h] = out[0, :, 0, 0].to(o.dtype)
        t += qi1 - qi0
    return o
