"""Plain PyTorch version of flash attention (GQA, causal or not, f32 math).

Same function as the CUDA kernel, atom form included.  The causal mask is
aligned to the END of the keys (``kpos <= Sk - Sq + qrow``), which covers
self-attention (Sq == Sk) and chunked prefill (Sq < Sk).  ``window > 0``
also masks keys at or before ``qpos - window`` (sliding-window attention).
A query row with no unmasked key gives zeros (the ``l == 0 -> 1`` guard of
the kernel), never NaN.

The forward can also give each row's log-sum-exp of its scaled scores
(natural base, f32 ``[B,Hq,Sq]``; ``+inf`` for a row with no unmasked key),
from which the backward recomputes the probabilities:
``flash_attention_bwd_atom_ref`` is the plain version of
``csrc/flash_attention_bwd.cu`` over the same tile space (dQ tiles of
``(B*Hq) x ceil(Sq/block_q)``, then dK/dV tiles of ``(B*Hk) x
ceil(Sk/block_k)``, numbered as ``bwd_tile`` says), each tile computed on its
own, so atoms compose bit for bit in any order.
"""
from __future__ import annotations

import torch

# the f32 backward's (and forward's) split-TF32 emulation, importable here
# as before it moved to the module the atom matmul's ref shares
from repro_torch.kernels.tf32 import tf32_round, tf32_split_product  # noqa: F401

def _visible(qpos, kpos, *, causal: bool, window: int):
    """[Sq, Sk] bool: which keys (at ``kpos``) each query row (at ``qpos``
    among the keys) sees."""
    kpos = kpos[None, :]
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos[:, None]
    if window > 0:
        mask &= kpos > qpos[:, None] - window
    return mask


def _attend(q, k, v, qpos, *, causal: bool, sm_scale: float,
            window: int = 0):
    """q [B,Sq,Hk,G,D], k/v [B,Sk,Hk,D], qpos [Sq] (position of each query
    row among the keys) -> (f32 [B,Sq,Hk,G,D], lse f32 [B,Hk,G,Sq])."""
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * sm_scale
    if causal or window > 0:
        mask = _visible(qpos, torch.arange(Sk, device=q.device),
                        causal=causal, window=window)
        s = s.masked_fill(~mask[None, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                       # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l == 0, torch.full_like(l, float("inf")),
                      m + torch.log(l))[..., 0]
    l = torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float()), lse


def attention_ref(q, k, v, *, causal: bool = True, sm_scale=None,
                  window: int = 0, return_lse: bool = False):
    """q: [B,Sq,Hq,D]; k/v: [B,Sk,Hk,D] -> [B,Sq,Hq,D]; with ``return_lse``
    also each row's log-sum-exp, f32 [B,Hq,Sq]."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    o, lse = _attend(q.reshape(B, Sq, Hk, Hq // Hk, D), k, v, qpos,
                     causal=causal, sm_scale=scale, window=window)
    o = o.reshape(B, Sq, Hq, D).to(q.dtype)
    if return_lse:
        return o, lse.reshape(B, Hq, Sq)
    return o


def flash_attention_atom_ref(q, k, v, o, *, start: int, num_tiles: int,
                             causal: bool = True, block_q: int = 64,
                             window: int = 0, lse=None):
    """Tiles ``[start, start+num_tiles)`` of the flat tile space
    ``(B*Hq) x ceil(Sq/block_q)`` (tile ``t`` is head ``bh = t // n_qblocks``,
    q rows ``[qi*block_q, (qi+1)*block_q)`` with ``qi = t % n_qblocks``),
    written in place into the running output ``o`` [B,Sq,Hq,D], and their
    rows' log-sum-exp into ``lse`` [B,Hq,Sq] when given; every other tile is
    left as it is."""
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
        out, row_lse = _attend(q[b:b + 1, r0:r1, h:h + 1, None],
                               k[b:b + 1, :, hk:hk + 1],
                               v[b:b + 1, :, hk:hk + 1], qpos, causal=causal,
                               sm_scale=scale, window=window)
        o[b, r0:r1, h] = out[0, :, 0, 0].to(o.dtype)
        if lse is not None:
            lse[b, h, r0:r1] = row_lse[0, 0, 0]
        t += qi1 - qi0
    return o


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def bwd_tile_space(q, k, block_q: int = 128,
                   block_k: int = 128) -> tuple[int, int]:
    """(dQ tiles, dK/dV tiles) of the backward's flat tile space."""
    B, Sq, Hq, _ = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    return B * Hq * -(-Sq // block_q), B * Hk * -(-Sk // block_k)


def bwd_tile(t: int, q, k, block_q: int = 128,
             block_k: int = 128) -> tuple:
    """Tile ``t`` of the backward's flat tile space: ("dq", b, h, r0, r1),
    query rows [r0, r1) of head h, or ("dkv", b, hk, c0, c1), keys [c0, c1)
    of KV head hk.  Each part is numbered block by block, heaviest causal
    block first: dQ tile t is head ``bh = t % (B*Hq)`` and the last query
    block but ``t // (B*Hq)``; dK/dV tile ``u = t - n_dq`` is KV head ``bhk =
    u % (B*Hk)`` and key block ``u // (B*Hk)``.  The kernel's ``tile_of``
    is the same map."""
    B, Sq, Hq, _ = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    n_dq, n_kv = bwd_tile_space(q, k, block_q, block_k)
    if not 0 <= t < n_dq + n_kv:
        raise ValueError(f"tile {t} outside [0, {n_dq + n_kv})")
    if t < n_dq:
        qi, bh = divmod(t, B * Hq)
        r0 = (-(-Sq // block_q) - 1 - qi) * block_q
        return ("dq", bh // Hq, bh % Hq, r0, min(Sq, r0 + block_q))
    kj, bhk = divmod(t - n_dq, B * Hk)
    c0 = kj * block_k
    return ("dkv", bhk // Hk, bhk % Hk, c0, min(Sk, c0 + block_k))


def attention_delta_ref(o, do):
    """delta = rowsum(dO * O) in f32: [B,Sq,Hq,D] -> [B,Hq,Sq]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q, k, lse, qpos, kpos, *, causal, window, scale):
    """P = exp(scale * q k^T - lse), zero where masked: q [Sq,D], k [Sk,D]
    at positions ``kpos``, lse [Sq] -> f32 [Sq,Sk].  An empty row's lse is
    +inf, so its P is 0."""
    s = (q.float() @ k.float().T) * scale
    mask = _visible(qpos, kpos, causal=causal, window=window)
    return torch.where(mask, torch.exp(s - lse[:, None]),
                       torch.zeros_like(s))


def flash_attention_bwd_atom_ref(q, k, v, do, lse, delta, dq, dk, dv, *,
                                 start: int, num_tiles: int,
                                 causal: bool = True, window: int = 0,
                                 block_q: int = 128, block_k: int = 128):
    """Tiles ``[start, start+num_tiles)`` of the backward's tile space,
    written in place, each as ``bwd_tile`` maps it: a dQ tile's query rows
    of one head; a dK/dV tile's keys of one KV head, summed over the G query
    heads of its group in order.  ``lse``, ``delta``: f32 [B,Hq,Sq]; dq like
    q, dk/dv like k."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    n_dq, n_kv = bwd_tile_space(q, k, block_q, block_k)
    assert 0 <= start and start + num_tiles <= n_dq + n_kv
    scale = 1.0 / D ** 0.5
    off = Sk - Sq
    qpos_all = off + torch.arange(Sq, device=q.device)
    kpos_all = torch.arange(Sk, device=q.device)
    for t in range(start, start + num_tiles):
        role, b, hh, lo, hi = bwd_tile(t, q, k, block_q, block_k)
        if role == "dq":
            h, r0, r1 = hh, lo, hi
            kk, vv = k[b, :, h // G], v[b, :, h // G]
            p = _probs(q[b, r0:r1, h], kk, lse[b, h, r0:r1],
                       qpos_all[r0:r1], kpos_all, causal=causal,
                       window=window, scale=scale)
            dp = do[b, r0:r1, h].float() @ vv.float().T
            ds = p * (dp - delta[b, h, r0:r1, None])
            dq[b, r0:r1, h] = ((ds @ kk.float()) * scale).to(dq.dtype)
            continue
        hk, c0, c1 = hh, lo, hi
        kk, vv = k[b, c0:c1, hk], v[b, c0:c1, hk]
        gk = torch.zeros((c1 - c0, D), dtype=torch.float32, device=q.device)
        gv = torch.zeros_like(gk)
        for h in range(hk * G, (hk + 1) * G):
            p = _probs(q[b, :, h], kk, lse[b, h], qpos_all, kpos_all[c0:c1],
                       causal=causal, window=window, scale=scale)
            dp = do[b, :, h].float() @ vv.float().T
            ds = p * (dp - delta[b, h, :, None])
            gv += p.T @ do[b, :, h].float()
            gk += ds.T @ q[b, :, h].float()
        dk[b, c0:c1, hk] = (gk * scale).to(dk.dtype)
        dv[b, c0:c1, hk] = gv.to(dv.dtype)
    return dq, dk, dv
