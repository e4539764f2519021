"""Plain PyTorch version of decode attention (GQA, per-row valid lengths).

Same function as the CUDA kernel, atom form and lse output included.  f32
math, output in the input dtype (an atom: in its output's); a row whose
length is 0 gives zeros (the ``l == 0 -> 1`` guard of the kernel), never NaN, and an
lse of ``-inf``.  The lse of a query row is ``m + log(l)``: the log of the
sum of its exponentiated, scaled scores over the valid keys.
"""
from __future__ import annotations

import torch


def _attend(q, k_cache, v_cache, lens):
    """q [B,Hk,G,D], caches [B,S,Hk,D], lens [B] -> (f32 [B,Hk,G,D], lse f32
    [B,Hk,G])."""
    S, D = k_cache.shape[1], q.shape[-1]
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k_cache.float())
    s = s * (1.0 / D ** 0.5)
    lens = lens.clamp(0, S)
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                       # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]           # l == 0: -inf
    l = torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / l, lse


def decode_attention_ref(q, k_cache, v_cache, lens, *,
                         return_lse: bool = False):
    """q: [B,Hq,D]; caches: [B,S,Hk,D]; lens: [B] int -> [B,Hq,D], with the
    lse [B,Hq] f32 if ``return_lse``."""
    B, Hq, D = q.shape
    Hk = k_cache.shape[2]
    o, lse = _attend(q.reshape(B, Hk, Hq // Hk, D), k_cache, v_cache, lens)
    o = o.reshape(B, Hq, D).to(q.dtype)
    return (o, lse.reshape(B, Hq)) if return_lse else o


def decode_attention_atom_ref(q, k_cache, v_cache, lens, o, *, start: int,
                              num_rows: int, lse=None):
    """Rows ``[start, start+num_rows)`` of the ``R = B*Hk`` schedulable rows
    (row ``r`` is batch ``r // Hk``, kv head ``r % Hk``), written in place
    into the running output ``o`` [B,Hq,D] and, if given, the lse [B,Hq];
    every other row is left as it is."""
    B, Hq, D = q.shape
    Hk = k_cache.shape[2]
    G = Hq // Hk
    assert 0 <= start and start + num_rows <= B * Hk, (start, num_rows, B * Hk)
    og = o.view(B, Hk, G, D)
    lg = lse.view(B, Hk, G) if lse is not None else None
    qg = q.reshape(B, Hk, G, D)
    r, end = start, start + num_rows
    while r < end:                              # one batch row at a time
        b, h0 = divmod(r, Hk)
        h1 = min(Hk, h0 + end - r)
        out, row_lse = _attend(qg[b:b + 1, h0:h1], k_cache[b:b + 1, :, h0:h1],
                               v_cache[b:b + 1, :, h0:h1], lens[b:b + 1])
        og[b, h0:h1] = out[0].to(o.dtype)
        if lg is not None:
            lg[b, h0:h1] = row_lse[0]
        r += h1 - h0
    return o


def decode_attention_split_ref(q, k_cache, v_cache, lens, nsplit: int,
                               chunk: int, *, return_lse: bool = False):
    """The split-KV kernel's arithmetic: split ``j`` of each row attends to
    keys ``[j*chunk, min((j+1)*chunk, len))`` and keeps its partial
    ``(m_j, l_j, O_j)`` in f32 (an empty split: ``m = -inf, l = 0``); the
    partials are merged in split order 0..nsplit-1 with the ``l == 0 -> 1``
    rule, and the lse is ``m + log(sum_j f_j l_j)``.  q [B,Hq,D], caches
    [B,S,Hk,D], lens [B] -> [B,Hq,D] (and the lse [B,Hq] if
    ``return_lse``)."""
    B, Hq, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hk, Hq // Hk, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * (1.0 / D ** 0.5)
    kpos = torch.arange(S, device=q.device)
    lens = lens.clamp(0, S)
    m_all, l_all, o_all = [], [], []
    for j in range(nsplit):
        inside = ((kpos >= j * chunk) & (kpos < (j + 1) * chunk))[None, :] \
            & (kpos[None, :] < lens[:, None])                      # [B,S]
        sj = s.masked_fill(~inside[:, None, None, :], float("-inf"))
        m = sj.amax(dim=-1, keepdim=True)                          # [B,Hk,G,1]
        p = torch.exp(sj - torch.where(torch.isinf(m), torch.zeros_like(m), m))
        m_all.append(m)
        l_all.append(p.sum(dim=-1, keepdim=True))
        o_all.append(torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()))
    m = torch.stack(m_all).amax(dim=0)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    num = torch.zeros_like(o_all[0])
    den = torch.zeros_like(l_all[0])
    for mj, lj, oj in zip(m_all, l_all, o_all):              # in split order
        f = torch.exp(mj - m)
        num = num + f * oj
        den = den + f * lj
    lse = (m + torch.log(den)).reshape(B, Hq)                # den == 0: -inf
    den = torch.where(den == 0, torch.ones_like(den), den)
    o = (num / den).reshape(B, Hq, D).to(q.dtype)
    return (o, lse) if return_lse else o
