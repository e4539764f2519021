"""The combine of decode-attention partials over disjoint parts of a cache.

Each partial ``(o_r, lse_r)`` is decode attention over one part of the
keys (a sequence shard of the cache): ``o_r`` normalised over that part,
``lse_r`` the log of its sum of exponentiated scores, ``-inf`` for a part
that holds no valid key.  Over all parts

    M = max_r lse_r,   w_r = exp(lse_r - M),   o = sum_r w_r o_r / sum_r w_r

and the lse is ``M + log(sum_r w_r)``; where every part is empty the
output is zeros and the lse ``-inf``, as one call over the whole cache
gives.  The reference computes this in XLA, outside any Pallas kernel (GSPMD's
combine of a sequence-sharded cache), so it stays a few elementwise passes
of plain PyTorch on every device.
"""
from __future__ import annotations

import torch


def _over_stack(t, op: str):
    return t.amax(dim=0) if op == "max" else t.sum(dim=0)


def merge_partials(o, lse, *, out_dtype=None, reduce=_over_stack):
    """``(o, lse)`` over every partial.  By default the partials are
    stacked on dim 0: o [n,B,Hq,D], lse [n,B,Hq].  ``reduce(t, op)`` (op
    ``"max"`` or ``"sum"``) takes the reduction over the partials instead,
    across ranks say; then o [B,Hq,D] and lse [B,Hq] are this rank's own.
    Math in f32; o comes back in ``out_dtype`` (default o's)."""
    m = reduce(lse, "max")
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # all empty
    w = torch.exp(lse - m)                                    # empty: 0
    # one reduction of the weighted outputs and the weights side by side
    both = reduce(torch.cat([w[..., None] * o.float(), w[..., None]], dim=-1),
                  "sum")
    num, den = both[..., :-1], both[..., -1]
    out_lse = m + torch.log(den)                              # den 0: -inf
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num / den[..., None]).to(out_dtype or o.dtype), out_lse
