"""The attention kernels on ``DTensor`` operands: each rank runs the kernel
on its own shard.

Attention is exact on a shard that holds whole rows of the batch and whole
heads: ``local_attention`` redistributes q to batch over the data axes and
heads over ``model`` (``models/sharding.act_spec``, axes that do not divide
dropped), and k / v to the same batch split, every key on every rank (a
sequence-sharded KV cache is gathered).  Their heads shard over
``model`` where q's do and the kv heads divide; otherwise they replicate
(GQA: 8 kv heads on a 16-way axis, or 1 kv head), and each rank hands the
kernel the kv heads its local q heads read (q head ``h`` reads kv head
``h // G``).  The kv gradient of such a rank covers only those heads, so it
is a partial sum over ``model``.  A sequence-sharded q is refused.

The kernel function itself never sees a DTensor, so the CUDA path, the CPU
plain version and the dry-run's ``meta`` route (``roofline/cost.py``) are
the ones a plain tensor takes.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import is_dtensor


def local_attention(fn, q, k, v, *rows, head_dim_q: int = 2,
                    head_dim_kv: int = 2, kind: str = "act_bthd"):
    """``fn(q, k, v, *rows)`` on each rank's shard of DTensor operands,
    returned as a DTensor laid out as q; on plain tensors, ``fn`` itself.
    ``head_dim_q`` / ``head_dim_kv`` are the head dims of q and of k / v
    (dim 0 is the batch of all of them); ``rows`` are per-row operands
    ([B], the decode lengths); ``kind`` names q's ``act_spec``."""
    if not any(is_dtensor(t) for t in (q, k, v, *rows)):
        return fn(q, k, v, *rows)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.sharding import (act_spec, as_dtensor, dtensor,
                                             mesh_of, placements)
    dm = next(t.device_mesh for t in (q, k, v, *rows) if is_dtensor(t))
    mesh = mesh_of(dm)
    q, k, v = (as_dtensor(t, dm) for t in (q, k, v))
    rows = tuple(as_dtensor(r, dm) for r in rows)
    if any(isinstance(p, Shard) and 0 < p.dim < head_dim_q
           for p in q.placements):
        raise ValueError(f"attention of a sequence-sharded q "
                         f"({q.placements}) is not supported: each rank's "
                         f"kernel call takes whole rows of the batch")
    q_pl = placements(act_spec(kind, tuple(q.shape), mesh), mesh)
    Hq, Hk = q.shape[head_dim_q], k.shape[head_dim_kv]
    names = dm.mesh_dim_names
    kv_pl, kv_grad_pl, rows_pl = [], [], []
    heads_split = 1
    for name, p in zip(names, q_pl):
        batch = isinstance(p, Shard) and p.dim == 0
        rows_pl.append(Shard(0) if batch else Replicate())
        if batch:
            kv_pl.append(Shard(0))
            kv_grad_pl.append(Shard(0))
        elif isinstance(p, Shard):               # q's heads over this axis
            size = mesh.shape[name]
            if Hk % size == 0:
                kv_pl.append(Shard(head_dim_kv))
                kv_grad_pl.append(Shard(head_dim_kv))
            else:
                kv_pl.append(Replicate())
                kv_grad_pl.append(Partial())
                heads_split = size
                head_rank = dm.get_local_rank(name)
        else:
            kv_pl.append(Replicate())
            kv_grad_pl.append(Replicate())
    q = q.redistribute(dm, q_pl)
    k, v = (t.redistribute(dm, kv_pl) for t in (k, v))
    rows = tuple(r.redistribute(dm, rows_pl) for r in rows)
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad_pl) for t in (k, v))
    if heads_split > 1:
        kl, vl = (_kv_heads_of(t, head_rank, Hq // heads_split, Hq // Hk,
                               head_dim_kv) for t in (kl, vl))
    out = fn(ql, kl, vl, *(r.to_local() for r in rows))
    return dtensor(out, dm, q_pl, tuple(q.shape))


def _kv_heads_of(t, rank: int, hq_local: int, group: int, dim: int):
    """The kv heads that q heads ``[rank*hq_local, (rank+1)*hq_local)`` read
    (q head h reads kv head h // group), in the order of those q heads'
    groups: a contiguous run of kv heads when the local q heads hold whole
    groups or lie in one, else one kv head per local q head."""
    first = rank * hq_local
    if hq_local % group == 0 or group % hq_local == 0:
        lo = first // group
        return t.narrow(dim, lo, max(1, hq_local // group))
    idx = (first + torch.arange(hq_local, device=t.device)) // group
    return t.index_select(dim, idx)
