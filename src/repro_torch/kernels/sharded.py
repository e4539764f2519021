"""The attention kernels on ``DTensor`` operands: each rank runs the kernel
on its own shard.

Attention is exact on a shard that holds whole rows of the batch and whole
heads: ``local_attention`` redistributes q to batch over the data axes and
heads over ``model`` (``models/sharding.act_spec``, axes that do not divide
dropped), and k / v to the same batch split.  Their heads shard over
``model`` where q's do and the kv heads divide; otherwise they replicate
(GQA: 8 kv heads on a 16-way axis, or 1 kv head), and each rank hands the
kernel the kv heads its local q heads read (q head ``h`` reads kv head
``h // G``).  The kv gradient of such a rank covers only those heads, so it
is a partial sum over ``model``.  A sequence-sharded q is refused.

Decode (``head_dim_q=1``) against a KV cache whose sequence is split over a
mesh axis (``launch/shardings.cache_shardings``: kv heads that do not divide
``model``) leaves the cache where it is, as the reference's GSPMD does: q
is laid out whole on that axis, each rank attends to its own keys with
its lengths clamped to its part of the sequence, and the partials (f32
output and lse, ``fn(..., lse=, out_dtype=)``, decode attention's keywords)
are combined across the axis by ``merge.merge_partials`` over two
all-reduces: the max of the lse, then the weighted sums.  A layer moves
O(B * Hq * D) bytes, never the cache.  Any other sequence-sharded k / v is
gathered.

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
    out_pl = q_pl
    Hq, Hk = q.shape[head_dim_q], k.shape[head_dim_kv]
    names = dm.mesh_dim_names
    # decode: the mesh dims that split the cache's sequence (k and v alike)
    seq = [head_dim_q == 1 and all(
        isinstance(t.placements[i], Shard) and t.placements[i].dim == 1
        for t in (k, v)) and dm.size(i) > 1 for i in range(dm.ndim)]
    if any(seq):
        q_pl = [Replicate() if s else p for s, p in zip(seq, q_pl)]
    kv_pl, kv_grad_pl, rows_pl = [], [], []
    heads_split = 1
    for i, (name, p) in enumerate(zip(names, q_pl)):
        batch = isinstance(p, Shard) and p.dim == 0
        rows_pl.append(Shard(0) if batch else Replicate())
        if seq[i]:                               # the cache's sequence
            kv_pl.append(Shard(1))
            kv_grad_pl.append(Shard(1))
        elif batch:
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
    rl = [r.to_local() for r in rows]
    if any(seq):
        return _seq_sharded_decode(fn, q, ql, kl, vl, rl, k, seq, out_pl)
    out = fn(ql, kl, vl, *rl)
    return dtensor(out, dm, q_pl, tuple(q.shape))


def _seq_sharded_decode(fn, q, ql, kl, vl, rows, k, seq, out_pl):
    """Decode attention of this rank's q rows (whole on the ``seq`` mesh
    dims) against its part of a sequence-sharded cache, combined across
    those dims; returned laid out as ``out_pl``.  ``rows[0]`` are the rows'
    lengths over the whole cache."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.kernels.decode_attention.merge import merge_partials
    from repro_torch.models.sharding import dtensor
    dm = q.device_mesh
    S_local = kl.shape[1]
    first = compute_local_shape_and_global_offset(
        k.shape, dm, k.placements)[1][1]
    lens = (rows[0].to(torch.int32) - first).clamp(0, S_local)
    lse = torch.empty(ql.shape[:2], dtype=torch.float32, device=ql.device)
    o = fn(ql, kl, vl, lens, *rows[1:], lse=lse, out_dtype=torch.float32)
    whole = list(q.placements)

    def reduce(t, op):
        # a partial over the sequence dims, reduced to every rank of them
        part = [Partial(op) if s else p for s, p in zip(seq, whole)]
        shape = tuple(q.shape[:2]) + tuple(t.shape[2:])
        return dtensor(t, dm, part, shape).redistribute(dm, whole).to_local()

    out, _ = merge_partials(o, lse, out_dtype=q.dtype, reduce=reduce)
    return dtensor(out, dm, whole, tuple(q.shape)).redistribute(dm, out_pl)


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
