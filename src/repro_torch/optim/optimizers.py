"""Optimizers: AdamW with configurable moment dtype (fp32 / bf16 / int8).

The int8 mode stores both Adam moments block-quantized: blocks of
``QBLOCK`` = 128 values along the last dimension, each with its absmax scale
in f32, cutting optimizer memory from 8 to ~2 bytes a parameter.  The second
moment is quantized in the sqrt domain, so its relative error stays bounded
and small values survive.

Parameter trees are nested dicts of tensors.  The update is functional, as
the reference's: it returns new parameters and a new state, leaf by leaf in
f32.  Weight decay applies to every leaf of two or more dimensions as
stored, so the stacked ``[G, D]`` norm scales of a layer stack are decayed
too, as in the reference.

Over a mesh of ranks the blocks are the reference's global blocks of the
whole leaf, never blocks of a rank's shard: a DTensor is quantized on each
rank's piece only where that piece is whole blocks, else its last dim is
gathered first (``_block_placements``).

The route is chosen by what the inputs are (``fused_route``): where every
leaf is a plain CUDA tensor and the moments are f32 or bf16, the update
takes the fused kernels of ``kernels/adamw`` (one norm pass over all
gradients, one update pass a leaf, bit-equal to the plain route's update
given the same clip); CPU tensors, int8 moments and DTensor leaves take the
plain PyTorch route, leaf by leaf (``global_norm``, ``adamw_leaf``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.adamw import ops as fused
from repro_torch.models.common import (is_dtensor, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.sharding import dtensor, laid_out_as

PyTree = Any
QBLOCK = 128     # values a quantization block holds, along the last dim


class QTensor:
    """Block-quantized int8 tensor and its per-block f32 scales.

    ``q`` has the parameter's shape with the last dim padded to a multiple
    of ``QBLOCK``; ``scale`` drops the last dim to its number of blocks;
    ``shape`` is the original shape."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, shape: tuple):
        self.q = q            # int8 [..., last_padded]
        self.scale = scale    # f32  [..., n_blocks]
        self.shape = tuple(shape)


def quantize(x: torch.Tensor) -> QTensor:
    if is_dtensor(x):
        return _quantize_dtensor(x)
    shape = tuple(x.shape) if x.ndim else (1,)
    x2 = x.reshape(shape).to(torch.float32)
    last = shape[-1]
    pad = (-last) % QBLOCK
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
    blocks = x2.reshape(shape[:-1] + ((last + pad) // QBLOCK, QBLOCK))
    scale = (blocks.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(shape[:-1] + (last + pad,)).to(torch.int8)
    return QTensor(q, scale, tuple(x.shape))


def dequantize(t: QTensor) -> torch.Tensor:
    if is_dtensor(t.q):
        return _dequantize_dtensor(t)
    shape = t.shape if t.shape else (1,)
    last_p = t.q.shape[-1]
    blocks = t.q.reshape(t.q.shape[:-1] + (last_p // QBLOCK, QBLOCK))
    out = blocks.to(torch.float32) * t.scale[..., None]
    out = out.reshape(t.q.shape[:-1] + (last_p,))[..., :shape[-1]]
    return out.reshape(t.shape)


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``dequantize(quantize(x))``: ``x`` as its int8 blocks carry it.  Of
    a DTensor, on each rank's whole blocks (``_block_placements``), with no
    ``q`` laid out or moved."""
    if not is_dtensor(x):
        return dequantize(quantize(x))
    dm = x.device_mesh
    pl = _block_placements(x, x.shape[-1] if x.ndim else 1)
    local = x.redistribute(dm, pl).to_local()
    return dtensor(dequantize(quantize(local)), dm, pl, tuple(x.shape))


def _block_placements(x, last: int) -> list:
    """Placements of the DTensor ``x`` (a leaf of last dim ``last``, or its
    ``q`` or ``scale``) under which each rank holds whole global blocks:
    ``x``'s own where one mesh dim cuts the last dim into pieces of whole
    blocks, else with that dim gathered; a partial sum reduced."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    cuts = [i for i, p in enumerate(pl) if p.is_shard(x.ndim - 1)]
    if cuts and (len(cuts) > 1
                 or last % (x.device_mesh.size(cuts[0]) * QBLOCK)):
        pl = [Replicate() if i in cuts else p for i, p in enumerate(pl)]
    return pl


def _quantize_dtensor(x) -> QTensor:
    """``quantize`` of a DTensor, its blocks the whole leaf's.  ``q`` and
    ``scale`` come back laid out as ``launch/shardings._qtensor_sharding``
    lays out the state's moments: ``q`` at the leaf's placements unless its
    padded last dim does not divide, ``scale`` with its last dim whole."""
    from torch.distributed.tensor import Replicate
    dm = x.device_mesh
    shape = tuple(x.shape) or (1,)
    pl = _block_placements(x, shape[-1])
    t = quantize(x.redistribute(dm, pl).to_local())
    q_last = -(-shape[-1] // QBLOCK) * QBLOCK
    q = dtensor(t.q, dm, pl, shape[:-1] + (q_last,))
    scale = dtensor(t.scale, dm, pl, shape[:-1] + (q_last // QBLOCK,))
    own = [Replicate() if p.is_partial() else p for p in x.placements]
    cuts = [i for i, p in enumerate(own) if p.is_shard(x.ndim - 1)]
    n = math.prod(dm.size(i) for i in cuts)
    q_pl = [Replicate() if i in cuts and q_last % n else p
            for i, p in enumerate(own)]
    s_pl = [Replicate() if i in cuts else p for i, p in enumerate(own)]
    return QTensor(q.redistribute(dm, q_pl), scale.redistribute(dm, s_pl),
                   tuple(x.shape))


def _dequantize_dtensor(t: QTensor):
    """``dequantize`` of a ``QTensor`` of DTensors, each rank decoding whole
    blocks; laid out as ``_block_placements`` leaves it."""
    dm = t.q.device_mesh
    last = t.shape[-1] if t.shape else 1
    pl = _block_placements(t.q, last)
    q = t.q.redistribute(dm, pl).to_local()
    # a piece of whole blocks holds no padding
    cut = any(p.is_shard(t.q.ndim - 1) for p in pl)
    shape = (tuple(q.shape[:-1]) + (q.shape[-1] if cut else last,)
             if t.shape else ())
    local = dequantize(QTensor(q, t.scale.redistribute(dm, pl).to_local(),
                               shape))
    return dtensor(local, dm, pl, t.shape)


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: PyTree
    nu: PyTree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8


def _encode_moment(x, dtype: str, positive: bool = False):
    if dtype == "int8":
        return quantize(torch.sqrt(x) if positive else x)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.to(torch.float32)


def _decode_moment(x, dtype: str, positive: bool = False):
    if dtype == "int8":
        d = dequantize(x)
        return torch.square(d) if positive else d
    return x.to(torch.float32)


def adamw_init(params: PyTree, cfg: AdamWConfig) -> OptState:
    def zeros():
        return tree_map(lambda p: _encode_moment(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            cfg.moment_dtype), params)

    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32, leaves in
    the order of their sorted paths (the reference's tree order)."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_leaf(p, g, mu, nu, cfg: AdamWConfig, lr, clip, c1, c2):
    """One leaf's AdamW step on the plain route, in f32; the moments
    round-trip through the configured encoding.  Returns (new p, new mu,
    new nu)."""
    g = g.to(torch.float32) * clip
    # an int8 moment decodes as whole blocks: back to the leaf's layout
    mu = laid_out_as(_decode_moment(mu, cfg.moment_dtype), p)
    nu = laid_out_as(_decode_moment(nu, cfg.moment_dtype, positive=True), p)
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
    upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    if p.ndim >= 2:                       # decay matrices only
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    new_p = (p.to(torch.float32) - lr * upd).to(p.dtype)
    return (new_p, _encode_moment(mu, cfg.moment_dtype),
            _encode_moment(nu, cfg.moment_dtype, positive=True))


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fused_route(params: PyTree, grads: PyTree, state: OptState,
                cfg: AdamWConfig) -> bool:
    """Whether the update takes the fused kernels: every leaf of params,
    grads and moments a plain tensor, one of them on a CUDA device, the
    moments f32 or bf16.  int8 moments and DTensor leaves take the plain
    route, as does a tree with no CUDA leaf.  Raises for a tree with a CUDA
    leaf that the kernels cannot take (another device beside it, a dtype
    other than float32 and bfloat16, moments not of the configured dtype).
    Any layout is taken: ``adamw_update`` hands the kernels each operand
    contiguous."""
    moments = tree_leaves(state.mu) + tree_leaves(state.nu)
    if cfg.moment_dtype not in _MOMENT_DTYPES or any(
            isinstance(m, QTensor) for m in moments):
        return False
    leaves = tree_leaves(params) + tree_leaves(grads) + moments
    if any(is_dtensor(x) for x in leaves):
        return False
    cuda = [x.device for x in leaves if x.device.type == "cuda"]
    if not cuda:
        return False
    for i, x in enumerate(leaves):
        if x.device != cuda[0]:
            raise ValueError(f"fused AdamW: leaf {i} of params, grads and "
                             f"moments lies on {x.device}, another on "
                             f"{cuda[0]}")
        if x.dtype not in _MOMENT_DTYPES.values():
            raise TypeError(f"fused AdamW takes float32 and bfloat16, not "
                            f"{x.dtype} (leaf {i} of params, grads and "
                            f"moments)")
    want = _MOMENT_DTYPES[cfg.moment_dtype]
    if any(m.dtype != want for m in moments):
        raise TypeError(f"fused AdamW: moments of "
                        f"{sorted({str(m.dtype) for m in moments})}, the "
                        f"configuration's are {want}")
    return True


def adamw_update(params: PyTree, grads: PyTree, state: OptState,
                 cfg: AdamWConfig, lr: Optional[torch.Tensor] = None
                 ) -> tuple[PyTree, OptState, dict]:
    """One AdamW step, leaf by leaf in f32, on the route ``fused_route``
    picks; moments round-trip through the configured encoding.  ``lr`` (f32
    scalar tensor) defaults to ``cfg.lr``.  Returns (new params, new state,
    {"grad_norm"})."""
    on_kernels = fused_route(params, grads, state, cfg)
    step = state.step + 1
    lr = _f32(cfg.lr, step) if lr is None else lr
    trees = (params, grads, state.mu, state.nu)
    if on_kernels:
        # the kernels read flat memory: each operand contiguous, a copy only
        # of one that is not (a tied embedding's gradient from autograd, a
        # dequantized gradient cut from its padded blocks)
        ps, gs, mus, nus = ([x.contiguous() for x in tree_leaves(t)]
                            for t in trees)
        gnorm = fused.grad_norm(gs)
    else:
        ps, gs, mus, nus = (tree_leaves(t) for t in trees)
        gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(cfg.b1, step), stepf)
    c2 = 1.0 - torch.pow(_f32(cfg.b2, step), stepf)

    if on_kernels:
        dev = gnorm.device
        lr, clip, c1, c2 = (torch.as_tensor(x, dtype=torch.float32,
                                            device=dev).reshape(())
                            for x in (lr, clip, c1, c2))

        def leaf(p, g, mu, nu):
            return fused.update_leaf(p, g, mu, nu, lr=lr, clip=clip, c1=c1,
                                     c2=c2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                                     weight_decay=cfg.weight_decay)
    else:
        def leaf(p, g, mu, nu):
            return adamw_leaf(p, g, mu, nu, cfg, lr, clip, c1, c2)

    trip = [leaf(*x) for x in zip(ps, gs, mus, nus)]
    new_p = tree_unflatten(params, [t[0] for t in trip])
    new_mu = tree_unflatten(params, [t[1] for t in trip])
    new_nu = tree_unflatten(params, [t[2] for t in trip])
    return new_p, OptState(step, new_mu, new_nu), {"grad_norm": gnorm}


def make_optimizer(moment_dtype: str = "float32", **kw):
    cfg = AdamWConfig(moment_dtype=moment_dtype, **kw)

    def init(params):
        return adamw_init(params, cfg)

    def update(params, grads, state, lr=None):
        return adamw_update(params, grads, state, cfg, lr)

    return cfg, init, update
