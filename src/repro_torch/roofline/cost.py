"""Per-device cost of a step that runs on ``meta`` tensors: the port's
counterpart of the JAX package's ``roofline/hlo_cost.py``.

The JAX package lowers a step to HLO and walks the text, multiplying loop
bodies by their trip counts.  The port has no HLO: it runs the step once,
eagerly, on ``meta`` tensors (shapes and dtypes, no data), so every Python
loop (layers, microbatches, loss chunks) runs its real number of times and
the counts below are exact for the trace.  ``CostCounter`` is a
``TorchDispatchMode`` that sits below DTensor: on a DTensor op it returns
``NotImplemented``, DTensor turns the op into ops on each rank's local
shard, and those come back to it, so everything it counts is per device.

* FLOPs: a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``_scaled_mm``, their ``out=`` and ``out_dtype`` forms) costs
  ``2 * prod(result) * prod(contracting dims)`` (``dot_flops``); every
  other op that computes costs one flop per result element, the
  reference's rule; a write into part of a tensor (``index_put_``,
  ``scatter_``) one per element written.  Views, ``empty`` and
  collectives cost none.
* Bytes: operands plus result of every op that computes (a partial write:
  the values read and written, and the indices).  The trace is
  eager and unfused, so this is the traffic of unfused kernels: larger than
  XLA's fused count, and not comparable with it.
* Peak bytes: the most bytes held at once by tensors the traced ops
  created (each counted when made, dropped when the tensor is freed).
* Kernels: the hand-written kernels have no ``meta`` path.  While a
  counter is installed, their wrappers return empty outputs of the right
  shapes and ``charge`` the kernel's own work here (``kernels`` counts the
  calls); outside one, a ``meta`` tensor still raises there.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten._scaled_mm}
# allocate without computing
_ALLOC = {aten.empty, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided, aten.empty_like}
# metadata only
_FREE = {aten.detach, aten.alias, aten.lift_fresh, aten._local_scalar_dense,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size}

# writes into part of a tensor: index of the written values' arg (the work
# and traffic are the values', not the whole destination's)
_PART_WRITES = {aten.index_put: 2, aten.index_put_: 2, aten.scatter: 3,
                aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
                aten.index_copy: 3, aten.index_copy_: 3}

_ACTIVE: list["CostCounter"] = []


def counting() -> Optional["CostCounter"]:
    """The innermost installed counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def dot_flops(func, args) -> float:
    """2 * prod(result) * prod(contracting) of a matrix product op."""
    p = func._overloadpacket
    if p in (aten.addmm, aten.baddbmm):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if p in (aten.bmm, aten.baddbmm):
        batch, m, k = a.shape
        return 2.0 * batch * m * k * b.shape[2]
    m, k = a.shape
    return 2.0 * m * k * b.shape[1]


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes per device while installed
    (``with CostCounter() as c:``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops: Counter = Counter()          # dispatched ops, by name
        self.kernels: Counter = Counter()      # charged kernel calls
        self.scale = 1                         # trip count of the body run

    @contextlib.contextmanager
    def times(self, n: int):
        """Work counted inside is charged ``n`` times: a loop's body traced
        once stands for its ``n`` trips (``loop_once``)."""
        outer, self.scale = self.scale, self.scale * n
        try:
            yield
        finally:
            self.scale = outer

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- charges ---------------------------------------------------------

    def charge(self, kernel: str, *, flops: float, dot_flops: float,
               nbytes: float) -> None:
        """A hand-written kernel's work: ``flops`` in all, of which
        ``dot_flops`` on matrix products, moving ``nbytes``."""
        self.kernels[kernel] += self.scale
        self.flops += flops * self.scale
        self.dot_flops += dot_flops * self.scale
        self.bytes += nbytes * self.scale

    def _made(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._freed, n)

    def _freed(self, n: int) -> None:
        self.live -= n

    # -- dispatch --------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor turns the op into local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(isinstance(t, FakeTensor)
                   for t in _tensors((args, kwargs, out))):
            # (DTensor's sharding rules make fake tensors of the global
            # shapes and run ops on them to learn outputs' metadata: no
            # work of the step)
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" or packet in _FREE \
                or func.is_view:
            return
        results = _tensors(out)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if not writes:
            for t in results:
                self._made(t)
        if packet in _ALLOC:
            return
        k = self.scale
        self.ops[packet.__name__] += k
        if packet in _PART_WRITES:
            src = args[_PART_WRITES[packet]]
            self.flops += k * src.numel()
            self.bytes += k * (2 * _nbytes(src) + sum(
                _nbytes(t) for t in _tensors(args[1:_PART_WRITES[packet]])))
            return
        res = sum(t.numel() for t in results)
        if packet in _DOTS:
            f = dot_flops(func, args)
            self.dot_flops += k * f
            self.flops += k * (f + (res if packet in (aten.addmm,
                                                      aten.baddbmm) else 0))
        else:
            self.flops += k * res
        self.bytes += k * (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in results))


class _LoopOnce(torch.autograd.Function):
    """See ``loop_once``."""

    @staticmethod
    def forward(ctx, body, n, outputs, *args):
        with counting().times(n):
            body(*args)
        ctx.body, ctx.n, ctx.args = body, n, args
        return tuple(torch.empty(shape, dtype=dt, device="meta")
                     for shape, dt in outputs)

    @staticmethod
    def backward(ctx, *grads):
        # one trip again, uncounted (the forward was), to differentiate it
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(a.is_floating_point())
                   for a in ctx.args]
            with counting().times(0):
                outs = [o for o in ctx.body(*ins) if o.requires_grad]
            with counting().times(ctx.n):
                torch.autograd.grad(outs, ins, [torch.empty_like(o)
                                                for o in outs],
                                    allow_unused=True)
        return (None, None, None, *(torch.empty_like(a)
                                     if a.is_floating_point() else None
                                     for a in ctx.args))


def loop_once(body, n: int, outputs, *args):
    """A loop of ``n`` trips of ``body`` on ``meta`` tensors under a
    counter, traced as one trip charged ``n`` times, forward and backward
    (the trip-count rule of the JAX package's ``hlo_cost`` for a while
    loop): ``body(*args)`` runs one trip; the loop's results are empty
    ``meta`` tensors of ``outputs`` ((shape, dtype) pairs).  The peak bytes
    count one trip's tensors, not ``n`` trips' saved states."""
    return _LoopOnce.apply(body, n, outputs, *args)


# ---------------------------------------------------------------------------
# The kernels' own work (their ``meta`` route)
# ---------------------------------------------------------------------------
# elementwise flops a visited score element costs besides its products:
# the reference's blocked attention scales, masks, takes the running max,
# subtracts it, exponentiates and sums (6); the backward recomputes the
# probabilities from the lse (2), subtracts delta, multiplies by them and
# scales (3), in both of its roles
SCORE_FLOPS = 6
SCORE_FLOPS_BWD = 10
# the backward's products a visited score element: S and dP recomputed for
# the dQ tiles and again for the dK / dV tiles, then dQ, dK and dV (7 of
# 2*D each).  Every path issues these seven: bf16 at head_dim 64 / 128
# (wgmma), bf16 at 256 (wgmma; its dV warpgroup takes S, its dK warpgroup
# dP) and f32 (split TF32: each product as three TF32 products on the
# tensor cores, counted here once, as the reference's f32 product)
BWD_DOT_FLOPS_PER_D = 14


def attention_blocks(Sq: int, Sk: int, *, causal: bool, window: int,
                     block: int = 512) -> int:
    """Query x key elements a head visits, as the reference's
    ``blocked_attention(block_skip=True)`` iterates its blocks: the lower
    triangle of whole blocks when causal, the blocks that meet the window,
    else every block."""
    bq = min(block, max(16, Sq))
    bk = min(block, max(16, Sk))
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    if causal and window == 0 and nq == nk:
        pairs = nq * (nq + 1) // 2
    elif window:
        pairs = nq * ((window + bk - 1) // bk + 2)
    else:
        pairs = nq * nk
    return pairs * bq * bk


def charge_flash(q, k, v, *, causal: bool, window: int, lse: bool) -> None:
    """K2's forward: q [B,Sq,Hq,D], k/v [B,Sk,Hk,D]."""
    B, Sq, Hq, D = q.shape
    scores = B * Hq * attention_blocks(Sq, k.shape[1], causal=causal,
                                       window=window)
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v) + (
        4 * B * Hq * Sq if lse else 0)
    counting().charge("flash_attention", flops=(4 * D + SCORE_FLOPS) * scores,
                      dot_flops=4 * D * scores, nbytes=nbytes)


def charge_flash_bwd(q, k, v, *, causal: bool, window: int) -> None:
    """K2-bwd (delta pass and atoms): reads q, k, v, o, dO, lse, delta and
    writes dQ, dK, dV."""
    B, Sq, Hq, D = q.shape
    scores = B * Hq * attention_blocks(Sq, k.shape[1], causal=causal,
                                       window=window)
    nbytes = 4 * _nbytes(q) + 2 * (_nbytes(k) + _nbytes(v)) + 8 * B * Hq * Sq
    dots = BWD_DOT_FLOPS_PER_D * D * scores
    counting().charge("flash_attention_bwd",
                      flops=dots + SCORE_FLOPS_BWD * scores,
                      dot_flops=dots, nbytes=nbytes)


def charge_decode(q, k_cache, v_cache, o, lse=None) -> None:
    """K1: each of the B*Hq query rows against every key of its cache row
    (the dry-run does not know the lengths; a decode cell is the step at the
    end of its context); reads q, the caches and the lengths, writes o and,
    if asked, the lse."""
    B, Hq, D = q.shape
    scores = B * Hq * k_cache.shape[1]
    nbytes = (_nbytes(q) + _nbytes(o) + _nbytes(k_cache) + _nbytes(v_cache)
              + 4 * B + (_nbytes(lse) if lse is not None else 0))
    counting().charge("decode_attention", flops=(4 * D + SCORE_FLOPS) * scores,
                      dot_flops=4 * D * scores, nbytes=nbytes)
