"""Per-device collective traffic of a traced step: the port's counterpart of
the JAX package's ``roofline/hlo.py``, which parses it out of compiled HLO.

The port has no HLO.  ``CommRecorder`` (a ``CommDebugMode``) sees every
collective that DTensor issues while the step runs, with its operand and
result, and the size of the process group it runs over (one mesh dim, or
several).  Each is charged with the same ring-algorithm accounting:

    all-gather          result_bytes * (g-1)/g      (receives g-1 shards)
    reduce-scatter      result_bytes * (g-1)        (operand = result * g)
    all-reduce          2 * bytes * (g-1)/g         (RS + AG)
    all-to-all          bytes * (g-1)/g
    collective-permute  bytes                       (one hop send)

The tensors are the local shards, so the bytes are per device.  On a CPU
process group (the dry-run's fake one included) DTensor replaces an
all-to-all by an all-gather and a chunk, and it is recorded as such.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.distributed.tensor.debug import CommDebugMode

# functional collective op -> the reference's kind
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclass
class CollectiveOp:
    kind: str
    bytes_moved: float                 # per device, over the interconnect
    result_bytes: float
    group_size: int


def ring_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one device moves for a collective of ``kind`` whose result
    holds ``result_bytes``, over a group of ``g``."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * frac
    if kind == "all-to-all":
        return result_bytes * frac
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_op(kind: str, result_bytes: float, g: int) -> CollectiveOp:
    return CollectiveOp(kind, ring_bytes(kind, result_bytes, g),
                        result_bytes, g)


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _nbytes(tree) -> float:
    from torch.utils._pytree import tree_leaves
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


class CommRecorder(CommDebugMode):
    """``CommDebugMode`` that also keeps every collective as a
    ``CollectiveOp`` (``.collectives``)."""

    def __init__(self):
        super().__init__()
        self.collectives: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented
                and not isinstance(func, torch._ops.HigherOrderOperator)
                and func.namespace == "_c10d_functional"):
            kind = KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                name = next(a for a in reversed(args) if isinstance(a, str))
                self.collectives.append(
                    collective_op(kind, _nbytes(out), _group_size(name)))
        return out


def collective_bytes(ops: list[CollectiveOp]) -> dict[str, float]:
    """Per-device interconnect bytes by collective kind (+ 'total')."""
    out: dict[str, float] = defaultdict(float)
    for op in ops:
        out[op.kind] += op.bytes_moved
        out["total"] += op.bytes_moved
    return dict(out)


def count_ops(ops: list[CollectiveOp], dots: int = 0,
              kernels: int = 0) -> dict:
    """Counts by kind of the recorded collectives, the dispatched matrix
    products (``dot``) and the hand-written kernels' calls."""
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for op in ops:
        counts[op.kind] += 1
    counts["dot"] = dots
    counts["kernel"] = kernels
    return counts
