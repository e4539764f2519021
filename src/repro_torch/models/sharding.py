"""Logical-axis -> mesh-axis resolution: the sharding rules.

Two built-in rule-sets:

* ``tp_dp``   — tensor parallel over ``model``; params replicated over ``data``
                (fine for <= ~10B configs).
* ``fsdp_tp`` — additionally shards the embed dims over ``data`` (ZeRO-3
                style); required for the 340B/314B configs.

The ``pod`` axis (multi-pod mesh) joins ``data`` for batch / FSDP sharding.

A spec is a ``P``: one entry a tensor dim, each ``None`` (replicated), a mesh
axis name, or a tuple of names (sharded over their product), as the JAX
package's ``PartitionSpec``.  ``NamedSharding`` pairs a spec with the
``launch.mesh.Mesh`` it was resolved against; ``placements`` gives the
``torch.distributed`` ``Shard`` / ``Replicate`` per mesh dim.

Activation constraints: ``shard_act`` / ``shard_dims`` redistribute a
``DTensor`` to the spec the JAX package's would constrain to (``act_spec`` /
``dims_spec``, pure functions of a shape and a mesh), against the mesh that
``use_mesh`` installs.  On a plain tensor, or with no mesh installed, they
return their input.
"""
from __future__ import annotations

import math

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import is_dtensor

PyTree = Any

# logical axis -> mesh axes, per rule-set.  Entries may be a tuple of mesh
# axes (sharded over their product) or None (replicated).
RULESETS: dict[str, dict[str, Any]] = {
    "tp_dp": {
        "vocab": "model",
        "embed": None,
        "embed2": None,
        "ff": "model",
        "expert_ff": None,
        "experts": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "head": None,
        "layers": None,
        "rnn": "model",
        "rnn_heads": None,
    },
    "fsdp_tp": {
        "vocab": "model",
        "embed": "data",          # FSDP: shard the big embed dim over data
        "embed2": None,
        "ff": "model",
        "expert_ff": "model",
        "experts": None,          # overridden to "model" when moe.parallelism == "ep"
        "q_heads": "model",
        "kv_heads": "model",
        "head": None,
        "layers": None,
        "rnn": "model",
        "rnn_heads": None,
    },
}


class P(tuple):
    """A partition spec: ``P(None, "model")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: P


def placements(spec: P, mesh: Mesh) -> tuple:
    """One ``torch.distributed`` placement per mesh dim: ``Shard(d)`` where
    tensor dim ``d`` of ``spec`` is sharded over that mesh axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes that make up the data-parallel dimension (pod folds in)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def resolve_rules(ruleset: str, mesh: Mesh, ep: bool = False) -> dict[str, Any]:
    rules = dict(RULESETS[ruleset])
    if ep:
        rules["experts"] = "model"
        rules["expert_ff"] = None
    if ruleset == "fsdp_tp" and rules.get("embed") == "data":
        rules["embed"] = data_axes(mesh) or None
    return rules


def spec_for_axes(axes: tuple, rules: dict[str, Any],
                  shape: Optional[tuple] = None,
                  mesh: Optional[Mesh] = None) -> P:
    """Resolve logical axes to a spec.  When ``shape`` and ``mesh`` are
    given, mesh axes that do not divide the dimension are dropped (e.g. 8
    GQA kv heads on a 16-way model axis replicate — the standard
    KV-replication fallback)."""
    parts = []
    used: set[str] = set()
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            parts.append(None)
            continue
        ms = tuple(a for a in ((m,) if isinstance(m, str) else tuple(m))
                   if a not in used)
        if shape is not None and mesh is not None and i < len(shape):
            keep, prod = [], 1
            for a in ms:
                size = mesh.shape[a]
                if shape[i] % (prod * size) == 0:
                    keep.append(a)
                    prod *= size
            ms = tuple(keep)
        used.update(ms)
        if not ms:
            parts.append(None)
        else:
            parts.append(ms if len(ms) != 1 else ms[0])
    return P(*parts)


def param_shardings(param_axes: PyTree, mesh: Mesh, ruleset: str = "tp_dp",
                    ep: bool = False, shapes: Optional[PyTree] = None
                    ) -> PyTree:
    """``NamedSharding`` per leaf of a tree of logical-axis tuples (nested
    as the params; ``shapes``, if given, holds the leaves' shapes)."""
    rules = resolve_rules(ruleset, mesh, ep=ep)

    def walk(axes, shp):
        if isinstance(axes, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in axes.items()}
        if shp is None:
            return NamedSharding(mesh, spec_for_axes(axes, rules))
        return NamedSharding(mesh, spec_for_axes(axes, rules,
                                                 tuple(shp.shape), mesh))

    return walk(param_axes, shapes)


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------

_ACT_SPECS = {
    # [batch, seq, embed]
    "act_btd": lambda d: P(d, None, None),
    # [batch, seq, heads, head_dim]
    "act_bthd": lambda d: P(d, None, "model", None),
    # [batch, heads, ...]   (decode: no seq dim)
    "act_bhd": lambda d: P(d, "model", None),
    # sequence-sharded long-context activations [batch, seq, embed]
    "act_seq": lambda d: P(None, d, None),
    # logits chunk [batch, chunk, vocab]
    "act_btv": lambda d: P(d, None, "model"),
}


def _dividing(axes: tuple, dim: int, mesh: Mesh):
    """The leading mesh axes of ``axes`` whose product divides ``dim``, as a
    spec entry (None, one name or a tuple of names)."""
    keep, prod = [], 1
    for a in axes:
        if dim % (prod * mesh.shape[a]) == 0:
            keep.append(a)
            prod *= mesh.shape[a]
    return None if not keep else (keep[0] if len(keep) == 1 else tuple(keep))


def act_spec(kind: str, shape: tuple, mesh: Mesh) -> P:
    """The spec ``shard_act(x, kind)`` constrains an activation of ``shape``
    to: mesh axes that do not divide their dimension are dropped (e.g. 40
    attention heads on a 16-way model axis)."""
    d = data_axes(mesh)
    d = d if len(d) > 1 else (d[0] if d else None)
    parts = []
    for i, p in enumerate(_ACT_SPECS[kind](d)):
        if p is None or i >= len(shape):
            parts.append(None)
        else:
            parts.append(_dividing((p,) if isinstance(p, str) else tuple(p),
                                   shape[i], mesh))
    return P(*parts)


def dims_spec(dims: tuple, shape: tuple, mesh: Mesh) -> P:
    """The spec of ``shard_dims(x, dims)``: 'dp' -> the data axes, 'tp' ->
    model, None -> replicated; axes that do not divide are dropped."""
    parts: list = []
    for i, tag in enumerate(dims[:len(shape)]):
        if tag == "dp":
            axes = data_axes(mesh)
        elif tag == "tp":
            axes = ("model",)
        else:
            parts.append(None)
            continue
        parts.append(_dividing(axes, shape[i], mesh))
    return P(*(parts + [None] * (len(shape) - len(parts))))


def mesh_of(device_mesh) -> Mesh:
    """The ``launch.mesh.Mesh`` (names and sizes) of a ``DeviceMesh``."""
    return Mesh(device_mesh.mesh.numpy(), device_mesh.mesh_dim_names)


def as_dtensor(t, device_mesh):
    """``t`` as a DTensor over ``device_mesh``: a plain tensor is taken as
    replicated."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def dtensor(local, device_mesh, placements_, shape):
    """The DTensor of global ``shape``, laid out row-major, whose block on
    this rank is ``local``."""
    from torch.distributed.tensor import DTensor
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return DTensor.from_local(local, device_mesh, placements_,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(strides)))


def laid_out_as(x, like):
    """``x`` redistributed to the layout of the DTensor ``like`` (as is if
    either is a plain tensor)."""
    if not (is_dtensor(x) and is_dtensor(like)):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def local_rows(fn, *args, shared: tuple = ()):
    """``fn(*args)`` on each rank's rows of the leading (group) dim, where
    any arg is a DTensor: every tensor arg is redistributed to its leading
    dim over the data axes (``dims_spec(("dp",))``), the rest replicated,
    except the args at the indices ``shared`` (parameters every row uses),
    which every rank holds whole; their gradient is a partial sum over the
    data axes.  The result (a tensor or a tuple of them, leading dim: the
    row args' common one) comes back laid out by rows.  For computations
    independent per row that use ops without DTensor sharding rules (an
    in-place scatter) or many small ops (a recurrence a token)."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate
    dm = dts[0].device_mesh
    mesh = mesh_of(dm)
    data = set(data_axes(mesh))
    whole = [Replicate()] * dm.ndim

    def local(i, a):
        if not isinstance(a, torch.Tensor):
            return a
        if i in shared:
            grad = [Partial() if n in data else Replicate()
                    for n in dm.mesh_dim_names]
            return as_dtensor(a, dm).redistribute(dm, whole).to_local(
                grad_placements=grad)
        pl = placements(dims_spec(("dp",), tuple(a.shape), mesh), mesh)
        return as_dtensor(a, dm).redistribute(dm, pl).to_local()

    out = fn(*(local(i, a) for i, a in enumerate(args)))
    rows = next(a for i, a in enumerate(args)
                if isinstance(a, torch.Tensor) and i not in shared).shape[0]

    def wrap(t):
        shape = (rows,) + tuple(t.shape[1:])
        return dtensor(t, dm, placements(dims_spec(("dp",), shape, mesh),
                                         mesh), shape)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def local_contract(spec: str, a, b, fn=None):
    """The two-operand einsum ``spec`` ("btd,dhk->bthk") of DTensors, each
    rank contracting its own blocks (``fn(spec, a_local, b_local)``,
    default ``torch.einsum``).  On each mesh dim the operands keep one
    split: a letter both are split on (a contracted one leaves a partial
    sum, as a row-parallel product does), else a kept letter that the first
    operand, then the second, is split on (the other operand split to match
    where it has that letter, a local chunk); every other dim of theirs is
    gathered, and a partial sum reduced.  The gradient of an operand whole
    on a mesh dim that splits the result is a partial sum there.

    Where autograd does not record (serving), a second operand split on
    another letter than the first's stays in place if moving the first and
    then the result (a partial sum reduced, or a split relaid) moves fewer
    bytes than gathering the second: a decode step's activations are a few
    rows, its weights (sharded over the data axes for FSDP) are not; a
    prompt's activations outweigh them.

    DTensor's own rule for an einsum picks the layout that moves the fewest
    bytes, whatever the compute, and may split a merged dim (heads x
    head_dim) that then cannot unflatten: this keeps the products of the
    port's layers sharded as ``AXIS_RULES`` lays out their weights."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    fn = fn or torch.einsum
    ins, out = spec.split("->")
    la, lb = ins.split(",")
    dm = next(t for t in (a, b) if is_dtensor(t)).device_mesh
    a, b = as_dtensor(a, dm), as_dtensor(b, dm)

    def letter(t, letters, i):
        p = t.placements[i]
        return letters[p.dim] if isinstance(p, Shard) else None

    size_of = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))

    pa, pb, po = [], [], []
    for i in range(dm.ndim):
        xa, xb = letter(a, la, i), letter(b, lb, i)
        if xa is not None and xa == xb:
            pick = xa
        elif xa is not None and xa in out:
            pick = xa
        elif xb is not None and xb in out:
            pick = xb
        else:
            pick = None
        if (pick is not None and pick == xa and xb not in (None, xa)
                and not torch.is_grad_enabled()
                and _moved_to_keep(a, b, out, size_of, i)):
            pick = xb
        if pick is None:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
            continue
        pa.append(Shard(la.index(pick)) if pick in la else Replicate())
        pb.append(Shard(lb.index(pick)) if pick in lb else Replicate())
        po.append(Shard(out.index(pick)) if pick in out else Partial())
    al = a.redistribute(dm, pa).to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) and not isinstance(o, Replicate)
        else p for p, o in zip(pa, po)])
    bl = b.redistribute(dm, pb).to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) and not isinstance(o, Replicate)
        else p for p, o in zip(pb, po)])
    return dtensor(fn(spec, al, bl), dm, po, tuple(size_of[c] for c in out))


def _moved_to_keep(a, b, out: str, size_of: dict, i: int) -> bool:
    """Whether keeping ``b``'s split on mesh dim ``i`` (moving ``a``, then
    the result to ``a``'s layout) moves fewer bytes a rank than gathering
    ``b`` there."""
    result = math.prod(size_of[c] for c in out) * a.element_size()
    moved = a.to_local().nbytes + result / a.device_mesh.size()
    return moved < b.to_local().nbytes * (a.device_mesh.size(i) - 1)


def logsumexp_last(x):
    """``torch.logsumexp(x, -1, keepdim=True)``; over a DTensor ``x`` whose
    last dim is split over ranks, from each rank's columns: the max and the
    sum of exponentials are reduced over the split, never the columns
    themselves (DTensor's rule gathers the whole last dim on every rank).
    The max is a constant to autograd: the gradient is the softmax."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1, keepdim=True)
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm, last = x.device_mesh, x.ndim - 1
    split = [isinstance(p, Shard) and p.dim == last and dm.size(i) > 1
             for i, p in enumerate(x.placements)]
    if not any(split):
        return torch.logsumexp(x, dim=-1, keepdim=True)
    xpl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(dm, xpl)
    rows = [Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in xpl]

    def reduced(local, op):
        return dtensor(local, dm, [Partial(op) if s else p
                                   for s, p in zip(split, rows)],
                       tuple(x.shape[:-1]) + (1,)).redistribute(dm, rows)

    xl = x.to_local()
    m = reduced(xl.detach().amax(dim=-1, keepdim=True), "max")
    e = reduced(torch.exp(xl - m.to_local()).sum(dim=-1, keepdim=True),
                "sum")
    return torch.log(e) + m


def gather_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])``; over a DTensor ``x`` whose
    last dim is split, each rank picks from its own columns (zeros for the
    others': a partial sum), so neither the forward nor the backward
    builds a tensor of the whole last dim (DTensor's rule for the
    backward makes zeros of the global shape on every rank)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm, last = x.device_mesh, x.ndim - 1
    xpl = [Replicate() if p.is_partial() else p for p in x.placements]
    ipl = [p if isinstance(p, Shard) and p.dim < last else Replicate()
           for p in xpl]
    opl = [Partial() if isinstance(p, Shard) and p.dim == last else q
           for p, q in zip(xpl, ipl)]
    xl = x.redistribute(dm, xpl).to_local()
    il = as_dtensor(idx, dm).redistribute(dm, ipl).to_local()
    at = il - compute_local_shape_and_global_offset(x.shape, dm,
                                                    xpl)[1][last]
    inside = (at >= 0) & (at < xl.shape[-1])
    picked = torch.gather(xl, -1, at.clamp(0, xl.shape[-1] - 1)[..., None])
    return dtensor(torch.where(inside[..., None], picked, 0), dm, opl,
                   tuple(idx.shape) + (1,))


def pad(x, widths, value: float = 0.0):
    """``F.pad(x, widths, value=value)``; of a DTensor on each rank's
    block, the padded dims gathered first (``F.pad`` of a DTensor fails on
    some torch versions)."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import Replicate, Shard
    grown = {x.ndim - 1 - i: widths[2 * i] + widths[2 * i + 1]
             for i in range(len(widths) // 2)}
    pl = [Replicate() if p.is_partial() or (isinstance(p, Shard)
                                            and grown.get(p.dim))
          else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    shape = tuple(n + grown.get(d, 0) for d, n in enumerate(x.shape))
    return dtensor(F.pad(x.to_local(), widths, value=value), x.device_mesh,
                   pl, shape)


def local_pointwise(fn, x):
    """The elementwise ``fn`` on each rank's shard of the DTensor ``x`` (a
    partial sum is reduced first); ``fn(x)`` on a plain tensor.  For
    elementwise ops without a DTensor rule (``logsigmoid``'s backward)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _constrain(x, spec: P, mesh: Mesh):
    if not is_dtensor(x):
        return x
    y = x.redistribute(x.device_mesh, placements(spec, mesh))
    # the result is laid out row-major, whatever order of dims the global
    # strides it came with claim (a later reshape must not view through
    # them)
    return dtensor(y.to_local().contiguous(), y.device_mesh, y.placements,
                   tuple(y.shape))


def shard_act(x, kind: str, mesh: Optional[Mesh] = None):
    """Redistribute the DTensor ``x`` to ``act_spec(kind, ...)`` (a no-op on
    a plain tensor or without a mesh)."""
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None:
        return x
    return _constrain(x, act_spec(kind, tuple(x.shape), mesh), mesh)


def shard_dims(x, dims: tuple, mesh: Optional[Mesh] = None):
    """Generic per-dim constraint (``dims_spec``); non-divisible dims
    replicate.  A no-op on a plain tensor or without a mesh."""
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None:
        return x
    return _constrain(x, dims_spec(dims, tuple(x.shape), mesh), mesh)


_MESH_STACK: list[Mesh] = []


class use_mesh:
    """Context manager installing a mesh for the shard_act constraints.
    On entry it builds the mesh's ``DeviceMesh`` over ``device_type`` (once
    per mesh; it needs a process group that holds the ranks)."""

    def __init__(self, mesh: Optional[Mesh], device_type: str = "cuda"):
        self.mesh = mesh
        self.device_type = device_type

    def __enter__(self):
        if self.mesh is not None:
            self.mesh.device_mesh(self.device_type)
        _MESH_STACK.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _MESH_STACK.pop()
        return False


def _current_mesh() -> Optional[Mesh]:
    return _MESH_STACK[-1] if _MESH_STACK else None
