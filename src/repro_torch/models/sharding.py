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
``torch.distributed`` ``Shard`` / ``Replicate`` per mesh dim.  Executing a
state over a mesh of more than one rank (DTensors, activation constraints)
is not ported yet (ROADMAP A10b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.launch.mesh import Mesh

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
