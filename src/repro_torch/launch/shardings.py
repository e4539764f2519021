"""Sharding resolution for whole train/serve states on a mesh.

Builds ``NamedSharding`` specs (``models/sharding.py``) for:
* parameter trees        — logical axes (models/common.py) -> mesh axes via
                           the rule-sets in models/sharding.py;
* optimizer state        — moments mirror parameter shardings; an int8
                           ``QTensor`` moment's ``q`` takes its parameter's
                           spec and ``scale`` drops the last-dim axis;
* batches                — batch dim over ("pod","data");
* KV caches/decode state — batch dim over ("pod","data"), head dims over
                           "model" when divisible (GQA kv-head counts below
                           the TP degree shard the sequence instead).

Every function takes shapes only (tensors on any device, ``meta``
included) and a ``launch.mesh.Mesh`` of ranks.
"""
from __future__ import annotations

import math
from typing import Any, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import logical_axes, tree_map
from repro_torch.models.sharding import (NamedSharding, P, data_axes,
                                         param_shardings)
from repro_torch.optim.optimizers import OptState, QTensor

PyTree = Any


def default_ruleset(cfg: ArchConfig) -> str:
    """fsdp_tp for the very large configs (params must shard over data too),
    tp_dp otherwise.  ``param_count()`` carries the analytic count's fault
    for two hybrid configs (ROADMAP §C), as the JAX package's does."""
    return "fsdp_tp" if cfg.param_count() > 20e9 else "tp_dp"


def use_ep(cfg: ArchConfig) -> bool:
    return cfg.moe is not None and cfg.moe.parallelism == "ep"


def _dp(mesh: Mesh):
    d = data_axes(mesh)
    return d if len(d) > 1 else (d[0] if d else None)


def _model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def _dp_total(mesh: Mesh) -> int:
    return math.prod([mesh.shape[a] for a in data_axes(mesh)]) or 1


def params_shardings(params_shapes: PyTree, cfg: ArchConfig, mesh: Mesh,
                     ruleset: Optional[str] = None) -> PyTree:
    rs = ruleset or default_ruleset(cfg)
    axes = logical_axes(params_shapes)
    return param_shardings(axes, mesh, rs, ep=use_ep(cfg),
                           shapes=params_shapes)


def _qtensor_sharding(qt_shapes: QTensor, p_sharding: NamedSharding,
                      mesh: Mesh) -> QTensor:
    """int8 moments are layout-compatible with their parameter: ``q`` takes
    the parameter's spec verbatim; ``scale`` drops the last-dim axis (its
    block dim rarely divides the TP degree)."""
    spec = p_sharding.spec
    ndim = len(qt_shapes.shape) or 1
    parts = list(spec) + [None] * (ndim - len(spec))
    # q: check the padded last dim still divides; else replicate that dim
    q_parts = list(parts)
    last_ax = q_parts[-1] if q_parts else None
    if last_ax is not None:
        axes = (last_ax,) if isinstance(last_ax, str) else tuple(last_ax)
        sz = math.prod(mesh.shape[a] for a in axes)
        if qt_shapes.q.shape[-1] % sz != 0:
            q_parts[-1] = None
    s_parts = list(q_parts[:-1]) + [None]
    if qt_shapes.scale.ndim > len(s_parts):
        s_parts += [None] * (qt_shapes.scale.ndim - len(s_parts))
    s_parts = s_parts[:qt_shapes.scale.ndim]
    return QTensor(NamedSharding(mesh, P(*q_parts)),
                   NamedSharding(mesh, P(*s_parts)),
                   qt_shapes.shape)


def moments_shardings(mu_shapes: PyTree, p_shardings: PyTree,
                      mesh: Mesh) -> PyTree:
    """mu/nu mirror params; QTensor leaves use the flat-block rule."""
    if isinstance(mu_shapes, dict):
        return {k: moments_shardings(v, p_shardings[k], mesh)
                for k, v in mu_shapes.items()}
    if isinstance(mu_shapes, QTensor):
        return _qtensor_sharding(mu_shapes, p_shardings, mesh)
    return p_shardings


def train_state_shardings(state_shapes, cfg: ArchConfig, mesh: Mesh,
                          ruleset: Optional[str] = None):
    """Shardings matching train.step.TrainState(params, opt, err_fb)."""
    from repro_torch.train.step import TrainState
    p_sh = params_shardings(state_shapes.params, cfg, mesh, ruleset)
    step_sh = NamedSharding(mesh, P())
    mu_sh = moments_shardings(state_shapes.opt.mu, p_sh, mesh)
    nu_sh = moments_shardings(state_shapes.opt.nu, p_sh, mesh)
    err_sh = (tree_map(lambda s: s, p_sh)
              if state_shapes.err_fb is not None else None)
    return TrainState(p_sh, OptState(step_sh, mu_sh, nu_sh), err_sh)


def batch_shardings(batch_shapes: dict, mesh: Mesh) -> dict:
    dp_total = _dp_total(mesh)
    dp = _dp(mesh)
    out = {}
    for k, v in batch_shapes.items():
        spec = [None] * v.ndim
        if v.ndim >= 1 and v.shape[0] % dp_total == 0:
            spec[0] = dp             # batch too small to shard: replicate
        out[k] = NamedSharding(mesh, P(*spec))
    return out


def cache_shardings(cache_shapes: PyTree, cfg: ArchConfig, mesh: Mesh,
                    batch: int) -> PyTree:
    """Generic decode-state sharding: batch dim over data axes; head dims
    over model when divisible; otherwise the **sequence** dim of KV caches
    shards over model (GQA head counts below the TP degree replicate heads
    but must not replicate the cache)."""
    dp = _dp(mesh)
    tp = _model_size(mesh)
    dp_total = _dp_total(mesh)
    headish = {cfg.n_kv_heads, cfg.n_heads}

    def leaf(x):
        spec: list = [None] * x.ndim
        # batch dim: first dim equal to the global batch (never the leading
        # layer-stack dim of stacked caches, which can collide with head
        # counts — hence the positional rules below)
        b_i = next((i for i, d in enumerate(x.shape)
                    if d == batch and d % dp_total == 0), None)
        if b_i is not None:
            spec[b_i] = dp
        if b_i is not None and x.ndim - b_i == 4:
            # KV-cache layout [.., B, S, H, Dh]: prefer heads over model;
            # GQA head counts below the TP degree shard the sequence
            s_i, h_i = b_i + 1, b_i + 2
            if x.shape[h_i] % tp == 0:
                spec[h_i] = "model"
            elif x.shape[s_i] % tp == 0:
                spec[s_i] = "model"
        else:
            # recurrent states etc.: any later head/width dim that divides
            for i in range((b_i + 1) if b_i is not None else 1, x.ndim):
                if x.shape[i] in headish and x.shape[i] % tp == 0:
                    spec[i] = "model"
                    break
        return NamedSharding(mesh, P(*spec))

    return tree_map(leaf, cache_shapes)


def logits_sharding(mesh: Mesh, vocab: int, batch: int = 0) -> NamedSharding:
    tp = _model_size(mesh)
    dp = _dp(mesh) if batch % _dp_total(mesh) == 0 else None
    return NamedSharding(mesh, P(dp, "model" if vocab % tp == 0 else None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
