"""Parameter conversion between the JAX package's trees and this package's.

Parameters cross as numpy arrays, leaf by leaf, with the same nested-dict
paths and the same shapes (``wq [d,Hq,hd]``, ``wo [Hq,hd,d]``, ``mlp/wi
[d,f]``, stacked ``[G, ...]`` under ``blocks``).  The caller turns the other
side's leaves into numpy (``np.asarray(x, np.float32)``) first, so no type of
another framework is ever seen here.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dtype_of

PyTree = Any


def from_jax_params(tree: PyTree, cfg: ArchConfig, *, device,
                    dtype: Optional[torch.dtype] = None) -> PyTree:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``,
    floating leaves cast to ``dtype`` (default ``cfg.dtype``)."""
    dt = dtype if dtype is not None else dtype_of(cfg.dtype)

    def leaf(x):
        t = torch.from_numpy(np.array(x))            # a writable copy
        if t.is_floating_point():
            t = t.to(dt)
        return t.to(device)

    def walk(node):
        if isinstance(node, dict):
            return {str(k): walk(v) for k, v in node.items()}
        return leaf(np.asarray(node))

    return walk(tree)


def to_numpy_tree(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays (floating leaves
    as float32), for comparisons against the other package."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return leaf(tree)
