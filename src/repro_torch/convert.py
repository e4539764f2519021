"""Parameter conversion between the JAX package's trees and this package's.

Parameters cross as numpy arrays, leaf by leaf, with the same nested-dict
paths and the same shapes (``wq [d,Hq,hd]``, ``wo [Hq,hd,d]``, ``mlp/wi
[d,f]``, stacked ``[G, ...]`` under ``blocks``).  The caller turns the other
side's leaves into numpy (``np.asarray(x)``, which keeps each leaf's dtype)
first, so no type of another framework is ever seen here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


PyTree = Any


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, as a writable copy.  A
    bfloat16 array (numpy's extension dtype of that name) crosses bit for
    bit."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def from_jax_params(tree: PyTree, *, device) -> PyTree:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    Every leaf keeps its own dtype: the leaves the other package keeps in
    float32 under a bfloat16 config (the RG-LRU's decay, the mLSTM's and
    sLSTM's gate biases) stay float32."""
    if isinstance(tree, dict):
        return {str(k): from_jax_params(v, device=device)
                for k, v in tree.items()}
    return _tensor(np.asarray(tree)).to(device)


def to_numpy_tree(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays (floating leaves
    as float32), for comparisons against the other package."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return leaf(tree)
