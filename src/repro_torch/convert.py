"""Parameter (and train-state) conversion between the JAX package's trees
and this package's.

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


def from_jax_train_state(state, *, device):
    """The other package's ``TrainState(params, OptState(step, mu, nu),
    err_fb)`` as this package's, leaf by leaf and bit for bit: an int8
    moment (any leaf with ``q``, ``scale`` and ``shape``) becomes a
    ``QTensor``, ``err_fb=None`` stays None."""
    from repro_torch.optim.optimizers import OptState, QTensor
    from repro_torch.train.step import TrainState

    def moments(tree):
        if isinstance(tree, dict):
            return {str(k): moments(v) for k, v in tree.items()}
        if all(hasattr(tree, a) for a in ("q", "scale", "shape")):
            return QTensor(_tensor(np.asarray(tree.q)).to(device),
                           _tensor(np.asarray(tree.scale)).to(device),
                           tuple(tree.shape))
        return _tensor(np.asarray(tree)).to(device)

    opt = state.opt
    return TrainState(
        from_jax_params(state.params, device=device),
        OptState(_tensor(np.asarray(opt.step)).to(device), moments(opt.mu),
                 moments(opt.nu)),
        None if state.err_fb is None
        else from_jax_params(state.err_fb, device=device))


def to_numpy_tree(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays (floating leaves
    as float32), for comparisons against the other package."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return leaf(tree)
