"""train_step factory: remat, microbatch accumulation in f32, optional int8
gradient compression with error feedback.

``make_train_step(cfg, tc, device=...)`` returns ``(init_state,
train_step)``; ``train_step(state, batch) -> (state, metrics)`` builds a new
state (the parameters and moments of the old one are not written).  The
gradient of each microbatch is taken with ``torch.autograd.grad`` (so no
``.grad`` of a bf16 parameter accumulates in bf16); with ``n_micro > 1``
they are summed in f32 and averaged.  Gradient compression quantizes the
gradients to int8 blocks before the (conceptual) data-axis reduction and
keeps the quantization error as feedback added to the next step.

Spans (``repro_torch.spans``, recorded only while a profiler records, each
also timed on the device): ``train.forward`` (``train_loss``) and
``train.backward`` (``torch.autograd.grad`` and the gradients' zero fill
and layout) once per microbatch, with its index and its label count, and
``train.optimizer`` (``adamw_update``, with ``fused``: the leaves the
fused AdamW kernel updated).  The autograd engine runs the
backward on a thread of its own but on the forward's stream, so the
events recorded before and after ``autograd.grad`` bracket all of it.

On the card the attention layers' forward and backward are the
flash-attention kernels (``kernels/flash_attention``); the rest is autograd
of PyTorch operations, as the reference's is autodiff of jnp.

Over a mesh the state's leaves and the batch are DTensors (``launch/
train.py``; run the step under ``implicit_replication``): a microbatch keeps
the batch's layout, and each gradient is reduced to its parameter's layout
before it is accumulated (the data-axis all-reduce).  Gradient compression
quantizes the whole leaf's int8 blocks there, as the reference does
(``optim.optimizers.quantize_roundtrip`` of a DTensor), and its residual
keeps the parameter's layout.
"""
from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.adamw import ops as fused_adamw
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import init_model, train_loss
from repro_torch.models.sharding import laid_out_as
from repro_torch.optim.optimizers import (AdamWConfig, OptState, adamw_init,
                                          adamw_update, quantize_roundtrip)
from repro_torch.optim.schedules import cosine_schedule

PyTree = Any

# the microbatch ``loss_and_grads`` works on, for its spans
_MICRO = contextvars.ContextVar("microbatch", default=0)


@dataclass(frozen=True)
class TrainConfig:
    remat: str = "none"              # none | dots | full
    n_micro: int = 1
    loss_chunk: int = 512
    # accepted for the reference's signature; no effect: the attention
    # kernels' tile is fixed (flash_attention.ops.BLOCK_Q)
    attn_block: int = 512
    grad_compress: bool = False      # int8 + error feedback
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class TrainState(NamedTuple):
    params: PyTree
    opt: OptState
    err_fb: Optional[PyTree]         # error-feedback residual (compression)


def _split_micro(batch: dict, n: int) -> list[dict]:
    """[B, ...] -> n microbatches of [B//n, ...]."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not split "
                             f"into {n} microbatches")
    return [{k: laid_out_as(v.chunk(n, dim=0)[i], v)
             for k, v in batch.items()} for i in range(n)]


def _compress_grads(grads: PyTree, err: PyTree) -> tuple[PyTree, PyTree]:
    """int8 block quantization with error feedback.  Returns (decoded grads
    as they would arrive after the all-reduce, new residual)."""
    dec, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.to(torch.float32) + e
        dec.append(laid_out_as(quantize_roundtrip(g32), g32))
        new_err.append(g32 - dec[-1])
    return tree_unflatten(grads, dec), tree_unflatten(grads, new_err)


def loss_and_grads(cfg: ArchConfig, tc: TrainConfig, params: PyTree,
                   batch: dict):
    """(loss, metrics, grads) of one (micro)batch; grads in the params'
    dtypes, nested as ``params``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        with spans.span("train.forward", device=True) as sp:
            if sp:
                sp.set(tokens=batch["labels"].numel(), micro=_MICRO.get())
            loss, metrics = train_loss(live, cfg, batch, remat=tc.remat,
                                       loss_chunk=tc.loss_chunk,
                                       attn_block=tc.attn_block)
        with spans.span("train.backward", device=True) as sp:
            if sp:
                sp.set(tokens=batch["labels"].numel(), micro=_MICRO.get())
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else laid_out_as(x, p)
                 for p, x in zip(leaves, g)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, g))


def make_train_step(cfg: ArchConfig, tc: TrainConfig = TrainConfig(), *,
                    device=None):
    """(init_state, train_step) for ``cfg``.  ``init_state(seed=0,
    params=None)`` draws parameters on ``device`` (None: the GPU) unless
    given them (converted from the reference, say)."""
    opt_cfg = AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay,
                          grad_clip=tc.grad_clip,
                          moment_dtype=tc.moment_dtype)

    def init_state(seed: int = 0, params: PyTree = None) -> TrainState:
        if params is None:
            params = init_model(cfg, seed=seed, device=device)
        opt = adamw_init(params, opt_cfg)
        err = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
               if tc.grad_compress else None)
        return TrainState(params, opt, err)

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        params = state.params
        if tc.n_micro > 1:
            gsum, lsum = None, 0.0
            for i, mb in enumerate(_split_micro(batch, tc.n_micro)):
                micro = _MICRO.set(i)
                try:
                    loss, _, g = loss_and_grads(cfg, tc, params, mb)
                finally:
                    _MICRO.reset(micro)
                g = [x.to(torch.float32) for x in tree_leaves(g)]
                gsum = g if gsum is None else [a.add_(b) for a, b in
                                               zip(gsum, g)]
                lsum = lsum + loss
                del g
            grads = tree_unflatten(params, [x / tc.n_micro for x in gsum])
            loss = lsum / tc.n_micro
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = loss_and_grads(cfg, tc, params, batch)

        err_fb = state.err_fb
        if tc.grad_compress:
            grads, err_fb = _compress_grads(grads, err_fb)

        lr = cosine_schedule(state.opt.step, tc.lr, tc.total_steps,
                             tc.warmup_steps)
        with spans.span("train.optimizer", device=True) as sp:
            launched = fused_adamw.launches
            new_params, new_opt, opt_metrics = adamw_update(
                params, grads, state.opt, opt_cfg, lr)
            if sp:
                # the fused route updates every leaf; the plain one launches
                # none of its kernels
                leaves = tree_leaves(params)
                sp.set(params=sum(p.numel() for p in leaves),
                       fused=len(leaves) * (fused_adamw.launches > launched))
        out = {"loss": loss, "lr": lr, **metrics, **opt_metrics}
        return TrainState(new_params, new_opt, err_fb), out

    return init_state, train_step

