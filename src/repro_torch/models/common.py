"""Shared model infrastructure: param trees, initializers, logical axes,
dtype helpers.

Models are plain functions on tensors: ``init_*`` builds a nested dict of
tensors (the parameter tree; paths like ``blocks/0/attn/wq``), apply
functions take ``(params, inputs)``.  Everything that allocates takes an
explicit ``device``; initialisers draw from an explicit ``torch.Generator``.
Sharding is expressed through *logical axes*: ``logical_axes()`` maps each
leaf's path to logical dimension names, which ``sharding.py`` resolves to
mesh axes.
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "int8": torch.int8}[name]


def resolve_device(device) -> torch.device:
    """``None`` means the GPU: entry points run on the card unless the caller
    asks for another device, and never carry on on the CPU by themselves."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present and device=None means 'cuda'; "
                "pass device='cpu' (or --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class _MetaGenerator:
    """Stands in for a generator on the ``meta`` device, which has none: the
    initialisers make tensors of the right shapes and dtypes there and draw
    nothing (a tree of shapes, such as a checkpoint restore's template)."""
    device = torch.device("meta")


def make_generator(seed: int, device) -> torch.Generator:
    device = torch.device(device)
    if device.type == "meta":
        return _MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# Initializers (seeded, shape-aware); drawn in f32 on the generator's device
# ---------------------------------------------------------------------------

# Most float32 elements one draw of ``normal_init`` holds at once (256 MB).
# A larger leaf is drawn a few leading-axis slices at a time (at least one:
# one layer of a stacked leaf) into a tensor of the target dtype, so the f32
# transient of a 34 B model's init is one layer's slice, not a whole stack.
DRAW_ELEMS = 1 << 26


def normal_init(gen: torch.Generator, shape, dtype, scale: float = 0.02):
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    width = math.prod(shape[1:])
    rows = out.view(shape[0] if shape else 1, width)
    step = max(1, DRAW_ELEMS // max(1, width))
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device,
                               dtype=torch.float32).mul_(scale))
    return out


def fan_in_init(gen: torch.Generator, shape, dtype, fan_axis: int = 0):
    fan_in = shape[fan_axis] if shape else 1
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(max(1, fan_in)))


def zeros_init(gen: torch.Generator, shape, dtype):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape, dtype):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Contraction helpers: f32 accumulation, output in the input dtype
# ---------------------------------------------------------------------------
# On the GPU a bf16 product accumulates in f32 inside the library call and
# rounds once on output.  On the CPU the operands are upcast to f32 and the
# result rounded once, which is the same contract.

def _upcast(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.bfloat16


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _contract(spec, a, b, fn=None):
    """``torch.einsum(spec, a, b)``; over DTensors on each rank's blocks
    (``sharding.local_contract``, each block through ``fn``)."""
    if is_dtensor(a) or is_dtensor(b):
        from repro_torch.models.sharding import local_contract
        return local_contract(spec, a, b, fn)
    return torch.einsum(spec, a, b)


def _matmul(x, w):
    """``x @ w`` of x [..., K] and w [K, N]; over DTensors as ``_contract``,
    each rank's blocks through ``torch.matmul`` as a plain tensor's."""
    if is_dtensor(x) or is_dtensor(w):
        lead = "abcefghijl"[:x.ndim - 1]
        return _contract(f"{lead}k,kn->{lead}n", x, w,
                         lambda _, a, b: torch.matmul(a, b))
    return torch.matmul(x, w)


def dot(x, w):
    """Matmul with f32 accumulation, output in x.dtype."""
    if _upcast(x):
        return _matmul(x.float(), w.float()).to(x.dtype)
    return _matmul(x, w)


def einsum(spec, *args, out_dtype: Optional[torch.dtype] = None):
    """``torch.einsum`` with f32 accumulation, output in ``out_dtype``
    (default: the first operand's dtype).  An f32 output of lower-precision
    operands (the MoE router's logits, the xLSTM gates) is computed from
    f32 operands, so it is never rounded to the operands' dtype first."""
    dt = out_dtype if out_dtype is not None else args[0].dtype
    if any(_upcast(a) for a in args) or (
            dt == torch.float32 and any(a.dtype != dt for a in args)):
        args = tuple(a.float() for a in args)
    if len(args) == 2:
        return _contract(spec, *args).to(dt)
    return torch.einsum(spec, *args).to(dt)


class _MmF32(torch.autograd.Function):
    """[N,K] @ [K,M] of low-precision operands with an f32 result, and its
    gradient: ``torch.mm(..., out_dtype=)`` has no derivative of its own.
    The backward rounds the f32 cotangent to the operands' dtype once and
    takes both products in it (f32 accumulation)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def dot_f32(x, w):
    """``x @ w`` with the result kept in f32 (the LM head's logits).  On
    ``meta`` (a dry-run) it takes the card's path.  Serving f32 DTensors
    take ``local_contract``'s layout (DTensor's own rule for ``matmul``
    gathers a weight that FSDP splits over the data axes)."""
    if x.dtype == torch.float32:
        if (is_dtensor(x) or is_dtensor(w)) and not torch.is_grad_enabled():
            from repro_torch.models.sharding import local_contract
            lead = "abcdefgh"[:x.ndim - 1]
            return local_contract(f"{lead}k,km->{lead}m", x, w)
        return torch.matmul(x, w)
    if x.device.type in ("cuda", "meta"):
        lead = x.shape[:-1]
        out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _mm_f32(x, w):
    """``_MmF32`` of [N,K] x [K,M]; over DTensors (``mm`` with an
    ``out_dtype`` has no DTensor rule) on each rank's blocks."""
    if is_dtensor(x) or is_dtensor(w):
        from repro_torch.models.sharding import local_contract
        return local_contract("nk,km->nm", x, w,
                              lambda _, a, b: _MmF32.apply(a, b))
    return _MmF32.apply(x, w)


# ---------------------------------------------------------------------------
# Param-tree helpers
# ---------------------------------------------------------------------------

def tree_paths(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    else:
        out.append((prefix, tree))
    return out


def tree_leaves(tree: PyTree) -> list:
    """The leaves in ``tree_paths`` order (keys sorted at every level)."""
    return [x for _, x in tree_paths(tree)]


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """``leaves`` (in ``tree_paths`` order) in the nesting of ``like``."""
    return _unflatten(like, iter(leaves))


def _unflatten(node: PyTree, it) -> PyTree:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would hold ``leaves`` (a whole new parameter
    # tree, say) until the garbage collector next runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn, tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def count_params(params: PyTree) -> int:
    return sum(int(np.prod(x.shape)) for _, x in tree_paths(params)
               if hasattr(x, "shape"))


def cast_tree(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Every floating leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


# ---------------------------------------------------------------------------
# Logical axes by param path
# ---------------------------------------------------------------------------
# Rules are (regex-on-path, axes-tuple).  Paths look like
# "blocks/0/attn/wq", "embed/tok", "blocks/0/moe/wi", ...  A leading
# "layers" axis is added for stacked layer params.

AXIS_RULES: list[tuple[str, tuple[str, ...]]] = [
    (r".*embed/tok$", ("vocab", "embed")),
    (r".*embed/pos$", (None, "embed")),
    (r".*head/w$", ("embed", "vocab")),
    (r".*(attn|xattn)/wq$", ("embed", "q_heads", "head")),
    (r".*(attn|xattn)/wk$", ("embed", "kv_heads", "head")),
    (r".*(attn|xattn)/wv$", ("embed", "kv_heads", "head")),
    (r".*(attn|xattn)/wo$", ("q_heads", "head", "embed")),
    (r".*(attn|xattn)/bq$", ("q_heads", "head")),
    (r".*(attn|xattn)/bk$", ("kv_heads", "head")),
    (r".*(attn|xattn)/bv$", ("kv_heads", "head")),
    (r".*mlp/wi$", ("embed", "ff")),
    (r".*mlp/wg$", ("embed", "ff")),
    (r".*mlp/wo$", ("ff", "embed")),
    (r".*moe/router$", ("embed", "experts")),
    (r".*moe/wi$", ("experts", "embed", "expert_ff")),
    (r".*moe/wg$", ("experts", "embed", "expert_ff")),
    (r".*moe/wo$", ("experts", "expert_ff", "embed")),
    (r".*moe/shared_wi$", ("embed", "ff")),
    (r".*moe/shared_wg$", ("embed", "ff")),
    (r".*moe/shared_wo$", ("ff", "embed")),
    # RG-LRU recurrent block
    (r".*rec/w_in$", ("embed", "rnn")),
    (r".*rec/w_gate_in$", ("embed", "rnn")),
    (r".*rec/conv_w$", (None, "rnn")),
    (r".*rec/conv_b$", ("rnn",)),
    (r".*rec/w_a$", ("rnn", "rnn_heads")),
    (r".*rec/w_i$", ("rnn", "rnn_heads")),
    (r".*rec/lam$", ("rnn",)),
    (r".*rec/w_out$", ("rnn", "embed")),
    # mLSTM / sLSTM
    (r".*mlstm/w_up$", ("embed", "ff")),
    (r".*mlstm/w_(q|k|v)$", ("ff", "q_heads", "head")),
    (r".*mlstm/w_(ig|fg)$", ("ff", "q_heads")),
    (r".*mlstm/b_(ig|fg)$", ("q_heads",)),
    (r".*mlstm/conv_w$", (None, "ff")),
    (r".*mlstm/w_down$", ("ff", "embed")),
    (r".*slstm/w_(i|f|z|o)$", ("embed", "q_heads", "head")),
    (r".*slstm/r_(i|f|z|o)$", ("q_heads", "head", "head")),
    (r".*slstm/b_(i|f|z|o)$", ("q_heads", "head")),
    (r".*slstm/ffn_wi$", ("embed", "ff")),
    (r".*slstm/ffn_wg$", ("embed", "ff")),
    (r".*slstm/ffn_wo$", ("ff", "embed")),
    # norms / misc
    (r".*(norm|ln)[^/]*/scale$", ("embed",)),
    (r".*(norm|ln)[^/]*/bias$", ("embed",)),
    (r".*vlm_proj/w$", ("embed", "embed2")),
]


def logical_axes_for_path(path: str, ndim: int) -> tuple:
    for pat, axes in AXIS_RULES:
        if re.match(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                # stacked layer param: leading layer axis
                return ("layers",) + axes
    return (None,) * ndim


def logical_axes(params: PyTree) -> PyTree:
    """Mirror tree of logical-axis tuples for a param tree (its leaves
    tensors, on any device ``meta`` included, or arrays)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return logical_axes_for_path(
            prefix, tree.ndim if hasattr(tree, "ndim") else np.ndim(tree))

    return walk(params, "")
