"""The fused AdamW of ``csrc/adamw.cu``: the gradients' global norm in one
multi-tensor pass, and each leaf's update in one pass.

``grad_norm(grads)`` returns the f32 norm of a list of CUDA gradients as a
device scalar.  ``update_leaf`` returns a leaf's new parameter and moments,
newly allocated: the old ones are not written.  Their arithmetic is the plain
route's (``optim/optimizers.adamw_leaf``), operation for operation, so given
the same ``clip`` the results are the plain route's bit for bit; the norm
sums in another order (f32 within a 16-byte vector, f64 beyond).

The plain version of both lives in ``optim/optimizers.py``, which chooses
the route from what its inputs are (``fused_route``: float32 or bfloat16
tensors on one CUDA device) and hands these wrappers each operand
contiguous.  The kernels read flat memory, so a wrapper raises for an
operand that is not contiguous or whose shape differs from its leaf's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0                      # kernel launches made by this module
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("adamw")
        for fn in (lib.adamw_sumsq_blocks, lib.adamw_max_leaves):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        lib.adamw_grad_norm.restype = ctypes.c_int
        lib.adamw_grad_norm.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.adamw_update_leaf.restype = ctypes.c_int
        lib.adamw_update_leaf.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_int]
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _operand(name: str, t: torch.Tensor) -> int:
    """The dtype code of ``t`` for the C interface; raises unless ``t`` is
    contiguous."""
    if not t.is_contiguous():
        raise ValueError(f"fused AdamW: {name} is not contiguous "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")
    return build.DTYPE_CODES[str(t.dtype)]


def max_leaves() -> int:
    """Leaves one launch of the norm's first stage takes."""
    return _library().adamw_max_leaves()


def launches_per_step(n_leaves: int) -> int:
    """Launches of one step over ``n_leaves`` leaves: the norm's first stage
    once per ``max_leaves()`` leaves, its final stage, one update a leaf."""
    return -(-n_leaves // max_leaves()) + 1 + n_leaves


def grad_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``grads`` (CUDA
    tensors on one device), as an f32 device scalar.  The same bits at every
    call on the same inputs."""
    global launches
    lib = _library()
    dev = grads[0].device
    codes = [_operand(f"gradient {i}", g) for i, g in enumerate(grads)]
    n = len(grads)
    groups = -(-n // lib.adamw_max_leaves())
    partial = torch.empty(groups * lib.adamw_sumsq_blocks(),
                          dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
    numel = (ctypes.c_longlong * n)(*[g.numel() for g in grads])
    dtypes = (ctypes.c_int * n)(*codes)
    with torch.cuda.device(dev):
        err = lib.adamw_grad_norm(ptrs, numel, dtypes, n, partial.data_ptr(),
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw grad_norm launch failed: CUDA error {err} "
                           f"({n} leaves)")
    launches += groups + 1
    return out


def update_leaf(p, g, mu, nu, *, lr, clip, c1, c2, b1: float, b2: float,
                eps: float, weight_decay: float):
    """One leaf's AdamW step: (new p, new mu, new nu), each newly allocated
    in the dtype of the one it replaces.  ``lr``, ``clip``, ``c1``, ``c2``
    are f32 scalars on the leaf's device; weight decay applies to leaves of
    two or more dimensions, as stored."""
    global launches
    dev = p.device
    pc, gc, mc = (_operand(name, t) for name, t in
                  (("parameter", p), ("gradient", g), ("first moment", mu)))
    if _operand("second moment", nu) != mc:
        raise TypeError(f"fused AdamW: moments of two dtypes ({mu.dtype}, "
                        f"{nu.dtype})")
    if not (p.shape == g.shape == mu.shape == nu.shape):
        raise ValueError(f"fused AdamW: shapes {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(mu.shape)}, "
                         f"{tuple(nu.shape)} differ")
    new_p, new_mu, new_nu = (torch.empty_like(t) for t in (p, mu, nu))
    with torch.cuda.device(dev):
        err = _library().adamw_update_leaf(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            new_p.data_ptr(), new_mu.data_ptr(), new_nu.data_ptr(),
            p.numel(), pc, gc, mc, lr.data_ptr(), clip.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, int(p.ndim >= 2),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw update launch failed: CUDA error {err} "
                           f"(shape {tuple(p.shape)}, {p.dtype}, {g.dtype}, "
                           f"{mu.dtype})")
    launches += 1
    return new_p, new_mu, new_nu
