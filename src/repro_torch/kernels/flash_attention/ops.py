"""Model-layout GQA flash attention as a schedule of atoms.

q [B,Sq,Hq,D], k/v [B,Sk,Hk,D] -> [B,Sq,Hq,D].  The schedulable space is the
flat tile index over ``(B*Hq) x ceil(Sq/block_q)``; ``n_atoms`` splits it into
contiguous ranges, each executed by one launch that writes in place into the
running output.  Ragged ``Sq`` / ``Sk`` are masked, never padded.

For a CUDA tensor an atom launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises.  The plain PyTorch version is taken
only for tensors that lie on the CPU.  A ``meta`` tensor raises too, except
while a dry-run's ``roofline/cost.py`` counter is installed: then
``flash_attention`` and ``flash_attention_bwd`` return empty outputs and
charge the kernels' work to it.

The forward can also write each row's log-sum-exp (``lse``).  The backward
(``csrc/flash_attention_bwd.cu``) takes it: a ``delta`` pass, then atoms of
its own tile space, dQ tiles ``(B*Hq) x ceil(Sq/block_q)`` followed by
dK/dV tiles ``(B*Hk) x ceil(Sk/block_k)``, each owned by one thread block,
numbered as ``bwd_tile`` says; ``bwd_blocks(dtype, head_dim)`` gives the
blocks of the path that takes them.  ``FlashAttention`` joins the two
for autograd.  The backward kernel takes bfloat16 and float32 at head_dim
64, 128 and 256; any other CUDA operand raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.atoms import schedule
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import (
    attention_delta_ref, flash_attention_atom_ref,
    flash_attention_bwd_atom_ref)
from repro_torch.roofline import cost

launches = 0                      # forward kernel launches of this module
bwd_launches = 0                  # backward atom kernel launches
delta_launches = 0                # backward delta-pass launches
# Query rows of a tile: one 64-row warpgroup multiply (wgmma) on the bf16
# path, four warps of 16 rows on the f32 (split TF32) path.  Two thread
# blocks fit one SM on both paths up to head_dim 128 (bf16 83 KB of Q and a
# 2-stage K/V ring; f32 101 KB of Q and a 2-stage ring of split K/V), one
# at 256.
BLOCK_Q = 64
# Keys of a KV block that a bf16 tile visits (``TBK`` of the .cu's wgmma
# path, exported and checked at load); ``core/llm_costs.py`` pads to it.
KEY_BLOCK = 64
BWD_HEAD_DIMS = (64, 128, 256)    # the backward kernel's head dims, both dtypes
_lib = None
_bwd_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        for fn in (lib.flash_attention_block_q, lib.flash_attention_key_block):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if (lib.flash_attention_block_q(),
                lib.flash_attention_key_block()) != (BLOCK_Q, KEY_BLOCK):
            raise RuntimeError("csrc/flash_attention.cu and ops.BLOCK_Q / "
                               "KEY_BLOCK disagree on the q tile or KV block")
        lib.flash_attention_ctas_per_sm.restype = ctypes.c_int
        lib.flash_attention_ctas_per_sm.argtypes = [ctypes.c_int] * 2
        fn = lib.flash_attention_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def tile_space(q, block_q: int = BLOCK_Q) -> int:
    """Schedulable tiles of a q [B,Sq,Hq,D]."""
    B, Sq, Hq, _ = q.shape
    return B * Hq * -(-Sq // block_q)


def ctas_per_sm(head_dim: int, dtype: torch.dtype) -> int:
    """Thread blocks (one a tile) of the kernel that one SM of the current
    GPU holds at once (the CUDA occupancy calculator)."""
    n = _library().flash_attention_ctas_per_sm(
        head_dim, build.DTYPE_CODES[str(dtype)])
    if n <= 0:
        raise RuntimeError(f"flash_attention occupancy query failed ({n})")
    return n


def _check(q, k, v, o):
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hk, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hk:
        raise ValueError(f"Hq={Hq} is not a multiple of Hk={Hk}")
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} does not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype):
        raise TypeError("q, k, v and o must share one dtype")
    if not (q.device == k.device == v.device == o.device):
        raise ValueError("all tensors must lie on one device")


def _check_cuda(q, k, v, o, block_q) -> int:
    if block_q != BLOCK_Q:
        raise ValueError(f"flash attention kernel is built for "
                         f"block_q={BLOCK_Q}, not {block_q}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        code = build.check_attention_operand("flash attention", name, t)
    return code


def _check_lse(name, t, B, Hq, Sq, device):
    if t.shape != (B, Hq, Sq) or t.dtype != torch.float32 \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous float32 [B,Hq,Sq] = "
                         f"{(B, Hq, Sq)} tensor on {device}, not "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_atom(q, k, v, o, *, start: int, num_tiles: int,
                         causal: bool = True, block_q: int = BLOCK_Q,
                         window: int = 0, lse=None):
    """One atom: tiles ``[start, start+num_tiles)`` of the flat tile space,
    written in place into the running output ``o`` [B,Sq,Hq,D], and, when
    ``lse`` (f32 [B,Hq,Sq]) is given, the natural-base log-sum-exp of their
    rows' scaled scores (+inf for a row that sees no key).  ``window > 0``
    also masks keys at or before ``qpos - window``.  Returns ``o``."""
    global launches
    _check(q, k, v, o)
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if window < 0:
        raise ValueError(f"window must be >= 0, not {window}")
    total = tile_space(q, block_q)
    if not (0 <= start and 0 <= num_tiles and start + num_tiles <= total):
        raise ValueError(f"atom [{start}, {start}+{num_tiles}) outside "
                         f"[0, {total})")
    if lse is not None:
        _check_lse("lse", lse, B, Hq, Sq, q.device)
    if q.device.type == "cpu":
        return flash_attention_atom_ref(q, k, v, o, start=start,
                                        num_tiles=num_tiles, causal=causal,
                                        block_q=block_q, window=window,
                                        lse=lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention has a CUDA kernel and a CPU "
                           f"version; no path for device {q.device}")
    dtype_code = _check_cuda(q, k, v, o, block_q)
    if num_tiles == 0:
        return o
    with torch.cuda.device(q.device):
        err = _library().flash_attention_atom(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), start,
            num_tiles, -(-Sq // block_q), B, Hq, Hq // Hk, Sq, Sk, D,
            int(causal), int(window), dtype_code,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_atom launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, Sk={Sk}, {q.dtype}, "
                           f"window={window})")
    launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, n_atoms: int = 1,
                    block_q: int = BLOCK_Q, order: Sequence[int] = (),
                    window: int = 0, return_lse: bool = False):
    """[B,Sq,Hq,D] x [B,Sk,Hk,D] -> [B,Sq,Hq,D]; ``window > 0``: each query
    sees only its last ``window`` keys.  ``order`` permutes the execution of
    the atoms; the result does not depend on it.  ``return_lse`` also
    returns each row's log-sum-exp, f32 [B,Hq,Sq]."""
    B, Sq, Hq, _ = q.shape
    if q.device.type == "meta" and cost.counting():
        o = torch.empty(q.shape, dtype=q.dtype, device="meta")
        _check(q, k, v, o)
        cost.charge_flash(q, k, v, causal=causal, window=window,
                          lse=return_lse)
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device="meta")
        return (o, lse) if return_lse else o
    o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    # the serving path's call is the one it always was (no ``lse``)
    lse = {"lse": torch.empty((B, Hq, Sq), dtype=torch.float32,
                              device=q.device)} if return_lse else {}
    for start, ln in schedule(tile_space(q, block_q), n_atoms, order):
        flash_attention_atom(q, k, v, o, start=start, num_tiles=ln,
                             causal=causal, block_q=block_q, window=window,
                             **lse)
    return (o, lse["lse"]) if return_lse else o


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("flash_attention_bwd")
        for fn in (lib.flash_attention_bwd_block_q,
                   lib.flash_attention_bwd_block_k):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 2
        for dtype in (torch.bfloat16, torch.float32):
            code = build.DTYPE_CODES[str(dtype)]
            for D in BWD_HEAD_DIMS:
                got = (lib.flash_attention_bwd_block_q(code, D),
                       lib.flash_attention_bwd_block_k(code, D))
                if got != bwd_blocks(dtype, D):
                    raise RuntimeError(
                        f"csrc/flash_attention_bwd.cu and ops.bwd_blocks "
                        f"disagree on the tiles of {dtype} at head_dim {D}: "
                        f"{got} against {bwd_blocks(dtype, D)}")
        fn = lib.flash_attention_bwd_delta
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn = lib.flash_attention_bwd_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                       + [ctypes.c_longlong] * 21 + [ctypes.c_void_p])
        _bwd_lib = lib
    return _bwd_lib


def bwd_blocks(dtype, head_dim: int) -> tuple[int, int]:
    """(query rows of a dQ tile, keys of a dK/dV tile) of the backward path
    that takes ``dtype`` at ``head_dim`` (exported by the .cu and checked at
    load): bf16 up to head_dim 128 is the wgmma path, two consumer
    warpgroups of 64 rows each; bf16 at 256 its variant, dQ tiles of 128
    query rows and dK/dV tiles of 64 keys split between a dV and a dK
    warpgroup; f32 the split-TF32 path, 128 rows (32 at head_dim 256, where
    a row takes 1 KB of shared memory).  The CPU's plain atoms take the same
    tiles, so an atom writes the same rows on either device."""
    if dtype == torch.bfloat16:
        return (128, 128) if head_dim <= 128 else (128, 64)
    return (32, 32) if head_dim == 256 else (128, 128)


def _blocks(q) -> tuple[int, int]:
    return bwd_blocks(q.dtype, q.shape[-1])


def bwd_tile_space(q, k) -> int:
    """Schedulable tiles of the backward: dQ tiles of q [B,Sq,Hq,D], then
    dK/dV tiles of k [B,Sk,Hk,D], at ``bwd_blocks`` of q."""
    n_dq, n_kv = ref.bwd_tile_space(q, k, *_blocks(q))
    return n_dq + n_kv


def bwd_tile(t: int, q, k) -> tuple:
    """What tile ``t`` of ``bwd_tile_space`` writes (``ref.bwd_tile`` at the
    kernel's tiles for q): ("dq", b, h, r0, r1), query rows [r0, r1) of
    dq[b, :, h], or ("dkv", b, hk, c0, c1), keys [c0, c1) of dk, dv[b, :,
    hk]."""
    return ref.bwd_tile(t, q, k, *_blocks(q))


def _check_bwd_cuda(tensors) -> int:
    """Raise unless the backward kernel takes these CUDA operands."""
    for name, t in tensors:
        code = build.check_attention_operand("flash attention backward",
                                             name, t)
        if t.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(
                f"flash attention backward kernel takes head_dim in "
                f"{BWD_HEAD_DIMS}, not {t.shape[-1]} ({name})")
    return code


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32: [B,Sq,Hq,D] -> [B,Hq,Sq]."""
    global delta_launches
    if o.shape != do.shape or o.dtype != do.dtype or o.device != do.device:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} do not match")
    if o.device.type == "cpu":
        return attention_delta_ref(o, do)
    if o.device.type != "cuda":
        raise RuntimeError(f"flash attention backward has a CUDA kernel and "
                           f"a CPU version; no path for device {o.device}")
    code = _check_bwd_cuda((("o", o), ("do", do)))
    B, Sq, Hq, D = o.shape
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = _bwd_library().flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, Hq, Sq, D, code,
            o.stride(0), o.stride(1), o.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_delta launch failed: CUDA "
                           f"error {err} (o {tuple(o.shape)}, {o.dtype})")
    delta_launches += 1
    return delta


def flash_attention_bwd_atom(q, k, v, do, lse, delta, dq, dk, dv, *,
                             start: int, num_tiles: int, causal: bool = True,
                             window: int = 0):
    """One backward atom: tiles ``[start, start+num_tiles)`` of
    ``bwd_tile_space``, written in place into dq (like q) and dk, dv (like
    k).  ``lse`` and ``delta``: f32 [B,Hq,Sq] from the forward and
    ``attention_delta``.  Returns (dq, dk, dv)."""
    global bwd_launches
    _check(q, k, v, dq)
    if do.shape != q.shape or dk.shape != k.shape or dv.shape != k.shape:
        raise ValueError(f"do {tuple(do.shape)}, dk {tuple(dk.shape)}, dv "
                         f"{tuple(dv.shape)} do not match q and k")
    if not all(t.dtype == q.dtype and t.device == q.device
               for t in (do, dk, dv)):
        raise TypeError("do, dq, dk and dv must share q's dtype and device")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    _check_lse("lse", lse, B, Hq, Sq, q.device)
    _check_lse("delta", delta, B, Hq, Sq, q.device)
    if window < 0:
        raise ValueError(f"window must be >= 0, not {window}")
    total = bwd_tile_space(q, k)
    if not (0 <= start and 0 <= num_tiles and start + num_tiles <= total):
        raise ValueError(f"backward atom [{start}, {start}+{num_tiles}) "
                         f"outside [0, {total})")
    block_q, block_k = _blocks(q)
    if q.device.type == "cpu":
        return flash_attention_bwd_atom_ref(
            q, k, v, do, lse, delta, dq, dk, dv, start=start,
            num_tiles=num_tiles, causal=causal, window=window,
            block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention backward has a CUDA kernel and "
                           f"a CPU version; no path for device {q.device}")
    code = _check_bwd_cuda((("q", q), ("k", k), ("v", v), ("do", do),
                            ("dq", dq), ("dk", dk), ("dv", dv)))
    if num_tiles == 0:
        return dq, dk, dv
    ts = [x for t in (q, k, v, do, dq, dk, dv) for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _bwd_library().flash_attention_bwd_atom(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), start, num_tiles, -(-Sq // block_q), B, Hq,
            Hq // Hk, Sq, Sk, D, int(causal), int(window), code, *ts,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_atom launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, Sk={Sk}, "
                           f"{q.dtype}, window={window})")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, n_atoms: int = 1,
                        order: Sequence[int] = ()):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` = o against
    the output gradient ``do``, from the forward's ``lse``.  The delta pass
    runs first, then ``n_atoms`` atoms of ``bwd_tile_space`` in ``order``;
    the result does not depend on either."""
    if q.device.type == "meta" and cost.counting():
        cost.charge_flash_bwd(q, k, v, causal=causal, window=window)
        return tuple(torch.empty_like(t) for t in (q, k, v))
    delta = attention_delta(o, do)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for start, ln in schedule(bwd_tile_space(q, k), n_atoms, order):
        flash_attention_bwd_atom(q, k, v, do, lse, delta, dq, dk, dv,
                                 start=start, num_tiles=ln, causal=causal,
                                 window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward launches the
    forward atoms with the log-sum-exp, the backward the delta pass and the
    backward atoms."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
