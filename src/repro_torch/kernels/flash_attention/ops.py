"""Model-layout GQA flash attention as a schedule of atoms.

q [B,Sq,Hq,D], k/v [B,Sk,Hk,D] -> [B,Sq,Hq,D].  The schedulable space is the
flat tile index over ``(B*Hq) x ceil(Sq/block_q)``; ``n_atoms`` splits it into
contiguous ranges, each executed by one launch that writes in place into the
running output.  Ragged ``Sq`` / ``Sk`` are masked, never padded.

For a CUDA tensor an atom launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises.  The plain PyTorch version is taken
only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.atoms import schedule
from repro_torch.kernels.flash_attention.ref import flash_attention_atom_ref

launches = 0                      # kernel launches made by this module
# Query rows of a tile: one 64-row warpgroup multiply (wgmma) on the bf16
# path.  Two thread blocks fit one SM on both paths up to head_dim 128 (bf16
# 83 KB of Q and a 2-stage K/V ring; f32 75 KB of staging), one at 256.
BLOCK_Q = 64
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_block_q.restype = ctypes.c_int
        lib.flash_attention_block_q.argtypes = []
        if lib.flash_attention_block_q() != BLOCK_Q:
            raise RuntimeError("csrc/flash_attention.cu and ops.BLOCK_Q "
                               "disagree on the q tile")
        lib.flash_attention_ctas_per_sm.restype = ctypes.c_int
        lib.flash_attention_ctas_per_sm.argtypes = [ctypes.c_int] * 2
        fn = lib.flash_attention_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
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


def flash_attention_atom(q, k, v, o, *, start: int, num_tiles: int,
                         causal: bool = True, block_q: int = BLOCK_Q,
                         window: int = 0):
    """One atom: tiles ``[start, start+num_tiles)`` of the flat tile space,
    written in place into the running output ``o`` [B,Sq,Hq,D].  ``window >
    0`` also masks keys at or before ``qpos - window``.  Returns ``o``."""
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
    if q.device.type == "cpu":
        return flash_attention_atom_ref(q, k, v, o, start=start,
                                        num_tiles=num_tiles, causal=causal,
                                        block_q=block_q, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention has a CUDA kernel and a CPU "
                           f"version; no path for device {q.device}")
    dtype_code = _check_cuda(q, k, v, o, block_q)
    if num_tiles == 0:
        return o
    with torch.cuda.device(q.device):
        err = _library().flash_attention_atom(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), start,
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
                    window: int = 0):
    """[B,Sq,Hq,D] x [B,Sk,Hk,D] -> [B,Sq,Hq,D]; ``window > 0``: each query
    sees only its last ``window`` keys.  ``order`` permutes the execution of
    the atoms; the result does not depend on it."""
    o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    for start, ln in schedule(tile_space(q, block_q), n_atoms, order):
        flash_attention_atom(q, k, v, o, start=start, num_tiles=ln,
                             causal=causal, block_q=block_q, window=window)
    return o
