"""Model-layout decode attention as a schedule of atoms.

q [B,Hq,D], caches [B,S,Hk,D], lens [B] -> [B,Hq,D].  The ``R = B*Hk`` rows
are the schedulable units; ``n_atoms`` splits them into contiguous ranges,
each executed by one launch that writes in place into the running output.

For a CUDA tensor an atom launches the hand-written kernel
(``csrc/decode_attention.cu``) or raises.  The plain PyTorch version is
taken only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.atoms import schedule
from repro_torch.kernels.decode_attention.ref import decode_attention_atom_ref

launches = 0                      # kernel launches made by this module
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        fn = lib.decode_attention_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(q, k_cache, v_cache, lens, o):
    B, Hq, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, S, Hk, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hk:
        raise ValueError(f"Hq={Hq} is not a multiple of Hk={Hk}")
    if o.shape != q.shape or lens.shape != (B,):
        raise ValueError(f"o {tuple(o.shape)} / lens {tuple(lens.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == o.dtype):
        raise TypeError("q, caches and o must share one dtype")
    if not (q.device == k_cache.device == v_cache.device == lens.device
            == o.device):
        raise ValueError("all tensors must lie on one device")


def _check_cuda(q, k_cache, v_cache, lens, o) -> int:
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError("lens must be a contiguous int32 tensor")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("o", o)):
        code = build.check_operand("decode attention", name, t)
    return code


def decode_attention_atom(q, k_cache, v_cache, lens, o, *, start: int,
                          num_rows: int):
    """One atom: rows ``[start, start+num_rows)`` of ``R = B*Hk``, written in
    place into the running output ``o`` [B,Hq,D].  Returns ``o``."""
    global launches
    _check(q, k_cache, v_cache, lens, o)
    B, Hq, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    if not (0 <= start and 0 <= num_rows and start + num_rows <= B * Hk):
        raise ValueError(f"atom [{start}, {start}+{num_rows}) outside "
                         f"[0, {B * Hk})")
    if q.device.type == "cpu":
        return decode_attention_atom_ref(q, k_cache, v_cache, lens, o,
                                         start=start, num_rows=num_rows)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode attention has a CUDA kernel and a CPU "
                           f"version; no path for device {q.device}")
    dtype_code = _check_cuda(q, k_cache, v_cache, lens, o)
    if num_rows == 0:
        return o
    with torch.cuda.device(q.device):
        err = _library().decode_attention_atom(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), o.data_ptr(), start, num_rows, Hk, Hq // Hk, S,
            D, dtype_code,
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            o.stride(0), o.stride(1),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_atom launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, S={S}, {q.dtype})")
    launches += 1
    return o


def decode_attention(q, k_cache, v_cache, lens, *, n_atoms: int = 1,
                     order: Sequence[int] = ()):
    """q [B,Hq,D] against caches [B,S,Hk,D], row ``b`` attending to its first
    ``lens[b]`` keys (clamped to [0, S]; length 0 gives zeros).  ``order``
    permutes the execution of the atoms; the result does not depend on it."""
    B, _, _ = q.shape
    Hk = k_cache.shape[2]
    lens = lens.to(torch.int32)
    o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    for start, ln in schedule(B * Hk, n_atoms, order):
        decode_attention_atom(q, k_cache, v_cache, lens, o, start=start,
                              num_rows=ln)
    return o
