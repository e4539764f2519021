"""Model-layout decode attention as a schedule of atoms.

q [B,Hq,D], caches [B,S,Hk,D], lens [B] -> [B,Hq,D].  The ``R = B*Hk`` rows
are the schedulable units; ``n_atoms`` splits them into contiguous ranges,
each executed by one launch that writes in place into the running output.

For a CUDA tensor an atom launches the hand-written kernel
(``csrc/decode_attention.cu``) or raises.  The plain PyTorch version is
taken only for tensors that lie on the CPU.  The kernel's route is decided
here, before the launch (``plan``): both dtypes take a split-KV kernel fed
by TMA, one cluster of ``nsplit`` CTAs a row, bfloat16 on the tensor cores
(``split``) and float32 on the CUDA cores (``split_f32``); ``kv_split``
mirrors the C side's schedule, checked when the library loads, over the
cluster occupancy of the dtype's kernel that ``cluster_fit`` reads.  Both
load through TMA, so caches whose strides are not multiples of 8 elements
raise.

Optionally a call also writes each query row's lse (``m + log(l)``, f32
[B,Hq], ``-inf`` for a row of length 0) and gives a bfloat16 call an f32
output: the partial of one part of a cache, which ``merge.merge_partials``
combines with the others' rounding once (``kernels/sharded.py``'s decode
over a sequence-sharded cache).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.atoms import schedule
from repro_torch.kernels.decode_attention.ref import decode_attention_atom_ref
from repro_torch.roofline import cost

launches = 0                      # kernel launches made by this module
KEY_BLOCK = 64                    # keys of the split kernel's TMA block
# route codes of the C interface
ROUTES = {"split_f32": 0, "split": 1}
SPLITS = (1, 2, 4, 8)              # split counts; 8 is the portable cluster size
_lib = None
_fit: dict[tuple[int, int, int], tuple[int, ...]] = {}


def kv_split(R_total: int, S: int, fit: Sequence[int]) -> tuple[int, int]:
    """The split schedule of a call over ``R_total = B*Hk`` rows of ``S``
    keys: ``(nsplit, chunk)``.  ``fit[i]`` is the number of clusters of
    ``SPLITS[i]`` CTAs the card runs at once (``cluster_fit``).  ``nsplit``
    is the largest of ``SPLITS``, at most the 64-key blocks of ``S``, whose
    ``R_total`` clusters all run at once, so every row is in flight in one
    round; split ``j`` covers keys ``[j*chunk, min((j+1)*chunk, S))`` and
    ``chunk`` is a multiple of 64.  It depends on the whole call and the
    card, never on an atom's rows, so every atom runs a row the same way."""
    nb = -(-S // KEY_BLOCK) if S > 0 else 1
    n = 1
    for i, c in enumerate(SPLITS[1:], start=1):
        if c <= nb and fit[i] >= R_total:
            n = c
    return n, -(-nb // n) * KEY_BLOCK


def _library():
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        lib.decode_attention_kv_split.restype = ctypes.c_int
        lib.decode_attention_kv_split.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)] * 3
        for R in (1, 8, 16, 32, 33, 66, 132, 264, 1000):
            for S in (1, 64, 65, 128, 200, 300, 2048, 8192):
                for fit in ((264, 132, 62, 30), (132, 66, 30, 15),
                            (1, 1, 1, 1), (1000, 500, 250, 120)):
                    n, c = ctypes.c_int(), ctypes.c_int()
                    lib.decode_attention_kv_split(
                        R, S, (ctypes.c_int * 4)(*fit), ctypes.byref(n),
                        ctypes.byref(c))
                    if (n.value, c.value) != kv_split(R, S, fit):
                        raise RuntimeError(
                            "csrc/decode_attention.cu and ops.kv_split "
                            f"disagree (R_total={R}, S={S}, fit={fit})")
        lib.decode_attention_max_active_clusters.restype = ctypes.c_int
        lib.decode_attention_max_active_clusters.argtypes = [ctypes.c_int] * 3
        fn = lib.decode_attention_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def max_active_clusters(head_dim: int, nsplit: int,
                        dtype=torch.bfloat16) -> int:
    """Clusters of ``nsplit`` CTAs of the split kernel of ``dtype`` that the
    current GPU runs at once (``cudaOccupancyMaxActiveClusters``)."""
    n = _library().decode_attention_max_active_clusters(
        head_dim, build.DTYPE_CODES[str(dtype)], nsplit)
    if n < 0:
        raise RuntimeError(f"decode_attention cluster occupancy query "
                           f"failed ({n})")
    return n


def cluster_fit(device, head_dim: int,
                dtype=torch.bfloat16) -> tuple[int, ...]:
    """``max_active_clusters`` for each of ``SPLITS`` on a CUDA device, read
    once per device, head dim and dtype."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    key = (idx, head_dim, build.DTYPE_CODES[str(dtype)])
    if key not in _fit:
        with torch.cuda.device(idx):
            _fit[key] = tuple(max_active_clusters(head_dim, n, dtype)
                              for n in SPLITS)
    return _fit[key]


def _check(q, k_cache, v_cache, lens, o, lse=None):
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
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("q and the caches must share one dtype")
    if o.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"o is {o.dtype}: q's dtype or float32")
    if lse is not None and (lse.shape != (B, Hq)
                            or lse.dtype != torch.float32):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: float32 "
                         f"[{B}, {Hq}]")
    if not (q.device == k_cache.device == v_cache.device == lens.device
            == o.device) or (lse is not None and lse.device != q.device):
        raise ValueError("all tensors must lie on one device")


def plan(q, k_cache, v_cache) -> dict:
    """The kernel route of a call on CUDA tensors, decided before the
    launch: ``{"route": "split" | "split_f32", "nsplit", "chunk"}``, the
    split schedule of ``kv_split`` over the dtype's kernel's cluster fit.
    Raises for an operand the kernels do not take."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        build.check_attention_operand("decode attention", name, t)
    B, S, Hk = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    nsplit, chunk = kv_split(B * Hk, S, cluster_fit(q.device, q.shape[-1],
                                                    q.dtype))
    route = "split_f32" if q.dtype == torch.float32 else "split"
    return {"route": route, "nsplit": nsplit, "chunk": chunk}


def decode_attention_atom(q, k_cache, v_cache, lens, o, *, start: int,
                          num_rows: int, lse=None):
    """One atom: rows ``[start, start+num_rows)`` of ``R = B*Hk``, written in
    place into the running output ``o`` [B,Hq,D] (q's dtype or float32) and,
    if given, the lse [B,Hq] (float32).  Returns ``o``."""
    global launches
    _check(q, k_cache, v_cache, lens, o, lse)
    B, Hq, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    if not (0 <= start and 0 <= num_rows and start + num_rows <= B * Hk):
        raise ValueError(f"atom [{start}, {start}+{num_rows}) outside "
                         f"[0, {B * Hk})")
    if q.device.type == "cpu":
        return decode_attention_atom_ref(q, k_cache, v_cache, lens, o,
                                         start=start, num_rows=num_rows,
                                         lse=lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode attention has a CUDA kernel and a CPU "
                           f"version; no path for device {q.device}")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError("lens must be a contiguous int32 tensor")
    build.check_attention_operand("decode attention", "o", o)
    p = plan(q, k_cache, v_cache)
    if num_rows == 0:
        return o
    with torch.cuda.device(q.device):
        err = _library().decode_attention_atom(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None, start, num_rows,
            B * Hk, Hk, Hq // Hk, S, D, build.DTYPE_CODES[str(q.dtype)],
            ROUTES[p["route"]], p["nsplit"], build.DTYPE_CODES[str(o.dtype)],
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            o.stride(0), o.stride(1),
            *(lse.stride() if lse is not None else (0, 0)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_atom launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, S={S}, {q.dtype}, "
                           f"route {p['route']}, nsplit {p['nsplit']})")
    launches += 1
    return o


def decode_attention(q, k_cache, v_cache, lens, *, n_atoms: int = 1,
                     order: Sequence[int] = (), lse=None, out_dtype=None):
    """q [B,Hq,D] against caches [B,S,Hk,D], row ``b`` attending to its first
    ``lens[b]`` keys (clamped to [0, S]; length 0 gives zeros).  ``order``
    permutes the execution of the atoms; the result does not depend on it.
    ``lse`` (float32 [B,Hq]), if given, receives each query row's lse
    (length 0: ``-inf``); ``out_dtype`` is q's dtype (default) or
    float32."""
    B, _, _ = q.shape
    Hk = k_cache.shape[2]
    lens = lens.to(torch.int32)
    out_dtype = out_dtype or q.dtype
    if q.device.type == "meta" and cost.counting():
        o = torch.empty(q.shape, dtype=out_dtype, device="meta")
        _check(q, k_cache, v_cache, lens, o, lse)
        cost.charge_decode(q, k_cache, v_cache, o, lse)
        return o
    o = torch.zeros(q.shape, dtype=out_dtype, device=q.device)
    for start, ln in schedule(B * Hk, n_atoms, order):
        decode_attention_atom(q, k_cache, v_cache, lens, o, start=start,
                              num_rows=ln, lse=lse)
    return o
