"""The atomizable matmul: ``a @ b`` as a schedule of atoms.

A [M,K], B [K,N] -> C [M,N].  The output tiles ``(block_m, block_n)`` are
flattened row-major (tile ``t`` is tile row ``t // nn``, tile column
``t % nn``); ``n_atoms`` splits them into contiguous ranges, each executed by
one launch that writes in place into the running output.  Ragged M, N, K are
masked, never padded.  ``block_k`` orders the reference's sum and leaves the
tile space as it is: the CUDA kernel picks its own K step.

For a CUDA tensor an atom launches the hand-written kernel
(``csrc/atom_matmul.cu``, which takes block sizes that are multiples of 128)
or raises.  The plain PyTorch version is taken only for tensors that lie on
the CPU.  The kernel covers an atom tile with CTA tiles of the shape
``cta_shape`` gives and walks them in the order ``cta_tiles`` gives; both
mirror the C side, which reports its CTA shape at load.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.atom_matmul.ref import matmul_atom_ref
from repro_torch.kernels.atoms import schedule, tile_count

launches = 0                      # kernel launches made by this module
BLOCK_MULTIPLE = 128              # block_m, block_n the kernel takes
_lib = None


def cta_shape(dtype: torch.dtype, block_n: int, vec16: bool) -> tuple[int, int]:
    """The kernel's CTA tile (rows, columns) for operands of ``dtype`` whose
    rows are (``vec16``) or are not whole 16-byte chunks: bf16 rows that TMA
    can address take the wgmma kernel, 128 x 256 where ``block_n`` is a
    multiple of 256, else 128 x 128; every other path 128 x 128."""
    if dtype == torch.bfloat16 and vec16 and block_n % 256 == 0:
        return 128, 256
    return 128, 128


def cta_tiles(M: int, N: int, block_m: int, block_n: int, start: int,
              num_tiles: int, cta_m: int, cta_n: int) -> list[tuple[int, int]]:
    """Origins (row, column) of the CTA tiles an atom runs, in the kernel's
    order: atom tiles ``start .. start+num_tiles-1`` row-major, each cut into
    ``(block_m // cta_m) x (block_n // cta_n)`` CTA tiles row-major, those
    wholly outside C left out.  The persistent kernel's CTA ``x`` runs the
    ``x``-th, ``x + grid``-th, ... of them."""
    nn = -(-N // block_n)
    sub_n = block_n // cta_n
    sub = (block_m // cta_m) * sub_n
    out = []
    for c in range(num_tiles * sub):
        t, s = start + c // sub, c % sub
        row = (t // nn) * block_m + (s // sub_n) * cta_m
        col = (t % nn) * block_n + (s % sub_n) * cta_n
        if row < M and col < N:
            out.append((row, col))
    return out


def _library():
    global _lib
    if _lib is None:
        lib = build.load("atom_matmul")
        lib.atom_matmul_cta_shape.restype = ctypes.c_int
        lib.atom_matmul_cta_shape.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        for dtype in (torch.float32, torch.bfloat16):
            for block_n in (128, 256, 384, 512):
                for vec16 in (False, True):
                    m, n = ctypes.c_int(), ctypes.c_int()
                    err = lib.atom_matmul_cta_shape(
                        build.DTYPE_CODES[str(dtype)], block_n, int(vec16),
                        ctypes.byref(m), ctypes.byref(n))
                    if err or (m.value, n.value) != cta_shape(dtype, block_n,
                                                              vec16):
                        raise RuntimeError(
                            "csrc/atom_matmul.cu and ops.cta_shape disagree "
                            f"on the CTA tile ({dtype}, block_n={block_n}, "
                            f"vec16={vec16})")
        lib.atom_matmul_ctas_per_sm.restype = ctypes.c_int
        lib.atom_matmul_ctas_per_sm.argtypes = [ctypes.c_int] * 2
        fn = lib.atom_matmul_atom
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(a, b, c, block_m, block_n, block_k):
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)} must be 2-D")
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"share K")
    if c.shape != (M, b.shape[1]):
        raise ValueError(f"c {tuple(c.shape)} is not [{M}, {b.shape[1]}]")
    if not (a.dtype == b.dtype == c.dtype):
        raise TypeError("a, b and c must share one dtype")
    if not (a.device == b.device == c.device):
        raise ValueError("all tensors must lie on one device")
    for name, v in (("block_m", block_m), ("block_n", block_n),
                    ("block_k", block_k)):
        if not (isinstance(v, int) and v > 0):
            raise ValueError(f"{name}={v!r} must be a positive int")


def _check_cuda(a, b, c, block_m, block_n) -> tuple[int, bool]:
    if block_m % BLOCK_MULTIPLE or block_n % BLOCK_MULTIPLE:
        raise ValueError(f"atom matmul kernel takes block_m, block_n that "
                         f"are multiples of {BLOCK_MULTIPLE}, not "
                         f"({block_m}, {block_n})")
    code = build.check_matmul_operand("atom matmul", "a", a)[0]
    return code, vec16(a, b, c)


def vec16(a, b, c) -> bool:
    """Whether the rows of every operand are whole 16-byte chunks (width,
    row pitch and base address): the routing decision, made before the
    launch.  Then bf16 takes the wgmma kernel fed by TMA (which needs just
    that), f32 the split-TF32 kernel on the tensor cores (16-byte
    ``cp.async`` loads); otherwise both take guarded element loads (f32 on
    the CUDA cores).  Raises for an operand the kernel does not take."""
    return all(build.check_matmul_operand("atom matmul", name, t)[1]
               for name, t in (("a", a), ("b", b), ("c", c)))


def ctas_per_sm(dtype: torch.dtype, block_n: int = 256) -> int:
    """CTAs of the kernel's path for ``dtype`` and ``block_n`` on operands
    whose rows are whole 16-byte chunks that one SM of the current GPU holds
    at once (the CUDA occupancy calculator; 1 for the bf16 wgmma kernel,
    whose ring of stages takes most of the SM's shared memory)."""
    n = _library().atom_matmul_ctas_per_sm(build.DTYPE_CODES[str(dtype)],
                                           block_n)
    if n <= 0:
        raise RuntimeError(f"atom_matmul occupancy query failed ({n})")
    return n


def matmul_atom(a, b, c, *, start: int, num_tiles: int, block_m: int = 256,
                block_n: int = 256, block_k: int = 256):
    """One atom: output tiles ``[start, start+num_tiles)`` of ``a @ b``,
    written in place into the running output ``c`` [M,N]; every other tile
    is left as it is.  Returns ``c``."""
    global launches
    _check(a, b, c, block_m, block_n, block_k)
    M, K = a.shape
    N = b.shape[1]
    total = tile_count(M, N, block_m, block_n)
    if not (0 <= start and 0 <= num_tiles and start + num_tiles <= total):
        raise ValueError(f"atom [{start}, {start}+{num_tiles}) outside "
                         f"[0, {total})")
    if a.device.type == "cpu":
        return matmul_atom_ref(a, b, c, start=start, num_tiles=num_tiles,
                               block_m=block_m, block_n=block_n)
    if a.device.type != "cuda":
        raise RuntimeError(f"atom matmul has a CUDA kernel and a CPU "
                           f"version; no path for device {a.device}")
    dtype_code, vec16 = _check_cuda(a, b, c, block_m, block_n)
    if num_tiles == 0:
        return c
    with torch.cuda.device(a.device):
        err = _library().atom_matmul_atom(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
            a.stride(0), b.stride(0), c.stride(0), start, num_tiles,
            block_m, block_n, dtype_code, int(vec16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_atom launch failed: CUDA error {err} "
                           f"(a {tuple(a.shape)}, b {tuple(b.shape)}, "
                           f"{a.dtype})")
    launches += 1
    return c


def atom_matmul(a, b, *, n_atoms: int = 1, block_m: int = 256,
                block_n: int = 256, block_k: int = 256,
                order: Sequence[int] = ()):
    """``a @ b`` [M,N] computed as ``n_atoms`` independently scheduled atoms.
    ``order`` permutes the execution of the atoms; the result does not depend
    on it."""
    M, N = a.shape[0], b.shape[-1]
    c = torch.zeros((M, N), dtype=a.dtype, device=a.device)
    for start, ln in schedule(tile_count(M, N, block_m, block_n), n_atoms,
                              order):
        matmul_atom(a, b, c, start=start, num_tiles=ln, block_m=block_m,
                    block_n=block_n, block_k=block_k)
    return c
