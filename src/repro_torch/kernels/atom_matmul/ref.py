"""Plain PyTorch version of the atomizable matmul, atom form included.

``matmul_ref`` is the product in f32, cast once.  ``matmul_atom_ref`` computes
the output tiles of one atom one by one, with true-size slices at the ragged
edge, and writes them in place into the running output: the function the CUDA
kernel computes.
"""
from __future__ import annotations

import torch


def matmul_ref(a, b, out_dtype=None):
    """``a @ b`` in f32, cast once to ``out_dtype`` (default: ``a``'s)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def matmul_atom_ref(a, b, c, *, start: int, num_tiles: int, block_m: int,
                    block_n: int):
    """Tiles ``[start, start+num_tiles)`` of the row-major flattened
    ``(block_m, block_n)`` tile space of ``c`` [M,N] (tile ``t`` is tile row
    ``t // nn``, tile column ``t % nn``, ``nn = ceil(N / block_n)``) set to
    those tiles of ``a @ b``; every other element of ``c`` is left as it is.
    Returns ``c``."""
    M, N = c.shape
    nn = -(-N // block_n)
    for t in range(start, start + num_tiles):
        mi, ni = divmod(t, nn)
        r0, c0 = mi * block_m, ni * block_n
        r1, c1 = min(M, r0 + block_m), min(N, c0 + block_n)
        c[r0:r1, c0:c1] = matmul_ref(a[r0:r1], b[:, c0:c1], c.dtype)
    return c
