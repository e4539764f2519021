"""Plain PyTorch version of the atomizable matmul, atom form included.

``matmul_ref`` is the product in f32, cast once.  ``matmul_atom_ref`` computes
the output tiles of one atom one by one, with true-size slices at the ragged
edge, and writes them in place into the running output: the function the CUDA
kernel computes.  ``matmul_split_ref`` emulates the f32 kernel's arithmetic
(split TF32, a K step at a time) for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import tf32_split_product


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


def matmul_split_ref(a, b, *, k_step: int = 32):
    """``a @ b`` (f32) as the f32 kernel's split-TF32 route sums it: each K
    step of ``k_step`` products in split TF32 (``tf32_split_product``), the
    steps added to the running sum in K order.  A plain emulation for the
    tests; no path calls it."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], k_step):
        out += tf32_split_product(a[:, k0:k0 + k_step].float(),
                                  b[k0:k0 + k_step].float())
    return out
