"""Split TF32: the float32 routes' products on the tensor cores, emulated.

The f32 routes of the atom matmul (``csrc/atom_matmul.cu``) and of flash
attention's forward and backward (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) take every product on the tensor cores in
split TF32: each operand is hi = tf32(x) and lo = x - hi truncated to TF32,
and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 of it,
is dropped).
These are plain emulations of that arithmetic for the tests; no path calls
them.
"""
from __future__ import annotations

import torch


def tf32_round(x):
    """``x`` (f32) rounded to TF32, 10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does for finite values: the f32
    bit pattern plus half a TF32 step, capped (unsigned) at x's sign over
    FLT_MAX's bits, its low 13 bits cleared (the kernels' ``tf32_rna``).
    The cap keeps the largest finite values finite (|x| >= 0x7F7FF000 gives
    +-0x7F7FE000, not an infinity); an infinity stays one, and a NaN may
    come out as 0, an infinity or a NaN, as there."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF                        # as unsigned
    hi = torch.minimum((bits + 0x1000) & 0xFFFFFFFF, bits | 0x7F7FFFFF)
    hi = hi & 0xFFFFE000
    return (hi - ((hi >> 31) << 32)).to(torch.int32).view(torch.float32)


def tf32_lo(x, hi):
    """``x - hi`` truncated to TF32, its low 13 bits cleared (the kernels'
    ``tf32_lo``): a NaN when ``x`` is one, whatever ``hi`` became."""
    bits = (x.float() - hi).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def tf32_split_product(a, b):
    """``a @ b`` as the f32 routes take each product, in split TF32, summed
    in f32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_lo(a, ah), tf32_lo(b, bh)
    return al @ bh + ah @ bl + ah @ bh
