"""The float32 backward's split-TF32 products, emulated on the CPU.

The card's float32 backward (``csrc/flash_attention_bwd.cu``,
``bwd_tf32_kernel``) takes every product on the tensor cores in split TF32
(``ref.tf32_split_product``).  Here the whole backward is recomputed with
every product split, on numpy inputs made from a seed, and held to the limit
the card's f32 path is held to (1e-5 of a gradient's largest |value|, the
smoke's ``BWD_F32_TOL``) against the plain f32 backward: at a toy shape like
the smoke's, causal with a window, MQA, and a row whose gradient cancels
(the first query row sees one key, so dP equals delta).  One TF32 product
(about 11 bits) must read above that limit, so the test tells a right split
from a wrong one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref

LIMIT = 1e-5        # chip_smoke.BWD_F32_TOL

# (B, S, Hq, Hk, D, window): MQA with a window, GQA at head_dim 256
CASES = [(1, 150, 4, 1, 128, 70), (1, 100, 4, 2, 256, 40),
         (2, 90, 2, 2, 64, 0)]


def _tf32_product(a, b):
    return flash_ref.tf32_round(a) @ flash_ref.tf32_round(b)


def _backward(q, k, v, do, lse, delta, window, product):
    """dQ, dK, dV of causal attention with every one of the five products
    (S, dP, dV, dK, dQ) taken by ``product``."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    scale = D ** -0.5
    pos = torch.arange(S)
    mask = flash_ref._visible(pos, pos, causal=True, window=window)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for h in range(Hq):
            kk, vv = k[b, :, h // G], v[b, :, h // G]
            s = product(q[b, :, h], kk.T) * scale
            p = torch.where(mask, torch.exp(s - lse[b, h, :, None]),
                            torch.zeros_like(s))
            dp = product(do[b, :, h], vv.T)
            ds = p * (dp - delta[b, h, :, None])
            dq[b, :, h] = product(ds, kk) * scale
            dk[b, :, h // G] += product(ds.T, q[b, :, h]) * scale
            dv[b, :, h // G] += product(p.T, do[b, :, h])
    return dq, dk, dv


def _inputs(case):
    B, S, Hq, Hk, D, window = case
    rng = np.random.default_rng(S + D)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, Hq, D))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hk, D))
                             .astype(np.float32)) for _ in range(2))
    o, lse = flash_ops.flash_attention(q, k, v, window=window,
                                       return_lse=True)
    return q, k, v, do, lse, flash_ref.attention_delta_ref(o, do), window


def _errors(got, want):
    return [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_tf32_backward_holds_the_f32_limit(case):
    q, k, v, do, lse, delta, window = _inputs(case)
    plain = _backward(q, k, v, do, lse, delta, window, torch.matmul)
    # the plain backward is the port's own plain atoms, and row 0's dQ
    # cancels (one visible key: dP = delta)
    n = flash_ops.bwd_tile_space(q, k)
    atoms = [torch.zeros_like(t) for t in (q, k, v)]
    flash_ref.flash_attention_bwd_atom_ref(
        q, k, v, do, lse, delta, *atoms, start=0, num_tiles=n, window=window,
        block_q=flash_ops.bwd_blocks(q.dtype, q.shape[-1])[0],
        block_k=flash_ops.bwd_blocks(q.dtype, q.shape[-1])[1])
    assert max(_errors(atoms, plain)) <= 1e-6
    assert plain[0][:, 0].abs().max() <= 1e-5 * plain[0].abs().max()
    split = _backward(q, k, v, do, lse, delta, window,
                      flash_ref.tf32_split_product)
    assert max(_errors(split, plain)) <= LIMIT


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_tf32_product_reads_above_the_limit(case):
    q, k, v, do, lse, delta, window = _inputs(case)
    plain = _backward(q, k, v, do, lse, delta, window, torch.matmul)
    single = _backward(q, k, v, do, lse, delta, window, _tf32_product)
    assert min(_errors(single, plain)) > LIMIT


def test_tf32_round_is_round_to_nearest_away():
    """Ties go away from zero; the result keeps 10 mantissa bits; the split
    of a value into hi and lo recovers it to about 2^-22."""
    step = 2.0 ** -10
    x = torch.tensor([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2 ** -20,
                      1 + 3 * step / 2, 3.0e-3, -7.25])
    got = flash_ref.tf32_round(x)
    want = torch.tensor([1 + step, -(1 + step), 1.0, 1 + 2 * step,
                         float(flash_ref.tf32_round(torch.tensor([3.0e-3]))),
                         -7.25])
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(6, dtype=torch.int32))
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi = flash_ref.tf32_round(r)
    lo = flash_ref.tf32_round(r - hi)
    assert ((hi - r).abs() <= 2.0 ** -11 * r.abs()).all()
    assert ((hi + lo - r).abs() <= 2.0 ** -21 * r.abs()).all()
