"""The float32 routes' split-TF32 products in the forward, emulated on the CPU.

The card's f32 atom matmul (``csrc/atom_matmul.cu``, ``matmul_tf32_kernel``)
and f32 flash attention forward (``csrc/flash_attention.cu``,
``flash_attn_tf32_kernel``) take every product on the tensor cores in split
TF32 (``kernels/tf32.py``).  Here the same products are recomputed with the
split on numpy inputs made from a seed and held to the limits the card holds
the kernels to against their plain f32 versions: the matmul at the
projections' full K (4096 and 14336) with few rows and columns, a K step of
32 at a time as the kernel sums it, within ``MM_TOL`` (1e-5 of the largest
|output|); the forward (S and P V split) causal with a window, non-causal
with ragged ``Sk`` and GQA at head_dim 64 and 256 within ``chip_smoke``'s
``FLASH_F32_TOL`` (1e-5 of the largest |output|), its lse within
``LSE_TOL``.  One TF32 product (about 11 bits) must read above each limit, so
the tests tell a right split from a wrong one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import tf32
from repro_torch.kernels.atom_matmul import ref as mm_ref
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch.atoms import MM_TOL

FLASH_LIMIT = 1e-5      # chip_smoke.FLASH_F32_TOL
LSE_LIMIT = 1e-4        # chip_smoke.LSE_TOL
K_STEP = 32             # the f32 matmul kernel's K step (BKT)


def _tf32_product(a, b):
    return tf32.tf32_round(a) @ tf32.tf32_round(b)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# ---------------------------------------------------------------------------
# the atom matmul at the projections' K
# ---------------------------------------------------------------------------

def _mm_inputs(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((24, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 40)).astype(np.float32))
    return a, b, mm_ref.matmul_ref(a, b)


@pytest.mark.parametrize("K", [4096, 14336])
def test_split_tf32_matmul_holds_mm_tol(K):
    a, b, plain = _mm_inputs(K)
    split = mm_ref.matmul_split_ref(a, b, k_step=K_STEP)
    assert _rel(split, plain) <= MM_TOL["float32"]


@pytest.mark.parametrize("K", [4096, 14336])
def test_one_tf32_product_misses_mm_tol(K):
    a, b, plain = _mm_inputs(K)
    assert _rel(_tf32_product(a, b), plain) > MM_TOL["float32"]


def test_split_tf32_matmul_sums_k_steps_in_order():
    """The emulation is the split product of each K step, added in K order:
    one step of all K is the plain split product."""
    a, b, _ = _mm_inputs(96)
    assert torch.equal(mm_ref.matmul_split_ref(a, b, k_step=96),
                       torch.zeros(24, 40) + tf32.tf32_split_product(a, b))


# ---------------------------------------------------------------------------
# the flash attention forward
# ---------------------------------------------------------------------------

# (B, Sq, Sk, Hq, Hk, D, causal, window): causal with a window; non-causal
# with Sq != Sk and Sk not a multiple of the kernel's 16-key block; GQA at
# head_dim 64; MQA at 256
FWD_CASES = [(1, 90, 90, 4, 2, 128, True, 40),
             (2, 37, 70, 2, 2, 64, False, 0),
             (1, 50, 50, 6, 2, 64, True, 0),
             (1, 40, 40, 4, 1, 256, True, 0)]


def _forward(q, k, v, causal, window, product):
    """o [B,Sq,Hq,D] and lse [B,Hq,Sq] of attention with both products (S
    and P V) taken by ``product``; P relative to each row's max, as the
    kernel's online softmax keeps it."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    qpos = (Sk - Sq) + torch.arange(Sq)
    mask = flash_ref._visible(qpos, torch.arange(Sk), causal=causal,
                              window=window)
    o = torch.zeros_like(q)
    lse = torch.zeros(B, Hq, Sq)
    for b in range(B):
        for h in range(Hq):
            s = product(q[b, :, h] * D ** -0.5, k[b, :, h // G].T)
            s = s.masked_fill(~mask, float("-inf"))
            m = s.amax(-1, keepdim=True)
            m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            lse[b, h] = torch.where(l == 0, torch.full_like(l, float("inf")),
                                    m + torch.log(l))[:, 0]
            o[b, :, h] = product(p, v[b, :, h // G]) / torch.where(
                l == 0, torch.ones_like(l), l)
    return o, lse


def _fwd_inputs(case):
    B, Sq, Sk, Hq, Hk, D, causal, window = case
    rng = np.random.default_rng(Sq + Sk + D)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hk, D))
                             .astype(np.float32)) for _ in range(2))
    want, want_lse = flash_ref.attention_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    return q, k, v, causal, window, want, want_lse


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_split_tf32_forward_holds_the_f32_limit(case):
    q, k, v, causal, window, want, want_lse = _fwd_inputs(case)
    plain, plain_lse = _forward(q, k, v, causal, window, torch.matmul)
    # the emulation's plain products are the plain version's
    assert _rel(plain, want) <= 1e-6
    got, lse = _forward(q, k, v, causal, window, tf32.tf32_split_product)
    assert _rel(got, want) <= FLASH_LIMIT
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isinf(lse), ~fin)
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= LSE_LIMIT


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_one_tf32_product_misses_the_f32_limit(case):
    q, k, v, causal, window, want, _ = _fwd_inputs(case)
    got, _ = _forward(q, k, v, causal, window, _tf32_product)
    assert _rel(got, want) > FLASH_LIMIT


def test_flash_ref_keeps_the_split_names():
    """The backward's tests import the emulation from flash attention's
    ref, where it lived before both kernels' refs shared it."""
    assert flash_ref.tf32_round is tf32.tf32_round
    assert flash_ref.tf32_split_product is tf32.tf32_split_product


def test_split_keeps_nan_in_the_low_part():
    """The rounding may turn a NaN into 0 or an infinity (-1 and
    0x7F800FFF here) or leave it a NaN (the canonical 0x7FFFFFFF, what
    0 * inf gives on the card).  The low part, x - hi truncated, is NaN
    whatever hi became, so a NaN in an operand reaches its row (or column)
    of the split product, as in the plain product.

    The largest finite values, whose rounding would carry into the exponent
    (every pattern from 0x7F7FE000 to 0x7F7FFFFF, both signs), keep hi and
    lo finite, so a row holding FLT_MAX gives the plain product's finite
    value (ROADMAP C1).  An infinity rounds to itself and its lo is
    inf - inf: its row of the split product is NaN where the plain product
    is an infinity, the deliberate difference ROADMAP names ("an infinite
    operand of a split-TF32 route gives NaN where the plain f32 product
    gives +-inf")."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800FFF, 0x7FC00000, 0x7F800000,
                         -0x800000, 0x7F7FFFFF], dtype=torch.int32)
    x = bits.view(torch.float32)
    hi = tf32.tf32_round(x)
    assert torch.isnan(hi[0]) and hi[1] == 0
    assert hi[2] == float("inf")
    assert torch.isnan(tf32.tf32_lo(x[:4], hi[:4])).all()
    assert torch.equal(tf32.tf32_lo(x[:4], hi[:4]).view(torch.int32) & 0x1FFF,
                       torch.zeros(4, dtype=torch.int32))
    assert hi[4] == float("inf") and hi[5] == float("-inf")
    assert hi[6].view(torch.int32).item() == 0x7F7FE000
    for nan in x[:4]:
        a = torch.ones(3, 8)
        a[1, 2] = nan
        out = tf32.tf32_split_product(a, torch.ones(8, 4))
        assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()
        out = tf32.tf32_split_product(torch.ones(4, 8), a.T)
        assert torch.isnan(out[:, 1]).all()
        assert torch.isfinite(out[:, [0, 2]]).all()

    top = torch.arange(0x7F7FE000, 0x7F800000, dtype=torch.int32)
    big = torch.cat([top.view(torch.float32), -top.view(torch.float32)])
    hi = tf32.tf32_round(big)
    lo = tf32.tf32_lo(big, hi)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert torch.equal(hi.abs().view(torch.int32),
                       torch.cat([top & -0x2000] * 2).clamp(max=0x7F7FE000))
    # below the cap the rounding is the bare sum's, bit for bit
    low = torch.arange(0x7F7F0000, 0x7F7FF000, dtype=torch.int32)
    assert torch.equal(tf32.tf32_round(low.view(torch.float32))
                       .view(torch.int32), (low + 0x1000) & -0x2000)

    fmax = torch.finfo(torch.float32).max
    for v, finite in ((fmax, True), (-fmax, True), (float("inf"), False),
                      (float("-inf"), False)):
        a = torch.ones(3, 8)
        a[1, 2] = v
        b = torch.full((8, 4), 1e-30)
        want, got = a @ b, tf32.tf32_split_product(a, b)
        if finite:
            assert torch.isfinite(want).all()
            assert ((got - want).abs() / want.abs()).max().item() <= 1e-6
        else:                       # the deliberate difference
            assert torch.isinf(want[1]).all() and torch.isnan(got[1]).all()
            assert torch.equal(got[[0, 2]], want[[0, 2]])
