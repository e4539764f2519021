"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip (the
decision is made inside a fixture, never at import).  Run them on the GPU
machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the serving path's shapes;
this file adds seeded random shapes and the model path end to end.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.atom_matmul import ops as matmul_ops
from repro_torch.kernels.atom_matmul.ref import matmul_atom_ref, matmul_ref
from repro_torch.kernels.atoms import schedule, tile_count
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.decode_compare import dropped_split_err, headline_limit
from repro_torch.kernels.flash_attention.ref import (
    attention_delta_ref, attention_ref)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_atom_ref as flash_bwd_atom_ref)
from repro_torch.models import transformer
from repro_torch.models.common import tree_map
from repro_torch.models.registry import init_model

pytestmark = pytest.mark.gpu

# float32: same f32 math, other summation order.  bfloat16: one rounding of an
# O(1) result to bf16 on each side (and of P inside the flash kernel).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# atom matmul, as max abs error over the largest |output| (``launch/atoms.py``
# states why): f32 products in split TF32 (each operand's split ~2^-22 of
# it) summed in short chains, against exact f32 products; bf16 one rounding
# of each side.
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# decode attention on the split-KV kernels, against the plain and the split
# plain versions: float32 ``chip_smoke.TOL[("decode", "float32")]`` (f32
# throughout, other summation orders), bfloat16 as TOL
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(6))
def test_decode_kernel_random_shapes(cuda, seed, dtype):
    rng = np.random.default_rng(seed)
    B, Hk = int(rng.integers(1, 6)), int(rng.integers(1, 5))
    G, D = int(rng.choice([1, 2, 3, 4, 12])), int(rng.choice([64, 128]))
    S = int(rng.integers(1, 700))
    q = _randn(rng, (B, Hk * G, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    lens = torch.from_numpy(rng.integers(0, S + 1, B).astype(np.int32)).to(cuda)
    before = decode_ops.launches
    n_atoms = int(rng.integers(1, 5))
    got = decode_ops.decode_attention(q, kc, vc, lens, n_atoms=n_atoms)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + min(n_atoms, B * Hk)
    p = decode_ops.plan(q, kc, vc)
    assert p["route"] == ("split_f32" if dtype == torch.float32 else "split")
    for want in (decode_attention_ref(q, kc, vc, lens),
                 decode_attention_split_ref(q, kc, vc, lens, p["nsplit"],
                                            p["chunk"])):
        assert (got.float() - want.float()).abs().max().item() \
            <= DECODE_TOL[dtype]
    assert torch.equal(got, decode_ops.decode_attention(q, kc, vc, lens))


# S ranges whose 64-key blocks cap the split count at 1, 2, 4 and 8
SPLIT_S = {1: (1, 64), 2: (65, 192), 4: (193, 448), 8: (449, 2100)}


def _boundary_lens(rng, B, S, chunk):
    """Lengths on and around the split boundaries, 0 and S among them."""
    pool = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, S - 1, S,
            int(rng.integers(0, S + 1))]
    return [min(max(int(x), 0), S) for x in rng.choice(pool, B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_decode_split_kernel_random_shapes(cuda, nsplit, D, dtype):
    """The split-KV kernels (bf16, and f32 on the CUDA cores) at every split
    count, lens on the split boundaries: values against the plain version
    and the split plain version, atoms at n = 1, 3, R in permuted order
    bit-equal, and an atom on a sentinel writes only its rows.  G = 12 and
    20 take passes of heads on both (16 a pass in bf16, 8 in f32)."""
    rng = np.random.default_rng(300 + 10 * nsplit + D)
    B, Hk = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    G = int(rng.choice([1, 4, 12, 20]))
    S = int(rng.integers(*SPLIT_S[nsplit]))
    q = _randn(rng, (B, Hk * G, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    p = decode_ops.plan(q, kc, vc)
    assert p["route"] == ("split_f32" if dtype == torch.float32 else "split")
    assert p["nsplit"] == nsplit
    lens = torch.tensor(_boundary_lens(rng, B, S, p["chunk"]),
                        dtype=torch.int32, device=cuda)
    got = decode_ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    for want in (decode_attention_ref(q, kc, vc, lens),
                 decode_attention_split_ref(q, kc, vc, lens, nsplit,
                                            p["chunk"])):
        assert (got.float() - want.float()).abs().max().item() \
            <= DECODE_TOL[dtype]
    assert bool((got[lens == 0] == 0).all())
    R = B * Hk
    for n in (3, R):
        order = tuple(int(i) for i in rng.permutation(min(n, R)))
        assert torch.equal(got, decode_ops.decode_attention(
            q, kc, vc, lens, n_atoms=n, order=order))
    start, num = R // 3, max(1, R // 3)
    o = torch.full_like(q, 7.0)
    decode_ops.decode_attention_atom(q, kc, vc, lens, o, start=start,
                                     num_rows=num)
    og, gg = o.view(R, G, D), got.view(R, G, D)
    assert torch.equal(og[start:start + num], gg[start:start + num])
    assert bool((og[:start] == 7.0).all()) and bool(
        (og[start + num:] == 7.0).all())


# the lse against the plain version's: f32 sums of exp in another order
LSE_TOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_decode_split_kernel_lse(cuda, nsplit, D, dtype):
    """K1's lse on both routes at every split count, lens on the split
    boundaries and 0: against the plain version's (``-inf`` where a row is
    empty); the output with the lse bit-equal to the output without it; a
    bf16 call's f32 output rounds to its bf16 output bit for bit; atoms
    write their rows' lse in place and compose bit-equal in any order."""
    rng = np.random.default_rng(700 + 10 * nsplit + D)
    B, Hk = int(rng.integers(2, 5)), int(rng.integers(1, 5))
    G = int(rng.choice([1, 4, 12, 20]))
    S = int(rng.integers(*SPLIT_S[nsplit]))
    q = _randn(rng, (B, Hk * G, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    p = decode_ops.plan(q, kc, vc)
    assert p["nsplit"] == nsplit
    lens = _boundary_lens(rng, B, S, p["chunk"])
    lens[0] = 0
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    lse = torch.full((B, Hk * G), 7.0, device=cuda)
    got = decode_ops.decode_attention(q, kc, vc, lens, lse=lse)
    wide = decode_ops.decode_attention(q, kc, vc, lens,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    want, want_lse = decode_attention_ref(q, kc, vc, lens, return_lse=True)
    assert (got.float() - want.float()).abs().max().item() \
        <= DECODE_TOL[dtype]
    empty = lens == 0
    assert bool(torch.isneginf(lse[empty]).all())
    assert (lse[~empty] - want_lse[~empty]).abs().max().item() <= LSE_TOL
    assert torch.equal(got, decode_ops.decode_attention(q, kc, vc, lens))
    assert wide.dtype == torch.float32 and torch.equal(wide.to(dtype), got)
    R = B * Hk
    order = tuple(int(i) for i in rng.permutation(min(3, R)))
    lse3 = torch.full_like(lse, 7.0)
    assert torch.equal(got, decode_ops.decode_attention(
        q, kc, vc, lens, n_atoms=3, order=order, lse=lse3))
    assert torch.equal(lse3, lse)
    start, num = R // 3, max(1, R // 3)
    o, one = torch.zeros_like(q), torch.full_like(lse, 7.0)
    decode_ops.decode_attention_atom(q, kc, vc, lens, o, start=start,
                                     num_rows=num, lse=one)
    inside = torch.zeros(R, dtype=torch.bool, device=cuda)
    inside[start:start + num] = True
    lg, og = one.view(R, G), lse.view(R, G)
    assert torch.equal(lg[inside], og[inside])
    assert bool((lg[~inside] == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", [2, 4, 16])
def test_decode_merge_partials_of_kernel_partials(cuda, n_shards, dtype):
    """The serving headline's shape cut into sequence shards: each shard's
    partial by K1 (f32 output and lse, lengths clamped to the shard), their
    ``merge_partials`` against one K1 call over the whole cache."""
    from repro_torch.kernels.decode_attention.merge import merge_partials
    rng = np.random.default_rng(40 + n_shards)
    B, Hq, Hk, D, S = 4, 32, 8, 128, 2048
    q = _randn(rng, (B, Hq, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    lens = torch.tensor([0, 1, S // n_shards, 1500], dtype=torch.int32,
                        device=cuda)
    whole_lse = torch.empty(B, Hq, device=cuda)
    whole = decode_ops.decode_attention(q, kc, vc, lens, lse=whole_lse)
    n = S // n_shards
    parts, lses = [], []
    for r in range(n_shards):
        lse = torch.empty(B, Hq, device=cuda)
        parts.append(decode_ops.decode_attention(
            q, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n],
            (lens - r * n).clamp(0, n), lse=lse, out_dtype=torch.float32))
        lses.append(lse)
    o, lse = merge_partials(torch.stack(parts), torch.stack(lses),
                            out_dtype=dtype)
    torch.cuda.synchronize()
    assert (o.float() - whole.float()).abs().max().item() \
        <= DECODE_TOL[dtype]
    assert bool((o[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())
    assert (lse[1:] - whole_lse[1:]).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_one_slot_long_context(cuda, dtype):
    """One slot of llama3-8b at its 8192-token context: 8 rows, 8 splits."""
    rng = np.random.default_rng(9)
    q = _randn(rng, (1, 32, 128), dtype, cuda)
    kc = _randn(rng, (1, 8192, 8, 128), dtype, cuda)
    vc = _randn(rng, (1, 8192, 8, 128), dtype, cuda)
    assert decode_ops.plan(q, kc, vc)["nsplit"] == 8
    lens = torch.tensor([8000], dtype=torch.int32, device=cuda)
    got = decode_ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, kc, vc, lens)
    # outputs here are ~0.07 at most: bf16 is held to two bf16 steps of the
    # largest, f32 to its 2e-5, each below what a kernel that dropped one of
    # the 8 splits would read
    limit = (headline_limit(want) if dtype == torch.bfloat16
             else DECODE_TOL[dtype])
    assert (got.float() - want.float()).abs().max().item() <= limit
    assert dropped_split_err(q, kc, vc, lens, 1024) > limit
    assert torch.equal(got, decode_ops.decode_attention(
        q, kc, vc, lens, n_atoms=8, order=(7, 0, 6, 1, 5, 2, 4, 3)))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_refuses_unaligned_pitch(cuda, D):
    """Caches whose key pitch is not a multiple of 16 bytes, which neither
    TMA nor 16-byte loads address, raise before any launch."""
    rng = np.random.default_rng(D)
    B, S, Hk, G = 3, 333, 2, 4
    wide = _randn(rng, (B, S, Hk * D + 3), torch.bfloat16, cuda)
    kc = wide[:, :, 1:1 + Hk * D].unflatten(-1, (Hk, D))
    q = _randn(rng, (B, Hk * G, D), torch.bfloat16, cuda)
    lens = torch.tensor([333, 0, 65], dtype=torch.int32, device=cuda)
    before = decode_ops.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        decode_ops.decode_attention(q, kc, kc, lens)
    assert decode_ops.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_decode_split_kernel_clusters_fit(cuda, D, nsplit, dtype):
    """The card runs clusters of every split count of each dtype's kernel
    (at most two CTAs an SM), and the schedule puts every row's cluster in
    flight at once."""
    n = decode_ops.max_active_clusters(D, nsplit, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 < n and n * nsplit <= 2 * sms
    fit = decode_ops.cluster_fit(cuda, D, dtype)
    assert fit[decode_ops.SPLITS.index(nsplit)] == n
    for B, Hk, S in ((4, 8, 2048), (1, 8, 8192), (8, 8, 2048)):
        q = torch.zeros(B, 4 * Hk, D, dtype=dtype, device=cuda)
        kc = torch.zeros(B, S, Hk, D, dtype=dtype, device=cuda)
        p = decode_ops.plan(q, kc, kc)
        assert p["nsplit"] == 1 or \
            fit[decode_ops.SPLITS.index(p["nsplit"])] >= B * Hk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [[2048, 2048], [2048, 1], [700, 2047]])
def test_decode_kernel_head_dim_256_mqa_ring(cuda, dtype, lens):
    """RecurrentGemma's decode: 16 query heads on one KV head (G = 16 fills a
    pass), head_dim 256, a ring-buffer cache of 2048 slots whose valid
    length is min(pos + 1, window): values, atoms bit-equal, the split."""
    rng = np.random.default_rng(256 + lens[1])
    B, Hq, Hk, D, S = 2, 16, 1, 256, 2048
    q = _randn(rng, (B, Hq, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = decode_ops.decode_attention(q, kc, vc, lens_t)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, kc, vc, lens_t)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    p = decode_ops.plan(q, kc, vc)
    assert p["nsplit"] > 1
    split = decode_attention_split_ref(q, kc, vc, lens_t, p["nsplit"],
                                       p["chunk"])
    assert (got.float() - split.float()).abs().max().item() \
        <= DECODE_TOL[dtype]
    assert torch.equal(got, decode_ops.decode_attention(
        q, kc, vc, lens_t, n_atoms=2, order=(1, 0)))


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,window", [(300, 300, 64), (300, 300, 100),
                                          (77, 333, 50), (200, 200, 1),
                                          (130, 130, 500)])
def test_flash_kernel_sliding_window(cuda, D, dtype, Sq, Sk, window):
    """The window argument at every head dim: values against the plain
    version, atoms in permuted order bit-equal, an atom writes only its
    tiles, and window 0 is the causal kernel bit for bit."""
    rng = np.random.default_rng(D + Sq + Sk + window)
    B, Hq, Hk = 2, 4, 1
    q = _randn(rng, (B, Sq, Hq, D), dtype, cuda)
    k = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    v = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    got = flash_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, window=window)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if dtype == torch.bfloat16:     # and row by row: 2^-6 of its max|output|
        err = (got.float() - want.float()).abs().amax(dim=(2, 3))
        assert bool((err <= 2.0 ** -6
                     * want.float().abs().amax(dim=(2, 3))).all())
    if window < Sk:
        full = attention_ref(q, k, v)
        assert (full.float() - want.float()).abs().max().item() > TOL[dtype]
    assert torch.equal(got, flash_ops.flash_attention(
        q, k, v, window=window, n_atoms=3, order=(2, 0, 1)))
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=0),
                       flash_ops.flash_attention(q, k, v))
    total = flash_ops.tile_space(q)
    o = torch.full_like(q, 7.0)
    flash_ops.flash_attention_atom(q, k, v, o, start=total // 3,
                                   num_tiles=total // 3, window=window)
    nqb = -(-Sq // flash_ops.BLOCK_Q)
    tile = (torch.arange(B * Hq, device=cuda)[:, None] * nqb
            + torch.arange(Sq, device=cuda)[None, :] // flash_ops.BLOCK_Q)
    inside = ((tile >= total // 3) & (tile < 2 * (total // 3))).view(
        B, Hq, Sq).permute(0, 2, 1)
    assert torch.equal(o[inside], got[inside])
    assert bool((o[~inside] == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (77, 333), (130, 70)])
def test_flash_kernel_head_dim_256(cuda, dtype, causal, Sq, Sk):
    """head_dim 256 (RecurrentGemma), MQA, causal or not, chunked prefill
    and Sq > Sk: values, atoms bit-equal; one CTA an SM on the bf16 path."""
    rng = np.random.default_rng(256 + Sq + Sk + causal)
    B, Hq, Hk, D = 2, 4, 1, 256
    q = _randn(rng, (B, Sq, Hq, D), dtype, cuda)
    k = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    v = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, flash_ops.flash_attention(
        q, k, v, causal=causal, n_atoms=3, order=(1, 2, 0)))
    assert flash_ops.ctas_per_sm(256, torch.bfloat16) == 1
    assert flash_ops.ctas_per_sm(256, torch.float32) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(6))
def test_flash_kernel_random_shapes(cuda, seed, dtype):
    rng = np.random.default_rng(100 + seed)
    B, Hk = int(rng.integers(1, 3)), int(rng.integers(1, 4))
    G, D = int(rng.choice([1, 2, 4])), int(rng.choice([64, 128]))
    Sk = int(rng.integers(1, 400))
    Sq = int(rng.integers(1, Sk + 1)) if seed % 2 else Sk
    causal = bool(seed % 3)
    q = _randn(rng, (B, Sq, Hk * G, D), dtype, cuda)
    k = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    v = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal,
                                    n_atoms=int(rng.integers(1, 5)))
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(6))
def test_matmul_kernel_random_shapes(cuda, seed, dtype):
    """Ragged shapes, block sizes 128 / 256, column-range views of wider
    operands, atoms in a random order: values against the plain version,
    bit equality with one atom, one atom on a sentinel against the plain
    atom."""
    rng = np.random.default_rng(200 + seed)
    M, N, K = (int(x) for x in rng.integers(1, 700, 3))
    bm, bn = (int(x) for x in rng.choice([128, 256], 2))
    pad = int(rng.choice([0, 3, 8])) if seed % 2 else 0
    a = _randn(rng, (M, K + pad), dtype, cuda)[:, pad:]
    b = _randn(rng, (K, N + pad), dtype, cuda)[:, :N]
    total = tile_count(M, N, bm, bn)
    ranges = schedule(total, int(rng.integers(1, 6)))
    order = tuple(int(i) for i in rng.permutation(len(ranges)))
    before = matmul_ops.launches
    got = matmul_ops.atom_matmul(a, b, n_atoms=len(ranges), block_m=bm,
                                 block_n=bn, order=order)
    torch.cuda.synchronize()
    assert matmul_ops.launches == before + len(ranges)
    want = matmul_ref(a, b)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() \
        <= MM_TOL[dtype] * scale
    assert torch.equal(got, matmul_ops.atom_matmul(a, b, block_m=bm,
                                                   block_n=bn))
    start, num = ranges[len(ranges) // 2]
    o = torch.full_like(got, 7.0)
    r = torch.full_like(got, 7.0)
    matmul_ops.matmul_atom(a, b, o, start=start, num_tiles=num, block_m=bm,
                           block_n=bn)
    matmul_atom_ref(a, b, r, start=start, num_tiles=num, block_m=bm,
                    block_n=bn)
    assert torch.equal(o == 7.0, r == 7.0)
    assert (o.float() - r.float()).abs().max().item() <= MM_TOL[dtype] * scale


@pytest.mark.parametrize("M,N,K,bm,bn,strided,wgmma", [
    (1000, 1000, 200, 256, 256, False, True),    # 128 x 256 CTA tiles
    (1000, 1000, 200, 128, 128, False, True),    # 128 x 128 CTA tiles
    (300, 700, 72, 128, 384, False, False),      # N = 700: guarded loads
    (300, 512, 256, 128, 256, True, True),       # column-range views
    (1000, 1024, 65, 256, 256, False, False),    # K = 65: guarded loads
    (4, 4096, 4096, 256, 256, False, True),      # a decode step's rows
])
def test_matmul_kernel_bf16_routes(cuda, M, N, K, bm, bn, strided, wgmma):
    """Each bf16 path, chosen before the launch by the 16-byte-row
    predicate: values against the plain version, atoms in a permuted order
    bit-equal to one atom, one atom on a sentinel changing exactly the
    plain atom's elements."""
    rng = np.random.default_rng(M + N + K)
    pad = 8 if strided else 0
    a = _randn(rng, (M, K + 2 * pad), torch.bfloat16, cuda)[:, pad:pad + K]
    b = _randn(rng, (K, N + pad), torch.bfloat16, cuda)[:, :N]
    c = torch.empty(M, N, dtype=torch.bfloat16, device=cuda)
    assert matmul_ops.vec16(a, b, c) == wgmma
    assert matmul_ops.cta_shape(torch.bfloat16, bn, wgmma) == (
        (128, 256) if wgmma and bn % 256 == 0 else (128, 128))
    want = matmul_ref(a, b)
    scale = want.float().abs().max().item()
    got = matmul_ops.atom_matmul(a, b, block_m=bm, block_n=bn)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() \
        <= MM_TOL[torch.bfloat16] * scale
    ranges = schedule(tile_count(M, N, bm, bn), 3)
    order = tuple(reversed(range(len(ranges))))
    assert torch.equal(got, matmul_ops.atom_matmul(
        a, b, n_atoms=3, block_m=bm, block_n=bn, order=order))
    start, num = ranges[len(ranges) // 2]
    o = torch.full_like(got, 7.0)
    r = torch.full_like(got, 7.0)
    matmul_ops.matmul_atom(a, b, o, start=start, num_tiles=num, block_m=bm,
                           block_n=bn)
    matmul_atom_ref(a, b, r, start=start, num_tiles=num, block_m=bm,
                    block_n=bn)
    assert torch.equal(o == 7.0, r == 7.0)
    assert torch.equal(o[o != 7.0], got[o != 7.0])


@pytest.mark.parametrize("K", [4096, 14336])
@pytest.mark.parametrize("M,N,bm,bn,strided,split", [
    (300, 520, 256, 256, False, True),     # split TF32, ragged M and N
    (200, 384, 128, 256, True, True),      # column-range views
    (257, 129, 128, 128, False, False),    # N = 129: the guarded f32 kernel
])
def test_matmul_kernel_f32_routes_at_long_k(cuda, K, M, N, bm, bn, strided,
                                            split):
    """float32 at the projections' K (4096 and 14336): split TF32 on the
    tensor cores where every row is whole 16-byte chunks, else the guarded
    CUDA-core kernel; values within MM_TOL of the plain version, atoms in a
    permuted order bit-equal to one atom, one atom on a sentinel changing
    exactly the plain atom's elements."""
    rng = np.random.default_rng(M + N + K)
    pad = 8 if strided else 0
    a = _randn(rng, (M, K + 2 * pad), torch.float32, cuda)[:, pad:pad + K]
    b = _randn(rng, (K, N + pad), torch.float32, cuda)[:, :N]
    c = torch.empty(M, N, dtype=torch.float32, device=cuda)
    assert matmul_ops.vec16(a, b, c) == split
    assert matmul_ops.cta_shape(torch.float32, bn, split) == (128, 128)
    want = matmul_ref(a, b)
    scale = want.abs().max().item()
    got = matmul_ops.atom_matmul(a, b, block_m=bm, block_n=bn)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= MM_TOL[torch.float32] * scale
    ranges = schedule(tile_count(M, N, bm, bn), 3)
    assert torch.equal(got, matmul_ops.atom_matmul(
        a, b, n_atoms=3, block_m=bm, block_n=bn, order=(1, 2, 0)))
    start, num = ranges[1]
    o = torch.full_like(got, 7.0)
    r = torch.full_like(got, 7.0)
    matmul_ops.matmul_atom(a, b, o, start=start, num_tiles=num, block_m=bm,
                           block_n=bn)
    matmul_atom_ref(a, b, r, start=start, num_tiles=num, block_m=bm,
                    block_n=bn)
    assert torch.equal(o == 7.0, r == 7.0)
    assert torch.equal(o[o != 7.0], got[o != 7.0])


# flash attention's float32 forward (split TF32) against its plain version:
# the max abs error over the largest |output| (``chip_smoke.FLASH_F32_TOL``)
# and the lse (``chip_smoke.LSE_TOL``)
FLASH_F32_TOL = 1e-5
LSE_TOL = 1e-4


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (300, 300, True, 100),     # a sliding window
    (77, 333, True, 0),        # chunked prefill (Sq < Sk)
    (90, 250, False, 0),       # non-causal, Sk not a multiple of 16
    (250, 250, True, 0),       # causal self-attention, GQA
])
def test_flash_kernel_f32_split_tf32(cuda, D, Sq, Sk, causal, window):
    """The f32 forward at every head dim: within 1e-5 of the largest
    |output| and the lse within 1e-4 (+inf on the same empty rows), atoms
    in a permuted order bit-equal to one atom, and the lse-free launch
    bit-equal to the one that writes it."""
    rng = np.random.default_rng(D + Sq + Sk + causal + window)
    B, Hq, Hk = 2, 4, 2
    q = _randn(rng, (B, Sq, Hq, D), torch.float32, cuda)
    k = _randn(rng, (B, Sk, Hk, D), torch.float32, cuda)
    v = _randn(rng, (B, Sk, Hk, D), torch.float32, cuda)
    kw = dict(causal=causal, window=window)
    got, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
    assert (got - want).abs().max().item() \
        <= FLASH_F32_TOL * want.abs().max().item()
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isinf(lse), ~fin)
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= LSE_TOL
    assert torch.equal(got, flash_ops.flash_attention(
        q, k, v, n_atoms=3, order=(2, 0, 1), **kw))
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, **kw))


def _device_nan(dev):
    """0 * inf made on the card: its NaN, 0x7fffffff, is the one whose bits
    a bare TF32 rounding (add half a step, clear 13 bits) carries to -0."""
    nan = torch.zeros((), device=dev) * torch.full((), float("inf"),
                                                   device=dev)
    assert nan.view(torch.int32).item() == 0x7FFFFFFF
    return nan


@pytest.mark.parametrize("operand", ["a", "b"])
@pytest.mark.parametrize("N", [384, 129])      # split TF32; guarded kernel
def test_matmul_kernel_f32_passes_nan(cuda, operand, N):
    """A NaN made on the card in an f32 operand gives NaN in the same
    elements as the plain version (its row or column) on both f32 routes;
    the rest stay within MM_TOL."""
    rng = np.random.default_rng(N)
    M, K = 200, 512
    a = _randn(rng, (M, K), torch.float32, cuda)
    b = _randn(rng, (K, N), torch.float32, cuda)
    if operand == "a":
        a[37, 100] = _device_nan(cuda)
    else:
        b[300, 70] = _device_nan(cuda)
    got = matmul_ops.atom_matmul(a, b, block_m=128, block_n=128)
    torch.cuda.synchronize()
    want = matmul_ref(a, b)
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert (got[~nan] - want[~nan]).abs().max().item() \
        <= MM_TOL[torch.float32] * want[~nan].abs().max().item()


def test_matmul_kernel_f32_keeps_flt_max_finite_and_an_inf_row_nan(cuda):
    """Split TF32 at the edge of f32's range (ROADMAP C1): a row of a
    holding FLT_MAX, whose TF32 rounding would carry into the exponent,
    gives the plain product's finite row within MM_TOL; a row holding an
    infinity gives NaN where the plain product is an infinity, the
    deliberate difference ROADMAP names."""
    rng = np.random.default_rng(7)
    M, N, K = 200, 256, 512
    a = _randn(rng, (M, K), torch.float32, cuda)
    b = torch.full((K, N), 1e-30, device=cuda)
    a[37, 100] = torch.finfo(torch.float32).max
    a[38, 100] = -torch.finfo(torch.float32).max
    a[90, 5] = float("inf")
    got = matmul_ops.atom_matmul(a, b, block_m=128, block_n=128)
    torch.cuda.synchronize()
    want = matmul_ref(a, b)
    fin = torch.ones(M, dtype=torch.bool, device=cuda)
    fin[90] = False
    assert torch.isfinite(want[fin]).all() and torch.isfinite(got[fin]).all()
    assert (got[fin] - want[fin]).abs().max().item() \
        <= MM_TOL[torch.float32] * want[fin].abs().max().item()
    assert torch.isinf(want[90]).all() and torch.isnan(got[90]).all()


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_f32_passes_nan(cuda, D):
    """A NaN made on the card in one element of q gives NaN in that query
    row's output and lse, as in the plain version, and nowhere else; the
    rest stay within 1e-5 of the largest |output|."""
    rng = np.random.default_rng(D)
    B, S, Hq, Hk = 1, 200, 4, 2
    q = _randn(rng, (B, S, Hq, D), torch.float32, cuda)
    k = _randn(rng, (B, S, Hk, D), torch.float32, cuda)
    v = _randn(rng, (B, S, Hk, D), torch.float32, cuda)
    q[0, 150, 1, 3] = _device_nan(cuda)
    got, lse = flash_ops.flash_attention(q, k, v, causal=True,
                                         return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = attention_ref(q, k, v, causal=True, return_lse=True)
    nan = torch.isnan(want)
    assert nan[0, 150, 1].all() and nan.sum().item() == D
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.isnan(lse), torch.isnan(want_lse))
    assert (got[~nan] - want[~nan]).abs().max().item() \
        <= FLASH_F32_TOL * want[~nan].abs().max().item()


def test_matmul_wgmma_kernel_holds_one_cta_an_sm(cuda):
    assert matmul_ops.ctas_per_sm(torch.bfloat16, 256) == 1
    assert matmul_ops.ctas_per_sm(torch.bfloat16, 128) >= 1


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (77, 333), (130, 70)])
def test_flash_kernel_bf16_wgmma(cuda, D, causal, Sq, Sk):
    """The bf16 wgmma path at both head dims, causal and not, chunked
    prefill with Sk not a multiple of the 64-key block, and Sq > Sk (rows
    with no visible key give zeros): values, atoms bit-equal, and an atom
    writes only its tiles."""
    rng = np.random.default_rng(D + Sq + Sk + causal)
    B, Hq, Hk = 2, 8, 2
    q = _randn(rng, (B, Sq, Hq, D), torch.bfloat16, cuda)
    k = _randn(rng, (B, Sk, Hk, D), torch.bfloat16, cuda)
    v = _randn(rng, (B, Sk, Hk, D), torch.bfloat16, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() \
        <= TOL[torch.bfloat16]
    assert torch.equal(got, flash_ops.flash_attention(
        q, k, v, causal=causal, n_atoms=3, order=(2, 0, 1)))
    total = flash_ops.tile_space(q)
    o = torch.full_like(q, 7.0)
    flash_ops.flash_attention_atom(q, k, v, o, start=total // 3,
                                   num_tiles=total // 3, causal=causal)
    nqb = -(-Sq // flash_ops.BLOCK_Q)
    tile = (torch.arange(B * Hq, device=cuda)[:, None] * nqb
            + torch.arange(Sq, device=cuda)[None, :] // flash_ops.BLOCK_Q)
    inside = ((tile >= total // 3) & (tile < 2 * (total // 3))).view(
        B, Hq, Sq).permute(0, 2, 1)
    assert torch.equal(o[inside], got[inside])
    assert bool((o[~inside] == 7.0).all())


def test_matmul_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(64, 32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        matmul_ops.atom_matmul(a, a.T, block_m=64)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        matmul_ops.atom_matmul(a.half(), a.T.half())
    with pytest.raises(ValueError, match="last stride 1"):
        matmul_ops.atom_matmul(a, a.T)      # b = a.T is column-major


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)          # head_dim 16
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="block_q"):
        flash_ops.flash_attention(q, q, q, block_q=32)
    with pytest.raises(ValueError, match="stride"):
        # same shape, but the head_dim axis is not the contiguous one
        flash_ops.flash_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_gpu_matches_cpu(cuda, dtype):
    """Prefill and two decode steps with the kernels on the card against the
    same parameters with the plain versions on the CPU (head_dim 64: the
    smallest the kernels take)."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), d_head=64,
                              dtype=dtype)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, 256, (3, 70)))
    tol = 1e-3 if dtype == "float32" else 5e-2
    before = flash_ops.launches, decode_ops.launches
    lc, cc = transformer.prefill(cpu, cfg, toks, max_len=80)
    lg, cg = transformer.prefill(gpu, cfg, toks.to(cuda), max_len=80)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    for step in range(2):
        nxt = torch.from_numpy(rng.integers(2, 256, (3,)))
        pos = torch.tensor([70 + step] * 3)
        lc, _ = transformer.decode_step(cpu, cfg, nxt, pos, cc)
        lg, _ = transformer.decode_step(gpu, cfg, nxt.to(cuda), pos.to(cuda), cg)
        assert (lg.cpu() - lc).abs().max().item() <= tol
    assert flash_ops.launches == before[0] + cfg.n_layers
    assert decode_ops.launches == before[1] + 2 * cfg.n_layers


@pytest.mark.parametrize("arch,dtype", [("qwen2-moe-a2.7b", "float32"),
                                        ("recurrentgemma-9b", "float32"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("xlstm-1.3b", "float32"),
                                        ("xlstm-1.3b", "bfloat16")])
def test_moe_and_hybrid_models_on_gpu_match_cpu(cuda, arch, dtype):
    """The MoE, hybrid and xLSTM decoders with the kernels on the card
    against the plain versions on the CPU: a 70-token prompt (past the
    reduced window of 32: the windowed flash kernel and the ring buffer run,
    recurrentgemma at head_dim 256) and two decode steps; one launch of each
    attention kernel per attention layer.  (MoE only in float32: a bf16
    rounding may flip a top-k choice between the devices.)"""
    d_head = 256 if arch == "recurrentgemma-9b" else 64
    cfg = dataclasses.replace(get_config(arch).reduced(), d_head=d_head,
                              dtype=dtype)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(2, 256, (2, 70)))
    tol = 2e-3 if dtype == "float32" else 5e-2
    n_attn = transformer.attention_layers(cfg)
    before = flash_ops.launches, decode_ops.launches
    lc, cc = transformer.prefill(cpu, cfg, toks, max_len=80)
    lg, cg = transformer.prefill(gpu, cfg, toks.to(cuda), max_len=80)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    for step in range(2):
        nxt = torch.from_numpy(rng.integers(2, 256, (2,)))
        pos = torch.tensor([70 + step] * 2)
        lc, _ = transformer.decode_step(cpu, cfg, nxt, pos, cc)
        lg, _ = transformer.decode_step(gpu, cfg, nxt.to(cuda), pos.to(cuda),
                                        cg)
        assert (lg.cpu() - lc).abs().max().item() <= tol
    assert flash_ops.launches == before[0] + n_attn
    assert decode_ops.launches == before[1] + 2 * n_attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hk,D,S,lens", [
    # llava-next-34b's grouping, G = 7 (bf16: 7 of 16 MMA rows; f32: a
    # pass of 4 heads, then one of 3)
    (4, 56, 8, 128, 2048, [1, 300, 1040, 2048]),
    (2, 14, 2, 128, 500, [0, 499]),
    # whisper-small's cross-attention: MHA (G = 1), head_dim 64, 1500 keys
    # (the last 64-key block partial), every row's length equal
    (4, 12, 12, 64, 1500, [1500] * 4),
    (2, 12, 12, 64, 1500, [1500, 1500]),
])
def test_decode_kernel_model_groupings(cuda, dtype, B, Hq, Hk, D, S, lens):
    """Decode attention at the groupings of the models served since the
    encoder-decoder and VLM slice: values against the plain version, padded
    heads never reach the output, atoms bit-equal in any order; the cross
    K/V as the model holds it, a per-layer view of [L,B,S,H,D]."""
    rng = np.random.default_rng(S + Hq)
    q = _randn(rng, (B, Hq, D), dtype, cuda)
    kv = _randn(rng, (2, 3, B, S, Hk, D), dtype, cuda)
    kc, vc = kv[0, 1], kv[1, 1]                    # layer 1 of 3
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = decode_ops.decode_attention(q, kc, vc, lens_t)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, kc, vc, lens_t)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if dtype == torch.bfloat16:
        p = decode_ops.plan(q, kc, vc)
        assert (got.float() - want.float()).abs().max().item() \
            <= headline_limit(want) < dropped_split_err(q, kc, vc, lens_t,
                                                         p["chunk"])
    assert bool((got[lens_t == 0] == 0).all())
    R = B * Hk
    order = tuple(int(i) for i in rng.permutation(min(3, R)))
    assert torch.equal(got, decode_ops.decode_attention(
        q, kc, vc, lens_t, n_atoms=3, order=order))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,causal", [(1, 1500, 1500, False),
                                            (2, 64, 1500, False),
                                            (2, 64, 64, True)])
def test_flash_kernel_whisper_shapes(cuda, dtype, B, Sq, Sk, causal):
    """Flash attention at whisper-small's shapes (MHA, 12 heads, head_dim
    64): the encoder non-causal over 1500 frames (not a multiple of the
    64-key block), a target's cross-attention (Sq != Sk) and its causal
    self-attention; bf16 row by row within 2^-6 of the row's max|output|."""
    rng = np.random.default_rng(Sq + Sk)
    q = _randn(rng, (B, Sq, 12, 64), dtype, cuda)
    k = _randn(rng, (B, Sk, 12, 64), dtype, cuda)
    v = _randn(rng, (B, Sk, 12, 64), dtype, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= (2e-3 if dtype == torch.float32 else 3e-2)
    if dtype == torch.bfloat16:
        rel = d.amax(dim=(2, 3)) / want.float().abs().amax(dim=(2, 3))
        assert rel.max().item() <= 2.0 ** -6
    assert torch.equal(got, flash_ops.flash_attention(
        q, k, v, causal=causal, n_atoms=3, order=(2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_on_gpu_matches_cpu(cuda, dtype):
    """Reduced whisper-small at head_dim 64 with the kernels on the card
    against the same parameters with the plain versions on the CPU: encode
    over 90 frames, ``serve_prefill``, two decode steps and ``forward``;
    flash attention once per encoder layer, decode attention twice per
    decoder layer a step."""
    from repro_torch.models import encdec
    from repro_torch.models.registry import serve_decode, serve_prefill
    cfg = dataclasses.replace(get_config("whisper-small").reduced(),
                              d_head=64, max_source_positions=90, dtype=dtype)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.standard_normal((2, 90, cfg.d_model)).astype(
        np.float32)).to(getattr(torch, dtype))
    toks = torch.from_numpy(rng.integers(2, 256, (2, 10)))
    tol = 2e-3 if dtype == "float32" else 5e-2
    before = flash_ops.launches, decode_ops.launches
    lc, cc = serve_prefill(cpu, cfg, {"frames": frames, "tokens": toks},
                           max_len=16)
    lg, cg = serve_prefill(gpu, cfg, {"frames": frames.to(cuda),
                                      "tokens": toks.to(cuda)}, max_len=16)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    for step in range(2):
        lc, _ = serve_decode(cpu, cfg, toks[:, 1 + step], 1 + step, cc)
        lg, _ = serve_decode(gpu, cfg, toks[:, 1 + step].to(cuda), 1 + step,
                             cg)
        assert (lg.cpu() - lc).abs().max().item() <= tol
    assert flash_ops.launches == before[0] + cfg.n_encoder_layers
    assert decode_ops.launches == before[1] + 3 * 2 * cfg.n_layers
    hc = encdec.forward(cpu, cfg, frames, toks)
    hg = encdec.forward(gpu, cfg, frames.to(cuda), toks.to(cuda))
    assert (hg.cpu().float() - hc.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llava_on_gpu_matches_cpu(cuda, dtype):
    """Reduced llava-next-34b at head_dim 64 (7 query heads on 1 KV head,
    the published G = 7) on the card against the CPU: a 70-row embedding
    prompt through ``vlm_proj``, a decode step fed one embedding row and
    one fed a token."""
    cfg = dataclasses.replace(get_config("llava-next-34b").reduced(),
                              d_model=448, n_heads=7, n_kv_heads=1, d_head=64,
                              dtype=dtype)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((2, 71, 448)).astype(
        np.float32)).to(getattr(torch, dtype))
    tol = 2e-3 if dtype == "float32" else 5e-2
    before = flash_ops.launches, decode_ops.launches
    lc, cc = transformer.prefill(cpu, cfg, None, input_embeds=emb[:, :70],
                                 max_len=80)
    lg, cg = transformer.prefill(gpu, cfg, None,
                                 input_embeds=emb[:, :70].to(cuda),
                                 max_len=80)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    lc, _ = transformer.decode_step(cpu, cfg, None, 70, cc,
                                    input_embeds=emb[:, 70:])
    lg, _ = transformer.decode_step(gpu, cfg, None, 70, cg,
                                    input_embeds=emb[:, 70:].to(cuda))
    assert (lg.cpu() - lc).abs().max().item() <= tol
    nxt = torch.from_numpy(rng.integers(2, 256, (2,)))
    lc, _ = transformer.decode_step(cpu, cfg, nxt, 71, cc)
    lg, _ = transformer.decode_step(gpu, cfg, nxt.to(cuda), 71, cg)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    assert flash_ops.launches == before[0] + cfg.n_layers
    assert decode_ops.launches == before[1] + 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# flash attention's backward and the training path
# ---------------------------------------------------------------------------

def _bwd_row_err(got, want):
    """Max over rows of a gradient [B,S,H,D] of the row's max abs error over
    its largest |want| (at least 2^-8 of the tensor's largest): the limit's
    reasoning is ``chip_smoke.BWD_REL_TOL``'s."""
    d = (got.float() - want.float()).abs().amax(dim=(2, 3))
    scale = want.float().abs().amax(dim=(2, 3))
    return (d / scale.clamp_min(2.0 ** -8 * scale.max().item())).max().item()


@pytest.mark.parametrize("seed", range(6))
def test_flash_bwd_kernel_random_shapes(cuda, seed):
    """bf16 dQ, dK, dV against the plain version of the backward atoms in
    f32 on the same inputs (the same bf16 output and lse), row by row
    within 2^-5; atoms in a random order bit-equal to one.  (Against
    autograd of the plain forward, a row whose gradient nearly cancels,
    dP close to delta, also reads delta's rounding through the bf16 output:
    ``chip_smoke.py`` holds fixed shapes to that.)"""
    rng = np.random.default_rng(100 + seed)
    D = int(rng.choice([64, 128]))
    Hk = int(rng.choice([1, 2, 4]))
    Hq = Hk * int(rng.choice([1, 2, 4]))
    Sk = int(rng.integers(1, 400))
    Sq = Sk if seed % 3 else int(rng.integers(1, 400))
    causal = bool(seed % 2)
    window = int(rng.integers(1, Sk + 1)) if seed in (1, 4) else 0
    q, do = (_randn(rng, (2, Sq, Hq, D), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_randn(rng, (2, Sk, Hk, D), torch.bfloat16, cuda)
            for _ in range(2))
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    want = [torch.zeros(t.shape, device=cuda) for t in (q, k, v)]
    flash_bwd_atom_ref(q.float(), k.float(), v.float(), do.float(), lse,
                       attention_delta_ref(o, do), *want, start=0,
                       num_tiles=flash_ops.bwd_tile_space(q, k),
                       causal=causal, window=window)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                        window=window)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _bwd_row_err(g, w) <= 2.0 ** -5
    n = flash_ops.bwd_tile_space(q, k)
    order = tuple(int(i) for i in rng.permutation(min(n, 7)))
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                          window=window, n_atoms=len(order),
                                          order=order)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,causal,window", [
    (1, 300, 300, 4, 2, True, 0), (2, 130, 260, 2, 1, False, 0),
    (1, 129, 129, 2, 2, True, 50)])
def test_flash_bwd_kernel_tile_map(cuda, D, B, Sq, Sk, Hq, Hk, causal,
                                   window):
    """The kernel's tiles are ``ops.bwd_tile``'s: an atom of one tile
    writes exactly the rows the map gives it, bit-equal to the whole
    backward."""
    rng = np.random.default_rng(D + Sq)
    q, do = (_randn(rng, (B, Sq, Hq, D), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_randn(rng, (B, Sk, Hk, D), torch.bfloat16, cuda)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    full = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    delta = flash_ops.attention_delta(o, do)
    for t in range(flash_ops.bwd_tile_space(q, k)):
        role, b, h, lo, hi = flash_ops.bwd_tile(t, q, k)
        got = [torch.full_like(x, float("nan")) for x in (q, k, v)]
        flash_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, *got,
                                           start=t, num_tiles=1, **kw)
        want = [torch.zeros(x.shape, dtype=torch.bool, device=cuda)
                for x in got]
        if role == "dq":
            want[0][b, lo:hi, h] = True
        else:
            want[1][b, lo:hi, h] = want[2][b, lo:hi, h] = True
        for g, f, m in zip(got, full, want):
            assert torch.equal(~torch.isnan(g), m)
            assert torch.equal(g[m], f[m])


# the paths beside bf16 at head_dim 64 / 128: bf16 at 256 (wgmma) and f32
# at every head dim (split TF32).  bf16 is held row by row
# (``_bwd_row_err``); f32 against f32 differs only in summation order, ~1e-6
# of a gradient's largest |value|, but a row whose gradient cancels (dP close
# to delta) is ~1e-7 of that and reads the rounding of delta, so f32 is held
# to 1e-5 of the tensor's largest |value| instead
BWD_NEW_PATHS = [(torch.bfloat16, 256), (torch.float32, 64),
                 (torch.float32, 128), (torch.float32, 256)]
BWD_NEW_TOL = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-5}


def _bwd_new_err(got, want):
    if got.dtype == torch.float32:
        return ((got - want).abs().max() / want.abs().max()).item()
    return _bwd_row_err(got, want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype,D", BWD_NEW_PATHS, ids=str)
def test_flash_bwd_new_paths_match_plain_and_compose(cuda, dtype, D, seed):
    """bf16 at head_dim 256 and f32 at 64 / 128 / 256: dQ, dK, dV against
    the plain backward atoms in f32 on the same inputs (the same output and
    lse), within ``BWD_NEW_TOL``; MQA, GQA, a
    window, Sq != Sk, ragged tails; atoms in a random order bit-equal to
    one."""
    rng = np.random.default_rng(200 + seed + D)
    Hk = int(rng.choice([1, 2]))
    Hq = Hk * int(rng.choice([1, 4, 16]))
    Sk = int(rng.integers(1, 300))
    Sq = Sk if seed % 2 == 0 else int(rng.integers(1, 300))
    causal = seed != 3
    window = int(rng.integers(1, Sk + 1)) if seed == 1 else 0
    q, do = (_randn(rng, (2, Sq, Hq, D), dtype, cuda) for _ in range(2))
    k, v = (_randn(rng, (2, Sk, Hk, D), dtype, cuda) for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    want = [torch.zeros(t.shape, device=cuda) for t in (q, k, v)]
    bq, bk = flash_ops.bwd_blocks(dtype, D)
    flash_bwd_atom_ref(q.float(), k.float(), v.float(), do.float(), lse,
                       attention_delta_ref(o, do), *want, start=0,
                       num_tiles=flash_ops.bwd_tile_space(q, k), block_q=bq,
                       block_k=bk, **kw)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _bwd_new_err(g, w) <= BWD_NEW_TOL[dtype]
    n = flash_ops.bwd_tile_space(q, k)
    order = tuple(int(i) for i in rng.permutation(min(n, 7)))
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                          n_atoms=len(order), order=order,
                                          **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_f32_keeps_flt_max_in_k_finite(cuda, D):
    """Split TF32 at the edge of f32's range in attention (ROADMAP C1): K
    holds FLT_MAX in one column that every query zeroes, so the plain
    forward and backward stay finite.  The forward splits K as it lands;
    the backward's dK/dV tiles hold that K resident and take the capped
    rounding for it (a bare one gives NaN through inf * 0): the output,
    dK, dV and dQ's other columns match the plain version within 1e-5 of
    their largest value."""
    rng = np.random.default_rng(D)
    B, S, Hq, Hk, d0 = 1, 200, 4, 2, 5
    q, do = (_randn(rng, (B, S, Hq, D), torch.float32, cuda) for _ in range(2))
    k, v = (_randn(rng, (B, S, Hk, D), torch.float32, cuda) for _ in range(2))
    q[..., d0] = 0.0
    k[0, 37, :, d0] = torch.finfo(torch.float32).max
    o, lse = flash_ops.flash_attention(q, k, v, causal=True, return_lse=True)
    want_o = attention_ref(q, k, v, causal=True)
    assert torch.isfinite(o).all()
    assert _bwd_new_err(o, want_o) <= FLASH_F32_TOL
    want = [torch.zeros(t.shape, device=cuda) for t in (q, k, v)]
    bq, bk = flash_ops.bwd_blocks(torch.float32, D)
    flash_bwd_atom_ref(q, k, v, do, lse, attention_delta_ref(o, do), *want,
                       start=0, num_tiles=flash_ops.bwd_tile_space(q, k),
                       block_q=bq, block_k=bk, causal=True)
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=True)
    torch.cuda.synchronize()
    other = torch.arange(D, device=cuda) != d0
    for g, w in ((dq[..., other], want[0][..., other]), (dk, want[1]),
                 (dv, want[2])):
        assert torch.isfinite(g).all()
        assert _bwd_new_err(g, w) <= BWD_NEW_TOL[torch.float32]


# keys that span each ring many times over (bf16 at 256: dQ tiles stream
# blocks of 32 keys through a ring of 3, dK/dV tiles blocks of 64 queries of
# every head of the group through a ring of 2; f32: blocks of 16 through a
# ring of 2), so the rings wrap and the mbarriers' phases flip many times:
# (dtype, D, B, S, Hq, Hk, window), causal
BWD_LONG = [(torch.bfloat16, 256, 1, 1700, 8, 1, 700),
            (torch.float32, 128, 1, 1100, 2, 2, 0)]


@pytest.mark.parametrize("dtype,D,B,S,Hq,Hk,window", BWD_LONG, ids=str)
def test_flash_bwd_new_paths_long_rings(cuda, dtype, D, B, S, Hq, Hk, window):
    """The new paths over 1100-1700 keys (MQA with a window at head_dim 256,
    f32 causal at 128) against the plain backward atoms in f32 on the same
    inputs, within ``BWD_NEW_TOL``; atoms in a random order bit-equal to
    one."""
    rng = np.random.default_rng(S + D)
    q, do = (_randn(rng, (B, S, Hq, D), dtype, cuda) for _ in range(2))
    k, v = (_randn(rng, (B, S, Hk, D), dtype, cuda) for _ in range(2))
    kw = dict(causal=True, window=window)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    want = [torch.zeros(t.shape, device=cuda) for t in (q, k, v)]
    bq, bk = flash_ops.bwd_blocks(dtype, D)
    n = flash_ops.bwd_tile_space(q, k)
    flash_bwd_atom_ref(q.float(), k.float(), v.float(), do.float(), lse,
                       attention_delta_ref(o, do), *want, start=0,
                       num_tiles=n, block_q=bq, block_k=bk, **kw)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _bwd_new_err(g, w) <= BWD_NEW_TOL[dtype]
    order = tuple(int(i) for i in rng.permutation(7))
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, n_atoms=7,
                                          order=order, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,D", BWD_NEW_PATHS, ids=str)
def test_flash_bwd_new_paths_tile_map(cuda, dtype, D):
    """On the new paths too an atom of one tile writes exactly the rows
    ``ops.bwd_tile`` gives it (at ``ops.bwd_blocks``), bit-equal to the
    whole backward."""
    rng = np.random.default_rng(D)
    B, Sq, Sk, Hq, Hk = 1, 150, 150, 4, 1
    q, do = (_randn(rng, (B, Sq, Hq, D), dtype, cuda) for _ in range(2))
    k, v = (_randn(rng, (B, Sk, Hk, D), dtype, cuda) for _ in range(2))
    kw = dict(causal=True, window=70)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    full = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    delta = flash_ops.attention_delta(o, do)
    for t in range(flash_ops.bwd_tile_space(q, k)):
        role, b, h, lo, hi = flash_ops.bwd_tile(t, q, k)
        got = [torch.full_like(x, float("nan")) for x in (q, k, v)]
        flash_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, *got,
                                           start=t, num_tiles=1, **kw)
        want = [torch.zeros(x.shape, dtype=torch.bool, device=cuda)
                for x in got]
        if role == "dq":
            want[0][b, lo:hi, h] = True
        else:
            want[1][b, lo:hi, h] = want[2][b, lo:hi, h] = True
        for g, f, m in zip(got, full, want):
            assert torch.equal(~torch.isnan(g), m)
            assert torch.equal(g[m], f[m])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda, dtype):
    """A head dim no path takes (32) raises for a CUDA operand; nothing
    falls back to the plain version."""
    q = torch.zeros(1, 64, 2, 32, dtype=dtype, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention_bwd(q, q, q, q, q, lse)


def test_train_step_on_gpu_matches_cpu(cuda):
    """Reduced olmo-1b at head_dim 64 in bf16: one train step on the card
    (the forward and backward kernels, one launch each a layer and
    microbatch) against the same step on the CPU (plain versions)."""
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), d_model=256,
                              n_heads=4, n_kv_heads=4, d_head=64,
                              dtype="bfloat16")
    tc = TrainConfig(n_micro=2, lr=1e-3)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(2, 256, (4, 96))),
             "labels": torch.from_numpy(rng.integers(0, 256, (4, 96)))}
    init_c, step_c = make_train_step(cfg, tc, device="cpu")
    init_g, step_g = make_train_step(cfg, tc, device=cuda)
    before = flash_ops.launches, flash_ops.bwd_launches
    _, mc = step_c(init_c(params=cpu), batch)
    _, mg = step_g(init_g(params=gpu),
                   {k: v.to(cuda) for k, v in batch.items()})
    assert (flash_ops.launches - before[0],
            flash_ops.bwd_launches - before[1]) == (2 * cfg.n_layers,
                                                    2 * cfg.n_layers)
    assert abs(mg["loss"].item() - mc["loss"].item()) <= 2e-2
    assert abs(mg["grad_norm"].item() / mc["grad_norm"].item() - 1) <= 5e-2
