"""The port's kernel wrappers against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
side runs as its own tests run it: the Pallas kernels in interpret mode
(``repro.kernels.*.ops``) and their pure-jnp oracles (``repro.kernels.*.ref``).
On the CPU the port's wrappers take their plain PyTorch versions, atom
schedule included; the CUDA kernels themselves are held against those plain
versions on the GPU by ``chip_smoke.py``.

Tolerances are the reference's own (``tests/test_kernels.py``): float32
decode 2e-5 and flash 2e-3 (two f32 implementations that sum in different
orders; the flash bound is loose because the Pallas kernel rescales its
accumulator block by block), bfloat16 3e-2 (outputs of O(1) rounded to 8
bits of mantissa, on inputs that were rounded the same way on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:                # only the property test needs hypothesis
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

from repro.kernels.atom_matmul.kernel import tile_count as jax_tile_count
from repro.kernels.atom_matmul.ops import atom_ranges as jax_atom_ranges
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jax_attn
from repro_torch.kernels.atoms import atom_ranges, schedule, tile_count
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as attn

from _torch_port import as_np, normal_pair

decode_attention = decode_ops.decode_attention
flash_attention = flash_ops.flash_attention


# ---------------------------------------------------------------------------
# atom schedule
# ---------------------------------------------------------------------------

if HAS_HYPOTHESIS:
    @given(total=st.integers(1, 500), n=st.integers(1, 64))
    @settings(max_examples=200, deadline=None)
    def test_atom_ranges_cover_exactly_once(total, n):
        ranges = atom_ranges(total, n)
        seen = []
        for start, ln in ranges:
            assert ln > 0
            seen.extend(range(start, start + ln))
        assert seen == list(range(total))
        assert ranges == jax_atom_ranges(total, n)
else:
    def test_atom_ranges_cover_exactly_once():
        pytest.skip("hypothesis not installed")


@pytest.mark.parametrize("total,n", [(1, 1), (7, 3), (32, 5), (256, 64),
                                     (5, 9)])
def test_atom_ranges_match_reference(total, n):
    assert atom_ranges(total, n) == jax_atom_ranges(total, n)


def test_tile_count_matches_reference():
    for M, N, bm, bn in [(256, 256, 256, 256), (300, 260, 128, 128),
                         (1, 1, 64, 64), (257, 129, 128, 64)]:
        assert tile_count(M, N, bm, bn) == jax_tile_count(M, N, bm, bn)


def test_schedule_order_must_be_a_permutation():
    assert schedule(10, 3, (2, 0, 1)) == [atom_ranges(10, 3)[i]
                                          for i in (2, 0, 1)]
    with pytest.raises(ValueError):
        schedule(10, 3, (0, 0, 1))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,Hq,Hk,D", [(2, 96, 4, 2, 32), (1, 128, 8, 8, 64),
                                         (2, 64, 4, 1, 32)])
@pytest.mark.parametrize("n_atoms", [1, 3])
def test_flash_attention_sweep(B, S, Hq, Hk, D, n_atoms):
    rng = np.random.default_rng(0)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (B, S, Hq, D)),
                                 normal_pair(rng, (B, S, Hk, D)),
                                 normal_pair(rng, (B, S, Hk, D)))
    o = flash_attention(q, k, v, causal=True, n_atoms=n_atoms, block_q=32)
    pallas = jax_flash(jq, jk, jv, causal=True, n_atoms=n_atoms, block_q=32,
                       block_k=32, interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(as_np(o), as_np(pallas), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(as_np(o), as_np(oracle), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(as_np(o), as_np(attention_ref(q, k, v)),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    rng = np.random.default_rng(3)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (1, 64, 4, 32), "bfloat16"),
                                 normal_pair(rng, (1, 64, 2, 32), "bfloat16"),
                                 normal_pair(rng, (1, 64, 2, 32), "bfloat16"))
    o = flash_attention(q, k, v, causal=True, block_q=32)
    assert o.dtype == torch.bfloat16
    pallas = jax_flash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                       interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(as_np(o), as_np(pallas), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(as_np(o), as_np(oracle), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("Sq,Sk", [(32, 96), (17, 80), (1, 50)])
def test_flash_attention_chunked_prefill(Sq, Sk):
    """Sq < Sk: the causal mask is aligned to the end of the keys."""
    rng = np.random.default_rng(4)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (2, Sq, 4, 32)),
                                 normal_pair(rng, (2, Sk, 2, 32)),
                                 normal_pair(rng, (2, Sk, 2, 32)))
    o = flash_attention(q, k, v, causal=True, n_atoms=2, block_q=16)
    oracle = jax_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(as_np(o), as_np(oracle), rtol=2e-3, atol=2e-3)
    pallas = jax_flash(jq, jk, jv, causal=True, block_q=16, block_k=16,
                       interpret=True)
    np.testing.assert_allclose(as_np(o), as_np(pallas), rtol=2e-3, atol=2e-3)
    # and it is the tail of full self-attention over the same keys
    qfull = torch.cat([torch.zeros(2, Sk - Sq, 4, 32), q], dim=1)
    full = flash_attention(qfull, k, v, causal=True, block_q=16)
    np.testing.assert_allclose(as_np(o), as_np(full[:, Sk - Sq:]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(37, 37), (70, 100), (100, 100)])
def test_flash_attention_ragged(Sq, Sk, causal):
    """Sq, Sk not multiples of any block: masked, never padded.  (The
    reference's wrapper refuses the non-causal ragged case; its oracle
    does not.)"""
    rng = np.random.default_rng(5)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (1, Sq, 4, 32)),
                                 normal_pair(rng, (1, Sk, 2, 32)),
                                 normal_pair(rng, (1, Sk, 2, 32)))
    o = flash_attention(q, k, v, causal=causal, n_atoms=3, block_q=32)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(as_np(o), as_np(oracle), rtol=2e-3, atol=2e-3)
    if causal:
        pallas = jax_flash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                           interpret=True)
        np.testing.assert_allclose(as_np(o), as_np(pallas), rtol=2e-3,
                                   atol=2e-3)


def test_flash_attention_fully_masked_rows_give_zeros():
    """Sq > Sk with the causal mask aligned to the end: the first Sq-Sk query
    rows see no key and give zeros, not NaN."""
    rng = np.random.default_rng(6)
    (q, _), (k, _), (v, _) = (normal_pair(rng, (1, 40, 2, 16)),
                              normal_pair(rng, (1, 24, 2, 16)),
                              normal_pair(rng, (1, 24, 2, 16)))
    o = flash_attention(q, k, v, causal=True, block_q=16)
    assert torch.isfinite(o).all()
    assert (o[:, :16] == 0).all()
    np.testing.assert_allclose(
        as_np(o[:, 16:]), as_np(attention_ref(q[:, 16:], k, v)), rtol=2e-5,
        atol=2e-5)


def test_flash_attention_atoms_order_free_bit_equal():
    rng = np.random.default_rng(7)
    (q, _), (k, _), (v, _) = (normal_pair(rng, (2, 80, 4, 32)),
                              normal_pair(rng, (2, 80, 2, 32)),
                              normal_pair(rng, (2, 80, 2, 32)))
    base = flash_attention(q, k, v, n_atoms=4, block_q=16)
    perm = flash_attention(q, k, v, n_atoms=4, block_q=16, order=(3, 1, 0, 2))
    assert torch.equal(base, perm)


def test_flash_attention_atom_leaves_other_tiles_untouched():
    rng = np.random.default_rng(8)
    B, S, Hq, Hk, D, bq = 2, 50, 4, 2, 16, 16
    (q, _), (k, _), (v, _) = (normal_pair(rng, (B, S, Hq, D)),
                              normal_pair(rng, (B, S, Hk, D)),
                              normal_pair(rng, (B, S, Hk, D)))
    full = flash_attention(q, k, v, block_q=bq)
    nqb = -(-S // bq)
    assert flash_ops.tile_space(q, bq) == B * Hq * nqb
    start, num = 5, 13
    o = torch.full_like(q, 7.0)
    out = flash_ops.flash_attention_atom(q, k, v, o, start=start,
                                         num_tiles=num, block_q=bq)
    assert out is o
    for t in range(B * Hq * nqb):
        bh, qi = divmod(t, nqb)
        b, h = divmod(bh, Hq)
        rows = slice(qi * bq, min(S, (qi + 1) * bq))
        if start <= t < start + num:
            np.testing.assert_allclose(as_np(o[b, rows, h]),
                                       as_np(full[b, rows, h]),
                                       rtol=2e-5, atol=2e-5)
        else:
            assert (o[b, rows, h] == 7.0).all(), t
    with pytest.raises(ValueError):
        flash_ops.flash_attention_atom(q, k, v, o, start=B * Hq * nqb - 1,
                                       num_tiles=2, block_q=bq)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hk,D,S", [(2, 8, 2, 64, 128), (3, 4, 4, 32, 100),
                                         (1, 8, 1, 64, 48)])
@pytest.mark.parametrize("n_atoms", [1, 2])
def test_decode_attention_sweep(B, Hq, Hk, D, S, n_atoms):
    rng = np.random.default_rng(0)
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hq, D)),
                                     normal_pair(rng, (B, S, Hk, D)),
                                     normal_pair(rng, (B, S, Hk, D)))
    lens = np.random.default_rng(0).integers(1, S + 1, B).astype(np.int32)
    out = decode_attention(q, kc, vc, torch.from_numpy(lens), n_atoms=n_atoms)
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lens), n_atoms=n_atoms,
                        block_k=32, interpret=True)
    oracle = jax_decode_ref(jq, jkc, jvc, jnp.asarray(lens))
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(as_np(out), as_np(oracle), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        as_np(out),
        as_np(decode_attention_ref(q, kc, vc, torch.from_numpy(lens))),
        rtol=2e-5, atol=2e-5)


def test_decode_attention_bf16():
    rng = np.random.default_rng(2)
    B, Hq, Hk, D, S = 2, 8, 2, 64, 96
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hq, D), "bfloat16"),
                                     normal_pair(rng, (B, S, Hk, D), "bfloat16"),
                                     normal_pair(rng, (B, S, Hk, D), "bfloat16"))
    lens = np.array([96, 31], np.int32)
    out = decode_attention(q, kc, vc, torch.from_numpy(lens))
    assert out.dtype == torch.bfloat16
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lens), block_k=32,
                        interpret=True)
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=3e-2, atol=3e-2)


def test_decode_attention_per_slot_lengths():
    """Continuous-batching: each row attends over exactly its own length."""
    rng = np.random.default_rng(7)
    B, Hq, Hk, D, S = 4, 4, 2, 32, 64
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hq, D)),
                                     normal_pair(rng, (B, S, Hk, D)),
                                     normal_pair(rng, (B, S, Hk, D)))
    lens = [1, 17, 32, 64]
    full = decode_attention(q, kc, vc, torch.tensor(lens, dtype=torch.int32))
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lens, jnp.int32),
                        block_k=16, interpret=True)
    np.testing.assert_allclose(as_np(full), as_np(pallas), rtol=1e-5,
                               atol=1e-5)
    for i, l in enumerate(lens):
        solo = decode_attention(q[i:i + 1], kc[i:i + 1, :l], vc[i:i + 1, :l],
                                torch.tensor([l], dtype=torch.int32))
        np.testing.assert_allclose(as_np(full[i]), as_np(solo[0]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_attention_len_zero_gives_zeros_and_len_is_clamped():
    rng = np.random.default_rng(9)
    B, Hq, Hk, D, S = 3, 4, 2, 16, 20
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hq, D)),
                                     normal_pair(rng, (B, S, Hk, D)),
                                     normal_pair(rng, (B, S, Hk, D)))
    out = decode_attention(q, kc, vc, torch.tensor([0, 5, 99]))
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    # the reference's oracle agrees (its kernel is never given a length 0)
    oracle = jax_decode_ref(jq, jkc, jvc, jnp.asarray([0, 5, S], jnp.int32))
    np.testing.assert_allclose(as_np(out), as_np(oracle), rtol=2e-5, atol=2e-5)


def test_decode_attention_atoms_order_free_bit_equal():
    rng = np.random.default_rng(10)
    (q, _), (kc, _), (vc, _) = (normal_pair(rng, (3, 8, 32)),
                                normal_pair(rng, (3, 40, 4, 32)),
                                normal_pair(rng, (3, 40, 4, 32)))
    lens = torch.tensor([40, 3, 17], dtype=torch.int32)
    base = decode_attention(q, kc, vc, lens, n_atoms=4)
    perm = decode_attention(q, kc, vc, lens, n_atoms=4, order=(2, 0, 3, 1))
    assert torch.equal(base, perm)


def test_decode_attention_atom_leaves_other_rows_untouched():
    rng = np.random.default_rng(11)
    B, Hq, Hk, D, S = 3, 8, 4, 16, 24
    (q, _), (kc, _), (vc, _) = (normal_pair(rng, (B, Hq, D)),
                                normal_pair(rng, (B, S, Hk, D)),
                                normal_pair(rng, (B, S, Hk, D)))
    lens = torch.tensor([24, 1, 9], dtype=torch.int32)
    full = decode_attention(q, kc, vc, lens)
    start, num = 3, 6                       # rows r = b*Hk + hk, across batches
    o = torch.full_like(q, 7.0)
    out = decode_ops.decode_attention_atom(q, kc, vc, lens, o, start=start,
                                           num_rows=num)
    assert out is o
    G = Hq // Hk
    og, fg = o.view(B * Hk, G, D), full.view(B * Hk, G, D)
    for r in range(B * Hk):
        if start <= r < start + num:
            np.testing.assert_allclose(as_np(og[r]), as_np(fg[r]), rtol=2e-5,
                                       atol=2e-5)
        else:
            assert (og[r] == 7.0).all(), r
    with pytest.raises(ValueError):
        decode_ops.decode_attention_atom(q, kc, vc, lens, o, start=B * Hk,
                                         num_rows=1)


# ---------------------------------------------------------------------------
# sliding-window attention and head_dim 256 (the hybrid slice)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(40, 32), (100, 32), (20, 32), (70, 1)])
def test_windowed_prefill_attention_matches_reference(S, window):
    """The flash wrapper's plain version with ``window`` against the
    reference's naive and blocked (the model's) windowed attention, at
    prompts below and beyond the reduced window of 32; atoms compose."""
    rng = np.random.default_rng(S + window)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (2, S, 4, 16)),
                                 normal_pair(rng, (2, S, 1, 16)),
                                 normal_pair(rng, (2, S, 1, 16)))
    got = attn.prefill_attention(q, k, v, window=window)
    np.testing.assert_allclose(
        as_np(got), as_np(jax_attn.naive_attention(jq, jk, jv, window=window)),
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        as_np(got), as_np(jax_attn.blocked_attention(
            jq, jk, jv, causal=True, window=window, block_q=16, block_kv=16)),
        rtol=2e-3, atol=2e-3)
    atoms = flash_ops.flash_attention(q, k, v, window=window, n_atoms=3,
                                      order=(2, 0, 1))
    np.testing.assert_allclose(as_np(atoms), as_np(got), rtol=1e-6, atol=1e-6)


def test_windowed_prefill_attention_chunked_end_aligned():
    """Sq < Sk: the window is measured from the end-aligned query position."""
    rng = np.random.default_rng(11)
    (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (1, 10, 2, 16)),
                                 normal_pair(rng, (1, 50, 2, 16)),
                                 normal_pair(rng, (1, 50, 2, 16)))
    np.testing.assert_allclose(
        as_np(attn.prefill_attention(q, k, v, window=12)),
        as_np(jax_attn.naive_attention(jq, jk, jv, window=12, q_offset=40)),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_ring_buffer_decode_matches_reference(per_slot):
    """A ring of 32 slots filled by a 45-token prefill (its last 32 tokens
    at pos % 32), then decode steps that wrap it further: the cache and the
    decode wrapper's plain version against the reference's."""
    W, S, B = 32, 45, 2
    rng = np.random.default_rng(12)
    (k, jk), (v, jv) = (normal_pair(rng, (B, S, 1, 16)),
                        normal_pair(rng, (B, S, 1, 16)))
    kc, vc = torch.zeros(B, W, 1, 16), torch.zeros(B, W, 1, 16)
    jkc, jvc = jnp.zeros((B, W, 1, 16)), jnp.zeros((B, W, 1, 16))
    attn.update_kv_cache(kc, vc, k[:, S - W:], v[:, S - W:], S - W, window=W)
    jkc, jvc = jax_attn.update_kv_cache(jkc, jvc, jk[:, S - W:], jv[:, S - W:],
                                        jnp.int32(S - W), window=W)
    np.testing.assert_array_equal(as_np(kc), as_np(jkc))
    for step in range(4):
        pos = S + step
        (q, jq), (kn, jkn), (vn, jvn) = (normal_pair(rng, (B, 1, 4, 16)),
                                         normal_pair(rng, (B, 1, 1, 16)),
                                         normal_pair(rng, (B, 1, 1, 16)))
        tp, jp = ((torch.full((B,), pos), jnp.full((B,), pos)) if per_slot
                  else (pos, jnp.int32(pos)))
        attn.update_kv_cache(kc, vc, kn, vn, tp, window=W)
        jkc, jvc = jax_attn.update_kv_cache(jkc, jvc, jkn, jvn, jp, window=W)
        np.testing.assert_array_equal(as_np(vc), as_np(jvc))
        got = attn.decode_attention(q[:, 0], kc, vc, tp + 1 if per_slot
                                    else pos + 1, window=W)
        want = jax_attn.decode_attention(jq[:, 0], jkc, jvc, jp + 1, window=W)
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-3, atol=2e-3)


def test_ring_decode_clamps_lens_to_the_window():
    """Below the window the valid length is pos + 1, beyond it the window."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    got = attn.decode_attention(q, kc, kc, torch.tensor([3, 50]), window=8)
    want = decode_ops.decode_attention(q, kc, kc, torch.tensor([3, 8],
                                                               dtype=torch.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_head_dim_256_mqa_matches_reference(kernel):
    """RecurrentGemma's attention shape: 16 query heads on one KV head,
    head_dim 256, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(256)
    if kernel == "flash":
        (q, jq), (k, jk), (v, jv) = (normal_pair(rng, (1, 40, 16, 256)),
                                     normal_pair(rng, (1, 40, 1, 256)),
                                     normal_pair(rng, (1, 40, 1, 256)))
        o = flash_attention(q, k, v, causal=True, block_q=32)
        want = jax_flash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                         interpret=True)
        np.testing.assert_allclose(as_np(o), as_np(want), rtol=2e-3, atol=2e-3)
        return
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (2, 16, 256)),
                                     normal_pair(rng, (2, 64, 1, 256)),
                                     normal_pair(rng, (2, 64, 1, 256)))
    lens = np.array([64, 9], np.int32)
    o = decode_attention(q, kc, vc, torch.from_numpy(lens))
    want = jax_decode(jq, jkc, jvc, jnp.asarray(lens), block_k=32,
                      interpret=True)
    np.testing.assert_allclose(as_np(o), as_np(want), rtol=2e-5, atol=2e-5)


def test_wrappers_check_shapes_and_dtypes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                    # Hq % Hk != 0
    with pytest.raises(TypeError):
        flash_attention(q, q.to(torch.bfloat16), q.to(torch.bfloat16))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], q, q, torch.ones(2, dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    before = decode_ops.launches, flash_ops.launches
    q = torch.zeros(1, 4, 2, 16)
    flash_attention(q, q, q)
    decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert (decode_ops.launches, flash_ops.launches) == before
