"""Decode attention over a cache cut into sequence shards, on the CPU.

The partial-softmax-plus-combine route of ``kernels/sharded.py`` rests on
two pieces, held here against the JAX package's decode attention on the
same numpy inputs:

* K1's lse (``decode_attention(..., lse=)``, its plain version on CPU
  tensors): ``m + log(l)`` of each query row against a float64
  log-sum-exp, ``-inf`` for a row of length 0; the atoms' and the split
  plain version's lse the same;
* ``merge.merge_partials``: the partials of 2, 4 and 8 shards (each shard's
  lengths clamped to it, f32 outputs) combine to one call over the whole
  cache, lengths ending inside the first shard, exactly on a shard
  boundary, at 0 and at S; and a sliding-window layer's ring buffer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as jax_decode
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.merge import merge_partials
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

# the merged partials against one call: f32 sums of exp in other orders;
# bf16: the one call rounds its f32 result to bf16 once, the combine rounds
# its own f32 result once (a step of 2^-8 at outputs up to ~2)
MERGE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-6


def _inputs(seed, B, Hq, Hk, D, S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, D), (B, S, Hk, D), (B, S, Hk, D)))


def _lse64(q, k, lens):
    """float64 log-sum-exp of each query row's scaled scores over its
    valid keys (``-inf`` for none)."""
    B, Hq, D = q.shape
    Hk = k.shape[2]
    qg = q.astype(np.float64).reshape(B, Hk, Hq // Hk, D)
    s = np.einsum("bhgd,bkhd->bhgk", qg, k.astype(np.float64)) / np.sqrt(D)
    valid = np.arange(k.shape[1])[None, :] < np.asarray(lens)[:, None]
    s = np.where(valid[:, None, None, :], s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isinf(m), 0.0, m)
    with np.errstate(divide="ignore"):
        lse = m[..., 0] + np.log(np.exp(s - m).sum(-1))
    return lse.reshape(B, Hq)


@pytest.mark.parametrize("B,Hq,Hk,D,S,lens", [
    (3, 8, 2, 16, 40, [40, 0, 13]),
    (2, 4, 4, 32, 64, [1, 64]),
    (2, 16, 1, 16, 100, [100, 37]),
])
def test_plain_lse_is_the_float64_logsumexp(B, Hq, Hk, D, S, lens):
    qn, kn, vn = _inputs(B * S, B, Hq, Hk, D, S)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    lse = torch.full((B, Hq), 7.0)
    R = B * Hk
    o = ops.decode_attention(q, k, v, lens_t, lse=lse, n_atoms=R,
                             order=tuple(reversed(range(R))))
    want = np.asarray(jax_decode(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(lens)))
    # the reference gives a row of length 0 the mean of V (ROADMAP C); the
    # port gives zeros, as the kernel does
    full = np.asarray(lens) > 0
    np.testing.assert_allclose(o.numpy()[full], want[full], rtol=2e-5,
                               atol=2e-5)
    want_lse = _lse64(qn, kn, lens)
    assert np.array_equal(np.isneginf(lse.numpy()), np.isneginf(want_lse))
    np.testing.assert_allclose(lse.numpy()[full], want_lse[full],
                               rtol=LSE_TOL, atol=LSE_TOL)
    # the one-call plain version and the split version give the same lse
    _, lse1 = decode_attention_ref(q, k, v, lens_t, return_lse=True)
    _, lse2 = decode_attention_split_ref(q, k, v, lens_t, 3, -(-S // 3),
                                         return_lse=True)
    for other in (lse1, lse2):
        np.testing.assert_allclose(other.numpy()[full], want_lse[full],
                                   rtol=LSE_TOL, atol=LSE_TOL)
        assert bool(torch.isneginf(other[~torch.from_numpy(full)]).all())


def _sharded(q, k, v, lens, n, dtype):
    """The partials of ``n`` equal sequence shards, merged."""
    S_local = k.shape[1] // n
    parts, lses = [], []
    for r in range(n):
        sl = slice(r * S_local, (r + 1) * S_local)
        lse = torch.empty(q.shape[:2])
        parts.append(ops.decode_attention(
            q, k[:, sl], v[:, sl], (lens - r * S_local).clamp(0, S_local),
            lse=lse, out_dtype=torch.float32))
        lses.append(lse)
    return merge_partials(torch.stack(parts), torch.stack(lses),
                          out_dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_then_merge_is_one_call(n, dtype):
    B, Hq, Hk, D, S = 4, 8, 2, 16, 128
    qn, kn, vn = _inputs(n, B, Hq, Hk, D, S)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (qn, kn, vn))
    # inside the first shard, on a shard boundary, 0, S
    lens = torch.tensor([S // n - 3, S // n, 0, S], dtype=torch.int32)
    whole_lse = torch.empty(B, Hq)
    whole = ops.decode_attention(q, k, v, lens, lse=whole_lse)
    o, lse = _sharded(q, k, v, lens, n, dtype)
    assert o.dtype == dtype
    np.testing.assert_allclose(o.float().numpy(), whole.float().numpy(),
                               rtol=0, atol=MERGE_TOL[dtype])
    assert bool((o[2] == 0).all()) and bool(torch.isneginf(lse[2]).all())
    keep = lens > 0
    np.testing.assert_allclose(lse[keep].numpy(), whole_lse[keep].numpy(),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("cur_len", [5, 32, 45, 200])
def test_split_then_merge_of_a_ring_buffer(cur_len):
    """A window-32 layer's ring buffer (RoPE applied before caching, so the
    slots' order does not matter), cut into 4 shards of 8 slots: the merge
    against the reference's windowed decode attention on the same ring."""
    from repro_torch.models.attention import decode_attention
    W, B, Hq, Hk, D = 32, 2, 4, 1, 16
    qn, kn, vn = _inputs(cur_len, B, Hq, Hk, D, W)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    lens = torch.tensor([cur_len, max(1, cur_len // 3)]).clamp(max=W)
    o, _ = _sharded(q, k, v, lens.to(torch.int32), 4, torch.float32)
    want = np.asarray(jax_decode(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray([cur_len, max(1, cur_len // 3)]), window=W))
    np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        decode_attention(q, k, v, torch.tensor(
            [cur_len, max(1, cur_len // 3)]), window=W).numpy(),
        o.numpy(), rtol=0, atol=2e-5)


def test_merge_of_empty_partials_is_zeros():
    o = torch.randn(3, 2, 4, 8)
    lse = torch.full((3, 2, 4), float("-inf"))
    lse[1, 1] = 0.5
    out, out_lse = merge_partials(o, lse)
    assert bool((out[0] == 0).all()) and bool(torch.isneginf(out_lse[0]).all())
    torch.testing.assert_close(out[1], o[1, 1], rtol=0, atol=1e-7)
    torch.testing.assert_close(out_lse[1], lse[1, 1])
