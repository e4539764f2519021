"""The flash-attention backward and the forward's log-sum-exp, on the CPU.

The port's backward on a CPU tensor is the plain version of
``csrc/flash_attention_bwd.cu`` (``ref.flash_attention_bwd_atom_ref``,
recomputing P from the saved lse; not autograd of the forward), atom
schedule included.  It is held against ``jax.grad`` of the reference
model's ``blocked_attention`` on the same numpy inputs, in float32, to 1e-4
of each gradient's largest |value| (two f32 computations that sum in
different orders).  Atoms must compose bit for bit in any order: each tile
is computed on its own, whatever atom runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_np, normal_pair
from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import attention as attn

# (B, Sq, Sk, Hq, Hk, D, causal, window): causal, non-causal with ragged
# tiles, a sliding window, GQA, Sq != Sk (cross-attention; chunked causal)
CASES = [(2, 70, 70, 4, 2, 16, True, 0),
         (1, 70, 70, 2, 2, 16, False, 0),
         (1, 100, 100, 4, 1, 16, True, 32),
         (2, 64, 64, 8, 2, 32, True, 0),
         (2, 20, 90, 4, 4, 16, False, 0),
         (1, 30, 90, 4, 2, 16, True, 0)]


def _inputs(seed, B, Sq, Sk, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    return [normal_pair(rng, s) for s in ((B, Sq, Hq, D), (B, Sk, Hk, D),
                                          (B, Sk, Hk, D), (B, Sq, Hq, D))]


def _jax_grads(jq, jk, jv, jdo, causal, window):
    """jax.grad of the reference's blocked attention (one block covering
    each sequence, so no padded key enters; the causal mask aligned to the
    end of the keys through ``q_offset``)."""
    Sq, Sk = jq.shape[1], jk.shape[1]

    def f(q, k, v):
        o = jax_attn.blocked_attention(
            q, k, v, causal=causal, window=window, block_q=Sq, block_kv=Sk,
            q_offset=Sk - Sq if causal else 0)
        return jnp.sum(o * jdo)

    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_matches_jax_grad_of_the_reference(case):
    B, Sq, Sk, Hq, Hk, D, causal, window = case
    (q, jq), (k, jk), (v, jv), (do, jdo) = _inputs(0, B, Sq, Sk, Hq, Hk, D)
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                        window=window)
    want = _jax_grads(jq, jk, jv, jdo, causal, window)
    for name, g, w in zip("qkv", got, want):
        w = as_np(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(as_np(g), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_is_the_rows_logsumexp(case):
    """The forward's lse is logsumexp of the row's scaled, masked scores;
    +inf for a row that sees no key (Sq > Sk, causal)."""
    B, Sq, Sk, Hq, Hk, D, causal, window = case
    (q, _), (k, _), (v, _), _ = _inputs(1, B, Sq, Sk, Hq, Hk, D)
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True, n_atoms=3)
    torch.testing.assert_close(
        o, flash_ref.attention_ref(q, k, v, causal=causal, window=window))
    kg = k.repeat_interleave(Hq // Hk, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kg) / D ** .5
    qpos = (Sk - Sq) + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_empty_rows_have_infinite_lse_and_zero_gradients():
    (q, _), (k, _), (v, _), (do, _) = _inputs(2, 1, 90, 50, 2, 2, 16)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    assert torch.isinf(lse[:, :, :40]).all() and (lse[:, :, :40] > 0).all()
    assert torch.isfinite(lse[:, :, 40:]).all()
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, :40] == 0).all()


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]], ids=str)
def test_backward_atoms_compose_bit_for_bit_in_any_order(case):
    B, Sq, Sk, Hq, Hk, D, causal, window = case
    (q, _), (k, _), (v, _), (do, _) = _inputs(3, B, Sq, Sk, Hq, Hk, D)
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    one = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                        window=window)
    n = flash_ops.bwd_tile_space(q, k)
    for n_atoms, order in ((5, (3, 0, 4, 2, 1)), (n, tuple(range(n))[::-1])):
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                            causal=causal, window=window,
                                            n_atoms=n_atoms, order=order)
        assert all(torch.equal(a, b) for a, b in zip(one, got))


def test_backward_atom_writes_only_its_tiles():
    """An atom spanning the end of the dQ tiles and the start of the dK/dV
    tiles writes exactly those rows, at the backward's own tiles (128 query
    rows, 128 keys; each part numbered heaviest causal block first)."""
    B, S, Hq, Hk, D = 1, 130, 2, 1, 16
    (q, _), (k, _), (v, _), (do, _) = _inputs(4, B, S, S, Hq, Hk, D)
    # bf16 at head_dim <= 128: the wgmma path's tiles
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    assert flash_ops.bwd_blocks(q.dtype, D) == (128, 128)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    full = flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
    n_dq, n_kv = flash_ref.bwd_tile_space(q, k)
    assert (n_dq, n_kv) == (2 * 2, 2) and flash_ops.bwd_tile_space(q, k) == 6
    delta = flash_ops.attention_delta(o, do)
    dq, dk, dv = (torch.full_like(t, 7.0) for t in (q, k, v))
    flash_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, dq, dk, dv,
                                       start=3, num_tiles=2)
    # dQ tile 3: head 1, rows 0..127 (the first query block, taken last);
    # dK/dV tile 0: keys 0..127
    assert torch.equal(dq[:, :128, 1], full[0][:, :128, 1])
    assert (dq[:, 128:] == 7).all() and (dq[:, :, 0] == 7).all()
    assert torch.equal(dk[:, :128], full[1][:, :128])
    assert torch.equal(dv[:, :128], full[2][:, :128])
    assert (dk[:, 128:] == 7).all() and (dv[:, 128:] == 7).all()
    with pytest.raises(ValueError, match="outside"):
        flash_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, dq, dk,
                                           dv, start=5, num_tiles=2)


# (B, Sq, Sk, Hq, Hk, causal, window): GQA with a ragged last query block,
# Sq != Sk (cross-attention, non-causal), a window over a ragged tail
TILE_CASES = [(1, 300, 300, 4, 2, True, 0),
              (2, 130, 260, 2, 1, False, 0),
              (1, 129, 129, 2, 2, True, 50)]


@pytest.mark.parametrize("case", TILE_CASES, ids=str)
def test_backward_tiles_partition_the_outputs(case):
    """``ops.bwd_tile`` (``ref.bwd_tile`` at the kernel's tiles) covers
    every row of dq and every key of dk / dv exactly once, each part
    heaviest causal block first: dQ tiles from the last query block down,
    dK/dV tiles from the first key block up."""
    B, Sq, Sk, Hq, Hk, causal, window = case
    q, k = torch.empty(B, Sq, Hq, 16), torch.empty(B, Sk, Hk, 16)
    seen = {"dq": torch.zeros(B, Sq, Hq, dtype=torch.int64),
            "dkv": torch.zeros(B, Sk, Hk, dtype=torch.int64)}
    last = {"dq": Sq, "dkv": -1}
    for t in range(flash_ops.bwd_tile_space(q, k)):
        role, b, h, lo, hi = flash_ops.bwd_tile(t, q, k)
        assert flash_ops.bwd_tile(t, q, k) == flash_ref.bwd_tile(
            t, q, k, *flash_ops.bwd_blocks(q.dtype, q.shape[-1]))
        seen[role][b, lo:hi, h] += 1
        assert (lo <= last[role]) if role == "dq" else (lo >= last[role])
        last[role] = lo
    assert (seen["dq"] == 1).all() and (seen["dkv"] == 1).all()
    with pytest.raises(ValueError, match="outside"):
        flash_ops.bwd_tile(flash_ops.bwd_tile_space(q, k), q, k)


@pytest.mark.parametrize("case", TILE_CASES, ids=str)
def test_backward_atom_of_one_tile_writes_what_the_map_says(case):
    """An atom of one tile, through ``ops``, writes exactly the rows that
    ``ops.bwd_tile`` gives it, with the values of the whole backward."""
    B, Sq, Sk, Hq, Hk, causal, window = case
    (q, _), (k, _), (v, _), (do, _) = _inputs(7, B, Sq, Sk, Hq, Hk, 16)
    kw = dict(causal=causal, window=window)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    full = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    delta = flash_ops.attention_delta(o, do)
    for t in range(flash_ops.bwd_tile_space(q, k)):
        role, b, h, lo, hi = flash_ops.bwd_tile(t, q, k)
        got = [torch.full_like(x, float("nan")) for x in (q, k, v)]
        flash_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, *got,
                                           start=t, num_tiles=1, **kw)
        written = [~torch.isnan(g) for g in got]
        want = [torch.zeros_like(w) for w in written]
        if role == "dq":
            want[0][b, lo:hi, h] = True
        else:
            want[1][b, lo:hi, h] = want[2][b, lo:hi, h] = True
        for g, f, w, m in zip(got, full, written, want):
            assert torch.equal(w, m)
            assert torch.equal(g[m], f[m])


def test_delta_is_rowsum_of_do_times_o():
    (o, _), (do, _) = (normal_pair(np.random.default_rng(5), (2, 9, 3, 16))
                       for _ in range(2))
    torch.testing.assert_close(flash_ops.attention_delta(o, do),
                               (o * do).sum(-1).transpose(1, 2))


def test_autograd_function_and_the_model_call():
    """``FlashAttention`` gives the gradients of the plain forward under
    autograd; ``prefill_attention`` takes it only when autograd records,
    and counts no kernel launch on the CPU."""
    (q, _), (k, _), (v, _), (do, _) = _inputs(6, 2, 50, 50, 4, 2, 16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_ops.launches, flash_ops.bwd_launches
    o = attn.prefill_attention(*leaves, causal=True, window=20)
    assert "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, do)
    want = torch.autograd.grad(
        flash_ref.attention_ref(*plain, causal=True, window=20), plain, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert attn.prefill_attention(*leaves).grad_fn is None
    assert attn.prefill_attention(q, k, v).grad_fn is None
    assert (flash_ops.launches, flash_ops.bwd_launches) == before


def test_backward_refuses_what_the_kernel_does_not_take():
    q = torch.empty(1, 8, 4, 64, device="meta")
    lse = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="no path for device"):
        flash_ops.flash_attention_bwd(q, q, q, q, q, lse)
    with pytest.raises(ValueError, match="lse"):
        flash_ops.flash_attention_bwd_atom(
            torch.zeros(1, 8, 4, 16), *[torch.zeros(1, 8, 4, 16)] * 3,
            torch.zeros(1, 8, 4), torch.zeros(1, 4, 8),
            *[torch.zeros(1, 8, 4, 16)] * 3, start=0, num_tiles=1)


@pytest.mark.parametrize("dtype,D,blocks", [
    (torch.bfloat16, 64, (128, 128)), (torch.bfloat16, 256, (128, 64)),
    (torch.float32, 64, (128, 128)), (torch.float32, 256, (32, 32))],
    ids=str)
def test_backward_blocks_of_each_path_compose_in_any_order(dtype, D, blocks):
    """Each kernel path's tiles (``ops.bwd_blocks``: the wgmma path, its
    head_dim-256 variant, the split-TF32 f32 path): ``ref.bwd_tile`` at them
    partitions the outputs, and the plain atoms, one tile at a time in a
    random order, equal one atom of every tile bit for bit."""
    assert flash_ops.bwd_blocks(dtype, D) == blocks
    B, S, Hq, Hk, window = 1, 200, 4, 1, 90     # MQA, a window, ragged tails
    rng = np.random.default_rng(D)
    q, do = (torch.tensor(rng.standard_normal((B, S, Hq, 16)),
                          dtype=torch.float32) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, S, Hk, 16)),
                         dtype=torch.float32) for _ in range(2))
    o, lse = flash_ops.flash_attention(q, k, v, window=window,
                                       return_lse=True)
    delta = flash_ref.attention_delta_ref(o, do)
    n_dq, n_kv = flash_ref.bwd_tile_space(q, k, *blocks)
    seen = {"dq": torch.zeros(B, S, Hq, dtype=torch.int64),
            "dkv": torch.zeros(B, S, Hk, dtype=torch.int64)}
    for t in range(n_dq + n_kv):
        role, b, h, lo, hi = flash_ref.bwd_tile(t, q, k, *blocks)
        seen[role][b, lo:hi, h] += 1
    assert (seen["dq"] == 1).all() and (seen["dkv"] == 1).all()
    kw = dict(window=window, block_q=blocks[0], block_k=blocks[1])
    one = [torch.zeros_like(t) for t in (q, k, v)]
    flash_ref.flash_attention_bwd_atom_ref(q, k, v, do, lse, delta, *one,
                                           start=0, num_tiles=n_dq + n_kv,
                                           **kw)
    got = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    for t in rng.permutation(n_dq + n_kv):
        flash_ref.flash_attention_bwd_atom_ref(q, k, v, do, lse, delta, *got,
                                               start=int(t), num_tiles=1,
                                               **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, got))
