"""The port's encoder-decoder model (whisper-small, reduced) against the JAX
package's, on the CPU.

Parameters are initialised by the JAX package and converted leaf by leaf;
frames and tokens are made from a seed with numpy and handed to both sides.
Float32 on both sides differs only in the order of f32 sums: ``rtol = atol =
1e-4``.  The bfloat16 cases use ``3e-2``: both sides upcast bf16 operands
and round each result once, at slightly different f32 values.  The encoder
runs 45 frames (not a multiple of the kernels' 64-key block) and the
reduced config's full 64.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_np, make_pair, to_numpy
from repro.models import encdec as jax_ed
from repro.models import registry as jax_reg
from repro.models.common import tree_paths as jax_tree_paths
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_numpy_tree
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.common import count_params, tree_paths
from repro_torch.models.registry import (init_model, serve_decode,
                                         serve_prefill)

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _frames(seed, B, S, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((B, S, 64)).astype(
        np.float32)
    t = torch.from_numpy(x).to(_TORCH_DTYPES[dtype])
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _tokens(seed, shape):
    t = np.random.default_rng(seed).integers(2, 256, shape)
    return torch.from_numpy(t), jnp.asarray(t, jnp.int32)


def _batch(frames, toks):
    return {"frames": frames, "tokens": toks}


def _assert_caches_close(tc, jc, upto, tol):
    """Self-attention K/V over the rows written so far (``[:upto]``: the
    port leaves the rest as it was), cross-attention K/V whole."""
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == tuple(jc[n].shape)
        np.testing.assert_allclose(as_np(tc[n][:, :, :upto]),
                                   as_np(jc[n][:, :, :upto]), **tol,
                                   err_msg=n)
    for n in ("xk", "xv"):
        assert tuple(tc[n].shape) == tuple(jc[n].shape)
        np.testing.assert_allclose(as_np(tc[n]), as_np(jc[n]), **tol,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_paths_shapes_and_dtypes_match(dtype):
    """The converted tree and the port's own initialiser against the
    reference's tree: paths (``enc_layers`` / ``dec_layers`` stacked over
    ``[L]``, ``dec_pos`` of 448 rows), shapes, dtypes; values round-trip."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype=dtype)
    jp, tp = jax_tree_paths(jparams), tree_paths(tparams)
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert [(tuple(x.shape), x.dtype) for _, x in tp] == [
        (tuple(x.shape), _TORCH_DTYPES[str(x.dtype)]) for _, x in jp]
    assert count_params(tparams) == sum(int(np.prod(x.shape)) for _, x in jp)
    assert tuple(tparams["dec_pos"].shape) == (448, 64)
    assert tuple(tparams["enc_layers"]["attn"]["wq"].shape) == (2, 64, 4, 16)
    assert tuple(tparams["dec_layers"]["xattn"]["bk"].shape) == (2, 4, 16)
    own = init_model(tcfg, seed=1, device="cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(own)] == [
        (p, tuple(x.shape), x.dtype) for p, x in tp]
    for (p, a), (_, b) in zip(tree_paths(to_numpy_tree(tparams)),
                              jax_tree_paths(to_numpy(jparams))):
        np.testing.assert_array_equal(a, as_np(b), err_msg=p)


def test_init_is_seeded_and_scaled():
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    a = init_model(tcfg, seed=3, device="cpu")
    b = init_model(tcfg, seed=3, device="cpu")
    for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), p
    assert abs(a["dec_pos"].std().item() - 0.02) < 2e-3
    assert (a["dec_layers"]["xattn"]["bq"] == 0).all()
    assert (a["enc_layers"]["ln1"]["scale"] == 1).all()


# ---------------------------------------------------------------------------
# the model, piece by piece
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_src", [45, 64])
def test_encode(S_src):
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    fr, jfr = _frames(1, 2, S_src)
    out = encdec.encode(tparams, tcfg, fr)
    assert tuple(out.shape) == (2, S_src, 64)
    np.testing.assert_allclose(as_np(out),
                               as_np(jax_ed.encode(jparams, jcfg, jfr)), **TOL)


@pytest.mark.parametrize("S_src", [45, 64])
def test_decoder_forward_and_forward(S_src):
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    fr, jfr = _frames(2, 2, S_src)
    toks, jtoks = _tokens(3, (2, 13))
    enc, jenc = encdec.encode(tparams, tcfg, fr), jax_ed.encode(jparams, jcfg,
                                                               jfr)
    h = encdec.decoder_forward(tparams, tcfg, toks, enc)
    np.testing.assert_allclose(
        as_np(h), as_np(jax_ed.decoder_forward(jparams, jcfg, jtoks, jenc)),
        **TOL)
    h = encdec.forward(tparams, tcfg, fr, toks)
    jh, _ = jax_ed.forward(jparams, jcfg, jfr, jtoks)
    assert tuple(h.shape) == (2, 13, 64)
    np.testing.assert_allclose(as_np(h), as_np(jh), **TOL)
    logits = encdec.lm_logits(tparams, tcfg, h)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(as_np(logits),
                               as_np(jax_ed.lm_logits(jparams, jcfg, jh)),
                               **TOL)


@pytest.mark.parametrize("S_src", [45, 64])
def test_serve_prefill_and_three_decode_steps(S_src):
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    B, L = 2, 20
    fr, jfr = _frames(4, B, S_src)
    toks, jtoks = _tokens(5, (B, 4))
    logits, caches = serve_prefill(tparams, tcfg, _batch(fr, toks), max_len=L)
    jlogits, jcaches = jax_reg.serve_prefill(jparams, jcfg,
                                             _batch(jfr, jtoks), max_len=L)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, 256)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL)
    assert tuple(caches["k"].shape) == (2, B, L, 4, 16)
    assert tuple(caches["xk"].shape) == (2, B, S_src, 4, 16)
    _assert_caches_close(caches, jcaches, 1, TOL)
    k_before = caches["k"]
    for step in range(3):
        nxt, jnxt = _tokens(6 + step, (B,))
        logits, caches2 = serve_decode(tparams, tcfg, nxt, 1 + step, caches)
        assert caches2 is caches and caches["k"] is k_before       # in place
        jlogits, jcaches = jax_reg.serve_decode(jparams, jcfg, jnxt,
                                                jnp.int32(1 + step), jcaches)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL)
        _assert_caches_close(caches, jcaches, 2 + step, TOL)


def test_prefill_then_decode_equals_forward():
    """Inside the port: the serving path at positions 0..S-1 gives the
    logits of the teacher-forced forward (each step sees the tokens before
    it through the cache)."""
    _, _, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    fr, _ = _frames(10, 2, 45)
    toks, _ = _tokens(11, (2, 8))
    full = encdec.lm_logits(tparams, tcfg,
                            encdec.forward(tparams, tcfg, fr, toks))
    logits, caches = serve_prefill(tparams, tcfg, _batch(fr, toks), max_len=8)
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 0]), **TOL)
    for t in range(1, 8):
        logits, caches = serve_decode(tparams, tcfg, toks[:, t], t, caches)
        np.testing.assert_allclose(as_np(logits), as_np(full[:, t]), **TOL)


def test_model_bf16():
    """cfg.dtype as published (bfloat16): encode, serve_prefill and a decode
    step; the caches in bfloat16."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype="bfloat16")
    fr, jfr = _frames(12, 2, 45, "bfloat16")
    toks, jtoks = _tokens(13, (2, 3))
    np.testing.assert_allclose(as_np(encdec.encode(tparams, tcfg, fr)),
                               as_np(jax_ed.encode(jparams, jcfg, jfr)),
                               **TOL_BF16)
    logits, caches = serve_prefill(tparams, tcfg, _batch(fr, toks),
                                   max_len=16)
    jlogits, jcaches = jax_reg.serve_prefill(jparams, jcfg,
                                             _batch(jfr, jtoks), max_len=16)
    assert caches["k"].dtype == caches["xk"].dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL_BF16)
    nxt, jnxt = _tokens(14, (2,))
    logits, _ = serve_decode(tparams, tcfg, nxt, 1, caches)
    jlogits, _ = jax_reg.serve_decode(jparams, jcfg, jnxt, jnp.int32(1),
                                      jcaches)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL_BF16)


# ---------------------------------------------------------------------------
# the reference's behaviour, reproduced (ROADMAP §C)
# ---------------------------------------------------------------------------

def test_serve_prefill_decodes_the_first_token_alone():
    """(a) ``serve_prefill`` decodes ``tokens[:, 0]`` at position 0 and
    nothing else of the prompt, in both packages: the whole prompt and its
    first token give the same logits and caches.  A decode at ``pos = S``
    (as the reference's own smoke test drives it) then attends over S-1
    self-attention rows that are still zero."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    B, S, L = 2, 9, 24
    fr, jfr = _frames(20, B, 45)
    toks, jtoks = _tokens(21, (B, S))
    lw, cw = serve_prefill(tparams, tcfg, _batch(fr, toks), max_len=L)
    l1, c1 = serve_prefill(tparams, tcfg, _batch(fr, toks[:, :1]), max_len=L)
    assert torch.equal(lw, l1)
    assert all(torch.equal(cw[n], c1[n]) for n in cw)
    jlw, jcw = jax_reg.serve_prefill(jparams, jcfg, _batch(jfr, jtoks),
                                     max_len=L)
    jl1, _ = jax_reg.serve_prefill(jparams, jcfg, _batch(jfr, jtoks[:, :1]),
                                   max_len=L)
    np.testing.assert_array_equal(np.asarray(jlw), np.asarray(jl1))
    np.testing.assert_allclose(as_np(lw), as_np(jlw), **TOL)
    nxt, jnxt = _tokens(22, (B,))
    logits, caches = serve_decode(tparams, tcfg, nxt, S, cw)
    jlogits, jcaches = jax_reg.serve_decode(jparams, jcfg, jnxt, jnp.int32(S),
                                            jcw)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL)
    for c in (caches, jcaches):
        assert not as_np(c["k"][:, :, 1:S]).any()
        assert as_np(c["k"][:, :, S]).any()
    _assert_caches_close(caches, jcaches, S + 1, TOL)


def test_decode_past_the_position_table_reads_its_last_row():
    """(b) The reference reads ``dec_pos`` (448 rows) with
    ``dynamic_slice_in_dim``, which clamps positions >= 448 to row 447; the
    port clamps alike and matches it at 448 and 450 (``max_len`` 451)."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    B, L = 2, 451
    fr, jfr = _frames(30, B, 45)
    toks, jtoks = _tokens(31, (B, 1))
    _, caches = serve_prefill(tparams, tcfg, _batch(fr, toks), max_len=L)
    _, jcaches = jax_reg.serve_prefill(jparams, jcfg, _batch(jfr, jtoks),
                                       max_len=L)
    for step, pos in enumerate((447, 448, 450)):
        nxt, jnxt = _tokens(32 + step, (B,))
        logits, caches = serve_decode(tparams, tcfg, nxt, pos, caches)
        jlogits, jcaches = jax_reg.serve_decode(jparams, jcfg, jnxt,
                                                jnp.int32(pos), jcaches)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL)
    _assert_caches_close(caches, jcaches, L, TOL)


# ---------------------------------------------------------------------------
# the path goes through the kernels' wrappers, as often as the smoke counts
# ---------------------------------------------------------------------------

def test_attention_calls_per_encode_prefill_and_decode_step(monkeypatch):
    """Flash attention once per encoder layer (non-causal, ``Sq = Sk =
    S_src``) and twice per decoder layer in ``decoder_forward`` (causal
    self-attention; cross-attention non-causal over ``S_src`` keys); decode
    attention twice per decoder layer a decode step (the self-attention
    cache with ``pos + 1`` keys, the cross K/V with ``S_src`` on every row),
    ``serve_prefill`` counting as one step."""
    _, _, tcfg, tparams = make_pair(ARCH)
    calls = []
    flash, decode = attn._flash_ops.flash_attention, attn._decode_ops.decode_attention

    def count_flash(q, k, v, *, causal, window):
        calls.append(("flash", causal, q.shape[1], k.shape[1]))
        return flash(q, k, v, causal=causal, window=window)

    def count_decode(q, kc, vc, lens):
        calls.append(("decode", kc.shape[1], tuple(lens.tolist())))
        return decode(q, kc, vc, lens)

    monkeypatch.setattr(attn._flash_ops, "flash_attention", count_flash)
    monkeypatch.setattr(attn._decode_ops, "decode_attention", count_decode)
    fr, _ = _frames(40, 2, 45)
    toks, _ = _tokens(41, (2, 5))
    enc = encdec.encode(tparams, tcfg, fr)
    assert calls == [("flash", False, 45, 45)] * tcfg.n_encoder_layers
    calls.clear()
    encdec.decoder_forward(tparams, tcfg, toks, enc)
    assert calls == [("flash", True, 5, 5),
                     ("flash", False, 5, 45)] * tcfg.n_layers
    calls.clear()
    _, caches = serve_prefill(tparams, tcfg, _batch(fr, toks), max_len=12)
    assert calls == ([("flash", False, 45, 45)] * tcfg.n_encoder_layers
                     + [("decode", 12, (1, 1)), ("decode", 45, (45, 45))]
                     * tcfg.n_layers)
    calls.clear()
    serve_decode(tparams, tcfg, toks[:, 1], 6, caches)
    assert calls == [("decode", 12, (7, 7)),
                     ("decode", 45, (45, 45))] * tcfg.n_layers


def test_servers_refuse_enc_dec_and_name_the_registry():
    from repro_torch.launch.serve import main
    from repro_torch.serve.engine import SlotServer
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="registry.serve_prefill"):
        SlotServer(cfg, device="cpu")
    with pytest.raises(SystemExit, match="registry.serve_prefill"):
        main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="builds its own caches"):
        serve_prefill({}, cfg, {"frames": torch.zeros(1, 4, 64)}, max_len=8,
                      caches={})
