"""The port's hybrid and recurrent decoders against the JAX package's, on the
CPU: the RG-LRU block, the mLSTM and sLSTM blocks, and reduced
recurrentgemma-9b and xlstm-1.3b end to end (sliding-window attention's
kernel cases are in ``test_torch_kernels.py``).

Parameters are initialised by the JAX package and converted leaf by leaf;
activations and tokens are made from a numpy seed and handed to both sides.
float32 on both sides: ``2e-5`` for the blocks (products and elementwise
gates; the scans sum in another order), ``2e-3`` for the whole models
(softmax and many layers); bfloat16 cases ``3e-2`` (one rounding of
each result, at slightly different f32 values).  States are compared leaf
by leaf against the reference's tuples and ``NamedTuple``s.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (as_np, assert_caches_close, assert_states_close,
                         make_pair, normal_pair, ref_state)
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro_torch.models import rglru, ssm, transformer

BLOCK = dict(rtol=2e-5, atol=2e-5)
ATTN = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=3e-2, atol=3e-2)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32", jitter=0.0):
    """``make_pair``, made once per case (no test changes the params)."""
    return make_pair(arch, dtype=dtype, jitter=jitter)


def _block(arch, kind, dtype="float32"):
    """(jax block params, port block params) of the first block of ``kind``
    in reduced ``arch`` (the group-0 layer of its pattern position)."""
    jcfg, jparams, tcfg, tparams = _pair(arch, dtype, 0.05)
    pos = str(jcfg.hybrid.pattern.index(kind))
    jb = jax.tree.map(lambda x: x[0], jparams["blocks"][pos])
    tb = transformer._layer(tparams["blocks"][pos], 0)
    return jcfg, jb, tcfg, tb


def _tokens(seed, shape):
    t = np.random.default_rng(seed).integers(2, 256, shape).astype(np.int32)
    return torch.from_numpy(t).long(), jnp.asarray(t)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0, 1, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(as_np(rglru.linear_scan(a, b)),
                               as_np(torch.stack(want, 1)), **BLOCK)


@pytest.mark.parametrize("S", [1, 5, 37])
def test_rglru_block_prefill_and_state(S):
    jcfg, jb, tcfg, tb = _block("recurrentgemma-9b", "rec")
    rng = np.random.default_rng(S)
    x, jx = normal_pair(rng, (2, S, 64))
    np.testing.assert_allclose(as_np(rglru.apply_rglru_block(tb["rec"], x)),
                               as_np(jax_rglru.apply_rglru_block(jb["rec"], jx)),
                               **BLOCK)
    conv, jconv = normal_pair(rng, (2, 3, 64))
    h0, jh0 = normal_pair(rng, (2, 64))
    out, (h, c) = rglru.apply_rglru_block(tb["rec"], x, h0=h0,
                                          conv_state=conv, return_state=True)
    jout, (jh, jc) = jax_rglru.apply_rglru_block(
        jb["rec"], jx, h0=jh0, conv_state=jconv, return_state=True)
    np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
    np.testing.assert_allclose(as_np(h), as_np(jh), **BLOCK)
    np.testing.assert_array_equal(as_np(c), as_np(jc))


def test_rglru_decode_steps():
    jcfg, jb, tcfg, tb = _block("recurrentgemma-9b", "rec")
    rng = np.random.default_rng(3)
    h, jh = normal_pair(rng, (3, 64))
    c, jc = normal_pair(rng, (3, 3, 64))
    for _ in range(3):
        x, jx = normal_pair(rng, (3, 1, 64))
        out, h, c = rglru.decode_rglru_block(tb["rec"], x, h, c)
        jout, (jh, jc) = jax_rglru.decode_rglru_block(jb["rec"], jx, (jh, jc))
        np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
        assert_states_close({"h": h, "conv": c},
                            ref_state("rec", (jh, jc)), **BLOCK)


def test_rglru_block_bf16():
    jcfg, jb, tcfg, tb = _block("recurrentgemma-9b", "rec", dtype="bfloat16")
    assert tb["rec"]["lam"].dtype == torch.float32           # stays f32
    x, jx = normal_pair(np.random.default_rng(4), (2, 19, 64), "bfloat16")
    out = rglru.apply_rglru_block(tb["rec"], x)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(out),
                               as_np(jax_rglru.apply_rglru_block(jb["rec"], jx)),
                               **BF16)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_state(rng, B=2, H=4, hd=32):
    C, jC = normal_pair(rng, (B, H, hd, hd))
    n, jn = normal_pair(rng, (B, H, hd))
    m, jm = normal_pair(rng, (B, H))
    return ({"C": C, "n": n, "m": m},
            jax_ssm.MLstmState(jC, jn, jm))


@pytest.mark.parametrize("S,chunk", [(16, 8), (11, 8), (11, 256), (30, 7)])
def test_mlstm_block_chunks_and_state(S, chunk):
    """Whole chunks, a padded last chunk (the reference's padding), and one
    chunk; from the initial state and from a carried one."""
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "mlstm")
    rng = np.random.default_rng(S + chunk)
    x, jx = normal_pair(rng, (2, S, 64))
    for st, jst in ((None, None), _mlstm_state(rng)):
        out, (st1, tail) = ssm.apply_mlstm_block(
            tb["mlstm"], x, chunk=chunk, state=st, return_state=True)
        jout, (jst1, jtail) = jax_ssm.apply_mlstm_block(
            jb["mlstm"], jx, chunk=chunk, state=jst, return_state=True)
        np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
        assert_states_close({**st1, "conv": tail},
                            ref_state("mlstm", (jst1, jtail)), **BLOCK)


def test_mlstm_decode_steps():
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "mlstm")
    rng = np.random.default_rng(5)
    st, jst = _mlstm_state(rng)
    conv, jconv = normal_pair(rng, (2, 3, 128))
    for _ in range(3):
        x, jx = normal_pair(rng, (2, 1, 64))
        out, st, conv = ssm.decode_mlstm_block(tb["mlstm"], x, st, conv)
        jout, jst, jconv = jax_ssm.decode_mlstm_block(jb["mlstm"], jx, jst,
                                                      jconv)
        np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
        assert_states_close({**st, "conv": conv},
                            ref_state("mlstm", (jst, jconv)), **BLOCK)


def _true_state(st):
    """The carried C and n unscaled: C^ e^m, n^ e^m."""
    e = np.exp(as_np(st["m"]))
    return as_np(st["C"]) * e[..., None, None], as_np(st["n"]) * e[..., None]


def test_mlstm_padding_decays_the_carried_state_in_both_packages():
    """Reference fault, reproduced (ROADMAP, section C): a prompt of S >
    chunk tokens with S % chunk != 0 is padded with forget logits of 0, so
    the state it carries is the true one times 2^-pad, while the prompt's
    own outputs are unchanged."""
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "mlstm")
    x, jx = normal_pair(np.random.default_rng(6), (2, 11, 64))
    pad = 5                                          # 11 -> 16 at chunk 8
    for mod, p, xx in ((ssm, tb["mlstm"], x), (jax_ssm, jb["mlstm"], jx)):
        o_pad, (st_pad, _) = mod.apply_mlstm_block(p, xx, chunk=8,
                                                   return_state=True)
        o_one, (st_one, _) = mod.apply_mlstm_block(p, xx, chunk=11,
                                                   return_state=True)
        if not isinstance(st_pad, dict):
            st_pad, st_one = st_pad._asdict(), st_one._asdict()
        np.testing.assert_allclose(as_np(o_pad), as_np(o_one), **BLOCK)
        (C_pad, n_pad), (C_one, n_one) = _true_state(st_pad), _true_state(st_one)
        np.testing.assert_allclose(C_pad, C_one * 2.0 ** -pad, rtol=1e-4,
                                   atol=1e-9)
        np.testing.assert_allclose(n_pad, n_one * 2.0 ** -pad, rtol=1e-4,
                                   atol=1e-9)


def test_mlstm_block_bf16():
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "mlstm", dtype="bfloat16")
    assert tb["mlstm"]["b_fg"].dtype == torch.float32        # stays f32
    x, jx = normal_pair(np.random.default_rng(7), (2, 13, 64), "bfloat16")
    np.testing.assert_allclose(
        as_np(ssm.apply_mlstm_block(tb["mlstm"], x, chunk=8)),
        as_np(jax_ssm.apply_mlstm_block(jb["mlstm"], jx, chunk=8)), **BF16)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def test_slstm_block_prefill_and_decode():
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "slstm")
    rng = np.random.default_rng(8)
    x, jx = normal_pair(rng, (2, 9, 64))
    out, st = ssm.apply_slstm_block(tb["slstm"], x, return_state=True)
    jout, jst = jax_ssm.apply_slstm_block(jb["slstm"], jx, return_state=True)
    np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
    assert_states_close(st, ref_state("slstm", jst), **BLOCK)
    for _ in range(3):
        x, jx = normal_pair(rng, (2, 1, 64))
        out, st = ssm.decode_slstm_block(tb["slstm"], x, st)
        jout, jst = jax_ssm.decode_slstm_block(jb["slstm"], jx, jst)
        np.testing.assert_allclose(as_np(out), as_np(jout), **BLOCK)
        assert_states_close(st, ref_state("slstm", jst), **BLOCK)


def test_slstm_block_bf16():
    jcfg, jb, tcfg, tb = _block("xlstm-1.3b", "slstm", dtype="bfloat16")
    assert all(tb["slstm"][f"b_{g}"].dtype == torch.float32 for g in "ifzo")
    x, jx = normal_pair(np.random.default_rng(9), (2, 6, 64), "bfloat16")
    np.testing.assert_allclose(
        as_np(ssm.apply_slstm_block(tb["slstm"], x)),
        as_np(jax_ssm.apply_slstm_block(jb["slstm"], jx)), **BF16)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_forward_prefill_and_three_decode_steps(arch, per_slot):
    """A 45-token prompt (past recurrentgemma's reduced window of 32, so the
    ring wraps), then three decode steps: logits and every cache leaf."""
    jcfg, jparams, tcfg, tparams = _pair(arch, jitter=0.05)
    B, S, L = 2, 45, 60
    toks, jtoks = _tokens(20, (B, S))
    h = transformer.forward(tparams, tcfg, toks)[0]
    jh, _ = jax_tf.forward(jparams, jcfg, jtoks)
    np.testing.assert_allclose(as_np(h), as_np(jh), **ATTN)
    logits, caches = transformer.prefill(tparams, tcfg, toks, max_len=L)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks, max_len=L)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **ATTN)
    assert_caches_close(caches, jcaches, tcfg, **ATTN)
    for step in range(3):
        nxt, jnxt = _tokens(30 + step, (B,))
        pos = S + step
        tp, jp = ((torch.full((B,), pos), jnp.full((B,), pos)) if per_slot
                  else (pos, jnp.int32(pos)))
        logits, caches2 = transformer.decode_step(tparams, tcfg, nxt, tp,
                                                  caches)
        assert caches2 is caches                                 # in place
        jlogits, jcaches = jax_tf.decode_step(jparams, jcfg, jnxt, jp, jcaches)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **ATTN)
        assert_caches_close(caches, jcaches, tcfg, **ATTN)


def test_recurrentgemma_windowed_cache_is_window_long():
    _, _, tcfg, _ = _pair("recurrentgemma-9b")
    caches = transformer.init_caches(tcfg, 2, 100, device="cpu")
    assert tuple(caches["groups"]["2"]["k"].shape) == (1, 2, 32, 1, 16)
    caches = transformer.init_caches(tcfg, 2, 20, device="cpu")
    assert tuple(caches["groups"]["2"]["k"].shape) == (1, 2, 20, 1, 16)
    assert transformer.attention_layers(tcfg) == 1
    full = dataclasses.replace(tcfg, n_layers=38)
    assert transformer.attention_layers(full) == 12


def test_xlstm_padded_prompt_matches_reference():
    """A reduced xlstm prompt longer than the 256-token chunk (padded to
    512 by the reference): logits and states of prefill and one decode
    step agree, the padding's decay included."""
    jcfg, jparams, tcfg, tparams = _pair("xlstm-1.3b")
    toks, jtoks = _tokens(21, (1, 300))
    logits, caches = transformer.prefill(tparams, tcfg, toks)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **ATTN)
    assert_caches_close(caches, jcaches, tcfg, **ATTN)
    nxt, jnxt = _tokens(22, (1,))
    logits, _ = transformer.decode_step(tparams, tcfg, nxt, 300, caches)
    jlogits, _ = jax_tf.decode_step(jparams, jcfg, jnxt, jnp.int32(300),
                                    jcaches)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **ATTN)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_prefill_then_decode_equals_forward(arch):
    """Inside the port, where no chunk padding occurs (S <= 256): a prefill
    of 20 tokens, then one decode step a token up to 40 (past the window
    of 32: the ring wraps), gives the logits of a full forward."""
    _, _, tcfg, tparams = _pair(arch)
    toks, _ = _tokens(23, (2, 40))
    full = transformer.lm_logits(tparams, tcfg,
                                 transformer.forward(tparams, tcfg, toks)[0])
    logits, caches = transformer.prefill(tparams, tcfg, toks[:, :20],
                                         max_len=48)
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 19]), **ATTN)
    for t in range(20, 40):
        logits, caches = transformer.decode_step(tparams, tcfg, toks[:, t], t,
                                                 caches)
        np.testing.assert_allclose(as_np(logits), as_np(full[:, t]), **ATTN)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_prefill_into_a_used_slot_resets_its_recurrent_state(arch):
    """Prefilling a slot whose states hold another request's (and garbage)
    gives the caches and logits of a prefill into fresh caches."""
    _, _, tcfg, tparams = _pair(arch)
    toks, _ = _tokens(24, (1, 12))
    want_logits, fresh = transformer.prefill(tparams, tcfg, toks, max_len=40)
    used = transformer.init_caches(tcfg, 2, 40, device="cpu")
    for tree in (used["groups"], used["rem"]):
        for c in tree.values():
            for t in c.values():
                t.copy_(torch.randn_like(t))
    logits, _ = transformer.prefill(tparams, tcfg, toks, caches=used, slot=1)
    np.testing.assert_allclose(as_np(logits), as_np(want_logits), **BLOCK)
    pat = tcfg.hybrid.pattern
    for pos, c in used["groups"].items():
        if pat[int(pos)] == "attn":
            continue
        for name, t in c.items():
            np.testing.assert_allclose(as_np(t[:, 1:2]),
                                       as_np(fresh["groups"][pos][name]),
                                       **BLOCK, err_msg=name)


def test_model_bf16_hybrid():
    """bfloat16 reduced recurrentgemma: prefill and a decode step within
    the bf16 tolerance of the reference."""
    jcfg, jparams, tcfg, tparams = _pair("recurrentgemma-9b",
                                         "bfloat16")
    toks, jtoks = _tokens(25, (2, 36))
    logits, caches = transformer.prefill(tparams, tcfg, toks, max_len=40)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks, max_len=40)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **BF16)
    nxt, jnxt = _tokens(26, (2,))
    logits, _ = transformer.decode_step(tparams, tcfg, nxt, 36, caches)
    jlogits, _ = jax_tf.decode_step(jparams, jcfg, jnxt, jnp.int32(36),
                                    jcaches)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **BF16)
