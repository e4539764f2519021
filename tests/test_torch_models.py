"""The port's dense decoder against the JAX package's, on the CPU.

Parameters are initialised by the JAX package and converted leaf by leaf
through numpy; tokens and activations are made from a seed with numpy and
handed to both sides.  Both run in float32 (``cfg.dtype`` replaced), where
the two frameworks differ only in the order of their f32 sums: ``rtol = atol
= 1e-4`` on activations and logits of O(1) after two layers.  One bfloat16
case per module uses ``3e-2``: both sides upcast bf16 operands to f32 and
round each result once, but they round at slightly different f32 values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_np, make_pair, to_numpy
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models.common import count_params as jax_count_params
from repro.models.common import tree_paths as jax_tree_paths
from repro_torch.convert import to_numpy_tree
from repro_torch.models import attention as attn
from repro_torch.models import layers, transformer
from repro_torch.models.common import count_params, tree_paths
from repro_torch.models.registry import (init_model, serve_decode,
                                         serve_prefill)

ARCHS = ["llama3-8b", "olmo-1b", "qwen1.5-32b", "nemotron-4-340b"]
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _block0(jparams, tparams):
    jb = jax.tree.map(lambda x: x[0], jparams["blocks"]["0"])
    tb = transformer._layer(tparams["blocks"]["0"], 0)
    return jb, tb


def _acts(seed, shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_paths_and_shapes_match(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch)
    jp, tp = jax_tree_paths(jparams), tree_paths(tparams)
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert [tuple(x.shape) for _, x in tp] == [tuple(x.shape) for _, x in jp]
    assert count_params(tparams) == jax_count_params(jparams)
    # the port's own initialiser builds the same tree
    own = init_model(tcfg, seed=1, device="cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(own)] == [
        (p, tuple(x.shape), x.dtype) for p, x in tp]
    back = to_numpy_tree(tparams)
    for (p, a), (_, b) in zip(tree_paths(back), jax_tree_paths(to_numpy(jparams))):
        np.testing.assert_array_equal(a, as_np(b), err_msg=p)


NEW_FAMILIES = ["qwen2-moe-a2.7b", "grok-1-314b", "recurrentgemma-9b",
                "xlstm-1.3b"]
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_param_tree_matches_for_moe_and_hybrid(arch, dtype):
    """Paths, shapes and dtypes of the converted tree and of the port's own
    initialiser against the reference's, the leaves the reference keeps in
    float32 under a bfloat16 config included; values round-trip."""
    jcfg, jparams, tcfg, tparams = make_pair(arch, dtype=dtype)
    jp, tp = jax_tree_paths(jparams), tree_paths(tparams)
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert [(tuple(x.shape), x.dtype) for _, x in tp] == [
        (tuple(x.shape), _TORCH_DTYPES[str(x.dtype)]) for _, x in jp]
    own = init_model(tcfg, seed=1, device="cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(own)] == [
        (p, tuple(x.shape), x.dtype) for p, x in tp]
    back = to_numpy_tree(tparams)
    for (p, a), (_, b) in zip(tree_paths(back),
                              jax_tree_paths(to_numpy(jparams))):
        np.testing.assert_array_equal(a, as_np(b), err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_leaves_dense_trees_as_they_were(arch, dtype):
    """Keeping each leaf's own dtype changes nothing in a dense config:
    every floating leaf still comes out in the config's dtype, with the
    values a cast of the reference's leaf to that dtype gives."""
    jcfg, jparams, tcfg, tparams = make_pair(arch, dtype=dtype)
    want = _TORCH_DTYPES[dtype]
    for (p, t), (_, x) in zip(tree_paths(tparams),
                              jax_tree_paths(to_numpy(jparams))):
        assert t.dtype == want, p
        assert torch.equal(t, torch.tensor(as_np(x)).to(want)), p


def test_init_is_seeded_and_scaled():
    _, _, tcfg, _ = make_pair("llama3-8b")
    a = init_model(tcfg, seed=3, device="cpu")
    b = init_model(tcfg, seed=3, device="cpu")
    c = init_model(tcfg, seed=4, device="cpu")
    for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), p
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    wq = a["blocks"]["0"]["attn"]["wq"]
    assert wq.shape == (2, 64, 4, 16) and abs(wq.std().item() - 0.02) < 2e-3
    wo = a["blocks"]["0"]["attn"]["wo"]             # fan-in over the heads axis
    assert abs(wo.std().item() - 0.5) < 5e-2
    assert (a["blocks"]["0"]["ln1"]["scale"] == 1).all()
    bf = init_model(dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    assert all(x.dtype == torch.bfloat16 for _, x in tree_paths(bf))


def test_normal_init_draws_a_stacked_leaf_slice_by_slice(monkeypatch):
    """A leaf larger than ``DRAW_ELEMS`` is drawn a few leading-axis slices
    at a time into a tensor of the target dtype: no float32 draw holds more
    than ``max(DRAW_ELEMS, one slice)`` elements, and the leaf comes out of
    the right shape, dtype and scale, the same for the same seed."""
    from repro_torch.models import common
    draws = []
    randn = torch.randn

    def counted(shape, **kw):
        draws.append(int(np.prod(shape)))
        return randn(shape, **kw)

    monkeypatch.setattr(common, "DRAW_ELEMS", 5000)
    monkeypatch.setattr(torch, "randn", counted)
    shape = (6, 40, 50)                            # slices of 2000 elements
    for dtype in (torch.bfloat16, torch.float32):
        draws.clear()
        w = common.normal_init(common.make_generator(0, "cpu"), shape, dtype)
        assert tuple(w.shape) == shape and w.dtype == dtype
        assert draws == [4000, 4000, 4000]         # two slices a draw
        assert abs(w.float().std().item() - 0.02) < 1e-3
        again = common.normal_init(common.make_generator(0, "cpu"), shape,
                                   dtype)
        assert torch.equal(w, again)
    draws.clear()
    big = common.normal_init(common.make_generator(1, "cpu"), (3, 80, 80),
                             torch.bfloat16)        # one slice above the cap
    assert draws == [6400] * 3
    fan = common.fan_in_init(common.make_generator(2, "cpu"), (4, 64, 100),
                             torch.bfloat16, fan_axis=1)
    assert abs(fan.float().std().item() - 0.125) < 5e-3
    assert big.dtype == torch.bfloat16 and max(draws) == 6400


# ---------------------------------------------------------------------------
# modules, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_norm(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.1)
    (jb, tb), (x, jx) = _block0(jparams, tparams), _acts(1, (2, 7, 64))
    np.testing.assert_allclose(
        _np(layers.apply_norm(tb["ln1"], 3 * x + 1, tcfg.norm)),
        _np(jax_layers.apply_norm(jb["ln1"], 3 * jx + 1, jcfg.norm)), **TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_bf16(kind):
    x, jx = _acts(2, (2, 5, 64), "bfloat16")
    rng = np.random.default_rng(0)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    jp = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16) for k, v in tp.items()}
    out = layers.apply_norm(tp, x, kind)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jax_layers.apply_norm(jp, jx, kind)),
                               **TOL_BF16)


def test_apply_rope():
    x, jx = _acts(3, (2, 9, 4, 16))
    pos = np.random.default_rng(3).integers(0, 500, (2, 9))
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            _np(layers.apply_rope(x, torch.from_numpy(pos), theta)),
            _np(jax_layers.apply_rope(jx, jnp.asarray(pos), theta)), **TOL)
    np.testing.assert_allclose(_np(layers.rope_frequencies(16, 1e4)),
                               _np(jax_layers.rope_frequencies(16, 1e4)),
                               rtol=1e-6)
    xb, jxb = _acts(3, (1, 4, 2, 16), "bfloat16")
    p4 = torch.arange(4)[None]
    np.testing.assert_allclose(
        _np(layers.apply_rope(xb, p4, 1e4)),
        _np(jax_layers.apply_rope(jxb, jnp.arange(4)[None], 1e4)), **TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mlp(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch)
    (jb, tb), (x, jx) = _block0(jparams, tparams), _acts(4, (2, 6, 64))
    np.testing.assert_allclose(
        _np(layers.apply_mlp(tb["mlp"], x, tcfg.activation)),
        _np(jax_layers.apply_mlp(jb["mlp"], jx, jcfg.activation)), **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_apply_mlp_activations(activation):
    """All four activations (gelu is the tanh approximation), f32 and bf16."""
    rng = np.random.default_rng(5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    x, jx = _acts(5, (2, 3, 32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(_np(layers.apply_mlp(tp, x, activation)),
                               _np(jax_layers.apply_mlp(jp, jx, activation)),
                               **TOL)
    tpb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    jpb = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16) for k, v in tpb.items()}
    xb, jxb = _acts(5, (2, 3, 32), "bfloat16")
    out = layers.apply_mlp(tpb, xb, activation)
    assert out.dtype == torch.bfloat16
    ref = _np(jax_layers.apply_mlp(jpb, jxb, activation))
    np.testing.assert_allclose(_np(out), ref, rtol=3e-2,
                               atol=3e-2 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_and_out_project(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.05)
    (jb, tb), (x, jx) = _block0(jparams, tparams), _acts(6, (2, 5, 64))
    pos = np.broadcast_to(np.arange(5), (2, 5))
    tq = attn.qkv_project(tb["attn"], x, torch.from_numpy(pos.copy()),
                          tcfg.rope_theta)
    jq = jax_attn.qkv_project(jb["attn"], jx, jnp.asarray(pos), jcfg.rope_theta)
    for a, b in zip(tq, jq):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(attn.out_project(tb["attn"], tq[0])),
                               _np(jax_attn.out_project(jb["attn"], jq[0])),
                               **TOL)


def test_attention_calls_match_reference():
    """The model-facing calls (routed to the kernel wrappers) against the
    reference's pure-jnp attention that its models call."""
    (q, jq), (k, jk), (v, jv) = (_acts(7, (2, 40, 4, 16)),
                                 _acts(8, (2, 40, 2, 16)),
                                 _acts(9, (2, 40, 2, 16)))
    want = _np(jax_attn.blocked_attention(jq, jk, jv, causal=True,
                                          block_q=16, block_kv=16))
    np.testing.assert_allclose(_np(attn.prefill_attention(q, k, v)), want, **TOL)
    np.testing.assert_allclose(_np(attn.naive_attention(q, k, v)),
                               _np(jax_attn.naive_attention(jq, jk, jv)), **TOL)
    np.testing.assert_allclose(
        _np(attn.naive_attention(q, k, v, window=8, q_offset=0)),
        _np(jax_attn.naive_attention(jq, jk, jv, window=8)), **TOL)
    for cur in (7, np.array([3, 40])):
        tcur = cur if isinstance(cur, int) else torch.from_numpy(cur)
        np.testing.assert_allclose(
            _np(attn.decode_attention(q[:, 0], k, v, tcur)),
            _np(jax_attn.decode_attention(jq[:, 0], jk, jv, jnp.asarray(cur))),
            **TOL)
    # sliding-window layers (ring-buffer caches): valid length min(cur, 8)
    for cur in (5, np.array([3, 40])):
        tcur = cur if isinstance(cur, int) else torch.from_numpy(cur)
        np.testing.assert_allclose(
            _np(attn.decode_attention(q[:, 0], k[:, :8], v[:, :8], tcur,
                                      window=8)),
            _np(jax_attn.decode_attention(jq[:, 0], jk[:, :8], jv[:, :8],
                                          jnp.asarray(cur), window=8)), **TOL)
    np.testing.assert_allclose(
        _np(attn.prefill_attention(q, k, v, window=8)),
        _np(jax_attn.blocked_attention(jq, jk, jv, causal=True, window=8,
                                       block_q=16, block_kv=16)), **TOL)


def test_update_kv_cache_scalar_and_per_slot():
    rng = np.random.default_rng(10)
    kc = torch.zeros(3, 12, 2, 16, dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    jkc, jvc = jnp.zeros((3, 12, 2, 16), jnp.bfloat16), jnp.zeros((3, 12, 2, 16), jnp.bfloat16)
    kn, jkn = _acts(11, (3, 5, 2, 16))              # f32 new entries: cast first
    k2, v2 = attn.update_kv_cache(kc, vc, kn, kn * 2, 0)
    assert k2 is kc and v2 is vc and kc.dtype == torch.bfloat16   # in place
    jkc, jvc = jax_attn.update_kv_cache(jkc, jvc, jkn, jkn * 2, jnp.int32(0))
    k1, jk1 = _acts(12, (3, 1, 2, 16))
    pos = np.array([5, 0, 11])
    attn.update_kv_cache(kc, vc, k1, -k1, torch.from_numpy(pos))
    jkc, jvc = jax_attn.update_kv_cache(jkc, jvc, jk1, -jk1, jnp.asarray(pos))
    np.testing.assert_array_equal(_np(kc), _np(jkc))
    np.testing.assert_array_equal(_np(vc), _np(jvc))
    # a ring buffer of 4 slots: a prefill's last 4 entries at pos % 4, then
    # per-slot and shared positions wrapping it
    rc, rv = torch.zeros(3, 4, 2, 16), torch.zeros(3, 4, 2, 16)
    jrc, jrv = jnp.zeros((3, 4, 2, 16)), jnp.zeros((3, 4, 2, 16))
    attn.update_kv_cache(rc, rv, kn[:, 1:], -kn[:, 1:], 1, window=4)
    jrc, jrv = jax_attn.update_kv_cache(jrc, jrv, jkn[:, 1:], -jkn[:, 1:],
                                        jnp.int32(1), window=4)
    attn.update_kv_cache(rc, rv, k1, 3 * k1, torch.from_numpy(pos), window=4)
    jrc, jrv = jax_attn.update_kv_cache(jrc, jrv, jk1, 3 * jk1,
                                        jnp.asarray(pos), window=4)
    attn.update_kv_cache(rc, rv, k1, k1, 6, window=4)
    jrc, jrv = jax_attn.update_kv_cache(jrc, jrv, jk1, jk1, jnp.int32(6),
                                        window=4)
    np.testing.assert_array_equal(_np(rc), _np(jrc))
    np.testing.assert_array_equal(_np(rv), _np(jrv))


def test_head_tied_untied_and_softcap():
    x, jx = _acts(13, (2, 3, 32))
    w = np.random.default_rng(13).standard_normal((32, 50)).astype(np.float32)
    for softcap in (0.0, 5.0):
        np.testing.assert_allclose(
            _np(layers.apply_head({"w": torch.from_numpy(w)}, x, None, softcap)),
            _np(jax_layers.apply_head({"w": jnp.asarray(w)}, jx, None, softcap)),
            **TOL)
        np.testing.assert_allclose(
            _np(layers.apply_head(None, x, {"tok": torch.from_numpy(w.T.copy())},
                                  softcap)),
            _np(jax_layers.apply_head(None, jx, {"tok": jnp.asarray(w.T)},
                                      softcap)), **TOL)
    xb, jxb = _acts(13, (2, 3, 32), "bfloat16")
    wb = torch.from_numpy(w).to(torch.bfloat16)
    out = layers.apply_head({"w": wb}, xb)
    assert out.dtype == torch.float32                       # f32 logits
    ref = jax_layers.apply_head({"w": jnp.asarray(_np(wb)).astype(jnp.bfloat16)}, jxb)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tokens(seed, shape, vocab=256):
    t = np.random.default_rng(seed).integers(2, vocab, shape)
    return torch.from_numpy(t), jnp.asarray(t, jnp.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.05)
    toks, jtoks = _tokens(20, (2, 24))
    h = transformer.forward(tparams, tcfg, toks)[0]
    jh, _ = jax_tf.forward(jparams, jcfg, jtoks)
    assert tuple(h.shape) == (2, 24, 64)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    np.testing.assert_allclose(_np(transformer.lm_logits(tparams, tcfg, h)),
                               _np(jax_tf.lm_logits(jparams, jcfg, jh)), **TOL)


def _compare_caches(tc, jc, upto: int):
    """The port writes K/V straight into the caches and leaves what lies
    beyond the written positions alone, so caches are compared over
    ``[:upto]`` only."""
    for pos in jc["groups"]:
        for n in ("k", "v"):
            np.testing.assert_allclose(
                _np(tc["groups"][pos][n][:, :, :upto]),
                _np(jc["groups"][pos][n][:, :, :upto]), **TOL)
    assert set(tc["rem"]) == set(jc["rem"])


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps(arch, per_slot):
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.05)
    B, S, L = 2, 11, 20
    toks, jtoks = _tokens(21, (B, S))
    logits, caches = serve_prefill(tparams, tcfg, {"tokens": toks}, max_len=L)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks, max_len=L)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, 256)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert tuple(caches["groups"]["0"]["k"].shape) == (2, B, L, tcfg.n_kv_heads, 16)
    _compare_caches(caches, jcaches, S)
    for step in range(3):
        nxt, jnxt = _tokens(30 + step, (B,))
        if per_slot:
            pos, jpos = torch.full((B,), S + step), jnp.full((B,), S + step)
        else:
            pos, jpos = S + step, jnp.int32(S + step)
        logits, caches2 = serve_decode(tparams, tcfg, nxt, pos, caches)
        assert caches2 is caches                              # in place
        jlogits, jcaches = jax_tf.decode_step(jparams, jcfg, jnxt, jpos, jcaches)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        _compare_caches(caches, jcaches, S + step + 1)


def test_decode_with_ragged_per_slot_positions():
    """Slots at different positions in one batched step, as the server
    decodes them: each row equals that request decoded alone."""
    jcfg, jparams, tcfg, tparams = make_pair("llama3-8b")
    L, lens = 24, [5, 13, 9]
    caches = transformer.init_caches(tcfg, 3, L, device="cpu")
    jcaches = jax_tf.init_caches(jcfg, 3, L)
    for slot, n in enumerate(lens):
        toks, jtoks = _tokens(40 + slot, (1, n))
        transformer.prefill(tparams, tcfg, toks, caches=caches, slot=slot)
        _, one = jax_tf.prefill(jparams, jcfg, jtoks, max_len=L)
        jcaches = jax.tree.map(
            lambda full, o: full.at[:, slot].set(o[:, 0]), jcaches, one)
    nxt, jnxt = _tokens(50, (3,))
    logits, _ = transformer.decode_step(tparams, tcfg, nxt,
                                        torch.tensor(lens), caches)
    jlogits, _ = jax_tf.decode_step(jparams, jcfg, jnxt,
                                    jnp.asarray(lens, jnp.int32), jcaches)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_prefill_then_decode_equals_forward(arch):
    """Inside the port: prefill of a prefix, then one decode step per
    remaining token, gives the logits of a full-sequence forward."""
    _, _, tcfg, tparams = make_pair(arch)
    toks, _ = _tokens(60, (2, 16))
    full = transformer.lm_logits(tparams, tcfg,
                                 transformer.forward(tparams, tcfg, toks)[0])
    logits, caches = transformer.prefill(tparams, tcfg, toks[:, :10], max_len=16)
    np.testing.assert_allclose(_np(logits), _np(full[:, 9]), **TOL)
    for t in range(10, 16):
        logits, caches = transformer.decode_step(tparams, tcfg, toks[:, t], t,
                                                 caches)
        np.testing.assert_allclose(_np(logits), _np(full[:, t]), **TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_model_bf16(arch):
    """cfg.dtype as published (bfloat16): prefill and one decode step."""
    jcfg, jparams, tcfg, tparams = make_pair(arch, dtype="bfloat16")
    assert tparams["embed"]["tok"].dtype == torch.bfloat16
    toks, jtoks = _tokens(70, (2, 12))
    logits, caches = transformer.prefill(tparams, tcfg, toks, max_len=16)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks, max_len=16)
    assert caches["groups"]["0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL_BF16)
    nxt, jnxt = _tokens(71, (2,))
    logits, _ = transformer.decode_step(tparams, tcfg, nxt, 12, caches)
    jlogits, _ = jax_tf.decode_step(jparams, jcfg, jnxt, jnp.int32(12), jcaches)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL_BF16)
