"""The port's mixture-of-experts layer and MoE decoders against the JAX
package's, on the CPU.

Parameters are initialised by the JAX package and converted leaf by leaf;
activations and tokens are made from a numpy seed and handed to both sides.
float32 on both sides: ``2e-5`` for the layer (matrix products and an f32
combine, summed in another order), ``2e-3`` for the whole models (many
layers and attention); one bfloat16 case ``3e-2``.  Routing is compared
exactly: the same experts, in the same order, and the same drops.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_np, assert_caches_close, make_pair, normal_pair
from repro.configs.registry import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.configs.registry import get_config
from repro_torch.models import moe, transformer

LAYER = dict(rtol=2e-5, atol=2e-5)
MODEL = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=3e-2, atol=3e-2)
ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b"]


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """``make_pair``, made once per case (no test changes the params)."""
    return make_pair(arch, dtype=dtype, jitter=0.05)


def _layer(arch, dtype="float32"):
    jcfg, jparams, tcfg, tparams = _pair(arch, dtype)
    jb = jax.tree.map(lambda x: x[0], jparams["blocks"]["0"]["moe"])
    tb = transformer._layer(tparams["blocks"]["0"]["moe"], 0)
    return jcfg, jb, tcfg, tb


def _tokens(seed, shape):
    t = np.random.default_rng(seed).integers(2, 256, shape).astype(np.int32)
    return torch.from_numpy(t).long(), jnp.asarray(t)


@pytest.mark.parametrize("n", [1, 7, 40, 1000, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch, n):
    """Full and reduced configs; a decode step (one token a row) has 8."""
    for reduce in (False, True):
        jc, tc = jax_get_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert moe._capacity(n, tc.moe) == jax_moe._capacity(n, jc.moe)
    assert moe._capacity(1, get_config(arch).moe) == 8


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, capacity_factor):
    """Output and both aux losses; at a capacity factor of 0.3 some experts
    overflow, and the drops (by the stable sort's order) must match."""
    jcfg, jb, tcfg, tb = _layer(arch)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor)
    x, jx = normal_pair(np.random.default_rng(1), (3, 24, 64))
    out, (lb, zl), ids = moe.apply_moe(tb, x, tm, return_ids=True)
    jout, (jlb, jzl) = jax_moe.apply_moe(jb, jx, jm)
    np.testing.assert_allclose(as_np(out), as_np(jout), **LAYER)
    np.testing.assert_allclose(float(lb), float(jlb), **LAYER)
    np.testing.assert_allclose(float(zl), float(jzl), **LAYER)
    per_expert = torch.nn.functional.one_hot(ids, tm.n_experts).sum((1, 2))
    dropped = bool((per_expert > moe._capacity(24, tm)).any())
    assert dropped == (capacity_factor < 1)


def test_apply_moe_flat_tokens_and_decode_shape():
    """[T,D] input (one group of all tokens) and a decode step's [B,1,D]
    (capacity 8 a row)."""
    jcfg, jb, tcfg, tb = _layer("qwen2-moe-a2.7b")
    rng = np.random.default_rng(2)
    for shape in ((17, 64), (4, 1, 64)):
        x, jx = normal_pair(rng, shape)
        out, _ = moe.apply_moe(tb, x, tcfg.moe)
        jout, _ = jax_moe.apply_moe(jb, jx, jcfg.moe)
        assert tuple(out.shape) == shape
        np.testing.assert_allclose(as_np(out), as_np(jout), **LAYER)


def test_routing_replay():
    """Replaying a call's own routing gives its output bit for bit; another
    routing gives another output; the gates stay this call's."""
    _, _, tcfg, tb = _layer("grok-1-314b")
    x, _ = normal_pair(np.random.default_rng(3), (2, 10, 64))
    out, aux, ids = moe.apply_moe(tb, x, tcfg.moe, return_ids=True)
    again, aux2 = moe.apply_moe(tb, x, tcfg.moe, expert_ids=ids)
    assert torch.equal(out, again)
    assert float(aux[0]) == float(aux2[0])
    other, _ = moe.apply_moe(tb, x, tcfg.moe, expert_ids=ids.flip(-1) * 0)
    assert not torch.allclose(out, other)


def test_apply_moe_bf16():
    jcfg, jb, tcfg, tb = _layer("qwen2-moe-a2.7b", "bfloat16")
    x, jx = normal_pair(np.random.default_rng(4), (2, 16, 64), "bfloat16")
    out, _ = moe.apply_moe(tb, x, tcfg.moe)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(out),
                               as_np(jax_moe.apply_moe(jb, jx, jcfg.moe)[0]),
                               **BF16)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_forward_prefill_and_three_decode_steps(arch, per_slot):
    """Hidden states of ``forward``; logits and K/V of ``prefill`` and three
    ``decode_step``s."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    B, S, L = 2, 13, 20
    toks, jtoks = _tokens(10, (B, S))
    h = transformer.forward(tparams, tcfg, toks)[0]
    jh, _ = jax_tf.forward(jparams, jcfg, jtoks)
    np.testing.assert_allclose(as_np(h), as_np(jh), **MODEL)
    logits, caches = transformer.prefill(tparams, tcfg, toks, max_len=L)
    jlogits, jcaches = jax_tf.prefill(jparams, jcfg, jtoks, max_len=L)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **MODEL)
    assert_caches_close(caches, jcaches, tcfg, upto=S, **MODEL)
    for step in range(3):
        nxt, jnxt = _tokens(11 + step, (B,))
        pos = S + step
        tp, jp = ((torch.full((B,), pos), jnp.full((B,), pos)) if per_slot
                  else (pos, jnp.int32(pos)))
        logits, _ = transformer.decode_step(tparams, tcfg, nxt, tp, caches)
        jlogits, jcaches = jax_tf.decode_step(jparams, jcfg, jnxt, jp, jcaches)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **MODEL)
        assert_caches_close(caches, jcaches, tcfg, upto=pos + 1, **MODEL)
