"""The port's VLM backbone (llava-next-34b, reduced) against the JAX package's,
on the CPU: the multimodal projector ``vlm_proj`` and the ``input_embeds``
path through ``forward``, ``prefill`` and ``decode_step``, and the serving
engine on token prompts.

Parameters are initialised by the JAX package and converted leaf by leaf;
embeddings and tokens are made from a seed with numpy.  Float32 tolerance
``1e-4``, bfloat16 ``3e-2``, as in ``test_torch_models.py``.  The reduced
config keeps the published grouping's shape: 4 query heads on 1 KV head.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_port import as_np, assert_caches_close, make_pair, normal_pair
from repro.models import registry as jax_reg
from repro.models import transformer as jax_tf
from repro.models.common import tree_paths as jax_tree_paths
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import SlotServer as JaxSlotServer
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import transformer
from repro_torch.models.common import tree_paths
from repro_torch.models.registry import (init_model, serve_decode,
                                         serve_prefill)
from repro_torch.serve import ServeConfig, SlotServer

ARCH = "llava-next-34b"
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tokens(seed, shape):
    t = np.random.default_rng(seed).integers(2, 256, shape)
    return torch.from_numpy(t), jnp.asarray(t, jnp.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_has_the_projector_and_matches(dtype):
    """Paths (``vlm_proj/w`` [D, D] beside the decoder's), shapes and dtypes
    of the converted tree and of the port's own initialiser."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype=dtype)
    jp, tp = jax_tree_paths(jparams), tree_paths(tparams)
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert [(tuple(x.shape), x.dtype) for _, x in tp] == [
        (tuple(x.shape), _TORCH_DTYPES[str(x.dtype)]) for _, x in jp]
    assert tuple(tparams["vlm_proj"]["w"].shape) == (64, 64)
    own = init_model(tcfg, seed=1, device="cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(own)] == [
        (p, tuple(x.shape), x.dtype) for p, x in tp]
    assert abs(own["vlm_proj"]["w"].float().std().item() - 0.02) < 3e-3
    # a decoder without the frontend has no projector
    plain = init_model(get_config("llama3-8b").reduced(), device="cpu")
    assert "vlm_proj" not in plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_through_the_projector(dtype):
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype=dtype)
    x, jx = normal_pair(np.random.default_rng(1), (2, 7, 64), dtype)
    out = transformer.embed_inputs(tparams, tcfg, input_embeds=x)
    assert out.dtype == _TORCH_DTYPES[dtype]
    np.testing.assert_allclose(
        as_np(out), as_np(jax_tf.embed_inputs(jparams, jcfg, None, jx)),
        **(TOL if dtype == "float32" else TOL_BF16))
    # token ids take the embedding table, not the projector
    toks, jtoks = _tokens(2, (2, 7))
    np.testing.assert_array_equal(
        as_np(transformer.embed_inputs(tparams, tcfg, toks)),
        as_np(jax_tf.embed_inputs(jparams, jcfg, jtoks)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_through_input_embeds(dtype):
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype=dtype, jitter=0.05)
    x, jx = normal_pair(np.random.default_rng(3), (2, 21, 64), dtype)
    h = transformer.forward(tparams, tcfg, input_embeds=x)[0]
    jh, _ = jax_tf.forward(jparams, jcfg, input_embeds=jx)
    tol = TOL if dtype == "float32" else TOL_BF16
    assert tuple(h.shape) == (2, 21, 64)
    np.testing.assert_allclose(as_np(h), as_np(jh), **tol)
    np.testing.assert_allclose(as_np(transformer.lm_logits(tparams, tcfg, h)),
                               as_np(jax_tf.lm_logits(jparams, jcfg, jh)),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_three_decode_steps_through_input_embeds(dtype):
    """An embedding prompt [B,S,D] through ``serve_prefill``, then three
    decode steps each fed one embedding row [B,1,D] through
    ``decode_step``: logits and caches against the reference."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, dtype=dtype, jitter=0.05)
    tol = TOL if dtype == "float32" else TOL_BF16
    rng = np.random.default_rng(4)
    B, S, L = 2, 13, 20
    x, jx = normal_pair(rng, (B, S, 64), dtype)
    logits, caches = serve_prefill(tparams, tcfg, {"input_embeds": x},
                                   max_len=L)
    jlogits, jcaches = jax_reg.serve_prefill(jparams, jcfg,
                                             {"input_embeds": jx}, max_len=L)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **tol)
    assert_caches_close(caches, jcaches, tcfg, upto=S, **tol)
    for step in range(3):
        e, je = normal_pair(rng, (B, 1, 64), dtype)
        logits, caches2 = transformer.decode_step(tparams, tcfg, None,
                                                  S + step, caches,
                                                  input_embeds=e)
        assert caches2 is caches
        jlogits, jcaches = jax_tf.decode_step(jparams, jcfg, None,
                                              jnp.int32(S + step), jcaches,
                                              input_embeds=je)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **tol)
        assert_caches_close(caches, jcaches, tcfg, upto=S + step + 1, **tol)


def test_embedding_prompt_then_token_decode():
    """An image-like prompt of embeddings followed by text: prefill through
    ``input_embeds``, then token decode steps (``serve_decode``) at
    per-slot positions, against the reference."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    rng = np.random.default_rng(5)
    x, jx = normal_pair(rng, (2, 9, 64))
    _, caches = transformer.prefill(tparams, tcfg, None, input_embeds=x,
                                    max_len=16)
    _, jcaches = jax_tf.prefill(jparams, jcfg, None, input_embeds=jx,
                                max_len=16)
    for step in range(2):
        nxt, jnxt = _tokens(6 + step, (2,))
        pos = np.array([9 + step, 9 + step])
        logits, _ = serve_decode(tparams, tcfg, nxt, torch.from_numpy(pos),
                                 caches)
        jlogits, jcaches = jax_reg.serve_decode(jparams, jcfg, jnxt,
                                                jnp.asarray(pos), jcaches)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL)


def test_prefill_then_decode_equals_forward_on_embeddings():
    """Inside the port: prefill of a prefix of embeddings, then one decode
    step per remaining embedding row, gives a full forward's logits."""
    _, _, tcfg, tparams = make_pair(ARCH, jitter=0.05)
    x, _ = normal_pair(np.random.default_rng(8), (2, 12, 64))
    full = transformer.lm_logits(
        tparams, tcfg, transformer.forward(tparams, tcfg, input_embeds=x)[0])
    logits, caches = transformer.prefill(tparams, tcfg, None,
                                         input_embeds=x[:, :8], max_len=12)
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 7]), **TOL)
    for t in range(8, 12):
        logits, caches = transformer.decode_step(
            tparams, tcfg, None, t, caches, input_embeds=x[:, t:t + 1])
        np.testing.assert_allclose(as_np(logits), as_np(full[:, t]), **TOL)


def _drain(server, prompts, max_new):
    for p in prompts:
        server.submit(p, max_new_tokens=max_new)
    return [r.output for r in sorted(server.run_until_drained(),
                                     key=lambda r: r.rid)]


def test_greedy_tokens_identical_to_jax_slotserver():
    """Token prompts through both packages' ``SlotServer`` (which the
    reference serves llava with; ``vlm_proj`` is unused there): identical
    greedy streams in float32, five requests on two slots."""
    jcfg, jparams, tcfg, tparams = make_pair(ARCH)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, 200, int(rng.integers(4, 20))).astype(np.int32)
               for _ in range(5)]
    kw = dict(max_slots=2, max_len=40, max_new_tokens=7)
    jax_out = _drain(JaxSlotServer(jcfg, jparams,
                                   serve_cfg=JaxServeConfig(**kw)), prompts, 7)
    port_out = _drain(SlotServer(tcfg, tparams, serve_cfg=ServeConfig(**kw),
                                 device="cpu"), prompts, 7)
    assert port_out == jax_out
    assert all(len(o) == 7 or o[-1] == 1 for o in port_out)


def test_launcher_serves_llava_on_the_cpu():
    cfg = get_config(ARCH).reduced()
    done, lats = serve(cfg, n_requests=3, max_slots=2, max_len=32, max_new=3,
                       verbose=False, device="cpu")
    assert len(done) == 3 and len(lats) == 3
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.output)


def test_logit_spread_walks_every_route_on_the_cpu():
    """``tools/logit_spread.py`` on reduced llava on the CPU: the kernel
    route is the plain version there (no difference), the other roundings of
    the same attention stays within float32 noise of it, and the wrappers
    are restored afterwards."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    path = Path(__file__).resolve().parents[1] / "tools" / "logit_spread.py"
    spec = importlib.util.spec_from_file_location("logit_spread", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    spread = tool.spread
    before = d_ops.decode_attention_atom, f_ops.flash_attention_atom
    recs = spread(ARCH, [1, 2], 12, reduced=True, device="cpu")
    assert [r["layers"] for r in recs] == [1, 2]
    for r in recs:
        assert r["kernel_vs_plain"] == {"prefill": 0.0, "decode": 0.0}
        assert max(r["batched_vs_plain"].values()) < 1e-4
    assert (d_ops.decode_attention_atom, f_ops.flash_attention_atom) == before
