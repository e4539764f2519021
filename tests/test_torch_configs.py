"""The port's copy of the configs equals the reference's, field by field."""
import dataclasses

import pytest

from repro.configs import registry as jax_registry
from repro_torch.configs import registry as torch_registry

ARCHS = jax_registry.ARCH_IDS


def _fields(cfg):
    """Every dataclass field, nested configs flattened to plain dicts (the two
    packages have their own classes, so instances never compare equal)."""
    return dataclasses.asdict(cfg)


def test_arch_ids_match():
    assert torch_registry.ARCH_IDS == jax_registry.ARCH_IDS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch):
    ref, port = jax_registry.get_config(arch), torch_registry.get_config(arch)
    assert type(port).__module__.startswith("repro_torch.")
    assert _fields(port) == _fields(ref)
    assert port.head_dim == ref.head_dim and port.q_per_kv == ref.q_per_kv


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_fields_match(arch):
    ref = jax_registry.get_config(arch).reduced()
    port = torch_registry.get_config(arch).reduced()
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match(arch):
    ref, port = jax_registry.get_config(arch), torch_registry.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.reduced().param_count() == ref.reduced().param_count()


def test_shapes_and_cells_match():
    assert ([dataclasses.asdict(s) for s in torch_registry.ALL_SHAPES]
            == [dataclasses.asdict(s) for s in jax_registry.ALL_SHAPES])
    ref = [(c.name, s.name) for c, s in jax_registry.runnable_cells()]
    port = [(c.name, s.name) for c, s in torch_registry.runnable_cells()]
    assert port == ref


MOE_AND_HYBRID = ["qwen2-moe-a2.7b", "grok-1-314b", "recurrentgemma-9b",
                  "xlstm-1.3b"]


@pytest.mark.parametrize("arch", MOE_AND_HYBRID)
def test_moe_and_hybrid_families_are_served(arch):
    """MoE (ROADMAP A5) and hybrid / recurrent (A6) configs are ported: the
    registry initialises them and serves a prompt and a decode step."""
    import torch
    from repro_torch.models.registry import (init_model, serve_decode,
                                             serve_prefill)
    cfg = torch_registry.get_config(arch).reduced()
    params = init_model(cfg, device="cpu")
    toks = torch.arange(2, 12).reshape(2, 5)
    logits, caches = serve_prefill(params, cfg, {"tokens": toks}, max_len=8)
    logits, _ = serve_decode(params, cfg, logits.argmax(-1), 5, caches)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def _serve_batch(cfg, B, S):
    """The reference's smoke-test batch for each frontend: token ids, patch
    embeddings or frame embeddings (the latter two in bfloat16)."""
    import torch
    gen = torch.Generator().manual_seed(0)
    toks = torch.arange(2, 2 + B * S).reshape(B, S) % cfg.vocab_size
    embeds = torch.randn(B, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    if cfg.frontend == "patch_stub":
        return {"input_embeds": embeds}
    if cfg.frontend == "frame_stub":
        return {"frames": embeds.repeat(1, 7, 1), "tokens": toks}
    return {"tokens": toks}


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE_AND_HYBRID])
def test_reduced_serve_roundtrip(arch):
    """The dense, encoder-decoder (42 frames) and VLM (an embedding prompt)
    configs are served (MoE and hybrid: the test above): a prefill and a
    decode step give finite logits of the vocab's width (the port's
    counterpart of the reference's smoke test)."""
    import torch
    from repro_torch.models.registry import (init_model, serve_decode,
                                             serve_prefill)
    cfg = torch_registry.get_config(arch).reduced()
    params = init_model(cfg, device="cpu")
    logits, caches = serve_prefill(params, cfg, _serve_batch(cfg, 2, 6),
                                   max_len=16)
    assert logits.shape == (2, cfg.vocab_size)
    logits, _ = serve_decode(params, cfg, logits.argmax(-1), 6, caches)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
