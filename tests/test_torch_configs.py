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


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_unported_families_raise_naming_the_roadmap(arch):
    from repro_torch.models.registry import init_model
    cfg = torch_registry.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        init_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_moe_and_hybrid_families_are_served(arch):
    """MoE (ROADMAP A5) and hybrid / recurrent (A6) configs are ported:
    ``check_supported`` accepts them at full size and reduced."""
    from repro_torch.models.transformer import check_supported
    cfg = torch_registry.get_config(arch)
    check_supported(cfg)
    check_supported(cfg.reduced())
