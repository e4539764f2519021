"""``--arch <id>`` registry over the assigned architecture configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME, ArchConfig,
                                ShapeConfig)

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "nemotron-4-340b": "repro_torch.configs.nemotron4_340b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown --arch {arch_id!r}; choose from {ARCH_IDS}")
    cfg = importlib.import_module(_MODULES[arch_id]).CONFIG
    assert cfg.name == arch_id, (cfg.name, arch_id)
    return cfg


def get_shape(shape_name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[shape_name]


def all_cells() -> list[tuple[ArchConfig, ShapeConfig]]:
    """All 40 (arch x shape) assignment cells, including documented skips."""
    return [(get_config(a), s) for a in ARCH_IDS for s in ALL_SHAPES]


def runnable_cells() -> list[tuple[ArchConfig, ShapeConfig]]:
    return [(c, s) for c, s in all_cells() if c.shape_applicable(s)[0]]
