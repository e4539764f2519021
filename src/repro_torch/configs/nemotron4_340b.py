"""nemotron-4-340b — dense GQA, squared-ReLU MLP [arXiv:2402.16819].

Largest dense config.  The config defaults to int8 block-quantized optimizer
moments, as in the reference package it was copied from.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819 (Nemotron-4 340B)",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="sq_relu",
    norm="layernorm",
    rope_theta=10_000.0,
    attention_class="quadratic",
    moment_dtype="int8",
)
