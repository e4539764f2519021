"""grok-1-314b — MoE with 8 experts, top-2 routing [hf:xai-org/grok-1].

8 experts < 16-way ``model`` axis, so the default is TP-within-expert
(d_ff 32768 sharded 16-way per expert); EP mode would pad 8 -> 16 (2x waste).
Grok-style tanh logit soft-capping at 30.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    logit_softcap=30.0,
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        n_shared_experts=0,
        expert_d_ff=32768,
        capacity_factor=1.25,
        parallelism="tp",
    ),
    attention_class="quadratic",
    moment_dtype="int8",
)
