"""qwen2-moe-a2.7b — MoE with 60 routed experts (top-4) + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Expert parallelism over the ``model`` axis (60 experts) in the reference;
the port serves it on one card (``repro_torch/models/moe.py``).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared_experts=4,
        expert_d_ff=1408,
        shared_d_ff=1408,
        capacity_factor=1.25,
        parallelism="ep",
    ),
    attention_class="quadratic",
)
