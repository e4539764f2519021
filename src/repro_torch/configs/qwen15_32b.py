"""qwen1.5-32b — dense MHA (kv == q heads) with QKV bias [hf:Qwen/Qwen1.5-0.5B
family scaling].

40 heads do not divide evenly over a 16-way tensor-parallel axis; how the
port shards them is decided with the sharding slice.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B (family config, scaled per assignment)",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    attention_class="quadratic",
)
