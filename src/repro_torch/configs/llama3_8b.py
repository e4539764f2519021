"""llama3-8b — dense GQA with 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783 (Llama 3 herd)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    attention_class="quadratic",
)
