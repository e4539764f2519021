"""olmo-1b — dense MHA with non-parametric LayerNorm, tied embeddings
[arXiv:2402.00838]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838 (OLMo)",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    activation="swiglu",
    norm="nonparam_ln",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attention_class="quadratic",
)
