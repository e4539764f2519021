"""llava-next-34b — VLM backbone (Yi-34B-class decoder) with anyres tiling
frontend STUB [hf:llava-hf/llava-v1.6-mistral-7b-hf family].

Per the assignment the modality frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings [B, S, d_model]; the vision tower/anyres tiler is
out of scope.  ``vlm_proj`` (the multimodal projector) is real.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-34b (Yi-34B backbone)",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    frontend="patch_stub",
    attention_class="quadratic",
)
