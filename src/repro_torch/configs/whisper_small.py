"""whisper-small — encoder-decoder with conv frontend STUB [arXiv:2212.04356].

Per the assignment the mel/conv frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings [B, 1500, d_model] (30 s of audio after the 2x
conv downsampling).  Decoder context is 448 tokens by construction, so
decode_32k / long_500k are skipped (documented skip).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356 (Whisper)",
    n_layers=12,                  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    is_encoder_decoder=True,
    n_encoder_layers=12,
    max_source_positions=1500,
    frontend="frame_stub",
    attention_class="quadratic",
)
