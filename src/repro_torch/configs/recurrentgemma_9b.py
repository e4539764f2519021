"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2
attention:recurrence ratio [arXiv:2402.19427].

Pattern (rec, rec, attn) cyclic; 38 layers = 12 periods + 2 remainder rec
blocks.  Local attention window 2048, MQA (1 KV head).  Sub-quadratic
(recurrent state + bounded window) so the ``long_500k`` cell runs.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin) / RecurrentGemma-9B",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    hybrid=HybridConfig(
        pattern=("rec", "rec", "attn"),
        window=2048,
        lru_width=4096,
        conv_width=4,
    ),
    attention_class="subquadratic",
)
