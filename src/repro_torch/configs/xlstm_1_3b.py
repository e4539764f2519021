"""xlstm-1.3b — sLSTM + mLSTM block stack [arXiv:2405.04517].

xLSTM[7:1] ratio: 7 mLSTM blocks per sLSTM block, cyclic; 48 layers = 6 full
periods.  Attention-free (recurrent state decode, O(1) per token) so the
``long_500k`` cell runs.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # mLSTM/sLSTM blocks carry their own FFN paths
    vocab_size=50304,
    norm="rmsnorm",
    hybrid=HybridConfig(pattern=("mlstm",) * 7 + ("slstm",), conv_width=4),
    attention_class="subquadratic",
)
