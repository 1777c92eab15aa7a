"""xlstm-1.3b [arXiv:2405.04517; unverified] - sLSTM + mLSTM blocks, 7:1.

48 blocks, d_model=2048, 4 heads, no separate FFN (xLSTM blocks embed their
own up/down projections), vocab=50304.  Attention-free -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    mlp="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    source="arXiv:2405.04517",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
                          vocab_size=512, remat=False)
