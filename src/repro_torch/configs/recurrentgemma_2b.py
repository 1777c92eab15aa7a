"""recurrentgemma-2b [arXiv:2402.19427; hf] - RG-LRU + local attention, 1:2.

26L, d_model=2560, 10H MQA (kv=1), d_ff=7680 (GeGLU), vocab=256000,
pattern = 2 recurrent blocks : 1 local-attention block (window 2048).
Sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    mlp="geglu", window=2048, lru_width=2560, conv_width=4,
    block_pattern=("rglru", "rglru", "local_attn"),
    head_dim=256,
    source="arXiv:2402.19427",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                          d_ff=128, vocab_size=512, lru_width=64, window=8,
                          head_dim=16, remat=False)
