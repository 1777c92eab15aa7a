"""veloc-demo-100m - in-house ~100M dense LM for the end-to-end examples
(train a few hundred steps on CPU with full VELOC checkpointing)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="veloc-demo-100m", family="dense",
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=32000,
    mlp="swiglu", remat=False,
    source="in-house demo",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                          d_ff=128, vocab_size=512)
