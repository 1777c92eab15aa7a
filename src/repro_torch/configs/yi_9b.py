"""yi-9b [arXiv:2403.04652; hf] - llama-arch GQA.

48L, d_model=4096, 32H GQA kv=4, d_ff=11008, vocab=64000, SwiGLU + RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    mlp="swiglu", fsdp=True,
    source="arXiv:2403.04652",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          d_ff=128, vocab_size=512, fsdp=False, remat=False)
