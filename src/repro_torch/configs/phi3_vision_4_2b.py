"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct; hf].

phi3-mini backbone (32L, d_model=3072, 32H MHA, d_ff=8192, vocab=32064) +
CLIP vision frontend stub: the batch carries 576 precomputed patch
embeddings, prepended to the token sequence (``models.model.batch_struct``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    mlp="swiglu", frontend="vision", num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                          d_ff=128, vocab_size=512, num_patches=4, remat=False)
