"""minitron-8b [arXiv:2407.14679; hf] - pruned Nemotron-4.

32L, d_model=4096, 32H GQA kv=8, d_ff=16384, vocab=256000.  Nemotron uses a
non-gated squared-ReLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    mlp="relu2", fsdp=True,
    source="arXiv:2407.14679",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          d_ff=128, vocab_size=512, fsdp=False, remat=False)
