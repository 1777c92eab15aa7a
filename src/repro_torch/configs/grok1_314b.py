"""grok-1-314b [hf:xai-org/grok-1; unverified] - 8-expert top-2 MoE.

64L, d_model=6144, 48H GQA kv=8, expert d_ff=32768, vocab=131072.
FSDP + bf16 optimizer state required to fit pod HBM (DESIGN.md SS3).
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    mlp="geglu",
    moe=MoECfg(num_experts=8, experts_per_token=2, d_ff=32768),
    fsdp=True, param_dtype="bfloat16", opt_dtype="bfloat16",
    source="hf:xai-org/grok-1",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          d_ff=128, vocab_size=512, fsdp=False, remat=False,
                          param_dtype="float32", opt_dtype="float32",
                          moe=MoECfg(num_experts=4, experts_per_token=2, d_ff=128))
