"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified] - trillion-param MoE.

61L, d_model=7168, 64H GQA kv=8, per-expert d_ff=2048, vocab=163840,
MoE 384 experts top-8 (~32B active).  bf16 params + bf16 optimizer state;
does not fit a single v5e-256 pod with Adam - see EXPERIMENTS.md SSRoofline.
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    mlp="swiglu",
    moe=MoECfg(num_experts=384, experts_per_token=8, d_ff=2048),
    fsdp=True, param_dtype="bfloat16", opt_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          d_ff=64, vocab_size=512, fsdp=False, remat=False,
                          param_dtype="float32", opt_dtype="float32",
                          moe=MoECfg(num_experts=8, experts_per_token=2, d_ff=64))
