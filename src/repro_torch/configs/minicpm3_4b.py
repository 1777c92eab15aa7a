"""minicpm3-4b [hf:openbmb/MiniCPM3-4B; hf] - multi-head latent attention.

62L, d_model=2560, 40H, d_ff=6400, vocab=73448.  MLA dims follow the HF
config: q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v=64.
The block pattern is the default ``("attn",)``, as in the JAX package,
whose blocks read ``cfg.mla`` only in the ``"mla"`` kind: the registered
config builds plain attention, ``replace(block_pattern=("mla",))`` the
latent form.
"""
from repro_torch.configs.base import MLACfg, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attention="mla",
    mla=MLACfg(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
               qk_rope_head_dim=32, v_head_dim=64),
    mlp="swiglu",
    source="hf:openbmb/MiniCPM3-4B",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                          d_ff=128, vocab_size=512, remat=False,
                          mla=MLACfg(q_lora_rank=32, kv_lora_rank=16,
                                     qk_nope_head_dim=8, qk_rope_head_dim=8,
                                     v_head_dim=8))
