"""whisper-medium [arXiv:2212.04356; unverified] - enc-dec audio transformer.

24L per stack, d_model=1024, 16H MHA, d_ff=4096, vocab=51865.  The audio
(conv) frontend is a stub: the batch carries precomputed frame embeddings
(B, T_enc, d_model) (``models.model.batch_struct``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    mlp="gelu", is_encoder_decoder=True, enc_layers=24,
    frontend="audio", dec_max_len=448,
    source="arXiv:2212.04356",
)

def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, enc_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, d_ff=128, vocab_size=512, dec_max_len=16,
                          remat=False)
