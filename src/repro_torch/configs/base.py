"""Model / run configuration system.

Every ported architecture provides a ``ModelConfig`` in its own module
(``src/repro_torch/configs/<arch>.py``) built from the exact published numbers.
``SHAPES`` defines the four assigned input-shape cells shared by all
LM-family archs.  ``get_config(name)`` / ``list_configs()`` form the registry
used by ``--arch`` flags throughout the launchers, benchmarks and tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes (identical across archs; decode/long lower
# serve_step with a KV cache of seq_len, not train_step).
SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    experts_per_token: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention (DeepSeek/MiniCPM3 style)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention flavour ---
    attention: str = "full"  # full | mla | local | none
    window: int = 0  # local-attention window
    causal: bool = True
    mla: Optional[MLACfg] = None
    # --- MoE ---
    moe: Optional[MoECfg] = None
    # --- block pattern for hybrid / mixed stacks ---
    # tuple of block kinds, cycled across the stack; default single kind.
    block_pattern: tuple[str, ...] = ("attn",)
    # --- mlp flavour: swiglu | geglu | relu2 | gelu | none ---
    mlp: str = "swiglu"
    # --- encoder/decoder ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    dec_max_len: int = 448  # decoder context for enc-dec archs (whisper)
    # --- modality frontend stub ---
    frontend: str = "none"  # none | audio | vision
    num_patches: int = 0  # vision: patch-embedding count prepended to text
    # --- recurrent (xLSTM / RG-LRU) ---
    lru_width: int = 0
    conv_width: int = 4
    # --- numerics / embedding ---
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"  # bf16 for the trillion-param configs
    # --- distribution ---
    fsdp: bool = False  # shard params' d_model dim over the data axes
    remat: bool = True
    # metadata
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # vocab padded so the logits dim shards evenly over 16-way model axis
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow quadratically with context
        (recurrent / local-attention archs) -> long_500k applies."""
        kinds = set(self.block_pattern)
        return "attn" not in kinds and "cross" not in kinds or (
            kinds <= {"local_attn", "rglru", "mlstm", "slstm"}
        )

    def supports_shape(self, shape: ShapeCfg) -> tuple[bool, str]:
        """Whether an assigned shape cell applies to this arch (skips are
        recorded, per DESIGN.md SS4)."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "full-attention arch: long_500k needs sub-quadratic attention"
        return True, ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter count (exact, from the layer math) for MODEL_FLOPS=6*N*D.
    # ------------------------------------------------------------------
    def param_counts(self) -> dict[str, float]:
        from repro_torch.models.model import count_params  # no import cycle

        return count_params(self)


#: The ported configurations: every architecture of the JAX package's
#: registry, the dense (minicpm3-4b's MLA among them), MoE, recurrent,
#: encoder-decoder and vision-stub families.
_REGISTRY = {
    "veloc-demo-100m": "veloc_demo_100m",
    "minitron-8b": "minitron_8b",
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minicpm3-4b": "minicpm3_4b",
    "grok-1-314b": "grok1_314b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-medium": "whisper_medium",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}


def list_configs() -> list[str]:
    return list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.smoke()
