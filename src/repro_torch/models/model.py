"""Model dispatch: one API over the ported architectures (decoder-only:
dense, xLSTM, RG-LRU hybrids).

  init_model          params on an explicit device
  make_loss_fn        (params, batch) -> scalar loss
  make_prefill_fn     (params, batch) -> (last_logits, cache)
  make_decode_fn      (params, cache, token, pos) -> (logits, cache)
  cache_init          an empty decode cache
  batch_struct        shapes and dtypes of a training batch
  make_batch          a concrete random batch (smoke tests, demos)
  count_params        exact parameter counts (total / active / expert)
  model_flops         6*N*D for training, 2*N*D otherwise

Encoder-decoder and vision-frontend models are not ported yet (ROADMAP.md
queue 1, item 9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core.capture import leaves_with_paths
from repro_torch.models import transformer as TF


def _check_family(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.family!r} models are not ported yet (ROADMAP.md queue 1, "
            f"item 9)")


def init_model(cfg: ModelConfig, *, generator: torch.Generator, device):
    _check_family(cfg)
    return TF.init_lm(generator, cfg, torch.device(device))


def make_loss_fn(cfg: ModelConfig):
    _check_family(cfg)
    return lambda params, batch: TF.lm_loss(params, cfg, batch)


def make_prefill_fn(cfg: ModelConfig, cache_len=None):
    """``prefill(params, batch)`` -> ``(last_logits, cache)``; ``cache_len``
    sizes the attention caches for decoding past the prompt
    (``transformer.lm_prefill``)."""
    _check_family(cfg)
    return lambda params, batch: TF.lm_prefill(params, cfg, batch["tokens"],
                                               cache_len)


def make_decode_fn(cfg: ModelConfig):
    """``decode(params, cache, token, pos)`` -> ``(logits, cache)``."""
    _check_family(cfg)
    return lambda params, cache, token, pos: TF.lm_decode_step(
        params, cfg, cache, token, pos)


def cache_init(cfg: ModelConfig, B: int, S: int, *, device):
    _check_family(cfg)
    return TF.lm_cache_init(cfg, B, S, torch.device(device))


@dataclass(frozen=True)
class Struct:
    """Shape and numpy dtype of one batch entry (``jax.ShapeDtypeStruct``
    in the JAX package)."""

    shape: tuple
    dtype: np.dtype


def batch_struct(cfg: ModelConfig, shape: ShapeCfg, kind: str | None = None):
    """Entries of a batch for a shape cell; ``kind`` defaults to
    ``shape.kind``.  train/prefill: a token batch; decode: (token, pos)."""
    _check_family(cfg)
    kind = kind or shape.kind
    B, T = shape.global_batch, shape.seq_len
    i32 = np.dtype("int32")
    if kind == "decode":
        return {"token": Struct((B, 1), i32), "pos": Struct((), i32)}
    return {"tokens": Struct((B, T), i32)}


def make_batch(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0,
               kind: str | None = None, *, device):
    """Random batch matching ``batch_struct``, drawn as the JAX package
    draws it (the same tokens from the same seed), on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in batch_struct(cfg, shape, kind).items():
        hi = cfg.vocab_size if name in ("tokens", "token") else max(
            1, shape.seq_len - 1)
        if name == "pos":
            arr = np.asarray(rng.integers(0, hi), s.dtype)
        else:
            arr = rng.integers(0, hi, size=s.shape).astype(s.dtype)
        out[name] = torch.from_numpy(arr).to(device)
    return out


def count_params(cfg: ModelConfig) -> dict:
    """Exact counts from the parameter tree, laid out on the meta device
    (no allocation)."""
    params = init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="meta")
    total = expert = embed = 0
    for name, leaf in leaves_with_paths(params):
        n = math.prod(leaf.shape)
        total += n
        if "emb" in name or "lm_head" in name:
            embed += n
    return {"total": total, "active": total - expert, "expert": expert,
            "embed": embed}


def model_flops(cfg: ModelConfig, shape: ShapeCfg,
                kind: str | None = None) -> float:
    """MODEL_FLOPS = 6*N*D for training (2*N*D otherwise), N the
    non-embedding parameters and D the tokens processed (a decode step
    processes one token per sequence)."""
    kind = kind or shape.kind
    counts = count_params(cfg)
    n = counts["active"] - counts["embed"]
    D = shape.global_batch if kind == "decode" else \
        shape.global_batch * shape.seq_len
    return float((6 if kind == "train" else 2) * n * D)
