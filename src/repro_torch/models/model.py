"""Model dispatch: one API over the ported architectures (decoder-only:
dense, MoE, xLSTM, RG-LRU hybrids, the vision frontend stub; and the
encoder-decoder).

  init_model          params on an explicit device
  model_specs         the params' logical sharding specs
  make_loss_fn        (params, batch) -> scalar loss
  make_prefill_fn     (params, batch) -> (last_logits, cache)
  make_decode_fn      (params, cache, token, pos) -> (logits, cache)
  cache_init          an empty decode cache
  cache_specs         its logical sharding specs
  batch_struct        shapes and dtypes of a batch
  batch_specs         their logical sharding specs
  make_batch          a concrete random batch (smoke tests, demos)
  count_params        exact parameter counts (total / active / expert)
  model_flops         6*N*D for training, 2*N*D otherwise

Under a mesh (``runtime.use_mesh``) the functions made here take DTensor
parameters and batches; the tables a forward builds as plain tensors
(positions, masks, the rotary factors) act there as replicated operands.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core.capture import leaves_with_paths
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF


def init_model(cfg: ModelConfig, *, generator: torch.Generator, device):
    if cfg.is_encoder_decoder:
        return ED.init_encdec(generator, cfg, torch.device(device))
    return TF.init_lm(generator, cfg, torch.device(device))


def model_specs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return ED.spec_encdec(cfg)
    return TF.spec_lm(cfg)


def make_loss_fn(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return lambda params, batch: ED.encdec_loss(params, cfg, batch)
    return lambda params, batch: TF.lm_loss(params, cfg, batch)


def make_prefill_fn(cfg: ModelConfig, cache_len=None):
    """``prefill(params, batch)`` -> ``(last_logits, cache)``; ``cache_len``
    sizes the self-attention caches for decoding past the prompt
    (``transformer.lm_prefill``, ``encdec.encdec_prefill``)."""
    if cfg.is_encoder_decoder:
        return lambda params, batch: ED.encdec_prefill(params, cfg, batch,
                                                       cache_len)
    return lambda params, batch: TF.lm_prefill(
        params, cfg, batch["tokens"], cache_len,
        extra_embeds=batch.get("patches"))


def make_decode_fn(cfg: ModelConfig):
    """``decode(params, cache, token, pos)`` -> ``(logits, cache)``."""
    if cfg.is_encoder_decoder:
        return lambda params, cache, token, pos: ED.encdec_decode_step(
            params, cfg, cache, token, pos)
    return lambda params, cache, token, pos: TF.lm_decode_step(
        params, cfg, cache, token, pos)


def cache_init(cfg: ModelConfig, B: int, S: int, *, device):
    if cfg.is_encoder_decoder:
        return ED.encdec_cache_init(cfg, B, S, torch.device(device))
    return TF.lm_cache_init(cfg, B, S, torch.device(device))


def cache_specs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return ED.encdec_cache_spec(cfg)
    return TF.lm_cache_spec(cfg)


@dataclass(frozen=True)
class Struct:
    """Shape and dtype name of one batch entry (``jax.ShapeDtypeStruct``
    in the JAX package).  The name is numpy's ("int32", "float32",
    "bfloat16"): numpy has no bfloat16 of its own."""

    shape: tuple
    dtype: str


def batch_struct(cfg: ModelConfig, shape: ShapeCfg, kind: str | None = None):
    """Entries of a batch for a shape cell; ``kind`` defaults to
    ``shape.kind``.  train/prefill: a token batch, with the stub frontends'
    embeddings in the compute dtype (the encoder-decoder's frames (B, T, d)
    and its min(dec_max_len, T) decoder tokens; the vision stub's patches
    (B, P, d) before T - P text tokens); decode: (token, pos)."""
    kind = kind or shape.kind
    B, T = shape.global_batch, shape.seq_len
    ct = cfg.compute_dtype
    if kind == "decode":
        return {"token": Struct((B, 1), "int32"), "pos": Struct((), "int32")}
    if cfg.is_encoder_decoder:
        Td = min(cfg.dec_max_len, T)
        return {"frames": Struct((B, T, cfg.d_model), ct),
                "tokens": Struct((B, Td), "int32")}
    if cfg.frontend == "vision":
        P = cfg.num_patches
        return {"tokens": Struct((B, T - P), "int32"),
                "patches": Struct((B, P, cfg.d_model), ct)}
    return {"tokens": Struct((B, T), "int32")}


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, kind: str | None = None):
    """Logical sharding specs matching ``batch_struct``."""
    kind = kind or shape.kind
    if kind == "decode":
        return {"token": ("batch", None), "pos": ()}
    if cfg.is_encoder_decoder:
        return {"frames": ("batch", None, None), "tokens": ("batch", None)}
    if cfg.frontend == "vision":
        return {"tokens": ("batch", None), "patches": ("batch", None, None)}
    return {"tokens": ("batch", None)}


def float_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A float64 numpy draw rounded once to ``dtype`` (as numpy's, and
    ml_dtypes', ``astype`` rounds it), on ``device``."""
    return torch.from_numpy(arr).to(L.torch_dtype(dtype)).to(device)


def make_batch(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0,
               kind: str | None = None, *, device):
    """Random batch matching ``batch_struct``, drawn as the JAX package
    draws it (the same tokens and floats from the same seed, in the same
    order), on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in batch_struct(cfg, shape, kind).items():
        if s.dtype != "int32":
            out[name] = float_tensor(rng.standard_normal(s.shape) * 0.02,
                                     s.dtype, device)
            continue
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
    (no allocation): ``total``, ``embed`` (embedding and LM head),
    ``expert`` (the MoE experts' stacks) and ``active`` (``total`` less
    the experts a token does not use: k of E)."""
    params = init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="meta")
    total = expert = embed = 0
    for name, leaf in leaves_with_paths(params):
        n = math.prod(leaf.shape)
        total += n
        if cfg.moe is not None and leaf.ndim >= 3 and any(
                w in name for w in ("w_gate", "w_up", "w_down")):
            expert += n
        if "emb" in name or "lm_head" in name:
            embed += n
    active = total - expert
    if expert:
        active += int(expert * cfg.moe.experts_per_token
                      / cfg.moe.num_experts)
    return {"total": total, "active": active, "expert": expert,
            "embed": embed}


def model_flops(cfg: ModelConfig, shape: ShapeCfg,
                kind: str | None = None) -> float:
    """MODEL_FLOPS = 6*N*D for training (2*N*D otherwise), N the active
    non-embedding parameters and D the tokens processed (a decode step
    processes one token per sequence; the encoder-decoder processes its
    frames and its decoder tokens)."""
    kind = kind or shape.kind
    counts = count_params(cfg)
    n = counts["active"] - counts["embed"]
    B, T = shape.global_batch, shape.seq_len
    if kind == "decode":
        D = B
    elif cfg.is_encoder_decoder:  # frames and decoder tokens
        D = B * (T + min(cfg.dec_max_len, T))
    else:
        D = B * T
    return float((6 if kind == "train" else 2) * n * D)
