"""Synthetic data pipeline: a deterministic, seekable token stream (step ->
batch), so a restarted job resumes mid-stream with identical data.

Batches are drawn with numpy from ``default_rng((seed, step))`` exactly as
the JAX package's ``SyntheticStream`` draws them, so both packages see the
same tokens bit for bit, and are placed on an explicit device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.models.model import batch_struct


class SyntheticStream:
    """Zipf-ish synthetic token batches; seekable by step index."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, seed: int = 1234,
                 *, device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = torch.device(device)
        self._struct = batch_struct(cfg, shape, kind="train")

    def batch_numpy(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        out = {}
        for name, s in self._struct.items():
            # zipf-ish marginal over the vocab, cheap to sample
            u = rng.random(s.shape)
            toks = (self.cfg.vocab_size * u ** 2.2).astype(np.int64)
            out[name] = np.clip(toks, 0, self.cfg.vocab_size - 1) \
                .astype(s.dtype)
        return out

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.batch_numpy(step).items()}
