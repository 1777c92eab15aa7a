"""Synthetic data pipeline: a deterministic, seekable token stream (step ->
batch), so a restarted job resumes mid-stream with identical data.

Batches are drawn with numpy from ``default_rng((seed, step))`` exactly as
the JAX package's ``SyntheticStream`` draws them, entry by entry in
``batch_struct`` order, so both packages see the same tokens and the same
frame or patch embeddings bit for bit, and are placed on an explicit
device.  numpy has no bfloat16: a float entry is drawn in float64 and
rounded once to the compute dtype by torch, as ml_dtypes' ``astype``
rounds it in the JAX package.

With a ``mesh``, batches arrive as DTensors with ``batch_specs``'
placements: every rank draws the same global batch and keeps its own
rows, bit-equal to the slice of the global batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.models.model import batch_specs, batch_struct, float_tensor
from repro_torch.sharding import distribute_tree, resolve_tree


class SyntheticStream:
    """Zipf-ish synthetic token batches; seekable by step index."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, seed: int = 1234,
                 mesh=None, *, device="cuda"):
        self.cfg, self.shape, self.seed, self.mesh = cfg, shape, seed, mesh
        self.device = torch.device(device if mesh is None
                                   else mesh.device_type)
        self._struct = batch_struct(cfg, shape, kind="train")
        self._shardings = None if mesh is None else resolve_tree(
            self._struct, batch_specs(cfg, shape, kind="train"), mesh, False)

    def batch_numpy(self, step: int) -> dict:
        """The draws of ``step``: integer entries in their dtype, float
        entries in float64, before their rounding to the compute dtype."""
        rng = np.random.default_rng((self.seed, step))
        out = {}
        for name, s in self._struct.items():
            if s.dtype != "int32":
                out[name] = rng.standard_normal(s.shape) * 0.02
                continue
            # zipf-ish marginal over the vocab, cheap to sample
            u = rng.random(s.shape)
            toks = (self.cfg.vocab_size * u ** 2.2).astype(np.int64)
            out[name] = np.clip(toks, 0, self.cfg.vocab_size - 1) \
                .astype(s.dtype)
        return out

    def batch(self, step: int) -> dict:
        out = {}
        for name, arr in self.batch_numpy(step).items():
            s = self._struct[name]
            out[name] = torch.from_numpy(arr).to(self.device) \
                if s.dtype == "int32" else \
                float_tensor(arr, s.dtype, self.device)
        if self._shardings is not None:
            return distribute_tree(out, self._shardings)
        return out
