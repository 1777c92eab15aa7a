"""Training state of the dense family, and its exchange with the JAX package.

``init_train_state`` builds ``{"params", "opt": {"m", "v", "step"}}`` with
the tree paths, shapes and dtypes of ``repro.train.steps.init_train_state``
(AdamW moments in ``cfg.opt_dtype``), drawn from an explicit
``torch.Generator`` on an explicit device.  The values differ from JAX's:
the two frameworks' generators give different numbers from one seed.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the package
boundary as numpy arrays.  numpy has no bfloat16 of its own: the JAX
package's bf16 leaves are ml_dtypes arrays, and the port's are
``torch.bfloat16`` tensors; the conversion goes through the 16-bit patterns.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.capture import map_tree


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _he(gen, shape, dtype, device, fan_in=None):
    """Normal weights scaled by 1/sqrt(fan_in) (the JAX package's ``he``);
    ``shape`` leads with the stacked-layer dimension, ``fan_in`` is the
    per-layer one."""
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * std).to(dtype)


def _init_block(gen, cfg: ModelConfig, kind: str, groups: int, dt, device):
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 9)")
    G = (groups,)

    def he(shape, fan_in):
        return _he(gen, G + shape, dt, device, fan_in)

    mix = {"wq": he((d, H, hd), d), "wk": he((d, K, hd), d),
           "wv": he((d, K, hd), d), "wo": he((H, hd, d), H * hd)}
    if cfg.mlp in ("swiglu", "geglu"):
        ffn = {"w_gate": he((d, f), d), "w_up": he((d, f), d),
               "w_down": he((f, d), f)}
    else:
        ffn = {"w_up": he((d, f), d), "w_down": he((f, d), f)}
    ones = torch.ones(G + (d,), dtype=dt, device=device)
    return {"norm1": ones, "mix": mix, "norm2": ones.clone(), "ffn": ffn}


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator = None,
                     device="cuda"):
    """Dense-family train state on ``device``: the layer stack stacked along
    a leading dimension per block kind, as the JAX package lays it out."""
    if cfg.family != "dense" or cfg.moe is not None \
            or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.family!r} models are not ported yet (ROADMAP.md queue 1, "
            f"item 9)")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = _dtype(cfg.param_dtype)
    pat = cfg.block_pattern
    n_groups, rem = cfg.num_layers // len(pat), cfg.num_layers % len(pat)
    d, V = cfg.d_model, cfg.padded_vocab
    params = {
        "emb": _he(generator, (V, d), dt, device, fan_in=d),
        "blocks": tuple(_init_block(generator, cfg, kind, n_groups, dt, device)
                        for kind in pat),
        "rem": tuple(
            map_tree(lambda _, x: x[0],
                     _init_block(generator, cfg, pat[i % len(pat)], 1, dt,
                                 device))
            for i in range(rem)),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _he(generator, (d, V), dt, device, fan_in=d)
    odt = _dtype(cfg.opt_dtype)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=odt, device=device)

    opt = {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    return {"params": params, "opt": opt}


def state_from_numpy(tree, device="cuda"):
    """numpy leaves (bf16 as ml_dtypes arrays, as the JAX package holds
    them) -> tensors on ``device``; the tree structure is kept."""

    def conv(_, leaf):
        arr = np.array(leaf, order="C")  # a copy; keeps 0-d leaves 0-d
        if str(arr.dtype) == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)) \
                .view(torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)

    return map_tree(conv, tree)


def _numpy_bfloat16() -> np.dtype:
    """numpy's bfloat16 dtype, which exists once ml_dtypes is imported (the
    JAX package imports it); the port itself never needs it."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        import ml_dtypes  # optional: only bf16 leaves leaving the port

        return np.dtype(ml_dtypes.bfloat16)


def state_to_numpy(tree):
    """Tensors -> numpy arrays on the host; bf16 leaves become numpy
    bfloat16 arrays with the same bits."""

    def conv(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy()
            return bits.view(_numpy_bfloat16())
        return t.numpy().copy()

    return map_tree(conv, tree)
