"""Training state and step of the ported model families, and the state's
exchange with the JAX package.

``init_train_state`` builds ``{"params", "opt": {"m", "v", "step"}}`` with
the tree paths, shapes and dtypes of ``repro.train.steps.init_train_state``
(AdamW moments in ``cfg.opt_dtype``), drawn from an explicit
``torch.Generator`` on an explicit device.  The values differ from JAX's:
the two frameworks' generators give different numbers from one seed.

``make_train_step`` returns an eager step: gradients from
``torch.autograd``, then AdamW in place.  With ``capture=True`` it also
returns the L1 snapshot of the fresh state (``snapshot_device``), queued
on the compute stream right after the update, the counterpart of the JAX
step's in-graph copy (DeepFreeze-style fused capture): the backend's copy
stream waits on the snapshot's event, and the next step's in-place update,
queued after the clones on the same stream, cannot overwrite them first.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the package
boundary as numpy arrays.  numpy has no bfloat16 of its own: the JAX
package's bf16 leaves are ml_dtypes arrays, and the port's are
``torch.bfloat16`` tensors; the conversion goes through the 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.capture import (leaves_with_paths, map_tree,
                                      snapshot_device)
from repro_torch.kernels.ops import check_device
from repro_torch.models.model import init_model, make_loss_fn, model_specs
from repro_torch.train import optimizer as opt_lib


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator = None,
                     device="cuda"):
    """Train state on ``device`` for any ported family: the layer stacks
    stacked along a leading dimension (per block kind, or per encoder and
    decoder stack), as the JAX package lays them out."""
    device = check_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = init_model(cfg, generator=generator, device=device)
    return {"params": params, "opt": opt_lib.adamw_init(params, cfg.opt_dtype)}


def train_state_specs(cfg: ModelConfig):
    pspecs = model_specs(cfg)
    return {"params": pspecs, "opt": opt_lib.adamw_specs(pspecs)}


def resolve_state_shardings(cfg, mesh, state_shapes):
    """NamedSharding tree for a train state (params+opt) on a mesh."""
    from repro_torch.sharding import resolve_tree

    return resolve_tree(state_shapes, train_state_specs(cfg), mesh, cfg.fsdp)


def make_train_step(cfg: ModelConfig, *, lr=3e-4, capture=False):
    """``step(state, batch)`` -> ``(state, metrics)``, or
    ``(state, snap, metrics)`` with ``capture``; ``state`` is updated in
    place and returned.  ``metrics`` holds 0-d device tensors ``loss`` and
    ``grad_norm``: reading them is the caller's wait for the device."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        tracked = map_tree(lambda _, t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(tracked, batch)
        grads = torch.autograd.grad(
            loss, [t for _, t in leaves_with_paths(tracked)])
        _, _, metrics = opt_lib.adamw_update(list(grads), state["opt"],
                                             params, lr=lr)
        metrics["loss"] = loss.detach()
        if capture:
            return state, snapshot_device(state), metrics
        return state, metrics

    return train_step


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


def _load_params(targets: dict, arrays: dict) -> None:
    """Copy numpy ``arrays`` into the tensors of ``targets`` in place (same
    keys, shapes; f32), so whatever holds the tensors — a captured CUDA
    graph, an optimizer — goes on using them."""
    if set(targets) != set(arrays):
        raise KeyError(f"parameters {sorted(arrays)} != {sorted(targets)}")
    with torch.no_grad():
        for k, t in targets.items():
            a = np.asarray(arrays[k], np.float32)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {a.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(a.copy()))


def gru_params_from_numpy(predictor, arrays: dict) -> None:
    """Load a ``GRUPhasePredictor``'s parameters (``wz``, ``wr``, ``wh``,
    ``wo`` as numpy arrays, e.g. the JAX predictor's) into the port's
    ``predictor`` on its device."""
    _load_params(predictor.params, arrays)


def interval_params_from_numpy(optimizer, arrays: dict) -> None:
    """Load an ``MLIntervalOptimizer``'s MLP (``w1``, ``b1``, ..., ``b3``
    as numpy arrays, e.g. the JAX optimizer's) into the port's
    ``optimizer`` on its device."""
    _load_params(optimizer.params, arrays)


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
