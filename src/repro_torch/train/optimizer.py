"""AdamW over trees of tensors, the JAX package's ``repro.train.optimizer``.

The optimizer state is ``{"m", "v", "step"}`` with the moments in
``cfg.opt_dtype`` and ``step`` a 0-d int32 tensor.  The update math runs in
float32 (global-norm clipping, bias corrections ``1 - b**step`` in f32)
and writes the new values into the state's own tensors, under
``torch.no_grad()``: the JAX trainer donates the state to the jitted step,
so nothing else holds the old values either.  Every scalar stays a device
tensor, so an update never waits for the device.
"""
from __future__ import annotations

import torch

from repro_torch.core.capture import leaves_with_paths, map_tree
from repro_torch.models.layers import torch_dtype


def adamw_init(params, opt_dtype="float32"):
    dt = torch_dtype(opt_dtype)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = leaves_with_paths(params)[0][1].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_specs(param_specs):
    """Optimizer-state sharding mirrors param sharding."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def _leaves(tree) -> list:
    return [t for _, t in leaves_with_paths(tree)]


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def _f32(ts: list) -> list:
    """float32 working copies; a float32 tensor is its own (updated in
    place)."""
    return [t.float() for t in ts]


@torch.no_grad()
def adamw_update(grads, opt, params, *, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0):
    """Update ``params`` and ``opt`` in place; returns
    ``(params, opt, {"grad_norm": tensor})``.  ``grads`` is consumed."""
    p_l, m_l, v_l = _leaves(params), _leaves(opt["m"]), _leaves(opt["v"])
    g = _f32(_leaves(grads))
    opt["step"].add_(1)
    gnorm = global_norm(g)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = opt["step"].float()
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)

    torch._foreach_mul_(g, scale)
    m, v, p = _f32(m_l), _f32(v_l), _f32(p_l)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, p, alpha=weight_decay)
    torch._foreach_add_(p, upd, alpha=-lr)
    for dst, src in zip(p_l + m_l + v_l, p + m + v):
        if dst is not src:  # a narrower dtype than float32: write it back
            dst.copy_(src)
    return params, opt, {"grad_norm": gnorm}
