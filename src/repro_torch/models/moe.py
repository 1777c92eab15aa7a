"""Mixture-of-Experts layer (``repro.models.moe``).

Each token's router logits (float32, ``wide``) pick its top-k experts, and
a softmax over those k logits weighs their outputs.  Dispatch is a
capacity-bounded scatter-add: slot j of expert e holds the j-th token
routed to e, in token order, while j < C; a slot past the capacity is
dropped and adds zeros to a sink row past the last expert's buffer.  The
experts' MLPs run as one batched product over the (E, C, d) buffer, and
the combine is a gather weighted by the routing weights.  No (N, E, C)
one-hot dispatch tensor is materialized.

Without a mesh every expert runs on the one device (the JAX package's
``apply_moe`` without a mesh).  Under a mesh with a "model" axis, with
DTensor weights, the layer runs the JAX package's explicit collective
schedule (``_moe_sharded``) under ``runtime.shard_map`` (``local_map``).
Tokens stay sharded over the data axes and replicated over "model":

  - ``E % model == 0`` (expert mode): model rank r owns experts
    ``[r·E/model, (r+1)·E/model)`` with their full d_ff and dispatches only
    the slots routed to them;
  - otherwise (tensor mode): every rank holds a d_ff slice of every expert
    and processes every routed slot on its slice.

Either way each (token, expert) slot's work is done once across the mesh,
and the one collective of the layer's output is an all-reduce over
"model" of the partial d_model outputs.  Under FSDP the expert weights
enter still sharded over the data axes and are all-gathered inside the
body (their gradients reduce-scattered back).  The routing, dispatch and
expert products are jitted XLA in the JAX package, not Pallas kernels;
here they are torch ops.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch import runtime, sharding
from repro_torch.models import layers as L

#: ``_he_experts`` draws at most this many float32 values at once
_DRAW_ELEMS = 1 << 28


def _he_experts(gen, shape, dtype, device, fan_in):
    """``layers.he`` for an (E, a, b) stack of experts, drawn a slice of
    experts at a time into the result: the float32 draw of a whole stack
    (kimi-k2-1t-a32b's ``w_gate`` is 22.5 GB) never exists."""
    E, rest = shape[0], tuple(shape[1:])
    per = max(1, _DRAW_ELEMS // math.prod(rest))
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(0, E, per):
        out[e:e + per] = L.he(gen, (min(per, E - e),) + rest, dtype, device,
                              fan_in=fan_in)
    return out


def init_moe(gen, cfg, device):
    """The router (d, E) in float32 whatever ``cfg.param_dtype``, and the
    experts' ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the
    parameter dtype: the JAX package's names, shapes and dtypes."""
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.d_ff
    dt = L.pdt(cfg)
    return {
        "router": L.he(gen, (d, E), torch.float32, device),
        "w_gate": _he_experts(gen, (E, d, f), dt, device, fan_in=d),
        "w_up": _he_experts(gen, (E, d, f), dt, device, fan_in=d),
        "w_down": _he_experts(gen, (E, f, d), dt, device, fan_in=f),
    }


def spec_moe(cfg):
    # The claiming rule resolves ("model", ..., "model") to expert- or
    # tensor-sharding depending on divisibility (see repro_torch.sharding).
    return {
        "router": (None, None),
        "w_gate": ("model", "fsdp", "model"),
        "w_up": ("model", "fsdp", "model"),
        "w_down": ("model", "model", "fsdp"),
    }


def _capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for ``n_tokens`` tokens: k * N * capacity_factor / E
    rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(m.experts_per_token * n_tokens * m.capacity_factor
                      / m.num_experts))
    return max(8, (c + 7) // 8 * 8)


def _route(router_w, cfg, x):
    """x: (N, d) -> top-k expert ids (N, k) int64 and weights (N, k) in
    float32 (``wide``).  A stable descending sort puts the lower expert
    first among equal logits, as ``jax.lax.top_k`` does."""
    x32 = L.wide(x)
    logits = x32 @ router_w.to(x32.dtype)  # (N, E)
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.moe.experts_per_token
    return ids[:, :k], torch.softmax(top[:, :k], dim=-1)


def _dispatch(flat_e, E: int, C: int, local=None):
    """flat_e: (N*k,) expert ids in token order, within [0, E) -> each
    slot's row in the (E*C + 1, d) buffer (``E*C``, the sink, for a dropped
    slot) and the keep mask.  A slot's position within its expert is the
    count of earlier slots routed to that expert.  ``local`` (N*k,) bool
    marks the slots this rank dispatches (its experts'); the others are
    dropped."""
    onehot = flat_e[:, None] == torch.arange(E, device=flat_e.device)
    if local is not None:
        onehot = onehot & local[:, None]
    onehot = onehot.to(torch.int32)  # (N*k, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    keep = slot < C if local is None else local & (slot < C)
    return torch.where(keep, flat_e * C + slot, E * C), keep


def _expert_mlp(cfg, xb, wg, wu, wd):
    """xb: (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    act = F.silu if cfg.mlp == "swiglu" else partial(F.gelu,
                                                       approximate="tanh")
    return (act(xb @ wg) * (xb @ wu)) @ wd


def _moe_block(cfg, x, router_w, wg, wu, wd, *, e_start=0, e_count=None):
    """x: (N, d) -> (N, d): route, dispatch into each expert's C slots,
    the experts' MLPs, and the weighted sum of each token's k outputs.
    Experts ``[e_start, e_start + e_count)`` (every expert by default)
    are dispatched here, with the weights given (that rank's blocks under
    a mesh); the result is then this rank's part of the output."""
    ct = L.cdt(cfg)
    N, d = x.shape
    k = cfg.moe.experts_per_token
    E = cfg.moe.num_experts if e_count is None else e_count
    C = _capacity(N, cfg)

    top_ids, top_w = _route(router_w, cfg, x)
    flat_e = top_ids.reshape(-1)
    if e_count is None:
        flat_idx, keep = _dispatch(flat_e, E, C)
    else:
        local = (flat_e >= e_start) & (flat_e < e_start + E)
        flat_idx, keep = _dispatch((flat_e - e_start).clamp(0, E - 1), E, C,
                                   local)
    # kept slots have rows of their own; dropped ones add zeros to the sink
    xs = x.to(ct).repeat_interleave(k, dim=0)  # (N*k, d)
    buf = torch.zeros((E * C + 1, d), dtype=ct, device=x.device).index_add(
        0, flat_idx, xs * keep[:, None].to(ct))
    out_buf = _expert_mlp(cfg, buf[:-1].reshape(E, C, d), wg.to(ct),
                          wu.to(ct), wd.to(ct))

    gathered = out_buf.reshape(E * C, d)[flat_idx.clamp(max=E * C - 1)]
    gathered = gathered * (keep[:, None] * top_w.reshape(-1)[:, None]).to(ct)
    return gathered.reshape(N, k, d).sum(dim=1)


def _gather_fsdp_axes(w, dim: int, mesh, fsdp_axes):
    """All-gather of a weight's ``dim`` over the FSDP axes, innermost axis
    first so the outer one (pod) concatenates whole inner blocks; the
    backward reduce-scatters (sums) the gradient back to the shard
    (``jax.lax.all_gather(..., tiled=True)``)."""
    from torch.distributed._functional_collectives import \
        all_gather_tensor_autograd

    for a in reversed(fsdp_axes):
        w = all_gather_tensor_autograd(w.contiguous(), dim,
                                       mesh.get_group(a))
    return w


def _moe_sharded(cfg, expert_mode, n_model, fsdp_axes, mesh, x, router_w,
                 wg, wu, wd):
    """Body run under ``runtime.shard_map`` over the full mesh, on each
    rank's local blocks.

    The FSDP all-gather of the expert weights happens HERE, explicitly,
    rather than at the boundary, so the weights' gradients come back
    reduce-scattered in their own dtype.  (The JAX package pins the
    collectives' dtypes with ``optimization_barrier``: ``runtime.
    opt_barrier`` is the identity here, eager torch reorders nothing.)"""
    if fsdp_axes:
        wg = runtime.opt_barrier(_gather_fsdp_axes(wg, 1, mesh, fsdp_axes))
        wu = runtime.opt_barrier(_gather_fsdp_axes(wu, 1, mesh, fsdp_axes))
        wd = runtime.opt_barrier(_gather_fsdp_axes(wd, 2, mesh, fsdp_axes))
    if expert_mode:
        e_count = cfg.moe.num_experts // n_model
        e_start = mesh.get_local_rank("model") * e_count \
            if n_model > 1 else 0
        y = _moe_block(cfg, x, router_w, wg, wu, wd, e_start=e_start,
                       e_count=e_count)
    else:  # tensor mode: all experts, f-sliced weights
        y = _moe_block(cfg, x, router_w, wg, wu, wd)
    # cast before the combine so the collective moves compute-dtype bytes
    y = runtime.opt_barrier(y.to(L.cdt(cfg)))
    if n_model == 1:
        return y
    # the layer's output is replicated over "model": each rank's gradient
    # of it is the whole gradient (runtime.psum's identity backward)
    return runtime.psum(y, mesh, "model")


def apply_moe(p, cfg, x):
    """x: (B, T, d) -> (B, T, d).  Without a mesh, or on plain tensors,
    every expert on this device.  Under a mesh, with DTensor weights, the
    explicit schedule of ``_moe_sharded``; with no "model" axis of size > 1
    that is every expert on each rank, on its own rows (what the JAX
    package's partitioner makes of its local path)."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    mesh = runtime.get_mesh()
    if mesh is None or not sharding.is_dtensor(p["w_gate"]):
        y = _moe_block(cfg, xf, p["router"], p["w_gate"], p["w_up"],
                       p["w_down"])
        return y.reshape(B, T, d)

    P = sharding.P
    sizes = runtime.mesh_axes(mesh)
    n_model = sizes.get("model", 1)
    expert_mode = cfg.moe.num_experts % n_model == 0
    dp = runtime.data_axes(mesh)
    # Under FSDP the weights enter the body still d_model-sharded over the
    # data axes and are all-gathered inside (see _moe_sharded); the
    # divisibility guard mirrors sharding.resolve_spec.
    fsdp_axes = dp if (cfg.fsdp and dp and cfg.d_model % math.prod(
        sizes[a] for a in dp) == 0) else ()
    fs = dp if fsdp_axes else None
    m = "model" if n_model > 1 else None
    if expert_mode:
        w_spec = (P(m, fs, None), P(m, fs, None), P(m, None, fs))
    else:
        w_spec = (P(None, fs, m), P(None, fs, m), P(None, m, fs))
    rows = P(dp or None, None)
    # each rank's gradient of a weight replicated over the data axes is
    # the part from its own rows; of the router and the tokens, the part
    # from its own experts or d_ff slice
    w_partial = () if fsdp_axes else dp
    fn = runtime.shard_map(
        partial(_moe_sharded, cfg, expert_mode, n_model, tuple(fsdp_axes),
                mesh),
        mesh=mesh,
        in_specs=(rows, P(None, None)) + w_spec,
        out_specs=rows,
        in_grad_specs=(("model",), dp + ("model",)) + (w_partial,) * 3)
    y = fn(xf, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return y.reshape(B, T, d)


def active_fraction(cfg) -> float:
    """Fraction of expert params active per token (for MODEL_FLOPS)."""
    m = cfg.moe
    return m.experts_per_token / m.num_experts
