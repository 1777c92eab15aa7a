"""Mixture-of-Experts layer, the single-device path of
``repro.models.moe``.

Each token's router logits (float32, ``wide``) pick its top-k experts, and
a softmax over those k logits weighs their outputs.  Dispatch is a
capacity-bounded scatter-add: slot j of expert e holds the j-th token
routed to e, in token order, while j < C; a slot past the capacity is
dropped and adds zeros to a sink row past the last expert's buffer.  The
experts' MLPs run as one batched product over the (E, C, d) buffer, and
the combine is a gather weighted by the routing weights.  No (N, E, C)
one-hot dispatch tensor is materialized.

Every expert runs on the one card (the JAX package's ``apply_moe`` without
a mesh).  Its mesh branch (``_moe_sharded``, ``spec_moe``) waits for the
multi-device tooling (ROADMAP.md queue 1, item 10).  The routing,
dispatch and expert products are jitted XLA in the JAX package, not
Pallas kernels; here they are torch ops.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

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


def _dispatch(flat_e, E: int, C: int):
    """flat_e: (N*k,) expert ids in token order -> each slot's row in the
    (E*C + 1, d) buffer (``E*C``, the sink, for a dropped slot) and the
    keep mask.  A slot's position within its expert is the count of
    earlier slots routed to that expert."""
    onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)) \
        .to(torch.int32)  # (N*k, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    keep = slot < C
    return torch.where(keep, flat_e * C + slot, E * C), keep


def _expert_mlp(cfg, xb, wg, wu, wd):
    """xb: (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    act = F.silu if cfg.mlp == "swiglu" else partial(F.gelu,
                                                       approximate="tanh")
    return (act(xb @ wg) * (xb @ wu)) @ wd


def _moe_block(cfg, x, router_w, wg, wu, wd):
    """x: (N, d) -> (N, d): route, dispatch into each expert's C slots,
    the experts' MLPs, and the weighted sum of each token's k outputs."""
    ct = L.cdt(cfg)
    N, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    C = _capacity(N, cfg)

    top_ids, top_w = _route(router_w, cfg, x)
    flat_idx, keep = _dispatch(top_ids.reshape(-1), E, C)
    # kept slots have rows of their own; dropped ones add zeros to the sink
    xs = x.to(ct).repeat_interleave(k, dim=0)  # (N*k, d)
    buf = torch.zeros((E * C + 1, d), dtype=ct, device=x.device).index_add(
        0, flat_idx, xs * keep[:, None].to(ct))
    out_buf = _expert_mlp(cfg, buf[:-1].reshape(E, C, d), wg.to(ct),
                          wu.to(ct), wd.to(ct))

    gathered = out_buf.reshape(E * C, d)[flat_idx.clamp(max=E * C - 1)]
    gathered = gathered * (keep[:, None] * top_w.reshape(-1)[:, None]).to(ct)
    return gathered.reshape(N, k, d).sum(dim=1)


def apply_moe(p, cfg, x):
    """x: (B, T, d) -> (B, T, d), every expert on this device."""
    B, T, d = x.shape
    y = _moe_block(cfg, x.reshape(B * T, d), p["router"], p["w_gate"],
                   p["w_up"], p["w_down"])
    return y.reshape(B, T, d)


def active_fraction(cfg) -> float:
    """Fraction of expert params active per token (for MODEL_FLOPS)."""
    m = cfg.moe
    return m.experts_per_token / m.num_experts
