"""Recurrent blocks: xLSTM (mLSTM chunkwise-parallel + sLSTM) and RG-LRU,
the port of ``repro.models.recurrent``.

The mLSTM uses the stabilized chunkwise-parallel form (linear-attention
chunking with exponential gating) for training and prefill and a one-step
recurrence for decode; ``mlstm_recurrent`` is the slow exact reference the
equivalence tests use.  The sLSTM is a loop over time steps with its input
projection hoisted out of the loop.  The RG-LRU's linear recurrence runs as
a log-depth scan (``linear_scan``), with the step-by-step loop
(``linear_scan_loop``) beside it as its plain version.

Functions take tensors and parameter dicts with the JAX package's names,
shapes and dtypes.  Gates, cells and carries are float32 as in the JAX
package, or float64 when the compute dtype is (``layers.wide``), so the
same code gives a float64 reference.  Three-operand contractions are written as matrix
products, so that no path builds a (B, H, s, d, e) tensor, and the chunk's
cumulative sum of log forget gates is a product with a triangular matrix of
ones: ``torch.cumsum`` on a CUDA float tensor has no deterministic kernel,
and the train path runs with deterministic algorithms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdt, he, pdt, rms_norm, wide

MLSTM_CHUNK = 256
NEG = -1e30
RGLRU_C = 8.0


# ===========================================================================
# mLSTM cell
# ===========================================================================


def _mlstm_chunk(q, k, v, log_i, log_f, carry):
    """One chunk.  q, k, v: (B,H,c,hd); log_i/log_f: (B,H,c);
    carry = (C (B,H,hd,hd), n (B,H,hd), m (B,H)).  Returns (h, new_carry)."""
    c = q.shape[2]
    C_prev, n_prev, m_prev = carry
    idx = torch.arange(c, device=q.device)
    causal = idx[:, None] >= idx[None, :]  # (t, s): s <= t
    b = log_f @ causal.T.to(log_f.dtype)  # (B,H,c) inclusive cumsum
    # decay from s to t (s<=t): b_t - b_s + log_i_s
    d = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    d = torch.where(causal, d, NEG)
    a = b + m_prev[..., None]  # (B,H,c) carry weight in log space
    m_t = torch.maximum(a, d.amax(dim=-1))  # (B,H,c)

    S = (q @ k.transpose(-1, -2)) * torch.exp(d - m_t[..., None])
    w_a = torch.exp(a - m_t)
    inter = w_a[..., None] * (q @ C_prev)
    num = inter + S @ v
    denom = w_a * (q @ n_prev[..., None])[..., 0] + S.sum(dim=-1)
    h = num / torch.maximum(denom.abs(), torch.exp(-m_t))[..., None]

    # end-of-chunk state
    b_end = b[..., -1]  # (B,H)
    g = b_end[..., None] - b + log_i  # (B,H,c)
    m_new = torch.maximum(b_end + m_prev, g.amax(dim=-1))
    w_carry = torch.exp(b_end + m_prev - m_new)
    w_in = torch.exp(g - m_new[..., None])
    wk = w_in[..., None] * k  # (B,H,c,hd)
    C_new = w_carry[..., None, None] * C_prev + wk.transpose(-1, -2) @ v
    n_new = w_carry[..., None] * n_prev + wk.sum(dim=-2)
    return h, (C_new, n_new, m_new)


def _wide_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _carry_init(B, H, hd, device, dtype):
    return (torch.zeros((B, H, hd, hd), dtype=dtype, device=device),
            torch.zeros((B, H, hd), dtype=dtype, device=device),
            torch.full((B, H), -math.inf, dtype=dtype, device=device))


def mlstm_chunkwise(q, k, v, log_i, log_f, carry=None, chunk=MLSTM_CHUNK):
    """q, k, v: (B,T,H,hd); gates: (B,T,H).  Returns (h (B,T,H,hd), carry).
    The cell computes in the carry's dtype (from ``None``, float32 as in
    the JAX package, float64 for float64 inputs)."""
    B, T, H, hd = q.shape
    k = k / math.sqrt(hd)
    if carry is None:
        carry = _carry_init(B, H, hd, q.device, _wide_dtype(q.dtype))
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"chunk {c}")
    nc = T // c

    def to_chunks(x):  # (B,T,H,...) -> (nc,B,H,c,...)
        x = x.to(carry[0].dtype).reshape((B, nc, c) + tuple(x.shape[2:]))
        return x.movedim(3, 2).movedim(0, 1)

    qs, ks, vs, lis, lfs = map(to_chunks, (q, k, v, log_i, log_f))
    hs = []
    for j in range(nc):
        h, carry = _mlstm_chunk(qs[j], ks[j], vs[j], lis[j], lfs[j], carry)
        hs.append(h)
    # (nc,B,H,c,hd) -> (B,T,H,hd)
    hs = torch.stack(hs).movedim(0, 1).movedim(2, 3).reshape(B, T, H, hd)
    return hs.to(q.dtype), carry


def mlstm_step(q, k, v, log_i, log_f, carry):
    """Single decode step.  q, k, v: (B,H,hd); gates (B,H); computed in the
    carry's dtype."""
    C_prev, n_prev, m_prev = carry
    hd = q.shape[-1]
    q = q.to(C_prev.dtype)
    k = k.to(C_prev.dtype) / math.sqrt(hd)
    v = v.to(C_prev.dtype)
    m_t = torch.maximum(log_f + m_prev, log_i)
    f = torch.exp(log_f + m_prev - m_t)
    i = torch.exp(log_i - m_t)
    C = f[..., None, None] * C_prev + i[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f[..., None] * n_prev + i[..., None] * k
    denom = (q * n).sum(dim=-1)
    h = (q[..., None, :] @ C)[..., 0, :] / torch.maximum(
        denom.abs(), torch.exp(-m_t))[..., None]
    return h, (C, n, m_t)


def mlstm_recurrent(q, k, v, log_i, log_f, carry=None):
    """Exact sequential reference (tests only).  Shapes and dtypes as
    ``mlstm_chunkwise``."""
    B, T, H, hd = q.shape
    if carry is None:
        carry = _carry_init(B, H, hd, q.device, _wide_dtype(q.dtype))
    dt = carry[0].dtype
    hs = []
    for t in range(T):
        h, carry = mlstm_step(q[:, t], k[:, t], v[:, t],
                              log_i[:, t].to(dt), log_f[:, t].to(dt), carry)
        hs.append(h)
    return torch.stack(hs, dim=1).to(q.dtype), carry


# ---------------------------------------------------------------------------
# mLSTM block (up-proj 2x, per-head q/k projections, v identity, gated out)
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg, device):
    d, H = cfg.d_model, cfg.num_heads
    di = 2 * d
    hd = di // H
    dt = pdt(cfg)
    return {
        "norm": torch.ones((d,), dtype=dt, device=device),
        "w_up": he(gen, (d, di), dt, device),
        "w_z": he(gen, (d, di), dt, device),
        "wq": he(gen, (H, hd, hd), dt, device, fan_in=hd),
        "wk": he(gen, (H, hd, hd), dt, device, fan_in=hd),
        "w_gates": he(gen, (di, 2 * H), dt, device),
        "b_gates": torch.cat([torch.zeros((H,), device=device),
                              torch.full((H,), 3.0, device=device)]).to(dt),
        "gn": torch.ones((di,), dtype=dt, device=device),
        "w_down": he(gen, (di, d), dt, device, fan_in=di),
    }


def spec_mlstm_block(cfg):
    return {
        "norm": (None,),
        "w_up": ("fsdp", "model"),
        "w_z": ("fsdp", "model"),
        "wq": (None, None, None),
        "wk": (None, None, None),
        "w_gates": ("model", None),
        "b_gates": (None,),
        "gn": (None,),
        "w_down": ("model", "fsdp"),
    }


def _mlstm_qkvg(p, cfg, x):
    ct = cdt(cfg)
    B, T, d = x.shape
    H = cfg.num_heads
    hd = 2 * d // H
    xn = rms_norm(x, p["norm"])
    u = xn @ p["w_up"].to(ct)  # (B,T,di)
    z = xn @ p["w_z"].to(ct)
    uh = u.reshape(B, T, H, hd)
    q = torch.einsum("bthi,hij->bthj", uh, p["wq"].to(ct))
    k = torch.einsum("bthi,hij->bthj", uh, p["wk"].to(ct))
    raw = u @ p["w_gates"].to(ct) + p["b_gates"].to(ct)  # (B,T,2H)
    log_i = wide(raw[..., :H])
    log_f = F.logsigmoid(wide(raw[..., H:]))
    return q, k, uh, log_i, log_f, z


def apply_mlstm_block(p, cfg, x, carry=None, return_carry=False):
    ct = cdt(cfg)
    x = x.to(ct)
    B, T, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_qkvg(p, cfg, x)
    h, carry = mlstm_chunkwise(q, k, v, log_i, log_f, carry)
    h = rms_norm(h.reshape(B, T, -1), p["gn"])
    out = (h * F.silu(z)) @ p["w_down"].to(ct)
    if return_carry:
        return x + out, carry
    return x + out


def mlstm_block_step(p, cfg, x, carry):
    """x: (B,1,d) decode step."""
    ct = cdt(cfg)
    x = x.to(ct)
    q, k, v, log_i, log_f, z = _mlstm_qkvg(p, cfg, x)
    # mlstm_step scales k itself
    h, carry = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                          log_f[:, 0], carry)
    h = rms_norm(h.reshape(x.shape[0], 1, -1).to(ct), p["gn"])
    out = (h * F.silu(z)) @ p["w_down"].to(ct)
    return x + out, carry


def mlstm_carry_init(cfg, B, device):
    H = cfg.num_heads
    return _carry_init(B, H, 2 * cfg.d_model // H, device,
                       _wide_dtype(cdt(cfg)))


# ===========================================================================
# sLSTM block (sequential loop; block-diagonal recurrence per head)
# ===========================================================================


def init_slstm_block(gen, cfg, device):
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    f_ff = max(128, int(math.ceil(4 * d / 3 / 128)) * 128)
    dt = pdt(cfg)
    return {
        "norm": torch.ones((d,), dtype=dt, device=device),
        "W": he(gen, (d, 4, H, hd), dt, device, fan_in=d),
        "R": he(gen, (4, H, hd, hd), dt, device, fan_in=hd),
        "b": torch.zeros((4, H, hd), dtype=dt, device=device),
        "gn": torch.ones((d,), dtype=dt, device=device),
        "norm2": torch.ones((d,), dtype=dt, device=device),
        "w_ff1": he(gen, (d, f_ff), dt, device),
        "w_ff2": he(gen, (d, f_ff), dt, device),
        "w_ff3": he(gen, (f_ff, d), dt, device, fan_in=f_ff),
    }


def spec_slstm_block(cfg):
    # W/R output-shard the per-head hd dim over "model": the cell state and
    # its per-timestep gradient accumulators then live hd-sharded
    return {
        "norm": (None,), "W": ("fsdp", None, None, "model"),
        "R": (None, None, None, "model"), "b": (None, None, "model"),
        "gn": (None,), "norm2": (None,),
        "w_ff1": ("fsdp", "model"), "w_ff2": ("fsdp", "model"),
        "w_ff3": ("model", "fsdp"),
    }


def _slstm_gates(raw, state, h_dtype):
    """The cell update from the pre-activations ``raw`` (B,4,H,hd)."""
    c, n, _, m = state
    raw = wide(raw)
    z = torch.tanh(raw[:, 0])
    log_i = raw[:, 1]
    log_f = F.logsigmoid(raw[:, 2])
    o = torch.sigmoid(raw[:, 3])
    m_t = torch.maximum(log_f + m, log_i)
    fp = torch.exp(log_f + m - m_t)
    ip = torch.exp(log_i - m_t)
    c = fp * c + ip * z
    n = fp * n + ip
    h_new = o * c / torch.clamp(n.abs(), min=1e-6)
    return (c, n, h_new.to(h_dtype), m_t), h_new


def _slstm_cell_step(W_R_b, xt, state):
    """xt: (B,d) pre-normed; state: (c, n, h, m) each (B,H,hd)."""
    W, R, b = W_R_b
    h = state[2]
    raw = (torch.einsum("bd,dghk->bghk", xt, W)
           + torch.einsum("bhj,ghjk->bghk", h, R) + b)  # (B,4,H,hd)
    return _slstm_gates(raw, state, xt.dtype)


def slstm_carry_init(cfg, B, device):
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    dt = _wide_dtype(cdt(cfg))
    z = torch.zeros((B, H, hd), dtype=dt, device=device)
    return (z, z.clone(), z.to(cdt(cfg)),
            torch.full((B, H, hd), -math.inf, dtype=dt, device=device))


def _slstm_rec_step(R, b, x_proj_t, state):
    """One recurrence step from a precomputed input projection.
    x_proj_t: (B,4,H,hd); state as in ``_slstm_cell_step``."""
    raw = x_proj_t + torch.einsum("bhj,ghjk->bghk", state[2], R) + b
    return _slstm_gates(raw, state, x_proj_t.dtype)


def _slstm_ffn(p, cfg, x):
    """The block's pf-4/3 gated FFN with its residual."""
    ct = cdt(cfg)
    xn2 = rms_norm(x, p["norm2"])
    hf = F.gelu(xn2 @ p["w_ff1"].to(ct), approximate="tanh") * (
        xn2 @ p["w_ff2"].to(ct))
    return x + hf @ p["w_ff3"].to(ct)


def apply_slstm_block(p, cfg, x, carry=None, return_carry=False):
    ct = cdt(cfg)
    x = x.to(ct)
    B, T, d = x.shape
    if carry is None:
        carry = slstm_carry_init(cfg, B, x.device)
    xn = rms_norm(x, p["norm"])
    # the input projection is hoisted out of the time loop: one matmul for
    # all steps, and one weight gradient
    x_proj = torch.einsum("btd,dghk->btghk", xn, p["W"].to(ct))
    R, b = p["R"].to(ct), p["b"].to(ct)
    hs = []
    for t in range(T):
        carry, h = _slstm_rec_step(R, b, x_proj[:, t], carry)
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, T, d).to(ct)
    x = _slstm_ffn(p, cfg, x + rms_norm(hs, p["gn"]))
    if return_carry:
        return x, carry
    return x


def slstm_block_step(p, cfg, x, carry):
    ct = cdt(cfg)
    x = x.to(ct)
    B = x.shape[0]
    xn = rms_norm(x, p["norm"])
    Wrb = (p["W"].to(ct), p["R"].to(ct), p["b"].to(ct))
    carry, h = _slstm_cell_step(Wrb, xn[:, 0], carry)
    hs = h.reshape(B, 1, -1).to(ct)
    return _slstm_ffn(p, cfg, x + rms_norm(hs, p["gn"])), carry


# ===========================================================================
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ===========================================================================


def init_rglru_block(gen, cfg, device):
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv_width
    dt = pdt(cfg)
    # Lambda init so a = exp(-8*softplus(lam)*r) spans ~(0.9, 0.999); f32
    # whatever the parameter dtype
    lam = torch.rand((w,), generator=gen, device=device) * 2.3 - 4.3
    return {
        "norm": torch.ones((d,), dtype=dt, device=device),
        "w_x": he(gen, (d, w), dt, device),
        "w_gate": he(gen, (d, w), dt, device),
        "conv_w": he(gen, (cw, w), dt, device, fan_in=cw),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "w_r": he(gen, (w, w), dt, device),
        "b_r": torch.zeros((w,), dtype=dt, device=device),
        "w_i": he(gen, (w, w), dt, device),
        "b_i": torch.zeros((w,), dtype=dt, device=device),
        "lam": lam,
        "w_out": he(gen, (w, d), dt, device, fan_in=w),
    }


def spec_rglru_block(cfg):
    return {
        "norm": (None,), "w_x": ("fsdp", "model"), "w_gate": ("fsdp", "model"),
        "conv_w": (None, "model"), "conv_b": ("model",),
        "w_r": (None, "model"), "b_r": ("model",),
        "w_i": (None, "model"), "b_i": ("model",),
        "lam": ("model",), "w_out": ("model", "fsdp"),
    }


def _causal_conv(x, w, b, carry=None):
    """x: (B,T,width); w: (cw, width).  carry: (B,cw-1,width) prior inputs.
    The taps are added in the order j = 0 .. cw-1, as the JAX package's
    Python ``sum`` adds them."""
    cw, T = w.shape[0], x.shape[1]
    if carry is None:
        pad = x.new_zeros((x.shape[0], cw - 1) + tuple(x.shape[2:]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:T] * w[cw - 1]
    for j in range(1, cw):
        out = out + xp[:, j:j + T] * w[cw - 1 - j]
    new_carry = xp[:, -(cw - 1):] if cw > 1 else None
    return out + b, new_carry


def _matmul_promoted(x, w):
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` promotes a
    bf16 activation against f32 weights."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _rglru_gates(p, xc):
    r = torch.sigmoid(wide(_matmul_promoted(xc, p["w_r"]) + p["b_r"]))
    i = torch.sigmoid(wide(_matmul_promoted(xc, p["w_i"]) + p["b_i"]))
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * wide(xc))


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    ceil(log2 T) out-of-place doubling steps on (a, b), each composing an
    element with the one ``shift`` steps before it (Hillis-Steele).  It adds
    in another order than the loop, ``linear_scan_loop``, and than the JAX
    package's ``jax.lax.associative_scan``."""
    T = a.shape[1]
    shift = 1
    while shift < T:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def linear_scan_loop(a, b):
    """The plain version of ``linear_scan``: one step at a time."""
    h = torch.zeros_like(b[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _rglru_mix(p, cfg, x, conv_carry):
    """The block's input half: (x in the compute dtype, gate, conv output,
    conv carry, a, the scan's input term)."""
    ct = cdt(cfg)
    x = x.to(ct)
    xn = rms_norm(x, p["norm"])
    xb = xn @ p["w_x"].to(ct)
    gate = F.gelu(xn @ p["w_gate"].to(ct), approximate="tanh")
    xc, conv_carry = _causal_conv(xb, p["conv_w"].to(ct), p["conv_b"].to(ct),
                                  conv_carry)
    a, bterm = _rglru_gates(p, xc)
    return x, gate, conv_carry, a, bterm


def apply_rglru_block(p, cfg, x, carry=None, return_carry=False):
    """carry = {"h": (B,w), "conv": (B,cw-1,w)}"""
    ct = cdt(cfg)
    x, gate, conv_carry, a, bterm = _rglru_mix(
        p, cfg, x, None if carry is None else carry["conv"])
    if carry is not None:
        first = bterm[:, :1] + a[:, :1] * carry["h"].to(a.dtype)[:, None]
        bterm = torch.cat([first, bterm[:, 1:]], dim=1)
    bb = linear_scan(a, bterm)
    out = (bb.to(ct) * gate) @ p["w_out"].to(ct)
    if return_carry:
        return x + out, {"h": bb[:, -1], "conv": conv_carry}
    return x + out


def rglru_block_step(p, cfg, x, carry):
    ct = cdt(cfg)
    x, gate, conv_carry, a, bterm = _rglru_mix(p, cfg, x, carry["conv"])
    h_new = a[:, 0] * carry["h"].to(a.dtype) + bterm[:, 0]
    out = (h_new[:, None].to(ct) * gate) @ p["w_out"].to(ct)
    return x + out, {"h": h_new, "conv": conv_carry}


def rglru_carry_init(cfg, B, device):
    dt = _wide_dtype(cdt(cfg))
    return {"h": torch.zeros((B, cfg.lru_width), dtype=dt, device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, cfg.lru_width),
                                dtype=dt, device=device)}
