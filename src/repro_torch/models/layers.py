"""Dense transformer layers: RMSNorm, RoPE, sinusoidal positions, the MLP
variants, full, GQA and local (windowed) self-attention with its one-token
decode against a cache, multi-head latent attention (MLA) with its decode
against a latent cache, and the encoder-decoder's cross-attention.

Parameters are plain nested dicts of tensors with the JAX package's names,
shapes and dtypes (``repro.models.layers``).  Every matmul input is cast to
``cfg.compute_dtype``; norms and the softmax run in float32 (``wide``:
float64 when the compute dtype is, for a reference run).  Attention is
computed with torch ops (einsum, the same ``-1e30`` mask, softmax in f32):
the JAX package computes it with ``jnp.einsum`` outside any Pallas kernel.

Initial values come from an explicit ``torch.Generator`` on an explicit
device; they differ from the JAX package's, whose generator gives other
numbers from one seed.  Tests carry a JAX state across through numpy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import runtime, sharding


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy-style name ("float32", "bfloat16")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype when that is wider: where the
    JAX package computes in float32, a float64 reference run stays
    float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def pdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def he(gen, shape, dtype, device, fan_in=None):
    """Normal weights scaled by ``1/sqrt(fan_in)`` (``fan_in`` defaults to
    the first dimension), drawn in float32 and cast."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = wide(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(x.dtype)).to(dt)


def rope_factor(half, theta, dtype, device=None):
    """The rotary frequencies ``theta ** (-i / half)``, i < half, in
    ``dtype``.  ``i / half`` is taken in ``dtype`` and the power in float64,
    rounded once: XLA's f32 ``pow`` is correctly rounded, torch's misses by
    an ulp at some entries of half = 32 and 64 (head_dim 64 and 128)."""
    freq = torch.arange(half, dtype=dtype, device=device) / half
    return (theta ** (-freq.double())).to(dtype)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding.  x: (..., T, H, hd); positions: (..., T)."""
    half = x.shape[-1] // 2
    wd = torch.promote_types(x.dtype, torch.float32)
    inv = rope_factor(half, theta, wd, x.device)
    ang = positions[..., None].to(wd) * inv  # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(T, d, dtype, device=None):
    """(T, d) sinusoidal position encodings, sines then cosines, computed in
    float32 (``wide``: float64 for a float64 ``dtype``) and cast.  The
    factor ``10000 ** (2i/d)`` is computed in float64 and rounded once:
    XLA's f32 ``pow`` is correctly rounded, torch's can miss by an ulp,
    which an angle of up to T rad magnifies (3e-5 at d = 1024, T = 1500)."""
    wd = torch.promote_types(dtype, torch.float32)
    pos = torch.arange(T, dtype=wd, device=device)[:, None]
    i = torch.arange(d // 2, dtype=wd, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * i / d).double()).to(wd)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = pdt(cfg)
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": he(gen, (d, f), dt, device),
                "w_up": he(gen, (d, f), dt, device),
                "w_down": he(gen, (f, d), dt, device, fan_in=f)}
    # non-gated: relu2 (nemotron) / gelu (whisper)
    return {"w_up": he(gen, (d, f), dt, device),
            "w_down": he(gen, (f, d), dt, device, fan_in=f)}


def spec_mlp(cfg):
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": ("fsdp", "model"),
            "w_up": ("fsdp", "model"),
            "w_down": ("model", "fsdp"),
        }
    return {"w_up": ("fsdp", "model"), "w_down": ("model", "fsdp")}


def apply_mlp(p, cfg, x):
    ct = cdt(cfg)
    x = x.to(ct)
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(ct)
        g = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * (x @ p["w_up"].to(ct))
    else:
        h = x @ p["w_up"].to(ct)
        if cfg.mlp == "relu2":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"].to(ct)


# ---------------------------------------------------------------------------
# scaled-dot-product attention core (chunked over queries for long context)
# ---------------------------------------------------------------------------

ATTN_CHUNK = 1024  # q-chunk size used once Tq exceeds this (bounds score memory)


def _shard_scores(shape, mesh):
    """The spec of the (B,H,Tq,Tk) score tensor on ``mesh``:
    the "model" axis on H when the head count divides it (plain TP),
    otherwise on the KEY dim (sequence-parallel attention), as the
    left-to-right claiming of ``sharding.resolve_spec`` arbitrates.  Tk,
    not Tq, so the backward's dk/dv stay rank-local."""
    return sharding.resolve_spec(tuple(shape), ("batch", "model", None,
                                                "model"), mesh, False)


def _mask(Tq, Tk, device, *, causal, window, q_start, k_len_valid,
          k_start=0):
    """(Tq, Tk) bool: which keys (global positions k_start..) each query
    (global positions q_start..) attends to."""
    qpos = q_start + torch.arange(Tq, device=device)[:, None]
    kpos = k_start + torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if k_len_valid is not None:
        mask &= kpos < k_len_valid
    return mask


def _attn_block(q, k, v, *, causal, window, q_start, k_len_valid=None):
    """q: (B,Tq,H,hd) k: (B,Tk,H,hd) v: (B,Tk,H,hv) -> (B,Tq,H,hv).  Mask
    rows are the global query positions q_start..q_start+Tq-1; keys are
    positions 0..Tk-1, of which only the first ``k_len_valid`` (an int or
    a 0-d tensor) are real when it is given.  Scores are scaled by
    1/sqrt(hd), q's width.  DTensor inputs take ``_attn_block_sharded``."""
    if sharding.is_dtensor(q):
        return _attn_block_sharded(q, k, v, causal=causal, window=window,
                                   q_start=q_start, k_len_valid=k_len_valid)
    Tq, hd, Tk = q.shape[1], q.shape[3], k.shape[1]
    scores = wide(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd))
    mask = _mask(Tq, Tk, q.device, causal=causal, window=window,
                 q_start=q_start, k_len_valid=k_len_valid)
    scores = torch.where(mask, scores, -1e30)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _attn_keys_local(q, k, v, mesh, k_start, *, causal, window, q_start,
                     k_len_valid):
    """One model rank's attention over its slice of the keys (global
    positions ``k_start``..): the softmax's max and sum, and the output,
    are all-reduced over "model"."""
    from torch.distributed import _functional_collectives as funcol

    Tq, hd, Tk = q.shape[1], q.shape[3], k.shape[1]
    scores = wide(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd))
    mask = _mask(Tq, Tk, q.device, causal=causal, window=window,
                 q_start=q_start, k_len_valid=k_len_valid, k_start=k_start)
    scores = torch.where(mask, scores, -1e30)
    # the shift cancels in the softmax: no gradient flows through it
    top = funcol.wait_tensor(funcol.all_reduce(
        scores.detach().amax(dim=-1, keepdim=True), "max",
        mesh.get_group("model")))
    e = torch.exp(scores - top)
    # each rank divides its own keys' terms by the sum: its gradient of
    # the sum is a part of the whole
    denom = runtime.psum_local_use(e.sum(dim=-1, keepdim=True), mesh,
                                   "model")
    attn = (e / denom).to(q.dtype)
    return runtime.psum(torch.einsum("bhqk,bkhd->bqhd", attn, v), mesh,
                        "model")


def _attn_block_sharded(q, k, v, *, causal, window, q_start, k_len_valid):
    """``_attn_block`` on DTensors, under ``runtime.shard_map``.  The
    scores' spec (``_shard_scores``) decides the layout: the batch over
    the data axes and, when the head count divides "model", the heads
    over it (each rank attends with its own heads, no collective);
    otherwise the keys over "model" (``_attn_keys_local``: each rank's
    keys, the softmax's statistics and the output all-reduced).  The
    scores never exist as a DTensor: their einsums flatten two sharded
    dims, which not every torch release can propagate."""
    mesh = q.device_mesh
    B, Tq, H, _ = q.shape
    spec = _shard_scores((B, H, Tq, k.shape[1]), mesh)
    spec = tuple(spec) + (None,) * (4 - len(spec))
    P = sharding.P
    kw = dict(causal=causal, window=window, q_start=q_start,
              k_len_valid=k_len_valid)
    if spec[3] != "model":
        s = P(spec[0], None, spec[1], None)
        fn = runtime.shard_map(lambda a, b, c: _attn_block(a, b, c, **kw),
                               mesh=mesh, in_specs=(s, s, s), out_specs=s)
        return fn(q, k, v)
    n = runtime.mesh_axes(mesh).get("model")
    qs, ks = P(spec[0], None, None, None), P(spec[0], "model", None, None)

    def body(a, b, c):
        start = mesh.get_local_rank("model") * (k.shape[1] // n)
        return _attn_keys_local(a, b, c, mesh, start, **kw)

    fn = runtime.shard_map(body, mesh=mesh, in_specs=(qs, ks, ks),
                           out_specs=qs,
                           in_grad_specs=(("model",), (), ()))
    return fn(q, k, v)


def sdpa(q, k, v, *, causal=True, window=0, q_start=0, chunk=ATTN_CHUNK):
    """Exact attention.  Past ``chunk`` queries it loops over query chunks,
    each recomputed in the backward pass, so the (Tq, Tk) scores never
    exceed (chunk, Tk), as the JAX package's scan over chunks does."""
    Tq = q.shape[1]
    if Tq <= chunk or Tq % chunk != 0:
        return _attn_block(q, k, v, causal=causal, window=window,
                           q_start=q_start)

    def one(qi, start):
        return _attn_block(qi, k, v, causal=causal, window=window,
                           q_start=start)

    outs = [checkpoint(one, qi, q_start + i * chunk, use_reentrant=False)
            for i, qi in enumerate(q.split(chunk, dim=1))]
    return torch.cat(outs, dim=1)


def repeat_kv(x, n_rep):
    """(B,T,K,hd) -> (B,T,K*n_rep,hd), each kv head repeated in place."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


# ---------------------------------------------------------------------------
# full / GQA / local attention layer
# ---------------------------------------------------------------------------


def init_attn(gen, cfg, device):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = pdt(cfg)
    return {"wq": he(gen, (d, H, hd), dt, device, fan_in=d),
            "wk": he(gen, (d, K, hd), dt, device, fan_in=d),
            "wv": he(gen, (d, K, hd), dt, device, fan_in=d),
            "wo": he(gen, (H, hd, d), dt, device, fan_in=H * hd)}


def spec_attn(cfg):
    return {
        "wq": ("fsdp", "model", None),
        "wk": ("fsdp", "model", None),
        "wv": ("fsdp", "model", None),
        "wo": ("model", None, "fsdp"),
    }


def apply_attn(p, cfg, x, positions, *, window=0, causal=None,
               use_rope=True):
    """Training / prefill self-attention: RoPE unless ``use_rope`` is
    false (the encoder-decoder adds its positions to the input), causal as
    ``cfg.causal`` unless ``causal`` says otherwise; ``window`` > 0 keeps
    only the last ``window`` keys of each query."""
    ct = cdt(cfg)
    x = x.to(ct)
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(ct))
    k = torch.einsum("btd,dgk->btgk", x, p["wk"].to(ct))
    v = torch.einsum("btd,dgk->btgk", x, p["wv"].to(ct))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    k, v = repeat_kv(k, H // K), repeat_kv(v, H // K)
    causal = cfg.causal if causal is None else causal
    o = sdpa(q, k, v, causal=causal, window=window)
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(ct))


def attn_decode(p, cfg, x, cache_k, cache_v, pos, *, window=0,
                use_rope=True):
    """One-token decode.  x: (B,1,d); cache_(k|v): (B,S,K,hd); pos: the
    position of the token, the same for every batch row (an int or a 0-d
    integer tensor).  A local-attention cache is a ring of S slots (S =
    min(window, context)), position p in slot p % window.  Without
    ``use_rope`` neither the query nor the cached key is rotated.

    Returns (out, new_k, new_v); the caches are new tensors."""
    ct = cdt(cfg)
    x = x.to(ct)
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(ct))
    k = torch.einsum("btd,dgk->btgk", x, p["wk"].to(ct))
    v = torch.einsum("btd,dgk->btgk", x, p["wv"].to(ct))
    S = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    slot = pos % window if window else pos
    if use_rope:
        ppos = pos.reshape(1, 1).expand(B, 1)
        q = rope(q, ppos, cfg.rope_theta)
        k = rope(k, ppos, cfg.rope_theta)
    spos = torch.arange(S, device=x.device)
    smask = (spos == slot)[None, :, None, None]
    cache_k = torch.where(smask, k.to(cache_k.dtype), cache_k)
    cache_v = torch.where(smask, v.to(cache_v.dtype), cache_v)
    # grouped-GQA attention against the cache, keeping the kv-head dim
    G = H // K
    qg = q.reshape(B, 1, K, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.to(ct)) \
        / math.sqrt(hd)
    if window:
        valid = spos < torch.clamp(pos + 1, max=window)  # ring slots used
    else:
        valid = spos <= pos
    scores = torch.where(valid, wide(scores), -1e30)
    attn = torch.softmax(scores, dim=-1).to(ct)
    o = torch.einsum("bkgqs,bskd->bqkgd", attn, cache_v.to(ct))
    o = o.reshape(B, 1, H, hd)
    out = torch.einsum("bqhk,hkd->bqd", o, p["wo"].to(ct))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = pdt(cfg)
    return {
        "wq_a": he(gen, (d, m.q_lora_rank), dt, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dt, device=device),
        "wq_b": he(gen, (m.q_lora_rank, H, qk), dt, device,
                   fan_in=m.q_lora_rank),
        "wkv_a": he(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                    device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt, device=device),
        "wkv_b": he(gen, (m.kv_lora_rank, H,
                          m.qk_nope_head_dim + m.v_head_dim), dt, device,
                    fan_in=m.kv_lora_rank),
        "wo": he(gen, (H, m.v_head_dim, d), dt, device,
                 fan_in=H * m.v_head_dim)}


def spec_mla(cfg):
    return {
        "wq_a": ("fsdp", None),
        "q_norm": (None,),
        "wq_b": (None, "model", None),
        "wkv_a": ("fsdp", None),
        "kv_norm": (None,),
        "wkv_b": (None, "model", None),
        "wo": ("model", None, "fsdp"),
    }


def _mla_qkv(p, cfg, x, positions):
    """x: (B,T,d) in the compute dtype -> q_nope (B,T,H,nope), q_rope
    (B,T,H,rope), the RMS-normed latent (B,T,r) and k_rope (B,T,1,rope),
    one rotated key shared by every head."""
    ct = cdt(cfg)
    m = cfg.mla
    cq = rms_norm(x @ p["wq_a"].to(ct), p["q_norm"])
    q = torch.einsum("btr,rhk->bthk", cq, p["wq_b"].to(ct))
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ p["wkv_a"].to(ct)
    latent, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    latent = rms_norm(latent, p["kv_norm"])
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, *, causal,
                q_start=0, k_len_valid=None):
    """Attention of the queries against keys and values expanded from the
    latent by ``wkv_b`` (every key each call, as the JAX package does):
    q and k are nope + rope wide, v ``v_head_dim``."""
    ct = cdt(cfg)
    m = cfg.mla
    kv = torch.einsum("btr,rhk->bthk", latent, p["wkv_b"].to(ct))
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.num_heads,
                             m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    Tq = q.shape[1]
    if Tq > ATTN_CHUNK and Tq % ATTN_CHUNK == 0 and k_len_valid is None:
        o = sdpa(q, k, v, causal=causal, q_start=q_start)
    else:
        o = _attn_block(q, k, v, causal=causal, window=0, q_start=q_start,
                        k_len_valid=k_len_valid)
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(ct))


def apply_mla(p, cfg, x, positions):
    """Training / prefill causal MLA."""
    x = x.to(cdt(cfg))
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, cfg, x, positions)
    return _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, causal=True)


def mla_decode(p, cfg, x, cache_latent, cache_krope, pos):
    """One-token decode.  x: (B,1,d); cache_latent: (B,S,r); cache_krope:
    (B,S,rope); pos: the token's position, the same for every row (an int
    or a 0-d integer tensor), written to slot ``pos`` of both caches.

    Returns (out, new_latent, new_krope); the caches are new tensors."""
    x = x.to(cdt(cfg))
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(
        p, cfg, x, pos.reshape(1, 1).expand(B, 1))
    smask = (torch.arange(cache_latent.shape[1], device=x.device)
             == pos)[None, :, None]
    cache_latent = torch.where(smask, latent.to(cache_latent.dtype),
                               cache_latent)
    cache_krope = torch.where(smask, k_rope[:, :, 0, :].to(cache_krope.dtype),
                              cache_krope)
    out = _mla_attend(p, cfg, q_nope, q_rope, cache_latent.to(x.dtype),
                      cache_krope[:, :, None, :].to(x.dtype), causal=False,
                      k_len_valid=pos + 1)
    return out, cache_latent, cache_krope


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def apply_cross_attn(p, cfg, x, enc_k, enc_v):
    """x: (B,Tq,d); enc_k/enc_v: (B,Tk,H,hd) precomputed from the encoder
    (``cross_kv``).  Non-causal, no RoPE."""
    ct = cdt(cfg)
    x = x.to(ct)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(ct))
    o = sdpa(q, enc_k.to(ct), enc_v.to(ct), causal=False)
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(ct))


def cross_kv(p, cfg, enc_out):
    """The cross-attention keys and values of the encoder output
    (B,Tk,d), each (B,Tk,H,hd) with the kv heads repeated to H."""
    ct = cdt(cfg)
    e = enc_out.to(ct)
    k = torch.einsum("btd,dgk->btgk", e, p["wk"].to(ct))
    v = torch.einsum("btd,dgk->btgk", e, p["wv"].to(ct))
    n_rep = cfg.num_heads // cfg.num_kv_heads
    return repeat_kv(k, n_rep), repeat_kv(v, n_rep)
