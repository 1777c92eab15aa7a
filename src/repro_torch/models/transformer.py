"""Decoder-only LM assembled from a block pattern, looped over layer groups.

The layer stack is ``cfg.block_pattern`` cycled; the ``num_layers // P``
full groups hold their parameters stacked along a leading dimension, as
the JAX package's ``jax.lax.scan`` over groups lays them out, and the
``num_layers % P`` remainder layers are held unstacked (recurrentgemma's
26 = 8*3 + 2).  Here the scan is a loop over that leading dimension, each
group recomputed in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``, as ``jax.checkpoint``).

Ported block kinds: ``"attn"``, ``"local_attn"`` and ``"mla"`` (latent
attention, its cache the latent and the shared rotated key), xLSTM's
``"mlstm"`` and ``"slstm"`` (self-contained blocks) and RG-LRU's
``"rglru"`` (the recurrent mix), each with its prefill (forward plus the
decode cache) and one-token decode.  The FFN half of the attention-style
and RG-LRU blocks is a dense MLP, or the MoE layer when ``cfg.moe`` is set
(``repro_torch.models.moe``, every expert on the one card).
``extra_embeds`` (the vision frontend stub's patch embeddings) are
prepended to the token embeddings.

Under a mesh (``runtime.use_mesh``) with DTensor parameters, the JAX
package's sharding constraints run as DTensor redistributions:
``_constrain`` places the embeddings' batch over the data axes, and
``gather_fsdp`` gathers each layer's FSDP-sharded parameters before use.
Without a mesh, or on plain tensors, both are no-ops.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import runtime, sharding
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R

_PORTED_KINDS = ("attn", "local_attn", "mla", "mlstm", "slstm", "rglru")


def _check_kind(cfg, kind: str):
    # cfg.attention selects nothing in the JAX package: the kind does, so
    # minicpm3-4b's registered ("attn",) pattern builds plain attention
    if kind not in _PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == "mla" and cfg.mla is None:
        raise ValueError("block kind 'mla' needs cfg.mla")


def _constrain(x, *spec):
    """``with_sharding_constraint`` against the ambient mesh (a no-op
    without one, or on a plain tensor)."""
    return sharding.constrain(x, spec)


def gather_fsdp(params, specs):
    """Explicit ZeRO-3 all-gather of one layer's FSDP-sharded params.

    Under a mesh, each DTensor leaf is redistributed to its spec with the
    "fsdp" dims dropped, right before use: a contraction over an
    fsdp-sharded d_model would otherwise leave a ``Partial`` activation to
    be all-reduced at full activation size.  Its backward reduce-scatters
    the gradient back to the leaf's own placement."""
    return sharding._map_up_to(params, specs,
                               lambda leaf, sp: sharding.constrain(leaf, sp))


def _vocab_split(mesh, V: int):
    """The mesh's data axes (or None) and whether the vocab dim is split
    over a "model" axis larger than 1 (a size-1 axis splits nothing)."""
    n = runtime.mesh_axes(mesh).get("model") or 1
    return runtime.data_axes(mesh) or None, n > 1 and V % n == 0


def embed_lookup(emb, tokens):
    """``emb[tokens]``.  On DTensors, under ``runtime.shard_map``: the rows
    of the vocab slice each "model" rank holds, zeros for the other
    tokens, summed over "model" (a vocab-parallel embedding); each data
    rank's gradient of the table is the part from its own tokens."""
    if not sharding.is_dtensor(emb):
        return emb[tokens]
    mesh = emb.device_mesh
    dp, split = _vocab_split(mesh, emb.shape[0])
    P = sharding.P

    def body(e, t):
        if not split:
            return e[t]
        lo = mesh.get_local_rank("model") * e.shape[0]
        mine = (t >= lo) & (t < lo + e.shape[0])
        rows = e[(t - lo).clamp(0, e.shape[0] - 1)] * mine[..., None].to(
            e.dtype)
        return runtime.psum(rows, mesh, "model")

    fn = runtime.shard_map(
        body, mesh=mesh, in_specs=(P("model" if split else None, None),
                                   P(dp, None)),
        out_specs=P(dp, None, None), in_grad_specs=(dp or (), ()))
    return fn(emb, sharding.as_dtensor(tokens, mesh))


def token_nll(logits, targets):
    """(B, T, V) logits, (B, T) targets -> (B, T) negative log-likelihood.
    On DTensors, under ``runtime.shard_map``: with the vocab split over
    "model", the log-sum-exp's max and sum and the target's logit are
    combined over "model" (vocab-parallel cross-entropy)."""
    if not sharding.is_dtensor(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    from torch.distributed import _functional_collectives as funcol

    mesh = logits.device_mesh
    dp, split = _vocab_split(mesh, logits.shape[-1])
    P = sharding.P

    def body(lg, tg):
        if not split:
            return token_nll(lg, tg)
        top = funcol.wait_tensor(funcol.all_reduce(
            lg.detach().amax(dim=-1), "max",
            mesh.get_group("model")))
        lse = torch.log(runtime.psum(torch.exp(lg - top[..., None]).sum(-1),
                                     mesh, "model")) + top
        Vl = lg.shape[-1]
        lo = mesh.get_local_rank("model") * Vl
        mine = (tg >= lo) & (tg < lo + Vl)
        picked = torch.gather(lg, -1, (tg - lo).clamp(0, Vl - 1)[..., None])
        picked = runtime.psum(picked[..., 0] * mine.to(lg.dtype), mesh,
                              "model")
        return lse - picked

    fn = runtime.shard_map(
        body, mesh=mesh, in_specs=(P(dp, None, "model" if split else None),
                                   P(dp, None)),
        out_specs=P(dp, None))
    return fn(logits, sharding.as_dtensor(targets, mesh))


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def _ffn_init(gen, cfg, device):
    if cfg.moe is not None:
        return MOE.init_moe(gen, cfg, device)
    return L.init_mlp(gen, cfg, device)


def init_block(gen, cfg, kind: str, device):
    _check_kind(cfg, kind)
    if kind == "mlstm":
        return R.init_mlstm_block(gen, cfg, device)
    if kind == "slstm":
        return R.init_slstm_block(gen, cfg, device)
    dt = L.pdt(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if kind == "rglru":
        return {"mix": R.init_rglru_block(gen, cfg, device), "norm2": ones,
                "ffn": _ffn_init(gen, cfg, device)}
    mix = L.init_mla(gen, cfg, device) if kind == "mla" else \
        L.init_attn(gen, cfg, device)
    return {"norm1": ones, "mix": mix, "norm2": ones.clone(),
            "ffn": _ffn_init(gen, cfg, device)}


def _ffn_spec(cfg):
    if cfg.moe is not None:
        return MOE.spec_moe(cfg)
    return L.spec_mlp(cfg)


def spec_block(cfg, kind: str):
    if kind in ("attn", "local_attn"):
        return {"norm1": (None,), "mix": L.spec_attn(cfg),
                "norm2": (None,), "ffn": _ffn_spec(cfg)}
    if kind == "mla":
        return {"norm1": (None,), "mix": L.spec_mla(cfg),
                "norm2": (None,), "ffn": _ffn_spec(cfg)}
    if kind == "mlstm":
        return R.spec_mlstm_block(cfg)
    if kind == "slstm":
        return R.spec_slstm_block(cfg)
    if kind == "rglru":
        return {"mix": R.spec_rglru_block(cfg),
                "norm2": (None,), "ffn": _ffn_spec(cfg)}
    raise ValueError(kind)


def _ffn(p, cfg, x):
    apply = MOE.apply_moe if cfg.moe is not None else L.apply_mlp
    return x + apply(p["ffn"], cfg, L.rms_norm(x, p["norm2"]))


def apply_block(p, cfg, kind: str, x, positions):
    if kind == "mlstm":
        return R.apply_mlstm_block(p, cfg, x)
    if kind == "slstm":
        return R.apply_slstm_block(p, cfg, x)
    if kind == "rglru":
        return _ffn(p, cfg, R.apply_rglru_block(p["mix"], cfg, x))
    xn = L.rms_norm(x, p["norm1"])
    if kind == "mla":
        return _ffn(p, cfg, x + L.apply_mla(p["mix"], cfg, xn, positions))
    window = cfg.window if kind == "local_attn" else 0
    return _ffn(p, cfg, x + L.apply_attn(p["mix"], cfg, xn, positions,
                                         window=window))


# ---------------------------------------------------------------------------
# per-block prefill (returns the cache) and decode step
# ---------------------------------------------------------------------------


def init_block_cache(cfg, kind: str, B: int, S: int, device):
    """The decode cache of one block for ``B`` rows and a context of ``S``
    tokens: k/v for attention (a ring of min(window, S) slots for local
    attention), the latent (B, S, r) and rotated key (B, S, rope) for MLA,
    the carry for the recurrent kinds."""
    _check_kind(cfg, kind)
    if kind == "mlstm":
        return R.mlstm_carry_init(cfg, B, device)
    if kind == "slstm":
        return R.slstm_carry_init(cfg, B, device)
    if kind == "rglru":
        return R.rglru_carry_init(cfg, B, device)
    if kind == "mla":
        m = cfg.mla
        return {"latent": torch.zeros((B, S, m.kv_lora_rank),
                                      dtype=L.cdt(cfg), device=device),
                "k_rope": torch.zeros((B, S, m.qk_rope_head_dim),
                                      dtype=L.cdt(cfg), device=device)}
    W = min(cfg.window, S) if kind == "local_attn" else S
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.cdt(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.cdt(cfg), device=device)}


def spec_block_cache(cfg, kind: str):
    """Logical specs for cache leaves: batch over ("pod","data"); the
    KV-cache sequence dim is sequence-parallel over "model"."""
    if kind == "attn":
        return {"k": ("batch", "seq", None, None),
                "v": ("batch", "seq", None, None)}
    if kind == "local_attn":
        return {"k": ("batch", None, None, None),
                "v": ("batch", None, None, None)}
    if kind == "mla":
        return {"latent": ("batch", "seq", None),
                "k_rope": ("batch", "seq", None)}
    if kind == "mlstm":
        return (("batch", None, "model", None), ("batch", None, "model"),
                ("batch", None))
    if kind == "slstm":
        return (("batch", None, None), ("batch", None, None),
                ("batch", None, None), ("batch", None, None))
    if kind == "rglru":
        return {"h": ("batch", "model"), "conv": ("batch", None, "model")}
    raise ValueError(kind)


def _attn_cache(cfg, kind, entries: dict, cache_len):
    """Prefill's per-token cache entries (B, T, ...) as a decode cache:
    ``{"k", "v"}`` for attention, ``{"latent", "k_rope"}`` for MLA.
    Without ``cache_len`` the JAX package's layout: T slots, the last
    min(window, T) for local attention.  With it, the cache of
    ``init_block_cache`` for that context, position p in slot p (p %
    window for local attention), which decode steps after the prompt go
    on filling."""
    e0 = next(iter(entries.values()))
    B, T = e0.shape[:2]
    if cache_len is None:
        if kind == "local_attn":
            W = min(cfg.window, T)
            entries = {n: e[:, -W:] for n, e in entries.items()}
        return entries
    if cache_len < T:
        raise ValueError(f"cache of {cache_len} tokens for a prompt of {T}")
    cache = init_block_cache(cfg, kind, B, cache_len, e0.device)
    for n, e in entries.items():
        keep = min(cache[n].shape[1], T)
        pos = torch.arange(T - keep, T, device=e.device)
        slots = pos % cfg.window if kind == "local_attn" else pos
        cache[n][:, slots] = e[:, -keep:]
    return cache


def prefill_block(p, cfg, kind: str, x, positions, cache_len=None):
    """Forward + build the decode cache.  Returns (x_out, cache)."""
    ct = L.cdt(cfg)
    if kind == "mlstm":
        return R.apply_mlstm_block(p, cfg, x, return_carry=True)
    if kind == "slstm":
        return R.apply_slstm_block(p, cfg, x, return_carry=True)
    if kind == "rglru":
        x, carry = R.apply_rglru_block(p["mix"], cfg, x, return_carry=True)
        return _ffn(p, cfg, x), carry
    # attention: recompute the cache entries (cheap beside attention)
    xn = L.rms_norm(x, p["norm1"])
    if kind == "mla":
        q_nope, q_rope, latent, k_rope = L._mla_qkv(p["mix"], cfg, xn.to(ct),
                                                    positions)
        mix = L._mla_attend(p["mix"], cfg, q_nope, q_rope, latent, k_rope,
                            causal=True)
        entries = {"latent": latent.to(ct), "k_rope": k_rope[:, :, 0].to(ct)}
    else:
        window = cfg.window if kind == "local_attn" else 0
        mix = L.apply_attn(p["mix"], cfg, xn, positions, window=window)
        k = torch.einsum("btd,dgk->btgk", xn.to(ct), p["mix"]["wk"].to(ct))
        v = torch.einsum("btd,dgk->btgk", xn.to(ct), p["mix"]["wv"].to(ct))
        k = L.rope(k, positions, cfg.rope_theta)
        entries = {"k": k.to(ct), "v": v.to(ct)}
    cache = _attn_cache(cfg, kind, entries, cache_len)
    return _ffn(p, cfg, x + mix), cache


def decode_block(p, cfg, kind: str, x, cache, pos):
    """One-token decode.  x: (B,1,d).  Returns (x_out, cache)."""
    if kind == "mlstm":
        return R.mlstm_block_step(p, cfg, x, cache)
    if kind == "slstm":
        return R.slstm_block_step(p, cfg, x, cache)
    if kind == "rglru":
        x, cache = R.rglru_block_step(p["mix"], cfg, x, cache)
        return _ffn(p, cfg, x), cache
    xn = L.rms_norm(x, p["norm1"])
    if kind == "mla":
        mix, lat, kr = L.mla_decode(p["mix"], cfg, xn, cache["latent"],
                                    cache["k_rope"], pos)
        return _ffn(p, cfg, x + mix), {"latent": lat, "k_rope": kr}
    window = cfg.window if kind == "local_attn" else 0
    mix, ck, cv = L.attn_decode(p["mix"], cfg, xn, cache["k"], cache["v"],
                                pos, window=window)
    return _ffn(p, cfg, x + mix), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# full LM
# ---------------------------------------------------------------------------


def _pattern(cfg):
    P = len(cfg.block_pattern)
    return cfg.block_pattern, cfg.num_layers // P, cfg.num_layers % P


def init_lm(gen, cfg, device):
    """``{"emb", "blocks", "rem", "final_norm"[, "lm_head"]}``: ``blocks`` is
    a tuple over the pattern of block dicts stacked over the groups."""
    pat, n_groups, rem = _pattern(cfg)
    dt = L.pdt(cfg)
    V = cfg.padded_vocab
    stacked = _stack([tuple(init_block(gen, cfg, kind, device)
                            for kind in pat) for _ in range(n_groups)])
    rem_params = tuple(init_block(gen, cfg, pat[i % len(pat)], device)
                       for i in range(rem))
    params = {
        "emb": L.he(gen, (V, cfg.d_model), dt, device, fan_in=cfg.d_model),
        "blocks": stacked,
        "rem": rem_params,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.he(gen, (cfg.d_model, V), dt, device)
    return params


def spec_lm(cfg):
    pat, n_groups, rem = _pattern(cfg)
    spec = {
        "emb": ("model", "fsdp"),
        # stacked over groups: a leading None (layer) dim on every leaf
        "blocks": sharding.stacked(tuple(spec_block(cfg, kind)
                                         for kind in pat)),
        "rem": tuple(spec_block(cfg, pat[i % len(pat)]) for i in range(rem)),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ("fsdp", "model")
    return spec


def _stack(blocks: list):
    """One tree (dicts and tuples) whose leaves stack the given trees'
    leaves.  Of one tree, the leaves are views with a leading dimension of
    1, not copies: a single group's parameters (38.8 GB for one
    kimi-k2-1t-a32b layer) are never held twice."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    if isinstance(blocks[0], tuple):
        return tuple(_stack([b[i] for b in blocks])
                     for i in range(len(blocks[0])))
    if len(blocks) == 1:
        return blocks[0].unsqueeze(0)
    return torch.stack(blocks)


def _unstack(tree, n: int) -> list:
    """The inverse of ``_stack``: ``n`` trees, one ``unbind`` a leaf (so
    the leaf's gradient is one stack of the groups' gradients, not one
    zero-filled copy a group)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unstack(v, n) for v in tree]
        return [tuple(part[i] for part in parts) for i in range(n)]
    return list(tree.unbind(0))


def _embed(params, cfg, tokens, extra_embeds=None):
    """Token embeddings, after ``extra_embeds`` (B, P, d) when given (the
    vision stub's patches)."""
    emb = params["emb"]
    if cfg.fsdp:
        emb = gather_fsdp(emb, ("model", "fsdp"))
    x = _constrain(embed_lookup(emb, tokens).to(L.cdt(cfg)), "batch", None,
                   None)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"])
    w = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    if cfg.fsdp and not cfg.tie_embeddings:
        w = gather_fsdp(w, ("fsdp", "model"))
    logits = L.wide(x @ w.to(x.dtype))
    V = cfg.padded_vocab
    if V != cfg.vocab_size:  # mask the padding vocab entries
        mask = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return logits


def _scan_groups(params, cfg, x, apply_fn):
    """apply_fn(block_params, kind, x) -> x over every full group, then the
    remainder layers."""
    pat, n_groups, rem = _pattern(cfg)
    per_kind = [_unstack(bp, n_groups) for bp in params["blocks"]]
    gspecs = tuple(spec_block(cfg, kind) for kind in pat)

    def group_body(x, g):
        for i, kind in enumerate(pat):
            p = per_kind[i][g]
            if cfg.fsdp:
                p = gather_fsdp(p, gspecs[i])
            x = apply_fn(p, kind, x)
        return x

    for g in range(n_groups):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(group_body, x, g, use_reentrant=False)
        else:
            x = group_body(x, g)
    for i in range(rem):
        rp = params["rem"][i]
        if cfg.fsdp:
            rp = gather_fsdp(rp, gspecs[i % len(pat)])
        x = apply_fn(rp, pat[i % len(pat)], x)
    return x


def lm_forward(params, cfg, tokens, extra_embeds=None):
    """tokens: (B, T) integer; extra_embeds: (B, P, d) prepended -> (B,
    P + T, padded_vocab) float32 logits (float64 with a float64 compute
    dtype)."""
    x = _embed(params, cfg, tokens, extra_embeds)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    x = _scan_groups(params, cfg, x,
                     lambda p, kind, h: apply_block(p, cfg, kind, h,
                                                    positions))
    return _logits(params, cfg, x)


def lm_loss(params, cfg, batch):
    """Mean next-token negative log-likelihood of the text tokens; the
    patches (``batch["patches"]``, when present) are context only."""
    tokens = batch["tokens"]
    extra = batch.get("patches")
    logits = lm_forward(params, cfg, tokens, extra_embeds=extra)
    P = 0 if extra is None else extra.shape[1]
    # predict token t+1 from text position t
    return token_nll(logits[:, P:-1], tokens[:, 1:].long()).mean()


# ---- prefill / decode -----------------------------------------------------


def lm_prefill(params, cfg, tokens, cache_len=None, extra_embeds=None):
    """tokens: (B, T) -> (last_logits (B, V), cache), the cache stacked like
    the parameters: ``{"blocks": tuple over the pattern, each stacked over
    the groups, "rem": tuple}``.  ``cache_len`` sizes the attention caches
    for decoding past the prompt (``_attn_cache``); the recurrent carries
    do not depend on it.  ``extra_embeds`` (B, P, d) are prepended, so the
    caches hold P + T positions."""
    x = _embed(params, cfg, tokens, extra_embeds)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    pat, n_groups, rem = _pattern(cfg)
    per_kind = [_unstack(bp, n_groups) for bp in params["blocks"]]
    gspecs = tuple(spec_block(cfg, kind) for kind in pat)
    caches = []
    for g in range(n_groups):
        group = []
        for i, kind in enumerate(pat):
            p = per_kind[i][g]
            if cfg.fsdp:
                p = gather_fsdp(p, gspecs[i])
            x, c = prefill_block(p, cfg, kind, x, positions, cache_len)
            group.append(c)
        caches.append(tuple(group))
    rem_cache = []
    for i in range(rem):
        x, c = prefill_block(params["rem"][i], cfg, pat[i % len(pat)], x,
                             positions, cache_len)
        rem_cache.append(c)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, {"blocks": _stack(caches), "rem": tuple(rem_cache)}


def lm_cache_init(cfg, B, S, device):
    """An empty decode cache for ``B`` rows and a context of ``S`` tokens."""
    pat, n_groups, rem = _pattern(cfg)
    group = tuple(init_block_cache(cfg, kind, B, S, device) for kind in pat)
    return {"blocks": _stack([group] * n_groups),
            "rem": tuple(init_block_cache(cfg, pat[i % len(pat)], B, S,
                                          device) for i in range(rem))}


def lm_cache_spec(cfg):
    pat, n_groups, rem = _pattern(cfg)
    return {"blocks": sharding.stacked(tuple(spec_block_cache(cfg, kind)
                                             for kind in pat)),
            "rem": tuple(spec_block_cache(cfg, pat[i % len(pat)])
                         for i in range(rem))}


def lm_decode_step(params, cfg, cache, token, pos):
    """token: (B, 1); pos: the position of the token (an int or a 0-d
    tensor).  Returns (logits (B, V), the new cache)."""
    x = _embed(params, cfg, token)
    pat, n_groups, rem = _pattern(cfg)
    per_kind = [_unstack(bp, n_groups) for bp in params["blocks"]]
    per_cache = [_unstack(bc, n_groups) for bc in cache["blocks"]]
    gspecs = tuple(spec_block(cfg, kind) for kind in pat)
    groups = []
    for g in range(n_groups):
        new_c = []
        for i, kind in enumerate(pat):
            p = per_kind[i][g]
            if cfg.fsdp:
                p = gather_fsdp(p, gspecs[i])
            x, c = decode_block(p, cfg, kind, x, per_cache[i][g], pos)
            new_c.append(c)
        groups.append(tuple(new_c))
    rem_cache = []
    for i in range(rem):
        x, c = decode_block(params["rem"][i], cfg, pat[i % len(pat)], x,
                            cache["rem"][i], pos)
        rem_cache.append(c)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {"blocks": _stack(groups), "rem": tuple(rem_cache)}
