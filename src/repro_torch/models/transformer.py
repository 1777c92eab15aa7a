"""Decoder-only LM assembled from a block pattern, looped over layer groups.

The layer stack is ``cfg.block_pattern`` cycled; the ``num_layers // P``
full groups hold their parameters stacked along a leading dimension, as
the JAX package's ``jax.lax.scan`` over groups lays them out, and the
``num_layers % P`` remainder layers are held unstacked (recurrentgemma's
26 = 8*3 + 2).  Here the scan is a loop over that leading dimension, each
group recomputed in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``, as ``jax.checkpoint``).

Ported block kinds: ``"attn"`` and ``"local_attn"`` with a dense MLP,
xLSTM's ``"mlstm"`` and ``"slstm"`` (self-contained blocks) and RG-LRU's
``"rglru"`` (the recurrent mix, then a dense MLP), each with its prefill
(forward plus the decode cache) and one-token decode.  ``extra_embeds``
(the vision frontend stub's patch embeddings) are prepended to the token
embeddings.  The sharding constraints of the JAX package (``_constrain``,
``gather_fsdp``) have nothing to do on one card.  MLA and MoE blocks wait
(ROADMAP.md queue 1, item 9, and its MoE note).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

_PORTED_KINDS = ("attn", "local_attn", "mlstm", "slstm", "rglru")


def _check_kind(cfg, kind: str):
    if kind not in _PORTED_KINDS or cfg.attention == "mla" or \
            cfg.mla is not None:
        raise NotImplementedError(
            f"block kind {kind!r} (attention {cfg.attention!r}) is not "
            f"ported yet: ROADMAP.md queue 1, item 9 has MLA left (item "
            f"9b)")
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE blocks are not ported yet: ROADMAP.md queue 1, item 9's "
            "MoE note puts them after item 10")


def check_config(cfg):
    """Raise ``NotImplementedError`` for a configuration whose blocks the
    port does not have yet (MLA, MoE)."""
    for kind in cfg.block_pattern:
        _check_kind(cfg, kind)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


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
                "ffn": L.init_mlp(gen, cfg, device)}
    return {"norm1": ones, "mix": L.init_attn(gen, cfg, device),
            "norm2": ones.clone(), "ffn": L.init_mlp(gen, cfg, device)}


def _ffn(p, cfg, x):
    return x + L.apply_mlp(p["ffn"], cfg, L.rms_norm(x, p["norm2"]))


def apply_block(p, cfg, kind: str, x, positions):
    if kind == "mlstm":
        return R.apply_mlstm_block(p, cfg, x)
    if kind == "slstm":
        return R.apply_slstm_block(p, cfg, x)
    if kind == "rglru":
        return _ffn(p, cfg, R.apply_rglru_block(p["mix"], cfg, x))
    window = cfg.window if kind == "local_attn" else 0
    x = x + L.apply_attn(p["mix"], cfg, L.rms_norm(x, p["norm1"]), positions,
                         window=window)
    return _ffn(p, cfg, x)


# ---------------------------------------------------------------------------
# per-block prefill (returns the cache) and decode step
# ---------------------------------------------------------------------------


def init_block_cache(cfg, kind: str, B: int, S: int, device):
    """The decode cache of one block for ``B`` rows and a context of ``S``
    tokens: k/v for attention (a ring of min(window, S) slots for local
    attention), the carry for the recurrent kinds."""
    _check_kind(cfg, kind)
    if kind == "mlstm":
        return R.mlstm_carry_init(cfg, B, device)
    if kind == "slstm":
        return R.slstm_carry_init(cfg, B, device)
    if kind == "rglru":
        return R.rglru_carry_init(cfg, B, device)
    W = min(cfg.window, S) if kind == "local_attn" else S
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.cdt(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.cdt(cfg), device=device)}


def _attn_cache(cfg, kind, k, v, cache_len):
    """Prefill's k/v (B,T,K,hd) as a decode cache.  Without ``cache_len``
    the JAX package's layout: T slots, the last min(window, T) for local
    attention.  With it, the cache of ``init_block_cache`` for that context,
    position p in slot p (p % window for local attention), which decode
    steps after the prompt go on filling."""
    T = k.shape[1]
    if cache_len is None:
        if kind == "local_attn":
            W = min(cfg.window, T)
            k, v = k[:, -W:], v[:, -W:]
        return {"k": k, "v": v}
    if cache_len < T:
        raise ValueError(f"cache of {cache_len} tokens for a prompt of {T}")
    cache = init_block_cache(cfg, kind, k.shape[0], cache_len, k.device)
    W = cache["k"].shape[1]
    keep = min(W, T)
    pos = torch.arange(T - keep, T, device=k.device)
    slots = pos % cfg.window if kind == "local_attn" else pos
    cache["k"][:, slots] = k[:, -keep:]
    cache["v"][:, slots] = v[:, -keep:]
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
    # attention: recompute k/v (cheap beside attention) for the cache
    xn = L.rms_norm(x, p["norm1"])
    window = cfg.window if kind == "local_attn" else 0
    mix = L.apply_attn(p["mix"], cfg, xn, positions, window=window)
    k = torch.einsum("btd,dgk->btgk", xn.to(ct), p["mix"]["wk"].to(ct))
    v = torch.einsum("btd,dgk->btgk", xn.to(ct), p["mix"]["wv"].to(ct))
    k = L.rope(k, positions, cfg.rope_theta)
    cache = _attn_cache(cfg, kind, k.to(ct), v.to(ct), cache_len)
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
    window = cfg.window if kind == "local_attn" else 0
    mix, ck, cv = L.attn_decode(p["mix"], cfg, L.rms_norm(x, p["norm1"]),
                                cache["k"], cache["v"], pos, window=window)
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


def _stack(blocks: list):
    """One tree (dicts and tuples) whose leaves stack the given trees'
    leaves."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    if isinstance(blocks[0], tuple):
        return tuple(_stack([b[i] for b in blocks])
                     for i in range(len(blocks[0])))
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
    x = params["emb"][tokens].to(L.cdt(cfg))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"])
    w = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
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

    def group_body(x, g):
        for i, kind in enumerate(pat):
            x = apply_fn(per_kind[i][g], kind, x)
        return x

    for g in range(n_groups):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(group_body, x, g, use_reentrant=False)
        else:
            x = group_body(x, g)
    for i in range(rem):
        x = apply_fn(params["rem"][i], pat[i % len(pat)], x)
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
    logp = torch.log_softmax(logits[:, P:-1], dim=-1)
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


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
    caches = []
    for g in range(n_groups):
        group = []
        for i, kind in enumerate(pat):
            x, c = prefill_block(per_kind[i][g], cfg, kind, x, positions,
                                 cache_len)
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


def lm_decode_step(params, cfg, cache, token, pos):
    """token: (B, 1); pos: the position of the token (an int or a 0-d
    tensor).  Returns (logits (B, V), the new cache)."""
    x = _embed(params, cfg, token)
    pat, n_groups, rem = _pattern(cfg)
    per_kind = [_unstack(bp, n_groups) for bp in params["blocks"]]
    per_cache = [_unstack(bc, n_groups) for bc in cache["blocks"]]
    groups = []
    for g in range(n_groups):
        new_c = []
        for i, kind in enumerate(pat):
            x, c = decode_block(per_kind[i][g], cfg, kind, x,
                                per_cache[i][g], pos)
            new_c.append(c)
        groups.append(tuple(new_c))
    rem_cache = []
    for i in range(rem):
        x, c = decode_block(params["rem"][i], cfg, pat[i % len(pat)], x,
                            cache["rem"][i], pos)
        rem_cache.append(c)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {"blocks": _stack(groups), "rem": tuple(rem_cache)}
