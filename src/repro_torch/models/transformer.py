"""Decoder-only LM assembled from a block pattern, looped over layer groups.

The layer stack is ``cfg.block_pattern`` cycled; the ``num_layers // P``
full groups hold their parameters stacked along a leading dimension, as
the JAX package's ``jax.lax.scan`` over groups lays them out, and the
``num_layers % P`` remainder layers are held unstacked.  Here the scan is a
loop over that leading dimension, each group recomputed in the backward
pass when ``cfg.remat`` (``torch.utils.checkpoint``, as ``jax.checkpoint``).

Ported block kinds: ``"attn"`` and ``"local_attn"`` with a dense MLP.  The
sharding constraints of the JAX package (``_constrain``, ``gather_fsdp``)
have nothing to do on one card.  MLA, MoE and recurrent blocks, prefill and
decode wait (ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

_PORTED_KINDS = ("attn", "local_attn")


def _check_kind(cfg, kind: str):
    if kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 9)")
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP.md queue 1, item 9)")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def init_block(gen, cfg, kind: str, device):
    _check_kind(cfg, kind)
    dt = L.pdt(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return {"norm1": ones, "mix": L.init_attn(gen, cfg, device),
            "norm2": ones.clone(), "ffn": L.init_mlp(gen, cfg, device)}


def apply_block(p, cfg, kind: str, x, positions):
    window = cfg.window if kind == "local_attn" else 0
    x = x + L.apply_attn(p["mix"], cfg, L.rms_norm(x, p["norm1"]), positions,
                         window=window)
    return x + L.apply_mlp(p["ffn"], cfg, L.rms_norm(x, p["norm2"]))


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
    groups = [tuple(init_block(gen, cfg, kind, device) for kind in pat)
              for _ in range(n_groups)]
    stacked = tuple(_stack([g[i] for g in groups]) for i in range(len(pat)))
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
    """One tree whose leaves stack the given trees' leaves."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def _unstack(tree, n: int) -> list:
    """The inverse of ``_stack``: ``n`` trees, one ``unbind`` a leaf (so
    the leaf's gradient is one stack of the groups' gradients, not one
    zero-filled copy a group)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _embed(params, cfg, tokens):
    return params["emb"][tokens].to(L.cdt(cfg))


def _logits(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"])
    w = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w.to(x.dtype)).float()
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


def lm_forward(params, cfg, tokens):
    """tokens: (B, T) integer -> (B, T, padded_vocab) float32 logits."""
    x = _embed(params, cfg, tokens)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    x = _scan_groups(params, cfg, x,
                     lambda p, kind, h: apply_block(p, cfg, kind, h,
                                                    positions))
    return _logits(params, cfg, x)


def lm_loss(params, cfg, batch):
    """Mean next-token negative log-likelihood."""
    tokens = batch["tokens"]
    logits = lm_forward(params, cfg, tokens)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()
