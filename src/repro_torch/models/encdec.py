"""Encoder-decoder transformer (whisper-medium backbone), the port of
``repro.models.encdec``.

The audio (conv) frontend is a stub: the batch carries precomputed frame
embeddings (B, T_enc, d_model).  Encoder blocks are non-causal full
attention; decoder blocks are causal self-attention, then cross-attention
to the encoder output, with learned decoder position embeddings.  No RoPE
(whisper predates it): sinusoidal positions are added to the frames.

The parameter tree has the JAX package's leaf names and stacking: the
``enc_blocks`` and ``dec_blocks`` leaves stack the layers along a leading
dimension, which ``jax.lax.scan`` walks and a loop walks here, each layer
recomputed in the backward pass when ``cfg.remat``.  The reference's
numerics are kept as they are:
  - ``encdec_decode_step`` adds ``pos_emb`` in the parameter dtype without
    a cast, so with a bf16 compute dtype the decode residual stream is f32
    while training and prefill run it in bf16;
  - ``encdec_cache_init`` sizes the cross cache at ``CROSS_LEN``, whatever
    the frames' length; ``encdec_prefill`` returns cross caches of the
    frames' own length;
  - decode clips the position at ``dec_max_len - 1`` for ``pos_emb`` but
    writes the self-attention cache at the position itself;
  - the blocks use RMSNorm, and the padded vocabulary is masked to -1e30.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_attn_cache, _stack, _unstack,
                                            embed_lookup, token_nll)

CROSS_LEN = 1500  # whisper's native encoder length, the decode cross cache's


def _init_enc_block(gen, cfg, device):
    ones = torch.ones((cfg.d_model,), dtype=L.pdt(cfg), device=device)
    return {"norm1": ones, "attn": L.init_attn(gen, cfg, device),
            "norm2": ones.clone(), "mlp": L.init_mlp(gen, cfg, device)}


def _init_dec_block(gen, cfg, device):
    ones = torch.ones((cfg.d_model,), dtype=L.pdt(cfg), device=device)
    return {"norm1": ones, "self": L.init_attn(gen, cfg, device),
            "norm_x": ones.clone(), "cross": L.init_attn(gen, cfg, device),
            "norm2": ones.clone(), "mlp": L.init_mlp(gen, cfg, device)}


def _spec_enc_block(cfg):
    return {"norm1": (None,), "attn": L.spec_attn(cfg),
            "norm2": (None,), "mlp": L.spec_mlp(cfg)}


def _spec_dec_block(cfg):
    return {"norm1": (None,), "self": L.spec_attn(cfg),
            "norm_x": (None,), "cross": L.spec_attn(cfg),
            "norm2": (None,), "mlp": L.spec_mlp(cfg)}


def spec_encdec(cfg):
    return {
        "enc_blocks": sharding.stacked(_spec_enc_block(cfg)),
        "enc_norm": (None,),
        "dec_blocks": sharding.stacked(_spec_dec_block(cfg)),
        "dec_norm": (None,),
        "tok_emb": ("model", "fsdp"), "pos_emb": (None, None),
        "lm_head": ("fsdp", "model"),
    }


def init_encdec(gen, cfg, device):
    """``{"enc_blocks", "enc_norm", "dec_blocks", "dec_norm", "tok_emb",
    "pos_emb", "lm_head"}`` on ``device``, drawn from ``gen``."""
    dt = L.pdt(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    enc = [_init_enc_block(gen, cfg, device) for _ in range(cfg.enc_layers)]
    dec = [_init_dec_block(gen, cfg, device) for _ in range(cfg.num_layers)]
    return {
        "enc_blocks": _stack(enc),
        "enc_norm": torch.ones((d,), dtype=dt, device=device),
        "dec_blocks": _stack(dec),
        "dec_norm": torch.ones((d,), dtype=dt, device=device),
        "tok_emb": L.he(gen, (V, d), dt, device, fan_in=d),
        "pos_emb": L.he(gen, (cfg.dec_max_len, d), dt, device, fan_in=d),
        "lm_head": L.he(gen, (d, V), dt, device),
    }


def _layers(cfg, body, x, n: int):
    """``x = body(x, i)`` for the layers ``i < n``, each recomputed in the
    backward pass when ``cfg.remat`` (``jax.checkpoint`` over the scan
    body)."""
    for i in range(n):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, i, use_reentrant=False)
        else:
            x = body(x, i)
    return x


def encode(params, cfg, frames):
    """frames: (B, T_enc, d) precomputed embeddings (the frontend stub) ->
    the encoder output (B, T_enc, d) in the compute dtype."""
    ct = L.cdt(cfg)
    T = frames.shape[1]
    x = frames.to(ct) + L.sinusoidal_pos(T, cfg.d_model, ct,
                                         frames.device)[None]
    blocks = _unstack(params["enc_blocks"], cfg.enc_layers)

    def body(x, i):
        bp = blocks[i]
        h = L.apply_attn(bp["attn"], cfg, L.rms_norm(x, bp["norm1"]), None,
                         causal=False, use_rope=False)
        x = x + h
        return x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["norm2"]))

    x = _layers(cfg, body, x, cfg.enc_layers)
    return L.rms_norm(x, params["enc_norm"])


def _dec_logits(params, cfg, x):
    x = L.rms_norm(x, params["dec_norm"])
    logits = L.wide(x @ params["lm_head"].to(x.dtype))
    V = cfg.padded_vocab
    if V != cfg.vocab_size:  # mask the padding vocab entries
        mask = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return logits


def _embed(params, cfg, tokens):
    ct = L.cdt(cfg)
    T = tokens.shape[1]
    return embed_lookup(params["tok_emb"], tokens).to(ct) \
        + params["pos_emb"][:T].to(ct)[None]


def _dec_block(bp, cfg, x, enc_out):
    """One decoder block over the whole sequence.  Returns (x_out, xn, ek,
    ev): xn the self-attention's normed input, ek/ev the cross keys and
    values."""
    xn = L.rms_norm(x, bp["norm1"])
    x = x + L.apply_attn(bp["self"], cfg, xn, None, causal=True,
                         use_rope=False)
    ek, ev = L.cross_kv(bp["cross"], cfg, enc_out)
    x = x + L.apply_cross_attn(bp["cross"], cfg, L.rms_norm(x, bp["norm_x"]),
                               ek, ev)
    x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["norm2"]))
    return x, xn, ek, ev


def decode_train(params, cfg, tokens, enc_out):
    """Teacher-forced decoder.  tokens: (B, T_dec) -> (B, T_dec,
    padded_vocab) float32 logits (float64 with a float64 compute dtype)."""
    blocks = _unstack(params["dec_blocks"], cfg.num_layers)
    x = _layers(cfg, lambda x, i: _dec_block(blocks[i], cfg, x, enc_out)[0],
                _embed(params, cfg, tokens), cfg.num_layers)
    return _dec_logits(params, cfg, x)


def encdec_loss(params, cfg, batch):
    """Mean next-token negative log-likelihood of the decoder tokens."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    logits = decode_train(params, cfg, tokens, enc_out)
    return token_nll(logits[:, :-1], tokens[:, 1:].long()).mean()


def encdec_prefill(params, cfg, batch, cache_len=None):
    """Encoder forward and decoder prefill -> (last_logits (B, V), cache):
    ``{"k", "v", "cross_k", "cross_v"}``, each stacked over the decoder
    layers.  The self-attention caches hold the prompt's T slots (the JAX
    package's layout), or ``cache_len`` slots with position p in slot p,
    which decode steps after the prompt go on filling; the cross caches
    hold the frames' own length."""
    enc_out = encode(params, cfg, batch["frames"])
    ct = L.cdt(cfg)
    blocks = _unstack(params["dec_blocks"], cfg.num_layers)
    x = _embed(params, cfg, batch["tokens"])
    caches = []
    for bp in blocks:
        x, xn, ek, ev = _dec_block(bp, cfg, x, enc_out)
        k = torch.einsum("btd,dgk->btgk", xn.to(ct), bp["self"]["wk"].to(ct))
        v = torch.einsum("btd,dgk->btgk", xn.to(ct), bp["self"]["wv"].to(ct))
        c = _attn_cache(cfg, "attn", {"k": k, "v": v}, cache_len)
        caches.append({"k": c["k"], "v": c["v"], "cross_k": ek,
                       "cross_v": ev})
    return _dec_logits(params, cfg, x[:, -1:])[:, 0], _stack(caches)


def encdec_cache_init(cfg, B, S, device):
    """An empty decode cache: self-attention k/v of ``S`` slots and cross
    k/v of ``CROSS_LEN``, in the compute dtype."""
    ct = L.cdt(cfg)
    Ld, K, hd, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=ct, device=device)

    return {"k": zeros(Ld, B, S, K, hd), "v": zeros(Ld, B, S, K, hd),
            "cross_k": zeros(Ld, B, CROSS_LEN, H, hd),
            "cross_v": zeros(Ld, B, CROSS_LEN, H, hd)}


def encdec_cache_spec(cfg):
    return {
        "k": (None, "batch", "seq", None, None),
        "v": (None, "batch", "seq", None, None),
        "cross_k": (None, "batch", "seq", None, None),
        "cross_v": (None, "batch", "seq", None, None),
    }


def encdec_decode_step(params, cfg, cache, token, pos):
    """token: (B, 1); pos: the position of the token (an int or a 0-d
    tensor); ``cache`` from ``encdec_cache_init`` or ``encdec_prefill``.
    Returns (logits (B, V), the new cache)."""
    ct = L.cdt(cfg)
    pos = torch.as_tensor(pos, device=token.device)
    pos_c = torch.clamp(pos, 0, cfg.dec_max_len - 1)
    # no cast of pos_emb: the residual stream is in the wider of the two
    x = params["tok_emb"][token].to(ct) + params["pos_emb"][pos_c][None, None]
    blocks = _unstack(params["dec_blocks"], cfg.num_layers)
    per_layer = _unstack(cache, cfg.num_layers)
    new = []
    for bp, c in zip(blocks, per_layer):
        # self-attention against the running cache; positions are added to
        # the input, so the cached keys need no rotation
        h, ck, cv = L.attn_decode(bp["self"], cfg, L.rms_norm(x, bp["norm1"]),
                                  c["k"], c["v"], pos, use_rope=False)
        x = x + h
        x = x + L.apply_cross_attn(bp["cross"], cfg,
                                   L.rms_norm(x, bp["norm_x"]),
                                   c["cross_k"].to(ct), c["cross_v"].to(ct))
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["norm2"]))
        new.append({"k": ck, "v": cv, "cross_k": c["cross_k"],
                    "cross_v": c["cross_v"]})
    return _dec_logits(params, cfg, x)[:, 0], _stack(new)
