"""The port's encoder-decoder (whisper-medium) against the JAX package on
the CPU: the same numpy inputs and the JAX parameters carried across
through numpy go through ``repro.models.encdec`` and
``repro_torch.models.encdec``.

Tolerances, as in ``test_torch_models``: with ``compute_dtype="float32"``
the layers, the encoder output and the logits agree within rtol 1e-5 /
atol 1e-5 (each value the end of a few hundred f32 sums a layer, summed in
other orders by the two packages), the loss within rtol 1e-5 / atol 1e-6,
every gradient leaf within rtol 1e-4 / atol 1e-6; with the default bf16
compute the loss within 2e-2 absolute (bf16 matmul inputs, rounded at
other places).  Prefill caches and decode logits against JAX's within the
forward tolerance.  Decode against the teacher-forced decoder: the case of
``tests/test_recurrent_equiv.py`` at its rtol/atol of 4e-2, and in f32
after a prefill into caches sized for the whole context within rtol 1e-5 /
atol 1e-5 (the same f32 sums in other orders, no bf16 anywhere).  Batches,
the stream and checkpoint bytes are equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import base as jbase
from repro.models import encdec as jED
from repro.models import layers as jL
from repro.models import model as jmodel
from repro.train import data as jdata
from repro.train import steps as jsteps
import repro_torch.core as tcore
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.launch import train as trainer
from repro_torch.models import encdec as tED
from repro_torch.models import layers as tL
from repro_torch.models import model as tmodel
from repro_torch.train import data as tdata
from repro_torch.train import steps as tsteps

ARCH = "whisper-medium"
FWD = dict(rtol=1e-5, atol=1e-5)

# smoke-size variants: (overrides); GQA kv heads repeated for the cross
# attention, remat over the layer loops and a padded vocab masked to -1e30
VARIANTS = {"smoke": {},
            "gqa-remat-padded": dict(num_kv_heads=2, remat=True,
                                     vocab_size=500)}


@pytest.fixture(autouse=True)
def port_env():
    """The port on its plain CPU versions, under its own lock checker."""
    prev = ops.get_device()
    ops.set_device("cpu")
    tconc.reset()
    tconc.enable("raise")
    yield
    leftovers = tconc.violations()
    tconc.disable()
    tconc.reset()
    ops.set_device(prev)
    assert not leftovers, "\n".join(leftovers)


def _cfgs(**over):
    return (jbase.smoke_config(ARCH).replace(**over),
            tbase.smoke_config(ARCH).replace(**over))


def _port(tree):
    return tsteps.state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _jax_leaves(tree):
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_tree_close(got, want, tol):
    want = _jax_leaves(want)
    got = [(n, _np(t)) for n, t in leaves_with_paths(got)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _inputs(cfg, seed=0, B=2, T_enc=12, T_dec=10):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, T_enc, cfg.d_model)) * 0.05) \
        .astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_dec)).astype(np.int32)
    return frames, tokens


def _setup(seed=1, **over):
    jcfg, tcfg = _cfgs(compute_dtype="float32", **over)
    jp = jED.init_encdec(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _port(jp)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d", [
    ("float32", 64), ("bfloat16", 64), ("float32", 1024), ("bfloat16", 1024)],
    ids=["float32", "bfloat16", "float32-d1024", "bfloat16-d1024"])
def test_sinusoidal_pos_matches_jax(dtype, d):
    """Up to whisper's 1500 positions, at d = 64 and at whisper-medium's
    d = 1024.  An angle up to 1499 rad is a quotient by a float32 power,
    each rounded to half an ulp: at d = 64 the sines agree within 2 ulps
    of 1500 in float32 (2.5e-4), within 1e-6 over the first 64 positions,
    and within one bf16 step (2^-7) once rounded.  The port rounds the
    power once from float64, as XLA's correctly rounded f32 ``pow`` does:
    at d = 1024 the tables then differ by one ulp of a sine, 2^-24
    (measured: 5.96e-8, where torch's f32 ``pow`` gave 3.05e-5), and are
    equal once rounded to bf16."""
    want = np.asarray(jL.sinusoidal_pos(1500, d, jnp.dtype(dtype)),
                      np.float32)
    got = tL.sinusoidal_pos(1500, d, tL.torch_dtype(dtype))
    assert got.dtype == tL.torch_dtype(dtype) and got.shape == (1500, d)
    if d == 1024:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=0 if dtype == "bfloat16" else 2 ** -24)
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-4)
        np.testing.assert_allclose(got[:64].numpy(), want[:64], rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 ** -7)
    f64 = tL.sinusoidal_pos(1500, d, torch.float64)
    assert f64.dtype == torch.float64  # computed wide, not through f32
    np.testing.assert_allclose(
        f64.numpy(), np.asarray(jL.sinusoidal_pos(1500, d, jnp.float32)),
        rtol=0, atol=2.5e-4)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_cross_kv_and_cross_attn_match_jax(kv_heads):
    jcfg, tcfg = _cfgs(compute_dtype="float32", num_kv_heads=kv_heads)
    p = jL.init_attn(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jk, jv = jL.cross_kv(p, jcfg, jnp.asarray(enc))
    tp = _port(p)
    tk, tv = tL.cross_kv(tp, tcfg, torch.from_numpy(enc))
    assert tuple(tk.shape) == (2, 7, jcfg.num_heads, jcfg.head_dim)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **FWD)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **FWD)
    want = jL.apply_cross_attn(p, jcfg, jnp.asarray(x), jk, jv)
    got = tL.apply_cross_attn(tp, tcfg, torch.from_numpy(x), tk, tv)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


def test_apply_attn_options_match_jax():
    """Non-causal attention without RoPE (the encoder's), and the default
    (RoPE, ``cfg.causal``) unchanged for existing callers."""
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    p = jL.init_attn(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    tp = _port(p)
    for kw in (dict(causal=False, use_rope=False), {}):
        want = jL.apply_attn(p, jcfg, jnp.asarray(x), jnp.asarray(pos), **kw)
        got = tL.apply_attn(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


# ---------------------------------------------------------------------------
# encoder, decoder, loss and gradients
# ---------------------------------------------------------------------------


def test_init_tree_matches_jax_layout():
    """Leaf names, shapes and dtypes of ``init_encdec`` equal JAX's."""
    jcfg, tcfg = _cfgs()
    jp = jED.init_encdec(jax.random.PRNGKey(0), jcfg)
    tp = tED.init_encdec(torch.Generator().manual_seed(0), tcfg, "cpu")
    want = [(n, a.shape, str(a.dtype)) for n, a in _jax_leaves(jp)]
    got = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in leaves_with_paths(tp)]
    assert got == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_and_decode_train_match_jax(variant):
    jcfg, tcfg, jp, tp = _setup(**VARIANTS[variant])
    frames, tokens = _inputs(jcfg)
    jenc = jED.encode(jp, jcfg, jnp.asarray(frames))
    tenc = tED.encode(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(tenc), np.asarray(jenc), **FWD)
    jlog = jED.decode_train(jp, jcfg, jnp.asarray(tokens), jenc)
    tlog = tED.decode_train(tp, tcfg, torch.from_numpy(tokens), tenc)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **FWD)
    if jcfg.padded_vocab != jcfg.vocab_size:
        assert (tlog[..., jcfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_f32_loss_and_grads_match_jax(variant):
    jcfg, tcfg, jp, tp = _setup(seed=6, **VARIANTS[variant])
    frames, tokens = _inputs(jcfg, seed=7)
    jloss, jgrads = jax.value_and_grad(jmodel.make_loss_fn(jcfg))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    leaves = [t.requires_grad_() for _, t in leaves_with_paths(tp)]
    tloss = tmodel.make_loss_fn(tcfg)(
        tp, {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, (name, w) in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_bf16_loss_close_to_jax():
    jcfg, tcfg = _cfgs()
    assert jcfg.compute_dtype == "bfloat16"
    jp = jED.init_encdec(jax.random.PRNGKey(4), jcfg)
    batch = jmodel.make_batch(jcfg, jbase.ShapeCfg("s", 16, 2, "train"),
                              seed=3)
    jloss = jED.encdec_loss(jp, jcfg, batch)
    tloss = tED.encdec_loss(_port(jp), tcfg, {
        "frames": tsteps.state_from_numpy(np.asarray(batch["frames"]), "cpu"),
        "tokens": torch.from_numpy(np.array(batch["tokens"]))})
    assert abs(float(tloss) - float(jloss)) < 2e-2


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_logits_and_caches_match_jax():
    """``encdec_prefill``'s last logits and caches against JAX's: the self
    caches hold the prompt's T slots, the cross caches the frames' length.
    With ``cache_len`` the self caches hold the same values in their first
    T slots and zeros after; the rest is unchanged."""
    jcfg, tcfg, jp, tp = _setup(seed=8)
    frames, tokens = _inputs(jcfg, seed=9)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(tokens)}
    jl, jc = jax.jit(lambda p, b: jED.encdec_prefill(p, jcfg, b))(jp, jb)
    tl, tc = tED.encdec_prefill(tp, tcfg, tb)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]),
                                   err_msg=k, **FWD)
    S = tcfg.dec_max_len
    tl2, tc2 = tmodel.make_prefill_fn(tcfg, cache_len=S)(tp, tb)
    np.testing.assert_array_equal(_np(tl2), _np(tl))
    T = tokens.shape[1]
    for k in ("k", "v"):
        assert tc2[k].shape[2] == S
        np.testing.assert_array_equal(_np(tc2[k][:, :, :T]), _np(tc[k]))
        assert (tc2[k][:, :, T:] == 0).all()
    for k in ("cross_k", "cross_v"):
        np.testing.assert_array_equal(_np(tc2[k]), _np(tc[k]))


def test_cache_init_matches_jax():
    jcfg, tcfg = _cfgs()
    jc = jmodel.cache_init(jcfg, 2, 16)
    tc = tmodel.cache_init(tcfg, 2, 16, device="cpu")
    assert tED.CROSS_LEN == jED.CROSS_LEN == 1500
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)
        assert not tc[k].any()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_decode_steps_match_jax(compute):
    """Decode steps against JAX's from the prefill's caches (the frames'
    cross length, the self caches extended to the whole context), logits
    and every cache leaf.  In bf16 the decode residual stream is f32 (the
    reference adds ``pos_emb`` uncast), so both packages' logits are f32;
    they differ by bf16 roundings at other places: logits within 2e-2, and
    cache values (up to ~4, where a bf16 step is 2^-5) within 4e-2."""
    jcfg, tcfg = _cfgs(compute_dtype=compute)
    jp = jED.init_encdec(jax.random.PRNGKey(10), jcfg)
    tp = _port(jp)
    frames, tokens = _inputs(jcfg, seed=11, T_dec=14)
    T, S = 8, 14
    ct = jnp.dtype(compute)
    jb = {"frames": jnp.asarray(frames, ct),
          "tokens": jnp.asarray(tokens[:, :T])}
    tb = {"frames": tmodel.float_tensor(frames.astype(np.float64), compute,
                                        "cpu"),
          "tokens": torch.from_numpy(tokens[:, :T])}
    _, jc = jED.encdec_prefill(jp, jcfg, jb)
    jc = dict(jc, k=jnp.pad(jc["k"], ((0, 0), (0, 0), (0, S - T), (0, 0),
                                      (0, 0))),
              v=jnp.pad(jc["v"], ((0, 0), (0, 0), (0, S - T), (0, 0),
                                  (0, 0))))
    _, tc = tmodel.make_prefill_fn(tcfg, cache_len=S)(tp, tb)
    tol = FWD if compute == "float32" else dict(rtol=2e-2, atol=2e-2)
    jdecode = jax.jit(jmodel.make_decode_fn(jcfg))
    tdecode = tmodel.make_decode_fn(tcfg)
    for pos in range(T, S):
        tok = tokens[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tdecode(tp, tc, torch.from_numpy(tok),
                         torch.tensor(pos, dtype=torch.int32))
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    if compute == "bfloat16":
        tol = dict(rtol=2e-2, atol=4e-2)
    for k in jc:
        assert tc[k].dtype == tL.torch_dtype(compute)
        np.testing.assert_allclose(_np(tc[k].float()),
                                   np.asarray(jc[k], np.float32),
                                   err_msg=k, **tol)


def test_attention_decode_agrees_with_forward():
    """``tests/test_recurrent_equiv.py::test_attention_decode_agrees_with_
    forward[whisper-medium]`` with its imports swapped: decode from
    ``cache_init`` (the cross cache rebuilt from the encoder output through
    ``cross_kv``) against the teacher-forced decoder, at its tolerance."""
    cfg = tbase.smoke_config(ARCH).replace(compute_dtype="float32")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    B, T = 2, 8
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))
    decode = tmodel.make_decode_fn(cfg)
    frames = torch.from_numpy(
        (rng.standard_normal((B, 8, cfg.d_model)) * 0.05).astype(np.float32))
    enc = tED.encode(params, cfg, frames)
    full_logits = tED.decode_train(params, cfg, tokens, enc)
    cache = tmodel.cache_init(cfg, B, T, device="cpu")
    # serving sizes the cross cache to the encoder output; rebuild it
    ck, cv = [], []
    for li in range(cfg.num_layers):
        bp = {k: v[li] for k, v in params["dec_blocks"]["cross"].items()}
        k, v = tL.cross_kv(bp, cfg, enc)
        ck.append(k)
        cv.append(v)
    cache["cross_k"] = torch.stack(ck)
    cache["cross_v"] = torch.stack(cv)
    for pos in range(T):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1],
                           torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), full_logits[:, pos].numpy(),
                                   rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("T", [1, 6])
def test_prefill_then_decode_continues_decode_train(T):
    """A prompt of T tokens prefilled into self caches sized for the whole
    context (``cache_len``), then one decode step a token: in f32 each
    row equals the teacher-forced decoder's at its position within the
    forward tolerance."""
    cfg = tbase.smoke_config(ARCH).replace(compute_dtype="float32")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(3),
                               device="cpu")
    frames, tokens = _inputs(cfg, seed=4, T_dec=cfg.dec_max_len)
    frames, tokens = torch.from_numpy(frames), torch.from_numpy(tokens)
    S = cfg.dec_max_len
    full = tED.decode_train(params, cfg, tokens, tED.encode(params, cfg,
                                                            frames))
    last, cache = tmodel.make_prefill_fn(cfg, cache_len=S)(
        params, {"frames": frames, "tokens": tokens[:, :T]})
    np.testing.assert_allclose(last.numpy(), full[:, T - 1].numpy(), **FWD)
    decode = tmodel.make_decode_fn(cfg)
    for pos in range(T, S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(), **FWD)


def test_decode_clips_position_for_pos_emb():
    """Past ``dec_max_len`` the reference clips the position for
    ``pos_emb`` but writes the self cache at the position itself: the
    port's step equals JAX's there."""
    jcfg, tcfg, jp, tp = _setup(seed=12)
    S = jcfg.dec_max_len + 2
    jc, tc = jmodel.cache_init(jcfg, 2, S), \
        tmodel.cache_init(tcfg, 2, S, device="cpu")
    tok = np.full((2, 1), 3, np.int32)
    for pos in (jcfg.dec_max_len - 1, jcfg.dec_max_len + 1):
        jl, jc = jED.encdec_decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32))
        tl, tc = tED.encdec_decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                        pos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
    assert tc["k"][:, :, jcfg.dec_max_len + 1].any()
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **FWD)


# ---------------------------------------------------------------------------
# batches, stream, counts, smoke
# ---------------------------------------------------------------------------


def _bits(x):
    """The bits of a float array (bf16 as 16-bit patterns) for a bitwise
    comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32 if x.dtype == torch.float32
                              else np.int32)
    x = np.asarray(x)
    if str(x.dtype) == "bfloat16":
        return x.view(np.uint16)
    return x.view(np.uint32 if x.dtype == np.float32 else np.int32)


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_make_batch_and_stream_bit_equal(arch, compute):
    """Frames or patches in the compute dtype and the tokens, from
    ``make_batch`` and from ``SyntheticStream``, equal JAX's bit for bit:
    numpy's float64 draws rounded once by torch as ml_dtypes rounds
    them."""
    jcfg = jbase.smoke_config(arch).replace(compute_dtype=compute)
    tcfg = tbase.smoke_config(arch).replace(compute_dtype=compute)
    jshape = jbase.ShapeCfg("s", 24, 3, "train")
    tshape = tbase.ShapeCfg("s", 24, 3, "train")
    want = jmodel.make_batch(jcfg, jshape, seed=5)
    got = tmodel.make_batch(tcfg, tshape, seed=5, device="cpu")
    assert list(got) == list(want)
    js = jdata.SyntheticStream(jcfg, jshape, seed=7)
    ts = tdata.SyntheticStream(tcfg, tshape, seed=7, device="cpu")
    pairs = [(got, want)] + [(ts.batch(s), js.batch(s)) for s in (0, 3)]
    for g, w in pairs:
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, k
            assert str(g[k].dtype).removeprefix("torch.") == \
                str(w[k].dtype), k
            np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), k)


def test_bf16_rounding_of_whisper_frames_pinned():
    """One full whisper batch of frames, (8, 1500, 1024) float64 draws:
    torch's float64 -> bfloat16 rounding equals ml_dtypes' (the JAX
    stream's), every one of the 12.3 M values."""
    draws = np.random.default_rng((1234, 0)).standard_normal(
        (8, 1500, 1024)) * 0.02
    want = jnp.asarray(draws.astype(jnp.bfloat16))
    got = tmodel.float_tensor(draws, "bfloat16", "cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("arch,total", [(ARCH, 811_657_216),
                                        ("phi-3-vision-4.2b", 3_822_259_200)])
def test_count_params_on_meta(arch, total):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    counts = tcfg.param_counts()
    assert counts["total"] == total
    assert counts == jmodel.count_params(jcfg)
    for sname, shape in tbase.SHAPES.items():
        assert tmodel.model_flops(tcfg, shape) == \
            jmodel.model_flops(jcfg, jbase.SHAPES[sname])


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_batch_struct_matches_jax(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for sname, shape in tbase.SHAPES.items():
        assert tcfg.supports_shape(shape) == \
            jcfg.supports_shape(jbase.SHAPES[sname])
        got = tmodel.batch_struct(tcfg, shape)
        want = jmodel.batch_struct(jcfg, jbase.SHAPES[sname])
        assert {k: (s.shape, s.dtype) for k, s in got.items()} == \
            {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}


SM = tbase.ShapeCfg("smoke", 32, 2, "train")


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_train_step_smoke(arch):
    """``test_models_smoke.py::test_train_step_smoke`` for the two archs."""
    cfg = tbase.smoke_config(arch)
    state = tsteps.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    before = [t.clone() for _, t in leaves_with_paths(state["params"])]
    step = tsteps.make_train_step(cfg)
    new_state, metrics = step(state, tmodel.make_batch(cfg, SM, device="cpu"))
    assert torch.isfinite(metrics["loss"]) and \
        torch.isfinite(metrics["grad_norm"])
    after = leaves_with_paths(new_state["params"])
    for old, (_, new) in zip(before, after):
        assert old.shape == new.shape and old.dtype == new.dtype
    assert any(not torch.equal(o, n) for o, (_, n) in zip(before, after))
    _, m2 = step(new_state, tmodel.make_batch(cfg, SM, seed=1, device="cpu"))
    assert torch.isfinite(m2["loss"])


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_prefill_and_decode_smoke(arch):
    """``test_models_smoke.py::test_prefill_and_decode_smoke`` for the two
    archs: prefill of a smoke batch, then 3 greedy decode steps from a
    fresh cache; the padded vocabulary never wins."""
    cfg = tbase.smoke_config(arch)
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    with torch.no_grad():
        logits, _ = tmodel.make_prefill_fn(cfg)(
            params, tmodel.make_batch(cfg, SM, device="cpu"))
        V = cfg.padded_vocab
        assert logits.shape == (SM.global_batch, V)
        assert torch.isfinite(logits).all()
        dcache = tmodel.cache_init(cfg, 2, 16, device="cpu")
        decode = tmodel.make_decode_fn(cfg)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        for pos in range(3):
            lg, dcache = decode(params, dcache, tok,
                                torch.tensor(pos, dtype=torch.int32))
            assert lg.shape == (2, V) and torch.isfinite(lg).all()
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
    assert int(tok.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# checkpoints across the packages, and the trainer
# ---------------------------------------------------------------------------


_CORE = {"jax": jcore, "torch": tcore}


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_encdec_state_crosses_packages(tmp_path, writer, reader):
    """A whisper-medium smoke train state (the two stacks, ``pos_emb``,
    AdamW moments) checkpointed by one package restores through the other
    in a fresh cluster, leaf for leaf and bit for bit, and both packages
    write the same shard bytes."""
    cfg = jbase.smoke_config(ARCH)
    jstate = jax.tree.map(np.asarray,
                          jsteps.init_train_state(jax.random.PRNGKey(3), cfg))
    assert "pos_emb" in jstate["params"] and "cross" in \
        jstate["params"]["dec_blocks"]
    inputs = {"jax": jstate, "torch": tsteps.state_from_numpy(jstate, "cpu")}
    shards = {}
    for pkg in (writer, reader):
        core = _CORE[pkg]
        vc = core.VelocConfig(scratch=str(tmp_path / pkg), mode="sync",
                              partner=False, xor_group=0)
        c = core.VelocClient(vc)
        c.checkpoint(inputs[pkg], version=1)
        shards[pkg] = c.cluster.fetch_shard(vc.name, 1, 0)
        c.shutdown()
    assert shards[writer] is not None and shards[writer] == shards[reader]
    core = _CORE[reader]
    vc = core.VelocConfig(scratch=str(tmp_path / writer), mode="sync",
                          partner=False, xor_group=0)
    c = core.VelocClient(vc)
    v, restored = c.restart_latest(inputs[reader])
    c.shutdown()
    assert v == 1, c.restart_diagnostics
    got = tsteps.state_to_numpy(restored) if reader == "torch" else \
        jax.tree.map(np.asarray, restored)
    want = dict(leaves_with_paths(jstate))
    got = dict(leaves_with_paths(got))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8), name)


def test_train_step_matches_jax_step():
    """One port train step from the JAX encoder-decoder state equals one
    jitted JAX step (f32 compute): loss, grad norm and the moments within
    the gradient tolerance."""
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    frames, tokens = _inputs(jcfg, seed=13)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))(jstate, jb)
    tstate = _port(jstate)
    tnew, tm = tsteps.make_train_step(tcfg, lr=1e-3)(tstate, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_tree_close(tnew["opt"]["m"], jnew["opt"]["m"],
                       dict(rtol=1e-4, atol=1e-7))
    _assert_tree_close(tnew["opt"]["v"], jnew["opt"]["v"],
                       dict(rtol=1e-4, atol=1e-10))


def test_trainer_recovers_and_resumes(tmp_path, capsys):
    """``launch.train --arch whisper-medium --smoke --device cpu``: frames
    and tokens from the stream, a failure after step 5 recovers v4 and
    ``--resume`` picks up v6, its state equal to the run's last state."""
    common = ["--arch", ARCH, "--smoke", "--device", "cpu",
              "--ckpt-every", "2", "--scratch", str(tmp_path),
              "--seq-len", "24", "--batch", "2"]
    run = trainer.main(common + ["--steps", "6", "--fail-at", "5"])
    assert "[failure-sim] recovered at v4" in capsys.readouterr().out
    assert run.recovered_version == 4 and np.isfinite(run.losses).all()
    assert len(run.losses) == 6
    resumed = trainer.main(common + ["--steps", "7", "--resume"])
    assert "[veloc] resumed from checkpoint v6" in capsys.readouterr().out
    for (name, a), (_, b) in zip(leaves_with_paths(resumed.resumed_state),
                                 leaves_with_paths(run.state)):
        assert torch.equal(a, b), name
