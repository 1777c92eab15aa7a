"""The port's dense models, AdamW and data stream against the JAX package:
the same numpy inputs and the JAX state carried across through numpy go
through ``repro`` and ``repro_torch`` on the CPU.

Tolerances: with ``compute_dtype="float32"`` the loss agrees within rtol
1e-5 / atol 1e-6, the logits (of size ~1, each the end of a few hundred
f32 sums per layer) within rtol 1e-5 / atol 1e-5, and every gradient leaf
within rtol 1e-4 / atol 1e-6 (the two packages sum in different orders);
one AdamW step within
rtol 1e-5; with the default bf16 compute the loss within 2e-2 absolute
(bf16 matmul inputs, accumulated differently).  Stream and batch tokens
are equal bit for bit.

The recurrent archs (xlstm-1.3b, recurrentgemma-2b) join the same tests.
Stacked mLSTM blocks are the exception to the f32 tolerances above: each
block agrees with JAX within ~5e-6 given the same input
(``test_torch_recurrent``), but the chain magnifies a difference in its
input 5-10x a layer (the cell divides by max(|q.n|, exp(-m)), small where
the gates have forgotten), so the 8-layer xLSTM's logits differ by up to
2.3e-4 and its gradients by up to 1.1e-4 of a leaf's largest element:
``F32_TOL`` holds it to atol 1e-3 (logits) and rtol 1e-3, atol 1e-3 x the
leaf's largest element (gradients).

The vision frontend stub (phi-3-vision-4.2b) is held at the dense
tolerances above, its patch embeddings prepended: the forward, the loss
over the text positions and every gradient leaf in f32, the bf16 loss, and
prefill.  The encoder-decoder has its own file (``test_torch_encdec``).
MLA and MoE stay refused: ``get_config`` raises ``KeyError`` for their
archs, and every entry point ``NotImplementedError`` for such a config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models import model as jmodel
from repro.models import transformer as jTF
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.models import layers as tL
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tTF
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

DENSE = ["veloc-demo-100m", "minitron-8b", "yi-9b", "phi3-mini-3.8b"]
RECURRENT = ["xlstm-1.3b", "recurrentgemma-2b"]
STUBS = ["whisper-medium", "phi-3-vision-4.2b"]  # frontend-stub families
SM = tbase.ShapeCfg("smoke", 32, 2, "train")

# smoke-size variants held against the JAX package: (arch, overrides)
VARIANTS = {
    "demo": ("veloc-demo-100m", {}),
    "minitron-relu2-gqa": ("minitron-8b", {}),
    "yi-gqa": ("yi-9b", {}),
    "phi3": ("phi3-mini-3.8b", {}),
    # a local-attention pattern of two with a remainder layer, remat over
    # the group loop, and a padded vocab (masked to -1e30)
    "local-rem-remat-padded": ("veloc-demo-100m", dict(
        block_pattern=("attn", "local_attn"), window=8, num_layers=3,
        remat=True, vocab_size=500)),
    "geglu-tied": ("veloc-demo-100m", dict(mlp="geglu",
                                           tie_embeddings=True)),
    "gelu": ("minitron-8b", dict(mlp="gelu")),
    # 7 mLSTM + 1 sLSTM blocks in one group
    "xlstm": ("xlstm-1.3b", {}),
    # rglru, rglru, local_attn (MQA, window 8 < T) in one group
    "recurrentgemma": ("recurrentgemma-2b", {}),
    # one group, two remainder RG-LRU blocks, remat, a padded vocab
    "recurrentgemma-rem-remat-padded": ("recurrentgemma-2b", dict(
        num_layers=5, remat=True, vocab_size=500)),
}

# per variant, where the defaults of the docstring do not hold: (logits
# rtol, atol), (gradient rtol, atol as a fraction of the leaf's largest
# element)
F32_TOL = {"xlstm": ((1e-4, 1e-3), (1e-3, 1e-3))}


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


def _cfgs(variant, **extra):
    arch, over = VARIANTS[variant]
    over = dict(over, **extra)
    return (jbase.smoke_config(arch).replace(**over),
            tbase.smoke_config(arch).replace(**over))


def _jax_leaves(tree):
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _port(tree):
    return tsteps.state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_tree_close(got, want, rtol, atol):
    want = _jax_leaves(want)
    got = [(n, t.detach().numpy()) for n, t in leaves_with_paths(got)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_stream_batches_bit_equal(arch):
    jcfg, tcfg = jbase.smoke_config(arch), tbase.smoke_config(arch)
    shape = tbase.ShapeCfg("s", 48, 3, "train")
    js = jdata.SyntheticStream(jcfg, jbase.ShapeCfg("s", 48, 3, "train"),
                               seed=7)
    ts = tdata.SyntheticStream(tcfg, shape, seed=7, device="cpu")
    for step in (0, 1, 17):
        want = np.asarray(js.batch(step)["tokens"])
        got = ts.batch(step)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(ts.batch_numpy(0)["tokens"],
                              ts.batch_numpy(1)["tokens"])


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_make_batch_bit_equal(kind):
    jcfg = jbase.smoke_config("yi-9b")
    tcfg = tbase.smoke_config("yi-9b")
    want = jmodel.make_batch(jcfg, jbase.ShapeCfg("s", 32, 2, "train"),
                             seed=5, kind=kind)
    got = tmodel.make_batch(tcfg, SM, seed=5, kind=kind, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def _tokens(cfg, seed=0, B=2, T=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_f32_logits_loss_grads_match_jax(variant):
    jcfg, tcfg = _cfgs(variant, compute_dtype="float32")
    jparams = jmodel.init_model(jax.random.PRNGKey(1), jcfg)
    tparams = _port(jparams)
    toks = _tokens(jcfg, seed=2)
    jlogits = jTF.lm_forward(jparams, jcfg, jnp.asarray(toks))
    tlogits = tTF.lm_forward(tparams, tcfg, torch.from_numpy(toks))
    (lrtol, latol), (grtol, gatol) = F32_TOL.get(
        variant, ((1e-5, 1e-5), (1e-4, None)))
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=lrtol, atol=latol)

    jloss, jgrads = jax.value_and_grad(jmodel.make_loss_fn(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    leaves = [t.requires_grad_() for _, t in leaves_with_paths(tparams)]
    tloss = tmodel.make_loss_fn(tcfg)(tparams,
                                      {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, (name, w) in zip(grads, want):
        atol = 1e-6 if gatol is None else gatol * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=grtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_bf16_loss_close_to_jax(arch):
    jcfg, tcfg = jbase.smoke_config(arch), tbase.smoke_config(arch)
    assert jcfg.compute_dtype == "bfloat16"
    jparams = jmodel.init_model(jax.random.PRNGKey(4), jcfg)
    toks = _tokens(jcfg, seed=3)
    jloss = jTF.lm_loss(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tloss = tTF.lm_loss(_port(jparams), tcfg,
                        {"tokens": torch.from_numpy(toks)})
    assert abs(float(tloss) - float(jloss)) < 2e-2


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_sdpa_chunked_matches_jax(causal, window):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 32, 3, 8)).astype(np.float32)
               for _ in range(3))
    want = jL.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal,
                   window=window, chunk=8)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tL.sdpa(qt, kt, vt, causal=causal, window=window, chunk=8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    whole = tL.sdpa(qt, kt, vt, causal=causal, window=window, chunk=1024)
    np.testing.assert_allclose(got.detach().numpy(), whole.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    got.sum().backward()  # the recomputed chunks have a backward
    assert torch.isfinite(qt.grad).all()


def test_rope_rms_norm_repeat_kv_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        tL.rope(torch.from_numpy(x), torch.from_numpy(pos.copy())).numpy(),
        np.asarray(jL.rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-6)
    scale = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        tL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tL.repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jL.repeat_kv(jnp.asarray(x), 3)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_step_matches_jax():
    cfg = jbase.smoke_config("veloc-demo-100m")
    params = jmodel.init_model(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(6)
    like = lambda s: jax.tree.map(  # noqa: E731
        lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32),
        params)
    grads = like(0.3)
    opt = {"m": like(0.01), "v": jax.tree.map(np.abs, like(1e-3)),
           "step": np.asarray(3, np.int32)}
    jp, jo, jm = jopt.adamw_update(grads, opt, params, lr=1e-3)

    tp, to, tg = _port(params), _port(opt), _port(grads)
    out_p, out_o, tm = topt.adamw_update(tg, to, tp, lr=1e-3)
    assert out_p is tp and out_o is to  # in place
    assert int(to["step"]) == 4 and to["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    # rtol 1e-5; where the two terms of an update cancel, a few f32
    # roundings of the terms (weights up to ~1, m terms up to ~0.05, v
    # terms up to ~0.005) remain, hence the atol
    _assert_tree_close(tp, jp, rtol=1e-5, atol=1e-7)
    _assert_tree_close(to["m"], jo["m"], rtol=1e-5, atol=1e-8)
    _assert_tree_close(to["v"], jo["v"], rtol=1e-5, atol=1e-9)


def test_adamw_clips_and_keeps_bf16_state():
    """A bf16 optimizer state (the trillion-parameter configs' opt_dtype)
    is updated in f32 and written back; a large gradient is clipped to
    unit global norm, as in the JAX package."""
    params = {"w": np.full((4, 3), 0.5, np.float32)}
    grads = {"w": np.full((4, 3), 100.0, np.float32)}
    jopt_state = jopt.adamw_init(params, "bfloat16")
    jp, jo, _ = jopt.adamw_update(grads, jopt_state, params)
    tp = _port(params)
    to = topt.adamw_init(tp, "bfloat16")
    assert to["m"]["w"].dtype == torch.bfloat16
    topt.adamw_update(_port(grads), to, tp)
    _assert_tree_close(tp, jp, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(
        to["m"]["w"].float().numpy(), np.asarray(jo["m"]["w"], np.float32))


def test_train_step_matches_jax_step():
    """One step of the port's train step from the JAX state equals one
    jitted JAX step (f32 compute): loss, grad norm and the new state."""
    jcfg, tcfg = _cfgs("demo", compute_dtype="float32")
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(jcfg, seed=8)
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))(
        jstate, {"tokens": jnp.asarray(toks)})
    tstate = _port(jstate)
    tnew, tm = tsteps.make_train_step(tcfg, lr=1e-3)(
        tstate, {"tokens": torch.from_numpy(toks)})
    assert tnew is tstate
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    # m and v are linear and quadratic in the gradient: the gradient
    # tolerance carries over
    _assert_tree_close(tnew["opt"]["m"], jnew["opt"]["m"], rtol=1e-4,
                       atol=1e-7)
    _assert_tree_close(tnew["opt"]["v"], jnew["opt"]["v"], rtol=1e-4,
                       atol=1e-10)
    # Adam's first step moves a weight by lr*g/(|g| + eps): where |g| is
    # near eps (1e-8) it magnifies the gradient's rounding, so those
    # weights are held to the update's bound (2*lr) and the rest within the
    # gradient tolerance
    m = {n: t.numpy() for n, t in leaves_with_paths(tnew["opt"]["m"])}
    for name, w in _jax_leaves(jnew["params"]):
        got = tnew["params"]
        for part in name.split("/"):
            got = got[int(part)] if isinstance(got, tuple) else got[part]
        got = got.numpy()
        near_eps = (m[name] != 0) & (np.abs(m[name]) < 1e-7)  # |g| < 1e-6
        assert near_eps.mean() < 0.01, name
        np.testing.assert_allclose(got[~near_eps], w[~near_eps], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-3, err_msg=name)


# ---------------------------------------------------------------------------
# ported test_models_smoke (dense archs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_train_step_smoke(arch):
    cfg = tbase.smoke_config(arch)
    state = tsteps.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    before = [t.clone() for _, t in leaves_with_paths(state["params"])]
    step = tsteps.make_train_step(cfg)
    new_state, metrics = step(state, tmodel.make_batch(cfg, SM,
                                                       device="cpu"))
    assert torch.isfinite(metrics["loss"]), arch
    assert torch.isfinite(metrics["grad_norm"]), arch
    for old, (_, new) in zip(before, leaves_with_paths(new_state["params"])):
        assert old.shape == new.shape and old.dtype == new.dtype
        assert not new.requires_grad
    assert any(not torch.equal(o, n) for o, (_, n) in
               zip(before, leaves_with_paths(new_state["params"])))
    _, m2 = step(new_state, tmodel.make_batch(cfg, SM, seed=1, device="cpu"))
    assert torch.isfinite(m2["loss"])
    assert int(new_state["opt"]["step"]) == 2


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_batch_struct_covers_shapes(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for sname, shape in tbase.SHAPES.items():
        ok, why = tcfg.supports_shape(shape)
        assert (ok, why) == jcfg.supports_shape(jbase.SHAPES[sname])
        if not ok:
            assert sname == "long_500k" and why
            continue
        got = tmodel.batch_struct(tcfg, shape)
        want = jmodel.batch_struct(jcfg, jbase.SHAPES[sname])
        assert {k: (s.shape, s.dtype) for k, s in got.items()} == \
            {k: (tuple(s.shape), s.dtype) for k, s in want.items()}


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_param_counts_and_flops_match_jax(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert tcfg.param_counts() == jmodel.count_params(jcfg)
    for sname, shape in tbase.SHAPES.items():
        assert tmodel.model_flops(tcfg, shape) == \
            jmodel.model_flops(jcfg, jbase.SHAPES[sname])


def test_param_counts_match_published():
    """The ported archs' totals within tolerance of their published sizes
    (the JAX test's table)."""
    expect = {"yi-9b": (8.8e9, 0.1), "phi3-mini-3.8b": (3.8e9, 0.1),
              "minitron-8b": (7.7e9, 0.15), "veloc-demo-100m": (8.3e7, 0.01),
              "xlstm-1.3b": (1.9e9, 0.5), "recurrentgemma-2b": (3.5e9, 0.5),
              "whisper-medium": (0.8e9, 0.3)}
    for arch, (want, tol) in expect.items():
        got = tbase.get_config(arch).param_counts()["total"]
        assert abs(got - want) / want < tol, (arch, got, want)


def test_registry_is_the_dense_family():
    """The registry is the ported families, dense, recurrent,
    encoder-decoder and vision stub, each config equal to the JAX
    package's."""
    assert set(tbase.list_configs()) == set(DENSE + RECURRENT + STUBS)
    for arch in DENSE + RECURRENT + STUBS:
        for get in ("get_config", "smoke_config"):
            assert dataclasses.asdict(getattr(tbase, get)(arch)) == \
                dataclasses.asdict(getattr(jbase, get)(arch))


def test_unported_families_raise():
    """MLA (the block kind, or ``attention="mla"`` as minicpm3-4b sets it)
    and MoE raise in every entry point, naming what ROADMAP.md has left;
    the encoder-decoder and the vision stub are ported."""
    cfg = tbase.smoke_config("veloc-demo-100m")
    gen = torch.Generator().manual_seed(0)
    mla = tbase.MLACfg(32, 16, 8, 8, 8)
    for bad in (cfg.replace(block_pattern=("mla",)),
                cfg.replace(attention="mla", mla=mla)):
        with pytest.raises(NotImplementedError,
                           match="item 9 has MLA left"):
            tmodel.init_model(bad, generator=gen, device="cpu")
        for fn in (tmodel.count_params, lambda c: tmodel.batch_struct(c, SM),
                   tmodel.make_loss_fn, tmodel.make_decode_fn):
            with pytest.raises(NotImplementedError, match="item 9"):
                fn(bad)
    moe = cfg.replace(moe=tbase.MoECfg(4, 2, 32))
    for fn in (lambda c: tmodel.init_model(c, generator=gen, device="cpu"),
               lambda c: tmodel.batch_struct(c, SM), tmodel.make_prefill_fn,
               lambda c: tmodel.cache_init(c, 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="MoE note"):
            fn(moe)
    for ok in (cfg.replace(is_encoder_decoder=True, enc_layers=1),
               cfg.replace(frontend="vision", num_patches=2)):
        tmodel.init_model(ok, generator=gen, device="cpu")
        tmodel.batch_struct(ok, SM)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "grok-1-314b",
                                  "kimi-k2-1t-a32b"])
def test_unported_archs_stay_out_of_the_registry(arch):
    """The JAX package's MLA and MoE archs are not in the port's registry:
    ``get_config`` and ``smoke_config`` raise ``KeyError``; their JAX
    configs, carried across, raise ``NotImplementedError``."""
    assert arch in jbase.list_configs()
    with pytest.raises(KeyError):
        tbase.get_config(arch)
    with pytest.raises(KeyError):
        tbase.smoke_config(arch)
    jcfg = jbase.smoke_config(arch)
    fields = dataclasses.asdict(jcfg)
    fields["mla"] = None if jcfg.mla is None else tbase.MLACfg(
        **fields["mla"])
    fields["moe"] = None if jcfg.moe is None else tbase.MoECfg(
        **fields["moe"])
    tcfg = tbase.ModelConfig(**fields)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tmodel.count_params(tcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tmodel.batch_struct(tcfg, SM)


# ---------------------------------------------------------------------------
# the vision frontend stub (phi-3-vision-4.2b)
# ---------------------------------------------------------------------------


def _vision(seed=0, compute="float32", **over):
    arch = "phi-3-vision-4.2b"
    jcfg = jbase.smoke_config(arch).replace(compute_dtype=compute, **over)
    tcfg = tbase.smoke_config(arch).replace(compute_dtype=compute, **over)
    jparams = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    patches = (rng.standard_normal((2, jcfg.num_patches, jcfg.d_model))
               * 0.02).astype(np.float32)
    return jcfg, tcfg, jparams, _tokens(jcfg, seed + 2, T=20), patches


@pytest.mark.parametrize("over", [{}, dict(remat=True, vocab_size=500)])
def test_vision_f32_forward_loss_grads_match_jax(over):
    """Patches prepended: the logits over patches and text, the loss over
    the text positions only (``logits[:, P:-1]``) and every gradient
    leaf, at the dense f32 tolerances."""
    jcfg, tcfg, jparams, toks, patches = _vision(**over)
    tparams = _port(jparams)
    jlogits = jTF.lm_forward(jparams, jcfg, jnp.asarray(toks),
                             extra_embeds=jnp.asarray(patches))
    tlogits = tTF.lm_forward(tparams, tcfg, torch.from_numpy(toks),
                             extra_embeds=torch.from_numpy(patches))
    assert tlogits.shape[1] == jcfg.num_patches + toks.shape[1]
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    jb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
    jloss, jgrads = jax.value_and_grad(jmodel.make_loss_fn(jcfg))(jparams,
                                                                  jb)
    leaves = [t.requires_grad_() for _, t in leaves_with_paths(tparams)]
    tloss = tmodel.make_loss_fn(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks),
                  "patches": torch.from_numpy(patches)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, (name, w) in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_vision_bf16_loss_close_to_jax():
    arch = "phi-3-vision-4.2b"
    jcfg, tcfg = jbase.smoke_config(arch), tbase.smoke_config(arch)
    jparams = jmodel.init_model(jax.random.PRNGKey(4), jcfg)
    batch = jmodel.make_batch(jcfg, jbase.ShapeCfg("s", 24, 2, "train"),
                              seed=3)
    tbatch = tmodel.make_batch(tcfg, tbase.ShapeCfg("s", 24, 2, "train"),
                               seed=3, device="cpu")
    jloss = jTF.lm_loss(jparams, jcfg, batch)
    tloss = tTF.lm_loss(_port(jparams), tcfg, tbatch)
    assert abs(float(tloss) - float(jloss)) < 2e-2


def test_vision_prefill_matches_jax_and_decode_continues():
    """``lm_prefill`` with the patches: the last logits and the caches (P +
    T positions) against JAX's; with ``cache_len`` the decode steps after
    the prompt continue the forward pass, at the dense f32 tolerances."""
    jcfg, tcfg, jparams, toks, patches = _vision(seed=5)
    tparams = _port(jparams)
    T = 12
    jl, jc = jax.jit(jmodel.make_prefill_fn(jcfg))(
        jparams, {"tokens": jnp.asarray(toks[:, :T]),
                  "patches": jnp.asarray(patches)})
    tb = {"tokens": torch.from_numpy(toks[:, :T]),
          "patches": torch.from_numpy(patches)}
    tl, tc = tmodel.make_prefill_fn(tcfg)(tparams, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    _assert_tree_close(tc, jc, rtol=1e-5, atol=1e-5)
    P, S = jcfg.num_patches, jcfg.num_patches + toks.shape[1]
    full = tTF.lm_forward(tparams, tcfg, torch.from_numpy(toks),
                          extra_embeds=torch.from_numpy(patches))
    _, cache = tmodel.make_prefill_fn(tcfg, cache_len=S)(tparams, tb)
    decode = tmodel.make_decode_fn(tcfg)
    for i in range(T, toks.shape[1]):
        lg, cache = decode(tparams, cache, torch.from_numpy(toks[:, i:i + 1]),
                           P + i)
        np.testing.assert_allclose(lg.numpy(), full[:, P + i].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_train_state_init_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda device is usable here")
    with pytest.raises(RuntimeError, match="no GPU"):
        tsteps.init_train_state(tbase.smoke_config("veloc-demo-100m"))
