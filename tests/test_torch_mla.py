"""The port's multi-head latent attention (MLA) and minicpm3-4b against the
JAX package on the CPU: the same numpy inputs and the JAX parameters
carried across through numpy go through ``repro.models.layers``'
functions, called directly, and their counterparts in
``repro_torch.models.layers``, then the whole ``mla``-form LM through
``repro.models.transformer`` and ``repro_torch.models.transformer``.

Tolerances, as ``test_torch_models`` holds the ``attn`` kind: with
``compute_dtype="float32"`` every MLA function and the logits agree within
rtol 1e-5 / atol 1e-6 (outputs of size ~1; each the end of a few hundred
f32 sums, summed in other orders by the two packages; atol 1e-5 for the
logits and caches of a whole LM, as ``test_torch_models`` holds the
vision stub's prefill), the loss within rtol 1e-5 / atol 1e-6, every
gradient leaf within rtol 1e-4 / atol 1e-6, a train step's grad norm
within rtol 1e-4.  The JAX package computes its norms, rotary angles and
softmax in float32 whatever the input dtype (``astype(jnp.float32)``), so
it has no float64 form to hold the port's float64 against; the float64
holds are the port's own: one-token decode against the forward pass
within 1e-12 for the block (no bf16, no f32 anywhere, only float64 sums in
other orders) and 1e-6 for the LM, as every decode check is, and the
chunked attention branch against the unchunked one within 1e-12.  The
rotary factor (half = 16, MLA's rope, and the other widths) and checkpoint
bytes are equal bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models import model as jmodel
from repro.models import transformer as jTF
from repro.train import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.models import layers as tL
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tTF
from repro_torch.train import steps as tsteps

ARCH = "minicpm3-4b"
MLA = dict(block_pattern=("mla",))
FWD = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


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


def _cfgs(compute="float32", **over):
    return (jbase.smoke_config(ARCH).replace(compute_dtype=compute, **over),
            tbase.smoke_config(ARCH).replace(compute_dtype=compute, **over))


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


def _mla_params(cfg_j, seed=0):
    p = jL.init_mla(jax.random.PRNGKey(seed), cfg_j)
    return p, _port(p)


def _x(cfg, B=2, T=12, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)


def _positions(B, T, start=0):
    return np.broadcast_to(np.arange(start, start + T)[None],
                           (B, T)).astype(np.int32).copy()


# ---------------------------------------------------------------------------
# the MLA layer against repro.models.layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_init_mla_names_shapes_dtypes_match_jax(size):
    """Leaf names, shapes and dtypes of ``init_mla`` (full width on the
    meta device against ``jax.eval_shape``); the norms start at one and
    each matrix's spread follows the reference's fan-in."""
    get = tbase.smoke_config if size == "smoke" else tbase.get_config
    jget = jbase.smoke_config if size == "smoke" else jbase.get_config
    tcfg, jcfg = get(ARCH), jget(ARCH)
    device = "cpu" if size == "smoke" else "meta"
    got = tL.init_mla(torch.Generator().manual_seed(0), tcfg, device)
    want = jax.eval_shape(lambda: jL.init_mla(jax.random.PRNGKey(0), jcfg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    if size == "smoke":
        m = tcfg.mla
        fan = {"wq_a": tcfg.d_model, "wq_b": m.q_lora_rank,
               "wkv_a": tcfg.d_model, "wkv_b": m.kv_lora_rank,
               "wo": tcfg.num_heads * m.v_head_dim}
        for k, n in fan.items():
            assert abs(float(got[k].std()) * n ** 0.5 - 1) < 0.1, k
        for k in ("q_norm", "kv_norm"):
            assert torch.equal(got[k], torch.ones_like(got[k]))


def _jax_rope_factor(half):
    return 10_000.0 ** (-(jnp.arange(half, dtype=jnp.float32) / half))


@pytest.mark.parametrize("half", [4, 8, 16, 32, 64])
def test_rope_factor_bit_equal_to_jax(half):
    """The rotary factor ``theta ** (-i / half)`` in f32, bit for bit as
    XLA computes it (jitted and not): half = 16 is minicpm3-4b's 32-wide
    MLA rope, 32 its ``attn`` form's head_dim 64 (phi3's too), 64 head_dim
    128, 4 and 8 the smoke widths.  Torch's own f32 ``pow`` misses at 32
    and 64."""
    got = tL.rope_factor(half, 10_000.0, torch.float32).numpy()
    fn = functools.partial(_jax_rope_factor, half)
    for want in (np.asarray(fn()), np.asarray(jax.jit(fn)())):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("half", [24, 48, 96])
def test_rope_factor_bit_equal_to_eager_jax(half):
    """Where ``half`` is no power of two, jitted XLA's factor differs from
    its eager one at some entries; the port's equals the eager one, the
    correctly rounded f32 power of the same f32 ``i / half``."""
    got = tL.rope_factor(half, 10_000.0, torch.float32).numpy()
    want = np.asarray(_jax_rope_factor(half))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mla_qkv_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _mla_params(jcfg)
    x, pos = _x(jcfg), _positions(2, 12, start=5)
    want = jL._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tL._mla_qkv(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    m = tcfg.mla
    shapes = [(2, 12, 4, m.qk_nope_head_dim), (2, 12, 4, m.qk_rope_head_dim),
              (2, 12, m.kv_lora_rank), (2, 12, 1, m.qk_rope_head_dim)]
    for g, w, s in zip(got, want, shapes):
        assert tuple(g.shape) == s == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **FWD)


def test_mla_attend_and_apply_match_jax():
    """``apply_mla`` (``_mla_qkv`` then ``_mla_attend``) against JAX's in
    one block (T = 12); ``_mla_attend`` alone on the same inputs,
    non-causal from a query offset, and with ``k_len_valid``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mla_params(jcfg, seed=2)
    x, pos = _x(jcfg, seed=3), _positions(2, 12)
    want = jL.apply_mla(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tL.apply_mla(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert tuple(got.shape) == (2, 12, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    parts = [np.array(a) for a in
             jL._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))]
    for kw in (dict(causal=False, q_start=3), dict(causal=False,
                                                     k_len_valid=7)):
        w = jL._mla_attend(jp, jcfg, *map(jnp.asarray, parts), **kw)
        g = tL._mla_attend(tp, tcfg, *map(torch.from_numpy, parts), **kw)
        np.testing.assert_allclose(_np(g), np.asarray(w), **FWD)


def test_mla_chunked_branch_matches_jax_one_block():
    """At T = 2 x ATTN_CHUNK ``_mla_attend`` takes ``sdpa``'s query
    chunks.  The JAX package's ``sdpa`` reshapes its output with q's head
    width (nope + rope), so there MLA raises ``TypeError`` whenever v is
    narrower (ROADMAP.md queue 3); the port's chunks are concatenated and
    give what JAX's one-block attention gives on the same inputs (its
    ``k_len_valid=T`` branch, every key valid)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mla_params(jcfg, seed=2)
    T = 2 * tL.ATTN_CHUNK
    x, pos = _x(jcfg, B=1, T=T, seed=3), _positions(1, T)
    with pytest.raises(TypeError, match="cannot reshape"):
        jL.apply_mla(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    parts = jL._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    want = jL._mla_attend(jp, jcfg, *parts, causal=True, k_len_valid=T)
    got = tL.apply_mla(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


def test_mla_chunked_branch_equals_one_block_in_float64():
    """At T = 2 x ATTN_CHUNK ``_mla_attend`` takes ``sdpa``'s query
    chunks; in float64 it equals the one-block attention it replaces
    within 1e-12."""
    _, tcfg = _cfgs("float64")
    tcfg = tcfg.replace(param_dtype="float64")
    tp = tL.init_mla(torch.Generator().manual_seed(4), tcfg, "cpu")
    T = 2 * tL.ATTN_CHUNK
    x = torch.from_numpy(_x(tcfg, B=1, T=T, seed=5).astype(np.float64))
    parts = tL._mla_qkv(tp, tcfg, x, torch.arange(T)[None])
    chunked = tL._mla_attend(tp, tcfg, *parts, causal=True)
    whole = tL._mla_attend(tp, tcfg, *parts, causal=True, k_len_valid=T)
    assert chunked.dtype == torch.float64
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **F64)


def test_mla_decode_matches_jax():
    """Decode steps from an empty latent cache: each output and both
    caches (slot ``pos`` written) against ``repro``'s ``mla_decode``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mla_params(jcfg, seed=6)
    B, S = 2, 10
    m = jcfg.mla
    jlat, jkr = (jnp.zeros((B, S, m.kv_lora_rank)),
                 jnp.zeros((B, S, m.qk_rope_head_dim)))
    tlat, tkr = (torch.zeros((B, S, m.kv_lora_rank)),
                 torch.zeros((B, S, m.qk_rope_head_dim)))
    x = _x(jcfg, B=B, T=S, seed=7)
    jdec = jax.jit(lambda p, x, a, b, pos: jL.mla_decode(p, jcfg, x, a, b,
                                                         pos))
    for pos in range(S):
        xs = x[:, pos:pos + 1]
        jo, jlat, jkr = jdec(jp, jnp.asarray(xs), jlat, jkr,
                             jnp.asarray(pos, jnp.int32))
        to, tlat, tkr = tL.mla_decode(tp, tcfg, torch.from_numpy(xs), tlat,
                                      tkr, torch.tensor(pos,
                                                        dtype=torch.int32))
        np.testing.assert_allclose(_np(to), np.asarray(jo), **FWD)
    np.testing.assert_allclose(_np(tlat), np.asarray(jlat), **FWD)
    np.testing.assert_allclose(_np(tkr), np.asarray(jkr), **FWD)


def test_mla_decode_equals_forward_in_float64():
    """Each one-token ``mla_decode`` against the latent cache equals the
    causal ``apply_mla`` row at its position within 1e-12 (float64)."""
    _, tcfg = _cfgs("float64")
    tcfg = tcfg.replace(param_dtype="float64")
    tp = tL.init_mla(torch.Generator().manual_seed(8), tcfg, "cpu")
    B, S = 2, 9
    x = torch.from_numpy(_x(tcfg, B=B, T=S, seed=9).astype(np.float64))
    full = tL.apply_mla(tp, tcfg, x, torch.arange(S).expand(B, S))
    cache = tTF.init_block_cache(tcfg, "mla", B, S, "cpu")
    assert cache["latent"].dtype == torch.float64
    lat, kr = cache["latent"], cache["k_rope"]
    for pos in range(S):
        out, lat, kr = tL.mla_decode(tp, tcfg, x[:, pos:pos + 1], lat, kr,
                                     pos)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, pos].numpy(),
                                   **F64)


# ---------------------------------------------------------------------------
# the mla-form LM: prefill, decode, a train step
# ---------------------------------------------------------------------------


def _tokens(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def test_lm_prefill_and_decode_match_jax():
    """``lm_prefill`` (last logits, and JAX's T-slot latent caches), then
    with ``cache_len`` the port's caches hold JAX's over the prompt slots
    and zeros after; decode steps from an empty cache against JAX's
    (logits, greedy tokens and caches)."""
    jcfg, tcfg = _cfgs(**MLA)
    jp = jTF.init_lm(jax.random.PRNGKey(10), jcfg)
    tp = _port(jp)
    T, steps = 10, 4
    toks = _tokens(jcfg, T=T + steps, seed=11)
    jl, jc = jax.jit(lambda p, t: jTF.lm_prefill(p, jcfg, t))(
        jp, jnp.asarray(toks[:, :T]))
    tl, tc = tTF.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :T]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGITS)
    _assert_tree_close(tc, jc, LOGITS)

    S = T + steps
    tl2, tc2 = tmodel.make_prefill_fn(tcfg, cache_len=S)(
        tp, {"tokens": torch.from_numpy(toks[:, :T])})
    assert torch.equal(tl2, tl)
    for (name, g), (_, w) in zip(leaves_with_paths(tc2), _jax_leaves(jc)):
        assert g.shape[-2] == S and w.shape[-2] == T, name
        np.testing.assert_allclose(_np(g)[..., :T, :], w, err_msg=name,
                                   **LOGITS)
        assert not g[..., T:, :].any(), name

    jc = jTF.lm_cache_init(jcfg, 2, S)
    tc = tTF.lm_cache_init(tcfg, 2, S, "cpu")
    _assert_tree_close(tc, jc, dict(rtol=0, atol=0))
    jdecode = jax.jit(lambda p, c, t, pos: jTF.lm_decode_step(
        p, jcfg, c, t, pos))
    for pos in range(S):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tTF.lm_decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                    torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGITS)
        np.testing.assert_array_equal(_np(tl.argmax(-1)),
                                      np.asarray(jl.argmax(-1)))
    _assert_tree_close(tc, jc, LOGITS)


@pytest.mark.parametrize("form", ["attn", "mla"])
def test_decode_continues_forward_in_float64(form):
    """A prompt prefilled into caches sized for the whole context, then
    one decode step a token, and decode from an empty cache: every row
    equals the forward pass's logits at its position within 1e-6
    (float64 compute and parameters), for both minicpm3-4b forms; the
    padded vocab columns stay masked."""
    over = dict(MLA) if form == "mla" else {}
    _, tcfg = _cfgs("float64", param_dtype="float64", vocab_size=500,
                    **over)
    params = tmodel.init_model(tcfg, generator=torch.Generator()
                               .manual_seed(12), device="cpu")
    T, S = 7, 13
    tokens = torch.from_numpy(_tokens(tcfg, T=S, seed=13))
    full = tTF.lm_forward(params, tcfg, tokens)
    assert full.dtype == torch.float64
    last, cache = tmodel.make_prefill_fn(tcfg, cache_len=S)(
        params, {"tokens": tokens[:, :T]})
    np.testing.assert_allclose(last.numpy(), full[:, T - 1].numpy(),
                               rtol=1e-6, atol=1e-6)
    decode = tmodel.make_decode_fn(tcfg)
    for pos in range(T, S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=1e-6, atol=1e-6)
    cache = tmodel.cache_init(tcfg, 2, S, device="cpu")
    for pos in range(S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert float(lg[:, tcfg.vocab_size:].max()) == -1e30


def test_mla_train_step_matches_jax_step():
    """One port train step of the mla form from the JAX state against one
    jitted JAX step: loss and grad norm, and the step moved every
    parameter leaf."""
    jcfg, tcfg = _cfgs(**MLA)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(14), jcfg)
    toks = _tokens(jcfg, T=24, seed=15)
    _, jm = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))(
        jstate, {"tokens": jnp.asarray(toks)})
    tstate = _port(jstate)
    before = {n: t.clone() for n, t in leaves_with_paths(tstate["params"])}
    _, tm = tsteps.make_train_step(tcfg, lr=1e-3)(
        tstate, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for name, t in leaves_with_paths(tstate["params"]):
        assert not torch.equal(t, before[name]), name


@pytest.mark.parametrize("form", ["attn", "mla"])
def test_cut_depth_full_width_forward_matches_jax(form):
    """minicpm3-4b at full width (d_model 2560, 40 heads, the published
    MLA ranks) cut to one layer and a 512-token vocabulary: the parameter
    tree's names and shapes, and the f32 logits against JAX's, in both
    forms."""
    over = dict(MLA) if form == "mla" else {}
    cut = dict(num_layers=1, vocab_size=512, compute_dtype="float32",
               **over)
    jcfg = jbase.get_config(ARCH).replace(**cut)
    tcfg = tbase.get_config(ARCH).replace(**cut)
    jp = jmodel.init_model(jax.random.PRNGKey(16), jcfg)
    tp = _port(jp)
    assert tmodel.count_params(tcfg) == jmodel.count_params(jcfg)
    toks = _tokens(jcfg, B=1, T=8, seed=17)
    want = np.asarray(jTF.lm_forward(jp, jcfg, jnp.asarray(toks)))
    del jp
    got = tTF.lm_forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), want, **LOGITS)


# ---------------------------------------------------------------------------
# an MLA serving state across the packages
# ---------------------------------------------------------------------------


_CORE = {"jax": jcore, "torch": tcore}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_mla_serving_state_crosses_packages(tmp_path, writer, reader):
    """An MLA serving state (the smoke params and a prefilled latent cache
    in the bf16 compute dtype, with the next token and position)
    checkpointed by one package restores through the other in a fresh
    cluster, leaf for leaf and bit for bit, and both packages write the
    same shard bytes."""
    cfg = jbase.smoke_config(ARCH).replace(**MLA)
    params = jmodel.init_model(jax.random.PRNGKey(18), cfg)
    toks = _tokens(cfg, T=12, seed=19)
    logits, cache = jTF.lm_prefill(params, cfg, jnp.asarray(toks))
    state = jax.tree.map(np.asarray, {
        "params": params, "cache": cache,
        "tok": jnp.argmax(logits, -1)[:, None].astype(jnp.int32),
        "pos": jnp.asarray(12, jnp.int32)})
    lat = state["cache"]["blocks"][0]["latent"]
    assert str(lat.dtype) == "bfloat16" and lat.shape == (2, 2, 12, 16)
    inputs = {"jax": state, "torch": tsteps.state_from_numpy(state, "cpu")}
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
    want, got = dict(leaves_with_paths(state)), dict(leaves_with_paths(got))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8), name)
