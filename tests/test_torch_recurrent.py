"""The port's recurrent blocks (mLSTM, sLSTM, RG-LRU), prefill and decode
against the JAX package on the CPU: the same numpy inputs and the JAX
parameters carried across through numpy go through ``repro`` and
``repro_torch``, in f32.

The cases of ``tests/test_recurrent_equiv.py`` that need no MLA or
encoder-decoder are ported first, with their imports swapped and their
tolerances unchanged.  Then each block against JAX, forward and the
gradient of every input and parameter: rtol 1e-4 / atol 1e-5 (forward)
and rtol 1e-3 / atol 2e-5 times the largest element of the JAX gradient
(at least 1) for gradients: the packages sum in other orders, the chunk's
cumulative sum here is a product with a triangular matrix, the RG-LRU scan
composes in another order than ``associative_scan``, and XLA fuses the
jitted JAX functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models import recurrent as jR
from repro.models import transformer as jTF
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops
from repro_torch.models import layers as tL
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as tTF
from repro_torch.train import steps as tsteps

FWD = dict(rtol=1e-4, atol=1e-5)


def _assert_grad_close(got, want, msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=2e-5 * scale,
                               err_msg=msg)


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


def _port(tree):
    return tsteps.state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_trees_close(got, want, tol):
    got, want = jax.tree.leaves(jax.tree.map(_np, got)), jax.tree.leaves(
        jax.tree.map(np.asarray, want))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"leaf {i}", **tol)


# ---------------------------------------------------------------------------
# ported from tests/test_recurrent_equiv.py
# ---------------------------------------------------------------------------


def test_mlstm_chunkwise_matches_recurrent():
    B, T, H, hd = 2, 64, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((B, T, H, hd)),
                            dtype=torch.float32) for _ in range(3))
    log_i = torch.tensor(rng.standard_normal((B, T, H)) - 1.0,
                         dtype=torch.float32)
    log_f = torch.tensor(-np.abs(rng.standard_normal((B, T, H))) * 0.1,
                         dtype=torch.float32)
    h_c, carry_c = R.mlstm_chunkwise(q, k, v, log_i, log_f, chunk=16)
    h_r, carry_r = R.mlstm_recurrent(q, k, v, log_i, log_f)
    np.testing.assert_allclose(h_c.numpy(), h_r.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(carry_c[0].numpy(), carry_r[0].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_mlstm_chunk_carry_streams():
    """Processing [0:T/2] then [T/2:T] with the carry equals one pass."""
    B, T, H, hd = 1, 64, 2, 8
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                 dtype=torch.float32)
    q, k, v = mk(B, T, H, hd), mk(B, T, H, hd), mk(B, T, H, hd)
    li, lf = mk(B, T, H) - 1, -torch.abs(mk(B, T, H)) * 0.1
    full, _ = R.mlstm_chunkwise(q, k, v, li, lf, chunk=16)
    h1, c1 = R.mlstm_chunkwise(q[:, :32], k[:, :32], v[:, :32],
                               li[:, :32], lf[:, :32], chunk=16)
    h2, _ = R.mlstm_chunkwise(q[:, 32:], k[:, 32:], v[:, 32:],
                              li[:, 32:], lf[:, 32:], carry=c1, chunk=16)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b"])
def test_prefill_decode_agree(arch):
    """Greedy decode after a T-token prefill must equal the forward logits
    (recurrent archs carry exact state, so this is tight).  fp32 compute to
    test the *math*, not bf16 rounding amplification."""
    cfg = tbase.smoke_config(arch).replace(compute_dtype="float32")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    B, T = 2, 16
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          dtype=torch.int32)
    full_logits = tTF.lm_forward(params, cfg, tokens)  # (B, T, V)

    decode = tmodel.make_decode_fn(cfg)
    cache = tmodel.cache_init(cfg, B, T, device="cpu")
    for pos in range(T):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1],
                           torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), full_logits[:, pos].numpy(),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ["yi-9b"])
def test_attention_decode_agrees_with_forward(arch):
    """KV-cache decode matches teacher-forced forward for attention archs."""
    cfg = tbase.smoke_config(arch).replace(compute_dtype="float32")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    B, T = 2, 8
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          dtype=torch.int32)
    decode = tmodel.make_decode_fn(cfg)
    full_logits = tTF.lm_forward(params, cfg, tokens)
    cache = tmodel.cache_init(cfg, B, T, device="cpu")
    for pos in range(T):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1],
                           torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), full_logits[:, pos].numpy(),
                                   rtol=4e-2, atol=4e-2)


# ---------------------------------------------------------------------------
# cells and blocks against JAX, forward and gradients
# ---------------------------------------------------------------------------


def _mlstm_inputs(rng, B=2, T=64, H=2, hd=16):
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((B, T, H)) - 1.0).astype(np.float32)
    lf = (-np.abs(rng.standard_normal((B, T, H))) * 0.1).astype(np.float32)
    return [q, k, v, li, lf]


def _grads_both(jfn, tfn, arrays):
    """Forward outputs and the gradients of sum(out * w) (w random, fixed)
    with respect to every array, in both packages."""
    jfn = jax.jit(jfn)
    jout = jfn(*map(jnp.asarray, arrays))
    rng = np.random.default_rng(99)
    ws = [rng.standard_normal(np.shape(o)).astype(np.float32)
          for o in jax.tree.leaves(jout)]

    def jloss(*xs):
        return sum(jnp.sum(o * w) for o, w in
                   zip(jax.tree.leaves(jfn(*xs)), ws))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a).requires_grad_() for a in arrays]
    tout = tfn(*ts)
    tleaves = [o for o in jax.tree.leaves(tout,
                                          is_leaf=lambda x: isinstance(
                                              x, torch.Tensor))]
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(tleaves, ws))
    tg = torch.autograd.grad(loss, ts, materialize_grads=True)
    return (tleaves, jax.tree.leaves(jout)), (tg, jg)


@pytest.mark.parametrize("with_carry", [False, True])
def test_mlstm_chunkwise_fwd_grad_match_jax(with_carry):
    """Several chunks (T=64, chunk 16), the carry out, and (with a carry in
    from a first pass) its gradient; without one, m starts at -inf and
    every gradient stays finite."""
    rng = np.random.default_rng(3)
    arrays = _mlstm_inputs(rng)
    if with_carry:
        first = jR.mlstm_chunkwise(*map(jnp.asarray, _mlstm_inputs(rng)),
                                   chunk=16)[1]
        arrays += [np.asarray(c) for c in first]

    def jfn(q, k, v, li, lf, *carry):
        return jR.mlstm_chunkwise(q, k, v, li, lf, carry or None, chunk=16)

    def tfn(q, k, v, li, lf, *carry):
        return R.mlstm_chunkwise(q, k, v, li, lf, carry or None, chunk=16)

    (tout, jout), (tg, jg) = _grads_both(jfn, tfn, arrays)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(_np(t), np.asarray(j), **FWD)
    for t, j in zip(tg, jg):
        assert torch.isfinite(t).all()
        _assert_grad_close(t, j)


def test_mlstm_ties_split_gradient_as_jax():
    """Constant input gates, zero log forget gates and a carry m equal to
    them make every entry of the decay matrix and the carry weight tie in
    the running maximum: the gradient splits over the ties as in JAX
    (``amax`` and ``maximum`` split evenly, as ``jnp.max`` and
    ``jnp.maximum`` do)."""
    rng = np.random.default_rng(4)
    B, T, H, hd = 1, 8, 1, 4
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    li = np.full((B, T, H), -0.5, np.float32)
    lf = np.zeros((B, T, H), np.float32)
    C = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    n = rng.standard_normal((B, H, hd)).astype(np.float32)
    m = np.full((B, H), -0.5, np.float32)

    def jfn(*xs):
        return jR.mlstm_chunkwise(*xs[:5], tuple(xs[5:]), chunk=8)

    def tfn(*xs):
        return R.mlstm_chunkwise(*xs[:5], tuple(xs[5:]), chunk=8)

    (tout, jout), (tg, jg) = _grads_both(jfn, tfn,
                                         [q, k, v, li, lf, C, n, m])
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(_np(t), np.asarray(j), **FWD)
    for t, j in zip(tg, jg):
        _assert_grad_close(t, j)


def _block_case(kind):
    cfg = jbase.smoke_config("xlstm-1.3b" if kind in ("mlstm", "slstm")
                             else "recurrentgemma-2b")
    return cfg.replace(compute_dtype="float32")


@pytest.mark.parametrize("kind,with_carry", [
    ("mlstm", False), ("mlstm", True), ("slstm", False), ("slstm", True),
    ("rglru", False), ("rglru", True)])
def test_block_fwd_grad_match_jax(kind, with_carry):
    """Each recurrent block in f32: output, carry out, and the gradient of
    the input and of every parameter; with a carry in (for RG-LRU, its h
    and the causal convolution's carry) from a first pass over other
    input."""
    cfg = _block_case(kind)
    jinit = getattr(jR, f"init_{kind}_block")
    japply = getattr(jR, f"apply_{kind}_block")
    tapply = getattr(R, f"apply_{kind}_block")
    jp = jinit(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    carry = None
    if with_carry:
        x0 = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
        carry = japply(jp, cfg, x0, return_carry=True)[1]
    jleaves, tree = jax.tree.flatten(jp)
    n_p = len(jleaves)
    carry_leaves, ctree = jax.tree.flatten(carry)

    def split(xs, unflatten):
        p = unflatten(tree, xs[:n_p])
        c = unflatten(ctree, xs[n_p + 1:]) if with_carry else None
        return p, xs[n_p], c

    def jfn(*xs):
        p, xx, c = split(xs, jax.tree.unflatten)
        return japply(p, cfg, xx, carry=c, return_carry=True)

    def tfn(*xs):
        p, xx, c = split(xs, _unflatten_torch)
        return tapply(p, cfg, xx, carry=c, return_carry=True)

    arrays = [np.asarray(a) for a in jleaves] + [x] + \
        [np.asarray(a) for a in carry_leaves]
    (tout, jout), (tg, jg) = _grads_both(jfn, tfn, arrays)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(_np(t), np.asarray(j), **FWD)
    for i, (t, j) in enumerate(zip(tg, jg)):
        _assert_grad_close(t, j, f"gradient {i}")


def _unflatten_torch(treedef, leaves):
    """``jax.tree.unflatten`` with torch tensors as leaves."""
    return jax.tree.unflatten(treedef, list(leaves))


def test_causal_conv_matches_jax_with_carry():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    c = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for carry in (None, c):
        jo, jc = jR._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if carry is None else jnp.asarray(carry))
        to, tc = R._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if carry is None else
                                torch.from_numpy(carry))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("T", [1, 2, 7, 64, 100])
def test_linear_scan_matches_loop_and_jax(T):
    """The log-depth scan against its loop and JAX's associative scan,
    forward and gradients; they differ in summation order only (f32, a in
    (0, 1))."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 5)).astype(np.float32)
    b = rng.standard_normal((2, T, 5)).astype(np.float32)

    def jfn(a, b):
        return jax.lax.associative_scan(
            lambda l, r: (r[0] * l[0], r[0] * l[1] + r[1]), (a, b),
            axis=1)[1]

    (tout, jout), (tg, jg) = _grads_both(jfn, R.linear_scan, [a, b])
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), **FWD)
    for t, j in zip(tg, jg):
        _assert_grad_close(t, j)
    ta, tb = (torch.tensor(z, requires_grad=True) for z in (a, b))
    loop = R.linear_scan_loop(ta, tb)
    np.testing.assert_allclose(_np(tout[0]), loop.detach().numpy(), **FWD)
    lg = torch.autograd.grad(loop.sum(), (ta, tb), materialize_grads=True)
    sg = torch.autograd.grad(R.linear_scan(ta, tb).sum(), (ta, tb),
                             materialize_grads=True)
    for x, y in zip(sg, lg):
        _assert_grad_close(x, y)


# ---------------------------------------------------------------------------
# prefill and decode against JAX
# ---------------------------------------------------------------------------


ARCHS = ["xlstm-1.3b", "recurrentgemma-2b", "yi-9b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """``lm_prefill`` (last logits and every cache leaf) and then decode
    steps (logits and caches) against JAX's, f32.  The logits of the
    stacked xLSTM blocks carry a magnified rounding difference (see
    ``test_torch_models``): their tolerance is 2e-3."""
    jcfg = jbase.smoke_config(arch).replace(compute_dtype="float32")
    tcfg = tbase.smoke_config(arch).replace(compute_dtype="float32")
    jp = jTF.init_lm(jax.random.PRNGKey(8), jcfg)
    tp = _port(jp)
    rng = np.random.default_rng(9)
    T, steps = 12, 4
    toks = rng.integers(0, jcfg.vocab_size, (2, T + steps)).astype(np.int32)
    tol = dict(rtol=2e-3, atol=2e-3) if arch == "xlstm-1.3b" else FWD
    jl, jc = jax.jit(lambda p, t: jTF.lm_prefill(p, jcfg, t))(
        jp, jnp.asarray(toks[:, :T]))
    tl, tc = tTF.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :T]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    _assert_trees_close(tc, jc, tol)

    # decode from an empty cache of T + steps tokens
    jc = jTF.lm_cache_init(jcfg, 2, T + steps)
    tc = tTF.lm_cache_init(tcfg, 2, T + steps, "cpu")
    _assert_trees_close(tc, jc, dict(rtol=0, atol=0))
    jdecode = jax.jit(lambda p, c, t, pos: jTF.lm_decode_step(
        p, jcfg, c, t, pos))
    for pos in range(T + steps):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tTF.lm_decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                    torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    _assert_trees_close(tc, jc, tol)


@pytest.mark.parametrize("arch,T", [("xlstm-1.3b", 12),
                                    ("recurrentgemma-2b", 5),
                                    ("recurrentgemma-2b", 12),
                                    ("yi-9b", 12)])
def test_prefill_then_decode_continues_forward(arch, T):
    """A prompt of T tokens prefilled into caches sized for the whole
    context (``cache_len``), then one decode step a token: each step's
    logits equal the forward pass's at that position.  recurrentgemma's
    smoke window is 8, so with T = 12 the local-attention ring is full
    after the prompt and decoding overwrites its oldest slots."""
    cfg = tbase.smoke_config(arch).replace(compute_dtype="float32")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    S = T + 6
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)), dtype=torch.int32)
    full = tTF.lm_forward(params, cfg, tokens)
    last, cache = tmodel.make_prefill_fn(cfg, cache_len=S)(
        params, {"tokens": tokens[:, :T]})
    np.testing.assert_allclose(last.numpy(), full[:, T - 1].numpy(),
                               rtol=3e-2, atol=3e-2)
    decode = tmodel.make_decode_fn(cfg)
    for pos in range(T, S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=3e-2, atol=3e-2)


def test_attn_decode_local_ring_matches_jax():
    """One local-attention decode step past the window: the slot written
    (pos % window) and the output equal JAX's."""
    jcfg = jbase.smoke_config("recurrentgemma-2b").replace(
        compute_dtype="float32")
    jp = jL.init_attn(jax.random.PRNGKey(3), jcfg)
    tp = _port(jp)
    rng = np.random.default_rng(5)
    W = jcfg.window
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, W, jcfg.num_kv_heads,
                                   jcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    for pos in (3, W + 5):
        jo = jL.attn_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
                            window=W)
        to = tL.attn_decode(tp, jcfg, torch.from_numpy(x),
                            torch.from_numpy(ck), torch.from_numpy(cv), pos,
                            window=W)
        for t, j in zip(to, jo):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD)


def test_rglru_lam_stays_f32_and_gates_start_open():
    cfg = tbase.smoke_config("recurrentgemma-2b").replace(
        param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = R.init_rglru_block(gen, cfg, "cpu")
    assert p["lam"].dtype == torch.float32
    assert p["w_x"].dtype == torch.bfloat16
    assert float(p["lam"].min()) >= -4.3 and float(p["lam"].max()) <= -2.0
    m = R.init_mlstm_block(gen, tbase.smoke_config("xlstm-1.3b"), "cpu")
    H = tbase.smoke_config("xlstm-1.3b").num_heads
    assert torch.equal(m["b_gates"], torch.cat([torch.zeros(H),
                                                torch.full((H,), 3.0)]))
