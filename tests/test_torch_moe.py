"""The port's mixture-of-experts layer and the two MoE archs (grok-1-314b,
kimi-k2-1t-a32b) against the JAX package on the CPU, at their ``smoke()``
sizes: the same numpy inputs and the JAX parameters carried across through
numpy go through ``repro.models.moe`` (no mesh: every expert local) and
``repro_torch.models.moe``, then the whole LM through
``repro.models.transformer`` and ``repro_torch.models.transformer``.

Routing is held exactly: the top-k ids are equal, except where the two
packages' float32 router products (summed in other orders) put two logits
within 1e-6 of each other, which the test then asserts of the gap; the
routing weights within 1e-6; the keep masks of the capacity-bounded
dispatch equal, at the registered capacity factor (1.25) and at 0.5,
which drops slots.  With ``compute_dtype="float32"`` the layer's output
and the logits agree within rtol 1e-5 / atol 1e-5 (outputs of size ~1,
each a sum of a few hundred f32 products per expert, summed in other
orders), the loss within rtol 1e-5 / atol 1e-6, every gradient leaf within
rtol 1e-4 / atol 1e-6, a train step's grad norm within rtol 1e-4.  Decode
against the forward pass is held in float64 within 1e-6, as every decode
check is, at ``capacity_factor = E / k``: then C >= N and nothing drops,
while the forward over the whole sequence would drop slots that a
one-token decode keeps at the registered factor.  Parameter counts at full
size and checkpoint bytes are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import moe as jMOE
from repro.models import transformer as jTF
from repro.train import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.launch import train as trainer
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tMOE
from repro_torch.models import transformer as tTF
from repro_torch.train import steps as tsteps

ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
FWD = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-6, atol=1e-6)
#: router logits closer than this may order differently in the two packages
TIE_GAP = 1e-6


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


def _moe(cfg, **over):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **over))


def _cfgs(arch, compute="float32", capacity=None, **over):
    cfgs = (jbase.smoke_config(arch).replace(compute_dtype=compute, **over),
            tbase.smoke_config(arch).replace(compute_dtype=compute, **over))
    if capacity is not None:
        cfgs = tuple(_moe(c, capacity_factor=capacity) for c in cfgs)
    return cfgs


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


def _moe_params(jcfg, seed=0):
    p = jMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, _port(p)


def _x(cfg, N=128, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _assert_ids_equal_but_near_ties(got, want, logits):
    """Top-k ids equal, except where the two packages' logits order a near
    tie differently: there the two experts' logits lie within
    ``TIE_GAP``."""
    got, want = np.asarray(got), np.asarray(want)
    for n, j in zip(*np.nonzero(got != want)):
        gap = abs(logits[n, got[n, j]] - logits[n, want[n, j]])
        assert gap < TIE_GAP, (n, j, got[n], want[n], gap)


def _jax_keep(jcfg, x, router):
    """The reference's top-k ids and keep mask: its own ``_route`` and
    ``_capacity``, then the slot positions of ``_moe_block`` without a
    mesh (``e_start=0``, ``e_count=E``: every slot local)."""
    E = jcfg.moe.num_experts
    ids, _ = jMOE._route(jnp.asarray(router), jcfg, jnp.asarray(x))
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
    return np.asarray(ids), np.asarray(slot < jMOE._capacity(x.shape[0],
                                                              jcfg))


# ---------------------------------------------------------------------------
# the layer against repro.models.moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_names_shapes_dtypes_match_jax(arch, size):
    """The router (d, E) in float32 whatever the parameter dtype (bf16 at
    full size), the experts' stacks in the parameter dtype: the JAX
    package's leaves, laid out on the meta device at full size."""
    get = "smoke_config" if size == "smoke" else "get_config"
    jcfg, tcfg = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
    want = jax.eval_shape(lambda: jMOE.init_moe(jax.random.PRNGKey(0),
                                                jcfg))
    got = tMOE.init_moe(torch.Generator().manual_seed(0), tcfg,
                        torch.device("meta"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype)
    assert got["router"].dtype == torch.float32
    assert str(got["w_gate"].dtype).endswith(tcfg.param_dtype)


def test_experts_drawn_in_slices_keep_the_he_scale(monkeypatch):
    """Experts drawn a slice at a time (here 3 of the 8 at a time, as
    kimi-k2-1t-a32b's are) have the ``1/sqrt(fan_in)`` scale of one
    draw."""
    cfg = tbase.smoke_config("kimi-k2-1t-a32b").replace(d_model=256)
    d, f = cfg.d_model, cfg.moe.d_ff
    monkeypatch.setattr(tMOE, "_DRAW_ELEMS", 3 * d * f)
    p = tMOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    for name, fan_in in (("w_gate", d), ("w_up", d), ("w_down", f)):
        per_expert = p[name].reshape(cfg.moe.num_experts, -1).std(dim=1)
        np.testing.assert_allclose(per_expert.numpy(), fan_in ** -0.5,
                                   rtol=0.05, err_msg=name)
    assert not torch.equal(p["w_gate"][0], p["w_gate"][3])


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for cf in (1.25, 0.5, jcfg.moe.num_experts / jcfg.moe.experts_per_token):
        j, t = _moe(jcfg, capacity_factor=cf), _moe(tcfg, capacity_factor=cf)
        for n in (1, 2, 3, 4, 7, 8, 31, 32, 100, 256, 1024, 4096):
            c = tMOE._capacity(n, t)
            assert c == jMOE._capacity(n, j), (cf, n)
            assert c % 8 == 0 and c >= 8


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, seed=2)
    x = _x(jcfg, seed=3)
    jids, jw = jMOE._route(jp["router"], jcfg, jnp.asarray(x))
    tids, tw = tMOE._route(tp["router"], tcfg, torch.from_numpy(x))
    assert tids.shape == (x.shape[0], jcfg.moe.experts_per_token)
    _assert_ids_equal_but_near_ties(tids, jids, x @ np.asarray(jp["router"]))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(tw).sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_ties_take_the_lower_expert(arch):
    """Equal logits: experts whose router columns are equal tie exactly
    for every token, and both packages list the lower id first, with equal
    weights."""
    jcfg, tcfg = _cfgs(arch)
    E = jcfg.moe.num_experts
    rng = np.random.default_rng(4)
    cols = rng.standard_normal((jcfg.d_model, 2)).astype(np.float32)
    router = cols[:, np.arange(E) % 2]  # experts 0, 2, 4, ... tie; 1, 3, ...
    x = _x(jcfg, N=16, seed=5)
    jids, jw = jMOE._route(jnp.asarray(router), jcfg, jnp.asarray(x))
    tids, tw = tMOE._route(torch.from_numpy(router), tcfg,
                           torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tids), np.asarray(jids))
    k = jcfg.moe.experts_per_token
    for n in range(x.shape[0]):
        parity = int(np.argmax(x[n] @ cols))
        np.testing.assert_array_equal(_np(tids[n]),
                                      parity + 2 * np.arange(k))
    np.testing.assert_array_equal(_np(tw), np.full_like(_np(tw), 1 / k))


@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, capacity):
    """The dispatch keeps exactly the reference's slots (at 0.5 it drops
    some), and ``_moe_block`` and ``apply_moe`` agree with the reference's
    in f32."""
    jcfg, tcfg = _cfgs(arch, capacity=capacity)
    E = jcfg.moe.num_experts
    jp, tp = _moe_params(jcfg, seed=6)
    x = _x(jcfg, N=128, seed=7)
    jids, jkeep = _jax_keep(jcfg, x, jp["router"])
    tids, _ = tMOE._route(tp["router"], tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tids), jids)
    C = tMOE._capacity(x.shape[0], tcfg)
    flat_idx, keep = tMOE._dispatch(tids.reshape(-1), E, C)
    np.testing.assert_array_equal(_np(keep), jkeep)
    if capacity == 0.5:
        assert not jkeep.all()
    kept = _np(flat_idx)[_np(keep)]
    assert len(set(kept)) == len(kept) and kept.max() < E * C
    assert (_np(flat_idx)[~_np(keep)] == E * C).all()

    want = jMOE._moe_block(jcfg, jnp.asarray(x), jp["router"], jp["w_gate"],
                           jp["w_up"], jp["w_down"], e_start=0, e_count=E,
                           n_model=1)
    got = tMOE._moe_block(tcfg, torch.from_numpy(x), tp["router"],
                          tp["w_gate"], tp["w_up"], tp["w_down"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    x3 = x.reshape(4, 32, -1)
    want = jMOE.apply_moe(jp, jcfg, jnp.asarray(x3))
    got = tMOE.apply_moe(tp, tcfg, torch.from_numpy(x3))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


def test_moe_block_dropped_slot_contributes_nothing():
    """With C = 8 and every token routed to the same two experts, the
    first 8 tokens are kept and the other 16 drop out: their output is
    0."""
    _, tcfg = _cfgs("grok-1-314b", capacity=0.5)
    d, E = tcfg.d_model, tcfg.moe.num_experts
    router = torch.zeros((d, E))
    router[:, 1], router[:, 3] = 1.0, 2.0
    x = torch.ones((24, d))
    p = tMOE.init_moe(torch.Generator().manual_seed(8), tcfg, "cpu")
    y = tMOE._moe_block(tcfg, x, router, p["w_gate"], p["w_up"],
                        p["w_down"])
    assert tMOE._capacity(24, tcfg) == 8
    assert y[:8].abs().sum(-1).min() > 0 and not y[8:].any()
    assert torch.equal(y[0], y[7])


@pytest.mark.parametrize("arch", ARCHS)
def test_active_fraction_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    assert tMOE.active_fraction(tcfg) == jMOE.active_fraction(jcfg)
    assert tMOE.active_fraction(tbase.get_config(arch)) == \
        jMOE.active_fraction(jbase.get_config(arch))


# ---------------------------------------------------------------------------
# the MoE LM against repro.models.transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch, capacity):
    """The f32 logits, the LM loss and every gradient leaf (the router's
    through the routing weights) at the registered capacity factor and at
    0.5."""
    jcfg, tcfg = _cfgs(arch, capacity=capacity)
    jp = jmodel.init_model(jax.random.PRNGKey(9), jcfg)
    tp = _port(jp)
    toks = _tokens(jcfg, T=32, seed=10)
    want = jTF.lm_forward(jp, jcfg, jnp.asarray(toks))
    got = tTF.lm_forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    jloss, jgrads = jax.value_and_grad(jmodel.make_loss_fn(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    leaves = [t.requires_grad_() for _, t in leaves_with_paths(tp)]
    tloss = tmodel.make_loss_fn(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    want = _jax_leaves(jgrads)
    names = [n for n, _ in leaves_with_paths(tp)]
    assert names == [n for n, _ in want]
    assert any(n.endswith("ffn/router") for n in names)
    for g, (name, w) in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_step(arch):
    """One port train step from the JAX state against one jitted JAX step:
    loss, grad norm, and Adam's first moments (a tenth of each gradient),
    and the step moved every parameter leaf."""
    jcfg, tcfg = _cfgs(arch)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(11), jcfg)
    toks = _tokens(jcfg, T=24, seed=12)
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))(
        jstate, {"tokens": jnp.asarray(toks)})
    tstate = _port(jstate)
    before = {n: t.clone() for n, t in leaves_with_paths(tstate["params"])}
    _, tm = tsteps.make_train_step(tcfg, lr=1e-3)(
        tstate, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_tree_close(tstate["opt"]["m"], jnew["opt"]["m"],
                       dict(rtol=1e-4, atol=1e-7))
    for name, t in leaves_with_paths(tstate["params"]):
        assert not torch.equal(t, before[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_keep_an_f32_router(arch):
    """Under bf16 parameters the JAX state carried across keeps its router
    in float32 and its experts in bf16, bit for bit, and the bf16 loss
    agrees with JAX's within 2e-2 (bf16 matmul inputs, accumulated
    differently)."""
    jcfg, tcfg = _cfgs(arch, compute="bfloat16", param_dtype="bfloat16")
    jp = jmodel.init_model(jax.random.PRNGKey(13), jcfg)
    tp = _port(jp)
    for name, t in leaves_with_paths(tp):
        want = "float32" if name.endswith("ffn/router") else "bfloat16"
        assert str(t.dtype) == f"torch.{want}", name
    got = tsteps.state_to_numpy(tp)
    for name, w in _jax_leaves(jp):
        np.testing.assert_array_equal(
            dict(leaves_with_paths(got))[name].view(np.uint8),
            w.view(np.uint8), name)
    toks = _tokens(jcfg, T=32, seed=14)
    jloss = jTF.lm_loss(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tloss = tTF.lm_loss(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tloss) - float(jloss)) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax(arch):
    """``lm_prefill`` (last logits and JAX's T-slot K/V caches) at the
    registered capacity factor, then decode steps from an empty cache
    against JAX's: logits, greedy tokens and caches."""
    jcfg, tcfg = _cfgs(arch)
    jp = jTF.init_lm(jax.random.PRNGKey(15), jcfg)
    tp = _port(jp)
    T, steps = 12, 4
    toks = _tokens(jcfg, T=T + steps, seed=16)
    jl, jc = jax.jit(lambda p, t: jTF.lm_prefill(p, jcfg, t))(
        jp, jnp.asarray(toks[:, :T]))
    tl, tc = tTF.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :T]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
    _assert_tree_close(tc, jc, FWD)

    S = T + steps
    jc = jTF.lm_cache_init(jcfg, 2, S)
    tc = tTF.lm_cache_init(tcfg, 2, S, "cpu")
    jdecode = jax.jit(lambda p, c, t, pos: jTF.lm_decode_step(
        p, jcfg, c, t, pos))
    for pos in range(S):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tTF.lm_decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                    torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
        np.testing.assert_array_equal(_np(tl.argmax(-1)),
                                      np.asarray(jl.argmax(-1)))
    _assert_tree_close(tc, jc, FWD)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_forward_in_float64(arch):
    """At ``capacity_factor = E / k`` (C >= N: no slot drops), a prompt
    prefilled into caches sized for the whole context, then one decode
    step a token, and decode from an empty cache: every row equals the
    forward pass's logits at its position within 1e-6 (float64 compute and
    parameters; the router stays float32 and routes in float64)."""
    _, tcfg = _cfgs(arch, "float64", param_dtype="float64", vocab_size=500)
    m = tcfg.moe
    tcfg = _moe(tcfg, capacity_factor=m.num_experts / m.experts_per_token)
    params = tmodel.init_model(tcfg, generator=torch.Generator()
                               .manual_seed(17), device="cpu")
    T, S = 7, 13
    tokens = torch.from_numpy(_tokens(tcfg, T=S, seed=18))
    assert tMOE._capacity(2 * S, tcfg) >= 2 * S
    full = tTF.lm_forward(params, tcfg, tokens)
    assert full.dtype == torch.float64
    last, cache = tmodel.make_prefill_fn(tcfg, cache_len=S)(
        params, {"tokens": tokens[:, :T]})
    np.testing.assert_allclose(last.numpy(), full[:, T - 1].numpy(), **F64)
    decode = tmodel.make_decode_fn(tcfg)
    for pos in range(T, S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(), **F64)
    cache = tmodel.cache_init(tcfg, 2, S, device="cpu")
    for pos in range(S):
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(), **F64)
    assert float(lg[:, tcfg.vocab_size:].max()) == -1e30


@pytest.mark.parametrize("arch,layers,counts", [
    ("grok-1-314b", None, dict(total=316_489_340_928)),
    ("kimi-k2-1t-a32b", None, dict(total=1_041_166_988_288)),
    ("grok-1-314b", 1, dict(total=6_530_598_912, expert=4_831_838_208)),
    ("kimi-k2-1t-a32b", 1, dict(total=19_378_623_488,
                                expert=16_911_433_728)),
])
def test_count_params_at_full_size(arch, layers, counts):
    """Counts laid out on the meta device equal JAX's ``eval_shape``
    counts (total, active, expert, embed), whole and cut to one layer as
    the card serves them."""
    over = {} if layers is None else {"num_layers": layers}
    tcfg = tbase.get_config(arch).replace(**over)
    got = tmodel.count_params(tcfg)
    assert got == jmodel.count_params(jbase.get_config(arch).replace(**over))
    assert {k: got[k] for k in counts} == counts
    assert got["active"] < got["total"]


# ---------------------------------------------------------------------------
# a MoE serving state across the packages
# ---------------------------------------------------------------------------


_CORE = {"jax": jcore, "torch": tcore}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_state_crosses_packages(tmp_path, arch, writer, reader):
    """A MoE serving state (the smoke params in bf16 with the router in
    float32, a prefilled K/V cache in the bf16 compute dtype, the next
    token and position) checkpointed by one package restores through the
    other in a fresh cluster, leaf for leaf and bit for bit, and both
    packages write the same shard bytes."""
    cfg = jbase.smoke_config(arch).replace(param_dtype="bfloat16")
    params = jmodel.init_model(jax.random.PRNGKey(19), cfg)
    toks = _tokens(cfg, T=12, seed=20)
    logits, cache = jTF.lm_prefill(params, cfg, jnp.asarray(toks))
    state = jax.tree.map(np.asarray, {
        "params": params, "cache": cache,
        "tok": jnp.argmax(logits, -1)[:, None].astype(jnp.int32),
        "pos": jnp.asarray(12, jnp.int32)})
    ffn = state["params"]["blocks"][0]["ffn"]
    assert str(ffn["router"].dtype) == "float32"
    assert str(ffn["w_gate"].dtype) == "bfloat16"
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


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "grok-1-314b"])
def test_trainer_runs_moe_smoke(tmp_path, arch):
    """``launch/train.py --arch kimi-k2-1t-a32b --smoke --steps 2`` on the
    CPU, and the same for grok-1-314b: two finite losses, the optimizer at
    step 2, the router still in float32."""
    run = trainer.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--scratch", str(tmp_path)])
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert int(run.state["opt"]["step"]) == 2
    ffn = run.state["params"]["blocks"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    cfg = tbase.smoke_config(arch)
    assert ffn["w_gate"].shape == (cfg.num_layers, cfg.moe.num_experts,
                                   cfg.d_model, cfg.moe.d_ff)
