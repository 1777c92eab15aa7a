"""The port's sharded train step and MoE mesh branch on 8 CPU ranks (a
gloo process group of 8 processes) against the JAX package on 8 fake XLA
host devices (``tests/test_multidevice.py::test_sharded_train_step_and_moe``):

  - yi-9b and kimi-k2-1t-a32b smoke configs with ``fsdp=True`` on a (data 4,
    model 2) mesh, from JAX's initial weights carried across: 2 steps of
    ``make_train_step`` on DTensor leaves (parameters, AdamW moments and
    batches placed by ``train_state_specs`` and ``batch_specs``), each loss
    against JAX's sharded loss and against the port's single-rank loss,
    and each parameter's update over the 2 steps against JAX's, both in
    the configs' bfloat16 compute and in float32 compute;
  - the MoE layer's explicit schedule in expert mode (kimi, (4, 2): E = 8
    experts over 2 model ranks) and tensor mode (grok, (1, 8): E = 4 does
    not divide 8, so each rank holds a d_ff slice of every expert), with
    FSDP's in-body gathers, in float64: the loss and every parameter's
    gradient against the port's local path.

Tolerances, each just above the gap this test reads on the CPU.  The
port's and JAX's sharded steps share their semantics (kimi's MoE capacity
comes from each data rank's own tokens on both), so what parts them is
rounding.  An update is held leaf by leaf at the worst leaf, as
``||d - d_jax|| / ||d_jax||``; AdamW's first steps move each weight by
about ``lr`` whatever its gradient's size, so rounding that flips a small
gradient's sign shows in full there.

  - bfloat16 compute: losses within 1e-3 of JAX's for yi-9b (5.8e-4 read)
    and 1e-2 for kimi (5.1e-3 read: a bf16 difference in the router's
    input flips a few near-tied expert choices, and the capacity drops
    with them); updates within 0.3 (yi, 0.21 read) and 0.6 (kimi, 0.48
    read).  Against the port's single-rank loss: 1e-3 for yi (6.9e-4
    read) and 2e-2 for kimi (1.4e-2 read), whose single-rank capacity
    comes from the whole batch, another drop rule.
  - float32 compute: losses within 2e-6 of JAX's (4.8e-7 read, one ulp
    at 6.7) and updates within 2e-3 (5.5e-4 read for yi, 1.1e-4 for
    kimi).  Kimi's single-rank updates, under the whole batch's drop
    rule, lie 0.62 or more from JAX's sharded ones: a wrong drop rule or
    update fails here.

The float64 MoE runs set ``capacity_factor = E / k`` so that no slot is
dropped on either path; loss and gradients then agree to float64
rounding: 1e-10 relative to each gradient's largest entry.  The router
stays float32 whatever the parameter dtype (as in the JAX package), and
its gradient sums the ranks' float32 parts in another order than the
local path: 1e-6 relative for it (a few float32 ulps; 9e-8 was seen)."""
import numpy as np
import pytest

from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops
from torch_mesh_helpers import run_jax, run_ranks


@pytest.fixture(autouse=True)
def port_env():
    """The port on its plain CPU versions, under its own lock checker (the
    rank processes set the same)."""
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

ARCHS = ("yi-9b", "kimi-k2-1t-a32b")

_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro import runtime
from repro.configs.base import ShapeCfg, smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import make_batch
from repro.sharding import resolve_tree
from repro.train.steps import init_train_state, make_train_step, train_state_specs

mesh = make_host_mesh(data=4, model=2)
shape = ShapeCfg("t", 32, 8, "train")
out = {}
for arch, compute in [(a, c) for c in ("bfloat16", "float32")
                      for a in ("yi-9b", "kimi-k2-1t-a32b")]:
    cfg = smoke_config(arch).replace(fsdp=True, compute_dtype=compute)
    with runtime.use_mesh(mesh):
        state = init_train_state(jax.random.PRNGKey(0), cfg)
        init = jax.tree.map(np.asarray, state)
        sh = resolve_tree(jax.eval_shape(lambda: state),
                          train_state_specs(cfg), mesh, cfg.fsdp)
        state = jax.tree.map(jax.device_put, state, sh)
        step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
        losses = []
        for seed in (0, 1):
            state, m = step(state, make_batch(cfg, shape, seed=seed))
            losses.append(float(m["loss"]))
    out[arch, compute] = {"init": init, "losses": losses,
                          "final": jax.tree.map(np.asarray,
                                                state["params"])}
with open(OUT + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
"""

_RANKS = """
import traceback
from repro_torch import runtime, sharding
from repro_torch.configs.base import MoECfg, ShapeCfg, smoke_config
from repro_torch.core.capture import leaves_with_paths, map_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import (batch_specs, init_model, make_batch,
                                      make_loss_fn, model_specs)
from repro_torch.train.steps import (make_train_step, state_from_numpy,
                                     train_state_specs)

with open(os.path.join(OUT, "jax", "jax.pkl"), "rb") as f:
    ref = pickle.load(f)
shape = ShapeCfg("t", 32, 8, "train")


def scenario(name, fn):
    try:
        dump(name, fn())
    except Exception:
        dump(name, {"error": traceback.format_exc()})


def batch_on(mesh, cfg, seed):
    b = make_batch(cfg, shape, seed=seed, device="cpu")
    return b, sharding.distribute_tree(
        b, sharding.resolve_tree(b, batch_specs(cfg, shape), mesh, False))


def train(arch, compute):
    mesh = make_host_mesh(4, 2)
    cfg = smoke_config(arch).replace(fsdp=True, compute_dtype=compute)
    init = ref[arch, compute]["init"]
    state = state_from_numpy(init, device="cpu")
    sh = sharding.resolve_tree(state, train_state_specs(cfg), mesh, cfg.fsdp)
    st = sharding.distribute_tree(state, sh)
    n_sharded = sum(tuple(t.to_local().shape) != tuple(t.shape)
                    for _, t in leaves_with_paths(st))
    step = make_train_step(cfg)
    sharded = []
    with runtime.use_mesh(mesh):
        for seed in (0, 1):
            st, m = step(st, batch_on(mesh, cfg, seed)[1])
            sharded.append(float(m["loss"].full_tensor()))
    plain = state_from_numpy(init, device="cpu")
    single = []
    for seed in (0, 1):
        plain, m = step(plain, make_batch(cfg, shape, seed=seed,
                                          device="cpu"))
        single.append(float(m["loss"]))
    # each parameter's update over the 2 steps against JAX's sharded one
    # and the port's single-rank one: ||d - d_jax|| / ||d_jax||
    first = state_from_numpy(init, device="cpu")["params"]
    final = state_from_numpy(ref[arch, compute]["final"], device="cpu")
    upd = {}
    for (name, t), (_, p0), (_, pj), (_, p1) in zip(
            leaves_with_paths(st["params"]), leaves_with_paths(first),
            leaves_with_paths(final), leaves_with_paths(plain["params"])):
        d, dj, d1 = (t.full_tensor() - p0).double(), (pj - p0).double(), \
            (p1 - p0).double()
        n = float(dj.norm())
        upd[name] = (float((d - dj).norm()) / n,
                     float((d1 - dj).norm()) / n, n)
    return {"sharded": sharded, "single": single, "n_sharded": n_sharded,
            "updates": upd}


def moe(arch, data, model, experts):
    mesh = make_host_mesh(data, model)
    base = smoke_config(arch)
    E, k = base.moe.num_experts, base.moe.experts_per_token
    cfg = base.replace(
        fsdp=True, param_dtype="float64", compute_dtype="float64",
        opt_dtype="float64",
        moe=MoECfg(num_experts=E, experts_per_token=k, d_ff=base.moe.d_ff,
                   capacity_factor=E / k))
    assert (E % model == 0) == experts
    params = init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    sh = sharding.resolve_tree(params, model_specs(cfg), mesh, cfg.fsdp)
    pd = sharding.distribute_tree(params, sh)
    # the dim the expert weights are sharded on over "model", by name
    w_pl = {n.rsplit("/", 1)[1]: t.placements[-1].dim
            for n, t in leaves_with_paths(pd) if "ffn/w_" in n}
    loss_fn = make_loss_fn(cfg)
    b, bd = batch_on(mesh, cfg, 5)

    def loss_and_grads(p, batch):
        tracked = map_tree(lambda _, t: t.detach().requires_grad_(), p)
        with torch.enable_grad():
            loss = loss_fn(tracked, batch)
        grads = torch.autograd.grad(
            loss, [t for _, t in leaves_with_paths(tracked)])
        return loss, grads

    with runtime.use_mesh(mesh):
        loss_s, grads_s = loss_and_grads(pd, bd)
        loss_s = float(loss_s.full_tensor())
        grads_s = [g.full_tensor() for g in grads_s]
    loss_l, grads_l = loss_and_grads(params, b)
    errs = {}
    for (name, _), gs, gl in zip(leaves_with_paths(params), grads_s,
                                 grads_l):
        scale = float(gl.abs().max())
        errs[name] = (float((gs - gl).abs().max()), scale, str(gl.dtype))
    return {"loss": (loss_s, float(loss_l)), "errs": errs,
            "w_placements": w_pl}


for arch in ("yi-9b", "kimi-k2-1t-a32b"):
    scenario("train_" + arch, lambda: train(arch, "bfloat16"))
    scenario("train32_" + arch, lambda: train(arch, "float32"))
scenario("moe_expert", lambda: moe("kimi-k2-1t-a32b", 4, 2, True))
scenario("moe_tensor", lambda: moe("grok-1-314b", 1, 8, False))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multidevice_train"))
    ref = run_jax(_JAX, out + "/jax")
    return ref, run_ranks(_RANKS, out)


def _rank0(got, name):
    res = got[(name, 0)]
    assert "error" not in res, res["error"]
    for r in range(8):
        other = got[(name, r)]
        assert "error" not in other, other["error"]
    return res


def _worst_update(res, which):
    """The worst leaf's ``||d - d_ref|| / ||d_ref||``: ``which`` 0 is the
    sharded update against JAX's, 1 the single-rank one against JAX's."""
    assert len(res["updates"]) > 5
    return max(u[which] for u in res["updates"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax_and_single_rank(runs, arch):
    """bfloat16 compute, as the smoke configs run."""
    ref, got = runs
    res = _rank0(got, "train_" + arch)
    assert res["n_sharded"] > 0
    loss_tol, single_tol, upd_tol = \
        (1e-3, 1e-3, 0.3) if arch == "yi-9b" else (1e-2, 2e-2, 0.6)
    want = ref[arch, "bfloat16"]["losses"]
    assert np.all(np.isfinite(res["sharded"]))
    np.testing.assert_allclose(res["sharded"], want, rtol=0, atol=loss_tol)
    np.testing.assert_allclose(res["sharded"], res["single"], rtol=0,
                               atol=single_tol)
    assert _worst_update(res, 0) <= upd_tol, res["updates"]
    for r in range(8):  # every rank saw the same replicated loss
        assert got[("train_" + arch, r)]["sharded"] == res["sharded"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_float32_matches_jax_update_for_update(runs,
                                                                  arch):
    """float32 compute: rounding no longer flips the MoE's expert choices,
    so the sharded losses and every parameter's update match JAX's
    sharded step closely, and kimi's single-rank step, whose capacity
    comes from the whole batch, is far from it."""
    ref, got = runs
    res = _rank0(got, "train32_" + arch)
    assert res["n_sharded"] > 0
    np.testing.assert_allclose(res["sharded"],
                               ref[arch, "float32"]["losses"], rtol=0,
                               atol=2e-6)
    assert _worst_update(res, 0) <= 2e-3, res["updates"]
    if arch != "yi-9b":
        assert _worst_update(res, 1) > 0.3, res["updates"]
    for r in range(8):
        assert got[("train32_" + arch, r)]["sharded"] == res["sharded"]


@pytest.mark.parametrize("mode", ["expert", "tensor"])
def test_moe_mesh_branch_loss_and_gradients(runs, mode):
    """Expert mode shards the expert dim over "model"; tensor mode shards
    d_ff.  Either way the loss and every gradient equal the local path's
    (float64, no dropped slot)."""
    _, got = runs
    res = _rank0(got, "moe_" + mode)
    sharded, local = res["loss"]
    assert abs(sharded - local) <= 1e-10 * abs(local), (sharded, local)
    # (layer, E, d, f) and (layer, E, f, d) stacks: the expert dim is 1
    want = {"w_gate": 1, "w_up": 1, "w_down": 1} if mode == "expert" \
        else {"w_gate": 3, "w_up": 3, "w_down": 2}
    assert res["w_placements"] == want
    assert len(res["errs"]) > 10
    for name, (err, scale, dtype) in res["errs"].items():
        assert scale > 0, name
        rel = 1e-6 if dtype == "torch.float32" else 1e-10
        assert err <= rel * scale, (name, err, scale, dtype)
