"""The port's sharded state path on 8 CPU ranks (a gloo process group of 8
processes on a (data 4, model 2) ``DeviceMesh``) against the JAX package on
8 fake XLA host devices, as ``tests/test_multidevice.py`` runs it:

  - the device L2 ring's mesh form (``partner.encode_l2(state, pspecs,
    mesh)``): every (data, model) slot's buffer bit-equal to the JAX
    mesh device's slice, in partner and XOR mode, and a lost slot rebuilt
    from the survivors and the parity;
  - a sharded checkpoint and restore: JAX's yi-9b smoke state after one
    sharded step, carried onto the mesh, goes through ``checkpoint`` (each
    process one rank of the cluster, writing the shards it holds) and
    ``restart_latest(shardings=)``: DTensors with the same placements, bit
    for bit, and the union over ranks of the region names and bytes equal
    to the JAX client's regions of the same state;
  - a batch of ``SyntheticStream(mesh=)``, each rank's rows the slice of
    the global batch.

The JAX package runs once, in a subprocess, for the whole file; the 8
ranks run once, each scenario recording its results."""
import numpy as np
import pytest

from repro.core import partner as jpartner
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

_JAX = """
import pickle, shutil
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeCfg, smoke_config
from repro.core import VelocClient, VelocConfig, restart
from repro.core.partner import encode_l2
from repro.launch.mesh import make_host_mesh
from repro.models.model import make_batch
from repro.sharding import resolve_tree
from repro import runtime
from repro.train.steps import init_train_state, make_train_step, train_state_specs

mesh = make_host_mesh(data=4, model=2)
rng = np.random.default_rng(11)
a = rng.standard_normal((24, 512)).astype(np.float32)
b = jnp.asarray(rng.standard_normal((2, 256)), jnp.bfloat16)
pspecs = {"a": P("data", None), "b": P(None, "model")}
sh = {k: NamedSharding(mesh, s) for k, s in pspecs.items()}
state = {"a": jax.device_put(jnp.asarray(a), sh["a"]),
         "b": jax.device_put(b, sh["b"])}
out = {"a": a, "b_bits": np.asarray(b).view(np.uint16),
       "partner": np.asarray(encode_l2(state, pspecs, mesh, mode="partner")),
       "xor": np.asarray(encode_l2(state, pspecs, mesh, mode="xor"))}

cfg = smoke_config("yi-9b")
shape = ShapeCfg("t", 32, 8, "train")
with runtime.use_mesh(mesh):
    st = init_train_state(jax.random.PRNGKey(0), cfg)
    ssh = resolve_tree(jax.eval_shape(lambda: st), train_state_specs(cfg),
                       mesh, cfg.fsdp)
    st = jax.tree.map(jax.device_put, st, ssh)
    st, _ = jax.jit(make_train_step(cfg))(st, make_batch(cfg, shape))
    scratch = OUT + "/jax_ckpt"
    shutil.rmtree(scratch, ignore_errors=True)
    client = VelocClient(VelocConfig(scratch=scratch, mode="sync",
                                     partner=False, xor_group=0))
    client.checkpoint(st, version=1)
    regions = restart.load_rank_regions(client.cluster, "ckpt", 1, 0)
out["state"] = jax.tree.map(np.asarray, st)
out["regions"] = {k: (str(np.asarray(v).dtype), np.asarray(v).shape,
                      np.asarray(v).tobytes()) for k, v in regions.items()}
with open(OUT + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
"""

_RANKS = """
import traceback
from repro_torch import sharding
from repro_torch.configs.base import ShapeCfg, smoke_config
from repro_torch.core import Cluster, VelocClient, VelocConfig, restart
from repro_torch.core.capture import leaves_with_paths
from repro_torch.core.partner import encode_l2
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.data import SyntheticStream
from repro_torch.train.steps import state_from_numpy, train_state_specs

with open(os.path.join(OUT, "jax", "jax.pkl"), "rb") as f:
    ref = pickle.load(f)
mesh = make_host_mesh(4, 2)
coord = tuple(int(c) for c in mesh.get_coordinate())
P = sharding.P


def scenario(name, fn):
    try:
        dump(name, {"coord": coord, **fn()})
    except Exception:
        dump(name, {"coord": coord, "error": traceback.format_exc()})


def encode():
    b = torch.from_numpy(ref["b_bits"].astype(np.int16)).view(torch.bfloat16)
    state = {"a": torch.from_numpy(ref["a"]), "b": b}
    pspecs = {"a": P("data", None), "b": P(None, "model")}
    st = sharding.distribute_tree(state, {
        k: sharding.NamedSharding(mesh, s) for k, s in pspecs.items()})
    out = {}
    for mode in ("partner", "xor"):
        o = encode_l2(st, pspecs, mesh, mode=mode)
        assert o.placements == sharding.placements(P(("data", "model")), mesh)
        out[mode] = o.to_local().numpy().view(np.uint32).copy()
        out[mode + "_len"] = int(o.shape[0])
    return out


def checkpoint():
    cfg = smoke_config("yi-9b")
    state = state_from_numpy(ref["state"], device="cpu")
    sh = sharding.resolve_tree(state, train_state_specs(cfg), mesh, cfg.fsdp)
    st = sharding.distribute_tree(state, sh)
    vc = VelocConfig(scratch=os.path.join(OUT, "port_ckpt"), mode="sync",
                     partner=False, xor_group=0)
    cluster = Cluster(vc, nranks=WORLD, process_group=dist.group.WORLD)
    client = VelocClient(vc, cluster=cluster, rank=RANK)
    client.checkpoint(st, version=1)
    dist.barrier()
    v, restored = client.restart_latest(st, shardings=sh)
    assert v == 1, client.restart_diagnostics
    n_sharded = 0
    for (name, a), (_, b) in zip(leaves_with_paths(st),
                                 leaves_with_paths(restored)):
        assert type(b).__name__ == "DTensor", name
        assert b.device_mesh is mesh and b.placements == a.placements, name
        assert b.shape == a.shape and b.dtype == a.dtype, name
        assert torch.equal(a.to_local(), b.to_local()), name
        n_sharded += tuple(a.to_local().shape) != tuple(a.shape)
    regions = restart.load_rank_regions(cluster, "ckpt", 1, RANK)
    client.shutdown()
    return {"n_sharded": n_sharded, "regions": {
        k: (str(np.asarray(v).dtype), np.asarray(v).shape,
            np.asarray(v).tobytes()) for k, v in regions.items()}}


def stream():
    cfg = smoke_config("yi-9b")
    shape = ShapeCfg("t", 32, 8, "train")
    dt = SyntheticStream(cfg, shape, seed=9, mesh=mesh).batch(3)
    whole = SyntheticStream(cfg, shape, seed=9, device="cpu").batch(3)
    out = {}
    for k, t in dt.items():
        n = t.to_local().shape[0]
        rows = whole[k][coord[0] * n:(coord[0] + 1) * n]
        out[k] = (tuple(t.placements) == sharding.placements(
            P("data"), mesh), bool(torch.equal(t.to_local(), rows)), n)
    return out


def l1_failure():
    # rank 3's node tiers refuse every put in v1, then heal for v2
    st = sharding.distribute_tree({"a": torch.from_numpy(ref["a"])}, {
        "a": sharding.NamedSharding(mesh, P("data", None))})
    vc = VelocConfig(scratch=os.path.join(OUT, "l1_failure"), mode="sync",
                     partner=False, xor_group=0)
    cluster = Cluster(vc, nranks=WORLD, process_group=dist.group.WORLD)
    client = VelocClient(vc, cluster=cluster, rank=RANK)
    tiers = cluster.node_tiers(RANK)

    def refuse(key, blob):
        raise OSError("node tier down")

    if RANK == 3:
        for tier in tiers:
            tier.put = refuse
    out = {"rank": RANK}
    for version in (1, 2):
        fut = client.checkpoint(st, version=version)
        fut.result(timeout=60)
        out[version] = {k: fut.results.get(k)
                        for k in ("l1-local.status", "l3-flush.status")}
        for tier in tiers:
            tier.__dict__.pop("put", None)
    dist.barrier()
    out["levels"] = sorted((m["version"], m["level"])
                           for m in cluster.manifests("ckpt"))
    v, restored = client.restart_latest(st, shardings={
        "a": sharding.NamedSharding(mesh, P("data", None))})
    out["restored"] = (v, bool(torch.equal(restored["a"].to_local(),
                                           st["a"].to_local())))
    client.shutdown()
    return out


def refusals():
    # the pipelines a process-group cluster cannot commit collectively
    out = {}
    for what, kw in (("default", {}), ("xor", {"partner": False}),
                     ("partner", {"xor_group": 0}),
                     ("aggregate", {"aggregate": True}),
                     ("delta", {"delta": True}),
                     ("interval", {"interval_s": 5.0}),
                     ("async", {"mode": "async"})):
        base = {"partner": False, "xor_group": 0} if what not in (
            "default", "xor", "partner") else {}
        vc = VelocConfig(**{"scratch": os.path.join(OUT, "refused"),
                            "mode": "sync", **base, **kw})
        try:
            VelocClient(vc, cluster=Cluster(
                vc, nranks=WORLD, process_group=dist.group.WORLD), rank=RANK)
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


scenario("encode", encode)
scenario("checkpoint", checkpoint)
scenario("l1_failure", l1_failure)
scenario("refusals", refusals)
scenario("stream", stream)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multidevice"))
    ref = run_jax(_JAX, out + "/jax")
    return ref, run_ranks(_RANKS, out)


def _by_coord(got, name) -> dict:
    out = {}
    for (n, _), res in got.items():
        if n == name:
            assert "error" not in res, res["error"]
            out[res["coord"]] = res
    assert len(out) == 8, sorted(out)
    return out


def test_ring_xor_and_partner_encode(runs):
    """Every (data, model) slot's buffer equals the JAX mesh device's slice
    of ``encode_l2`` bit for bit (slots matched by coordinate, not rank
    number), and the host oracle rebuilds a lost data slot from the
    survivors' buffers and the parity."""
    ref, got = runs
    res = _by_coord(got, "encode")
    for mode in ("partner", "xor"):
        want = ref[mode]
        n = want.shape[0] // 8
        assert res[(0, 0)][mode + "_len"] == want.shape[0]
        for (d, m), r in res.items():
            np.testing.assert_array_equal(
                r[mode], want[(d * 2 + m) * n:(d * 2 + m + 1) * n],
                err_msg=f"{mode} slot {(d, m)}")
    # rebuild data slot 2 from the model-0 column's buffers and parity
    a = ref["a"]
    b_bits = ref["b_bits"]

    def local_block(d):
        """JAX's flatten of device (d, 0)'s blocks: f32 words, then bf16
        pairs packed low half first; zero-padded to 1,024 words."""
        pairs = b_bits[:, :128].reshape(-1, 2).astype(np.uint32)
        buf = np.concatenate([a[d * 6:(d + 1) * 6].reshape(-1).view(np.uint32),
                              pairs[:, 0] | (pairs[:, 1] << 16)])
        return np.concatenate([buf, np.zeros((-len(buf)) % 1024, np.uint32)])

    bufs = [local_block(d) for d in range(4)]
    ref_par = jpartner.ring_xor_parity_ref(bufs)
    parity = {d: res[(d, 0)]["xor"][:len(ref_par[d])] for d in range(4)}
    for d in range(4):
        np.testing.assert_array_equal(parity[d], ref_par[d])
    lost = 2
    rec = jpartner.xor_reconstruct_group(
        {d: bufs[d] for d in range(4) if d != lost},
        {d: p for d, p in parity.items() if d != lost}, lost, 4,
        len(bufs[lost]))
    np.testing.assert_array_equal(rec, bufs[lost])
    np.testing.assert_array_equal(
        rec, res[(lost + 1, 0)]["partner"][:len(rec)])


def test_checkpoint_restore_sharded_state(runs):
    """Each rank restores its shards of every leaf as DTensors on the mesh
    with the written placements, bit for bit (asserted on the ranks); the
    union over ranks of the regions they wrote is the JAX client's set of
    regions, name for name and byte for byte."""
    ref, got = runs
    res = _by_coord(got, "checkpoint")
    assert all(r["n_sharded"] > 0 for r in res.values())
    union = {}
    for r in res.values():
        for k, v in r["regions"].items():
            assert union.setdefault(k, v) == v, k  # replicas agree
    assert sorted(union) == sorted(ref["regions"])
    assert any("@" in k for k in union)
    for k, (dtype, shape, data) in ref["regions"].items():
        assert union[k] == (dtype, shape, data), k


def test_failed_l1_write_on_one_rank_keeps_the_commit_collective(runs):
    """One rank's L1 tier refuses its put in v1: every rank still reaches
    each level's gather once, so the checkpoint completes on every rank
    (L3 holds it), v1 gets no L1 manifest, and the healed v2 gets both
    levels and restores."""
    _, got = runs
    res = _by_coord(got, "l1_failure")
    for coord, r in res.items():
        broken = r["rank"] == 3
        assert r[1] == {"l1-local.status": "error" if broken else "ok",
                        "l3-flush.status": "ok"}, (coord, r[1])
        assert r[2] == {"l1-local.status": "ok",
                        "l3-flush.status": "ok"}, (coord, r[2])
        assert r["levels"] == [(1, "L3"), (2, "L1"), (2, "L3")], coord
        assert r["restored"] == (2, True), coord


def test_process_group_cluster_refuses_per_process_pipelines(runs):
    """Partner copies, XOR parity, aggregation, delta chains, a defensive
    interval and async mode are refused on a process-group cluster, with
    the reason; the sync pipeline of serialize, local and flush is not."""
    _, got = runs
    for coord, r in _by_coord(got, "refusals").items():
        r = {k: v for k, v in r.items() if k != "coord"}
        for what, msg in r.items():
            assert msg is not None and "process group" in msg, (coord, what)
        assert "'partner'" in r["default"] and "'xor'" in r["default"]
        assert "'partner'" in r["partner"] and "'xor'" in r["xor"]
        assert "aggregate" in r["aggregate"] and "'delta'" in r["delta"]
        assert "interval_s" in r["interval"] and "async" in r["async"]


def test_stream_batches_are_slices_of_the_global_batch(runs):
    """A (data-sharded) batch of ``SyntheticStream(mesh=)``: each rank's
    rows, placed by ``batch_specs``, are its slice of the global batch."""
    _, got = runs
    res = _by_coord(got, "stream")
    for coord, r in res.items():
        assert set(r) == {"coord", "tokens"}
        placed, equal, rows = r["tokens"]
        assert placed and equal and rows == 2, coord
