"""v2 API: registries, PipelineSpec compilation, VelocConfig shim
equivalence, CheckpointFuture semantics, GC completeness, restart
diagnostics.

The JAX package's ``tests/test_v2_api.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import os
import threading

import numpy as np
import pytest

from repro_torch.core import (MODULES, TIERS, Cluster, ModuleRegistry,
                              ModuleSpec, PipelineSpec, TierSpec,
                              TierTopology, VelocClient, VelocConfig,
                              register_module)
from repro_torch.core import format as fmt
from repro_torch.core.backend import ActiveBackend
from repro_torch.core.modules import Module
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops


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


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


def test_module_registry_create_and_errors():
    reg = ModuleRegistry()

    @reg.register("rec")
    class Rec(Module):
        priority = 33

        def __init__(self, tag="x"):
            self.tag = tag

        def process(self, ctx):
            return "ok"

    m = reg.create("rec", tag="y")
    assert isinstance(m, Rec) and m.tag == "y"
    assert "rec" in reg and reg.names() == ["rec"]
    with pytest.raises(KeyError, match="unknown module 'nope'"):
        reg.create("nope")
    with pytest.raises(ValueError, match="already registered"):
        reg.register("rec", Rec)
    reg.register("rec", Rec, override=True)  # explicit override allowed


def test_builtin_modules_registered():
    for name in ("interval", "serialize", "local", "partner", "xor",
                 "flush", "verify"):
        assert name in MODULES, name


def test_tier_registry_builds_and_errors(tmp_path):
    spec = TierSpec("file", name="bb{rank}", gbps=8.0, persistent=True,
                    node_local=True, options={"subdir": "burst{rank}"})
    tier = TIERS.create(spec, scratch=str(tmp_path), rank=3)
    assert tier.info.name == "bb3"
    assert os.path.isdir(tmp_path / "burst3")
    with pytest.raises(KeyError, match="unknown tier kind"):
        TIERS.create(TierSpec("object-store"), scratch=str(tmp_path))


def test_custom_tier_kind_plugs_into_topology(tmp_path):
    from repro_torch.core.storage import DRAMTier, TierRegistry

    reg = TierRegistry()

    @reg.register("fastmem")
    def build(spec, *, scratch, rank=None):
        return DRAMTier(name=spec.resolved_name(rank), gbps=spec.gbps)

    t = reg.create(TierSpec("fastmem", name="fm{rank}", gbps=500.0),
                   scratch=str(tmp_path), rank=1)
    assert t.info.name == "fm1" and t.info.gbps == 500.0


# ---------------------------------------------------------------------------
# PipelineSpec -> Engine compilation
# ---------------------------------------------------------------------------


def test_pipeline_compiles_in_priority_order():
    spec = PipelineSpec(modules=[ModuleSpec("flush"), ModuleSpec("local"),
                                 ModuleSpec("serialize")])
    eng = spec.compile()
    assert [m.name for m in eng.modules] == ["serialize", "l1-local",
                                             "l3-flush"]


def test_pipeline_spec_priority_override_reorders():
    spec = PipelineSpec(modules=[ModuleSpec("serialize"),
                                 ModuleSpec("local", priority=45),
                                 ModuleSpec("flush")])
    eng = spec.compile()
    assert [m.name for m in eng.modules] == ["serialize", "l3-flush",
                                             "l1-local"]


def test_pipeline_unknown_module_raises():
    with pytest.raises(KeyError, match="unknown module 'telemetry'"):
        PipelineSpec(modules=[ModuleSpec("telemetry")]).compile()


def test_registered_custom_module_runs_in_pipeline(tmp_path):
    calls = []

    @register_module("probe-test", override=True)
    class Probe(Module):
        name = "probe"
        priority = 25

        def process(self, ctx):
            calls.append(ctx.version)
            return "ok"

    spec = PipelineSpec(name="p", mode="sync", modules=[
        ModuleSpec("serialize"), ModuleSpec("local"),
        ModuleSpec("probe-test")])
    client = VelocClient(spec, scratch=str(tmp_path))
    client.checkpoint({"w": np.arange(8.0)}, version=1, device_snapshot=False)
    assert calls == [1]


# ---------------------------------------------------------------------------
# VelocConfig -> spec compatibility shim
# ---------------------------------------------------------------------------


def test_config_compiles_to_equivalent_spec():
    cfg = VelocConfig(name="n", mode="sync", encoding="zlib", partner=True,
                      partner_distance=2, xor_group=4, rs_parity=1,
                      flush=True, verify=True, keep_versions=5)
    spec = cfg.to_pipeline_spec()
    assert [m.name for m in spec.modules] == \
        ["interval", "serialize", "local", "partner", "xor", "flush",
         "verify"]
    assert spec.module_options("serialize") == {"encoding": "zlib",
                                                "checksums": True}
    assert spec.module_options("partner") == {"distance": 2}
    assert spec.module_options("xor") == {"group_size": 4, "rs_parity": 1}
    assert spec.keep_versions == 5 and spec.mode == "sync"
    # switches off -> modules absent
    lean = VelocConfig(partner=False, xor_group=0, flush=False).to_pipeline_spec()
    assert [m.name for m in lean.modules] == ["interval", "serialize", "local"]


def _tree_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("nranks,kw", [
    (1, dict(partner=False, xor_group=0)),
    (4, dict(partner=True, xor_group=4)),
])
def test_config_shim_byte_identical_layout(tmp_path, nranks, kw):
    """A client built from a legacy VelocConfig and one built from the
    compiled specs must write byte-identical on-disk checkpoints."""
    states = [{"w": np.full(2048, r, np.float32), "step": np.asarray(3 + r)}
              for r in range(nranks)]

    def run(root, make):
        cfg = VelocConfig(name="ck", scratch=root, mode="sync",
                          keep_versions=0, **kw)
        cluster, clients = make(cfg)
        for r, c in enumerate(clients):
            c.checkpoint(states[r], version=1, device_snapshot=False,
                         meta={"step": 3})
        return _tree_files(root)

    def legacy(cfg):
        cluster = Cluster(cfg, nranks=nranks)
        return cluster, [VelocClient(cfg, cluster, rank=r)
                         for r in range(nranks)]

    def v2(cfg):
        cluster = Cluster(cfg.to_tier_topology(), nranks=nranks,
                          group_size=cfg.xor_group)
        spec = cfg.to_pipeline_spec()
        return cluster, [VelocClient(spec, cluster, rank=r)
                         for r in range(nranks)]

    a = run(str(tmp_path / "legacy"), legacy)
    b = run(str(tmp_path / "v2"), v2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], f"file {k} differs between legacy and v2"
    assert a  # sanity: something was written


# ---------------------------------------------------------------------------
# CheckpointFuture semantics
# ---------------------------------------------------------------------------


def _state():
    return {"w": np.arange(4096, dtype=np.float32), "step": np.asarray(1)}


def test_future_sync_completes_inline(tmp_path):
    client = VelocClient(PipelineSpec(name="s", mode="sync"),
                         scratch=str(tmp_path))
    fut = client.checkpoint(_state(), version=1, device_snapshot=False)
    assert fut.done() and fut.exception() is None
    res = fut.result()
    assert res["l1-local.status"] == "ok" and res["l3-flush.status"] == "ok"
    assert fut.level_event("L1").is_set() and fut.level_event("L3").is_set()
    assert fut.version == 1 and not fut.skipped


def test_future_async_result_waits_for_backend(tmp_path):
    client = VelocClient(PipelineSpec(name="a", mode="async"),
                         scratch=str(tmp_path))
    fut = client.checkpoint(_state(), version=1, device_snapshot=False)
    res = fut.result(timeout=60)
    assert fut.done()
    assert res["l3-flush.status"] == "ok"
    assert fut.wait_level("L1", timeout=5) and fut.wait_level("L3", timeout=5)
    # a level the pipeline never runs is never signalled
    assert not fut.wait_level("L2", timeout=0.05)
    client.shutdown()


def test_future_surfaces_background_exception(tmp_path):
    @register_module("boom-test", override=True)
    class Boom(Module):
        name = "boom"
        priority = 60  # past the blocking cut: runs in the backend

        def process(self, ctx):
            raise RuntimeError("flush target on fire")

    spec = PipelineSpec(name="b", mode="async", modules=[
        ModuleSpec("serialize"), ModuleSpec("local"),
        ModuleSpec("boom-test")])
    client = VelocClient(spec, scratch=str(tmp_path))
    fut = client.checkpoint(_state(), version=1, device_snapshot=False)
    assert fut.wait(timeout=60)
    exc = fut.exception()
    assert isinstance(exc, RuntimeError) and "on fire" in str(exc)
    with pytest.raises(RuntimeError, match="on fire"):
        fut.result(timeout=5)
    # still recorded in the backend log as before
    assert any("on fire" in e for e in client.backend.errors())
    client.shutdown()


def test_future_skipped_checkpoint_finishes_immediately(tmp_path):
    spec = PipelineSpec(name="sk", mode="async", modules=[
        ModuleSpec("interval", {"interval_s": 1e6}),
        ModuleSpec("serialize"), ModuleSpec("local")])
    client = VelocClient(spec, scratch=str(tmp_path))
    first = client.checkpoint(_state(), version=1, device_snapshot=False)
    assert first.result(timeout=60)["l1-local.status"] == "ok"
    second = client.checkpoint(_state(), version=2, device_snapshot=False)
    assert second.done() and second.skipped
    assert second.results["skip_reason"] == "interval"
    client.shutdown()


def test_future_superseded_by_newer_version(tmp_path):
    """When checkpoints outpace draining, the preempted version's future
    completes as superseded instead of hanging."""
    client = VelocClient(PipelineSpec(name="sup", mode="async",
                                      backend_workers=1),
                         scratch=str(tmp_path))
    gate = threading.Event()
    started = threading.Event()

    def blocker():
        started.set()
        gate.wait(30)

    client.backend.submit("blocker", 0, blocker, priority=1)
    assert started.wait(10)  # the single worker is now busy; tasks queue
    f1 = client.checkpoint(_state(), version=1, device_snapshot=False)
    f2 = client.checkpoint(_state(), version=2, device_snapshot=False)
    gate.set()
    assert f1.wait(timeout=60) and f2.wait(timeout=60)
    assert f1.superseded and f1.results.get("superseded")
    # a superseded version never persisted: result() must not read as ok
    from repro_torch.core import CheckpointError
    with pytest.raises(CheckpointError, match="superseded"):
        f1.result(timeout=5)
    assert not f2.superseded and f2.result(timeout=5)["l3-flush.status"] == "ok"
    client.shutdown()


def test_backend_supersede_fires_on_drop():
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    dropped = []
    b.submit("k", 1, lambda: gate.wait(10), priority=1)
    b.submit("k", 2, lambda: None, on_drop=lambda: dropped.append(2))
    b.submit("k", 3, lambda: None, supersede=True)
    gate.set()
    assert b.wait(timeout=10)
    assert dropped == [2]
    b.shutdown()


def test_explicit_cluster_adopts_pipeline_group_size(tmp_path):
    """Regression: a caller-built Cluster (the documented v2 pattern) must
    pick up the pipeline's XOR group size, or parity-based restore is
    silently disabled even though parity blobs get written."""
    from repro_torch.core import restart as rst

    nranks = 4
    spec = PipelineSpec(name="x", mode="sync", modules=[
        ModuleSpec("serialize"), ModuleSpec("local"),
        ModuleSpec("xor", {"group_size": 4})])
    cluster = Cluster(TierTopology(scratch=str(tmp_path)), nranks=nranks)
    clients = [VelocClient(spec, cluster, rank=r) for r in range(nranks)]
    assert cluster.group_size == 4
    for r, c in enumerate(clients):
        c.checkpoint({"w": np.full(128, r, np.float32)}, version=1,
                     device_snapshot=False)
    cluster.fail_node(2)
    regs = rst.load_rank_regions(cluster, "x", 1, 2)
    assert (regs["w"] == 2).all()
    # bare ModuleSpec("xor") resolves to the module's own default width
    assert PipelineSpec(modules=[ModuleSpec("xor")]).erasure_group_size() == 4
    assert PipelineSpec().erasure_group_size() == 0


# ---------------------------------------------------------------------------
# GC completeness (regression: parity + manifests used to leak)
# ---------------------------------------------------------------------------


def _all_keys(cluster, prefix):
    keys = set()
    for r in range(cluster.nranks):
        for tier in cluster.node_tiers(r):
            keys.update(tier.keys(prefix))
    for tier in cluster.external_tiers:
        keys.update(tier.keys(prefix))
    return keys


def test_gc_removes_parity_and_manifests(tmp_path):
    nranks = 8
    cfg = VelocConfig(name="g", scratch=str(tmp_path), mode="sync",
                      partner=True, xor_group=4, flush=True, keep_versions=1)
    cluster = Cluster(cfg, nranks=nranks)
    clients = [VelocClient(cfg, cluster, rank=r) for r in range(nranks)]
    for v in (1, 2, 3):
        for r, c in enumerate(clients):
            c.checkpoint({"w": np.full(256, r, np.float32)}, version=v,
                         device_snapshot=False)
    # v1 dropped (keep_versions+1 = 2 newest kept): every artifact gone —
    # shards, .partner copies, parity blobs AND the per-level manifests.
    assert _all_keys(cluster, fmt.version_prefix("g", 1)) == set()
    assert cluster.fetch_parity("g", 1, 0) is None
    assert all(m["version"] != 1 for m in cluster.manifests("g"))
    # newest version fully intact and restorable
    v2_keys = _all_keys(cluster, fmt.version_prefix("g", 3))
    assert any("parity" in k for k in v2_keys)
    assert any(".partner" in k for k in v2_keys)
    from repro_torch.core import restart as rst
    regs = rst.load_rank_regions(cluster, "g", 3, 5)
    assert (regs["w"] == 5).all()


# ---------------------------------------------------------------------------
# restart diagnostics (regression: failures were silently swallowed)
# ---------------------------------------------------------------------------


def test_restart_latest_records_skip_diagnostics(tmp_path):
    cfg = VelocConfig(name="d", scratch=str(tmp_path), mode="sync",
                      partner=False, xor_group=0, flush=False,
                      keep_versions=10)
    client = VelocClient(cfg)
    client.checkpoint({"w": np.arange(16.0)}, version=1,
                      device_snapshot=False)
    client.checkpoint({"w": np.arange(16.0) + 1}, version=2,
                      device_snapshot=False)
    # v2's only copy vanishes (flush disabled -> node-local only)
    for tier in client.cluster.node_tiers(0):
        tier.delete(fmt.shard_key("d", 2, 0))
    v, state = client.restart_latest({"w": np.zeros(16, np.float32)})
    assert v == 1 and np.allclose(state["w"], np.arange(16.0))
    assert len(client.restart_diagnostics) == 1
    d = client.restart_diagnostics[0]
    assert d["version"] == 2 and "unrecoverable" in d["error"]
    # a later clean restart resets the diagnostics
    client.checkpoint({"w": np.arange(16.0) + 2}, version=3,
                      device_snapshot=False)
    v, _ = client.restart_latest({"w": np.zeros(16, np.float32)})
    assert v == 3 and client.restart_diagnostics == []
