"""Incremental (differential) checkpointing in the PyTorch port: the JAX
package's behaviour tests (tests/test_delta.py) with their imports swapped —
diff/patch units, pipeline module behaviour, chain restart, GC refcounting,
compaction, and the write-amplification acceptance bound."""
import numpy as np
import pytest

from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import concurrency as tconc
from repro_torch.core import delta as dlt
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.modules import DeltaModule
from repro_torch.kernels import ops

CHUNK = 4096


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
# units
# ---------------------------------------------------------------------------


def test_dirty_detection_single_chunk():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(50_000).astype(np.float32)
    fp0 = dlt.fingerprints(a, CHUNK)
    b = a.copy()
    b[10_000] += 1.0
    fp1 = dlt.fingerprints(b, CHUNK)
    dirty = dlt.dirty_chunks(fp1, fp0)
    assert list(dirty) == [10_000 * 4 // CHUNK]


def test_patch_roundtrip_and_sizes():
    rng = np.random.default_rng(1)
    base = rng.standard_normal(100_000).astype(np.float32)
    new = base.copy()
    new[:10] += 1.0
    new[-3:] -= 2.0
    p0, fp0 = dlt.make_patch(base, None, chunk_bytes=CHUNK)
    p1, _ = dlt.make_patch(new, fp0, chunk_bytes=CHUNK, base_version=1)
    assert len(p1.indices) == 2  # first and last chunk
    assert len(p1.data) < new.nbytes // 10
    out = dlt.overlay(base, dlt.decode_patch(dlt.encode_patch(p1)))
    assert out.tobytes() == new.tobytes()


def test_overlay_detects_corruption_and_bad_base():
    rng = np.random.default_rng(2)
    base = rng.standard_normal(20_000).astype(np.float32)
    new = base.copy()
    new[5_000] = 9.0
    _, fp0 = dlt.make_patch(base, None, chunk_bytes=CHUNK)
    p, _ = dlt.make_patch(new, fp0, chunk_bytes=CHUNK, base_version=1)
    blob = bytearray(dlt.encode_patch(p))
    blob[-1] ^= 0xFF
    with pytest.raises(IOError):
        dlt.overlay(base, dlt.decode_patch(bytes(blob)))
    # wrong base (content differs but shape matches) -> full digest catches it
    with pytest.raises(IOError):
        dlt.overlay(base + 1.0, p)
    # wrong shape
    with pytest.raises(IOError):
        dlt.overlay(base[:100], p)


def test_empty_and_clean_regions():
    empty = np.zeros((0,), np.float32)
    p, fp = dlt.make_patch(empty, None, chunk_bytes=CHUNK)
    assert p.n_chunks == 0 and fp.shape == (0, 2)
    a = np.ones(1000, np.float32)
    p0, fp0 = dlt.make_patch(a, None, chunk_bytes=CHUNK)
    p1, _ = dlt.make_patch(a, fp0, chunk_bytes=CHUNK, base_version=1)
    assert len(p1.indices) == 0 and p1.data == b""
    assert dlt.overlay(a, p1).tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# pipeline module
# ---------------------------------------------------------------------------


def _delta_cluster(tmp_path, nranks=1, **kw):
    kw.setdefault("partner", nranks >= 2)
    kw.setdefault("xor_group", 0)
    kw.setdefault("flush", True)
    cfg = VelocConfig(scratch=str(tmp_path), mode="sync", delta=True,
                      delta_chunk_bytes=CHUNK, **kw)
    cluster = Cluster(cfg, nranks=nranks)
    clients = [VelocClient(cfg, cluster, rank=r) for r in range(nranks)]
    return cfg, cluster, clients


def _step(w, v, frac=0.01):
    """Dirty ~frac of w in a contiguous slice (step v)."""
    w = w.copy()
    n = max(1, int(w.size * frac))
    lo = (v * 131) % (w.size - n)
    w[lo:lo + n] += 1.0
    return w


def test_module_emits_full_then_delta(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path)
    rng = np.random.default_rng(3)
    w = rng.standard_normal(100_000).astype(np.float32)
    f1 = c.checkpoint({"w": w}, version=1, device_snapshot=False)
    assert f1.results["delta_kind"] == "full"
    full_bytes = f1.results["shard_bytes"]
    w2 = _step(w, 2)
    f2 = c.checkpoint({"w": w2}, version=2, device_snapshot=False)
    assert f2.results["delta_kind"] == "delta"
    assert f2.results["shard_bytes"] < full_bytes / 5
    regs = rst.load_rank_regions(cluster, cfg.name, 2, 0)
    assert regs["w"].tobytes() == w2.tobytes()


def test_module_full_after_max_chain(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path, delta_max_chain=2,
                                        keep_versions=10)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(50_000).astype(np.float32)
    kinds = []
    for v in range(1, 7):
        w = _step(w, v)
        f = c.checkpoint({"w": w}, version=v, device_snapshot=False)
        kinds.append(f.results["delta_kind"])
    assert kinds == ["full", "delta", "delta", "full", "delta", "delta"]


def test_module_full_when_mostly_dirty(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path)
    rng = np.random.default_rng(5)
    w = rng.standard_normal(50_000).astype(np.float32)
    c.checkpoint({"w": w}, version=1, device_snapshot=False)
    f = c.checkpoint({"w": w + 1.0}, version=2, device_snapshot=False)
    assert f.results["delta_kind"] == "full"  # 100% dirty: delta won't pay


def test_module_handles_new_and_reshaped_regions(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path)
    rng = np.random.default_rng(6)
    w = rng.standard_normal(50_000).astype(np.float32)
    c.checkpoint({"w": w}, version=1, device_snapshot=False)
    w2 = _step(w, 2)
    b = np.arange(10, dtype=np.int32)  # region appears mid-stream
    c.checkpoint({"w": w2, "b": b}, version=2, device_snapshot=False)
    regs = rst.load_rank_regions(cluster, cfg.name, 2, 0)
    assert regs["w"].tobytes() == w2.tobytes()
    assert (regs["b"] == b).all()


def test_delta_rejects_lossy_encoding(tmp_path):
    """q8 bases decode lossily, so overlays could never verify — refused
    up front instead of failing every restore."""
    with pytest.raises(ValueError, match="lossless"):
        VelocConfig(scratch=str(tmp_path), delta=True,
                    encoding="q8").to_pipeline_spec()
    # zlib is lossless: fine
    VelocConfig(scratch=str(tmp_path), delta=True,
                encoding="zlib").to_pipeline_spec()


def test_delta_with_zlib_serialize(tmp_path):
    """Delta regions coexist with zlib-encoded full regions in one chain."""
    cfg, cluster, (c,) = _delta_cluster(tmp_path, encoding="zlib",
                                        keep_versions=10)
    rng = np.random.default_rng(12)
    w = rng.standard_normal(100_000).astype(np.float32)
    c.checkpoint({"w": w}, version=1, device_snapshot=False)
    w = _step(w, 2)
    c.checkpoint({"w": w}, version=2, device_snapshot=False)
    regs = rst.load_rank_regions(cluster, cfg.name, 2, 0)
    assert regs["w"].tobytes() == w.tobytes()


def test_stale_version_emits_full():
    m = DeltaModule(chunk_bytes=CHUNK)
    t = m.tracker("x", 0)
    t.note_full(5, {})
    # version going backwards (e.g. duplicate submit) must not corrupt the
    # chain: module falls back to a standalone full shard
    import types
    ctx = types.SimpleNamespace(
        regions=[fmt.Region("w", np.ones(10, np.float32))],
        name="x", rank=0, version=4, meta={}, results={})
    assert m.process(ctx) == "ok"
    assert ctx.results["delta_kind"] == "full"


# ---------------------------------------------------------------------------
# acceptance: chain restore under tier loss + write amplification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wipe", ["none", "dram", "ssd", "pfs"])
def test_chain_restore_byte_identical_any_tier_wiped(tmp_path, wipe):
    """Base + 3 deltas; any single tier wiped; restore == full state."""
    cfg, cluster, (c,) = _delta_cluster(tmp_path, keep_versions=10)
    rng = np.random.default_rng(7)
    w = rng.standard_normal(200_000).astype(np.float32)
    states = {}
    for v in range(1, 5):
        w = _step(w, v)
        states[v] = w.copy()
        c.checkpoint({"w": w, "step": np.asarray(v)}, version=v,
                     device_snapshot=False)
    if wipe == "dram":
        cluster.node_tiers(0)[0].wipe()
    elif wipe == "ssd":
        cluster.node_tiers(0)[1].wipe()
    elif wipe == "pfs":
        cluster.external_tiers[0].wipe()
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == states[4].tobytes()
    assert regs["step"].item() == 4
    assert rst.chain_versions(cluster, cfg.name, 4) == [4, 3, 2, 1]


def test_write_amplification_at_least_5x(tmp_path):
    """>=5x fewer bytes written per checkpoint on a 1%-dirty workload."""
    cfg, cluster, (c,) = _delta_cluster(tmp_path, keep_versions=20)
    rng = np.random.default_rng(8)
    w = rng.standard_normal(500_000).astype(np.float32)  # ~2 MB
    f = c.checkpoint({"w": w}, version=1, device_snapshot=False)
    full = f.results["shard_bytes"]
    delta_bytes = []
    for v in range(2, 8):
        w = _step(w, v, frac=0.01)
        f = c.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert f.results["delta_kind"] == "delta"
        delta_bytes.append(f.results["shard_bytes"])
    assert max(delta_bytes) * 5 < full, (delta_bytes, full)


# ---------------------------------------------------------------------------
# GC refcounting + compaction
# ---------------------------------------------------------------------------


def test_gc_never_drops_referenced_base(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path, keep_versions=20)
    rng = np.random.default_rng(9)
    w = rng.standard_normal(100_000).astype(np.float32)
    for v in range(1, 5):
        w = _step(w, v)
        c.checkpoint({"w": w}, version=v, device_snapshot=False)
    cluster.gc(cfg.name, 1)  # keep only v4 ... plus its chain
    vers = sorted({v for (n, v, _l) in cluster._registry if n == cfg.name})
    assert vers == [1, 2, 3, 4]
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == w.tobytes()


def test_compact_folds_chain_and_frees_ancestors(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path, keep_versions=20)
    rng = np.random.default_rng(10)
    w = rng.standard_normal(100_000).astype(np.float32)
    for v in range(1, 5):
        w = _step(w, v)
        c.checkpoint({"w": w}, version=v, device_snapshot=False)
    assert c.compact() == 4
    # compacted shard restores without touching the chain
    cluster.gc(cfg.name, 1)
    vers = sorted({v for (n, v, _l) in cluster._registry if n == cfg.name})
    assert vers == [4]
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == w.tobytes()
    assert rst.chain_versions(cluster, cfg.name, 4) == [4]
    # next delta chains off the compacted base
    w = _step(w, 5)
    f = c.checkpoint({"w": w}, version=5, device_snapshot=False)
    assert f.results["delta_kind"] == "delta"
    regs = rst.load_rank_regions(cluster, cfg.name, 5, 0)
    assert regs["w"].tobytes() == w.tobytes()


def test_multirank_compact_keeps_chain_until_all_ranks_fold(tmp_path):
    """Regression: one rank's compact() must not clear the version-wide
    parent link — the other rank's shard is still a delta, and GC dropping
    the chain would strand it permanently."""
    cfg, cluster, clients = _delta_cluster(tmp_path, nranks=2,
                                           keep_versions=20)
    rng = np.random.default_rng(14)
    w = [rng.standard_normal(100_000).astype(np.float32) + r
         for r in range(2)]
    for v in range(1, 5):
        for r, c in enumerate(clients):
            w[r] = _step(w[r], v)
            c.checkpoint({"w": w[r]}, version=v, device_snapshot=False)
    clients[0].compact(4)
    cluster.gc(cfg.name, 1)  # rank 1's chain must survive
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 4, r)
        assert regs["w"].tobytes() == w[r].tobytes(), r
    clients[1].compact(4)
    cluster.gc(cfg.name, 1)  # now the ancestors can go
    vers = sorted({v for (n, v, _l) in cluster._registry if n == cfg.name})
    assert vers == [4]
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 4, r)
        assert regs["w"].tobytes() == w[r].tobytes(), r


def test_compact_from_fresh_process(tmp_path):
    """Regression: compact() after a restart (empty in-memory registry)
    must republish the on-disk manifests with the new digest — previously
    it rewrote the shard bytes but left the stale manifest digest, so every
    copy read as corrupt and the newest version was silently lost."""
    cfg, cluster, (c,) = _delta_cluster(tmp_path, keep_versions=20)
    rng = np.random.default_rng(16)
    w = rng.standard_normal(100_000).astype(np.float32)
    for v in range(1, 5):
        w = _step(w, v)
        c.checkpoint({"w": w}, version=v, device_snapshot=False)
    # "new process": fresh Cluster + client over the same scratch
    cluster2 = Cluster(cfg, nranks=1)
    c2 = VelocClient(cfg, cluster2)
    template = {"w": np.zeros(100_000, np.float32)}
    v0, state0 = c2.restart_latest(template)
    assert v0 == 4
    assert c2.compact() == 4
    v1, state1 = c2.restart_latest(template)
    assert v1 == 4, c2.restart_diagnostics
    assert np.asarray(state1["w"]).tobytes() == w.tobytes()
    assert rst.chain_versions(cluster2, cfg.name, 4) == [4]


def test_compact_honors_serialize_encoding(tmp_path):
    cfg, cluster, (c,) = _delta_cluster(tmp_path, encoding="zlib",
                                        keep_versions=20)
    w = np.zeros(100_000, np.float32)  # compresses well
    c.checkpoint({"w": w}, version=1, device_snapshot=False)
    w = _step(w, 2)
    c.checkpoint({"w": w}, version=2, device_snapshot=False)
    c.compact(2)
    blob = rst.fetch_shard_any_level(cluster, cfg.name, 2, 0)
    reader = fmt.ShardReader(blob)
    assert reader.entry("w")["encoding"] == "zlib"
    assert rst.load_rank_regions(cluster, cfg.name, 2, 0)["w"].tobytes() \
        == w.tobytes()


def test_q8_delta_rejected_in_v2_spec_too(tmp_path):
    from repro_torch.core import ModuleSpec, PipelineSpec

    spec = PipelineSpec(mode="sync", modules=[
        ModuleSpec("delta"), ModuleSpec("serialize", {"encoding": "q8"}),
        ModuleSpec("local")])
    with pytest.raises(ValueError, match="lossless"):
        spec.compile()


def test_async_delta_pipeline(tmp_path):
    """Delta module past the blocking cut: async checkpoints drain in the
    backend and restore byte-identical."""
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", delta=True,
                      delta_chunk_bytes=CHUNK, partner=False, xor_group=0,
                      keep_versions=10)
    cluster = Cluster(cfg, nranks=1)
    c = VelocClient(cfg, cluster)
    rng = np.random.default_rng(11)
    w = rng.standard_normal(100_000).astype(np.float32)
    futs = []
    for v in range(1, 4):
        w = _step(w, v)
        futs.append(c.checkpoint({"w": w}, version=v, device_snapshot=False))
    assert c.wait(timeout=60)
    # versions may have been superseded under race; the newest must be live
    assert futs[-1].result(timeout=60)["delta_kind"] in ("full", "delta")
    regs = rst.load_rank_regions(cluster, cfg.name, 3, 0)
    assert regs["w"].tobytes() == w.tobytes()
    c.shutdown()
