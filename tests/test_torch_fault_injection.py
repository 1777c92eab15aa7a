"""Failure-scenario coverage for the multi-level recovery paths: injected
tier faults (FlakyTier / CorruptingTier) against the pipeline's graceful
degradation and restart's L1 -> partner -> parity -> L3 fallback, including
delta-chain loss.

The JAX package's ``tests/test_fault_injection.py`` run against
``repro_torch``, its imports swapped, on the plain CPU versions of the
kernels."""
import time

import numpy as np
import pytest

from torch_helpers import CorruptingTier, FlakyTier, StallingTier, \
    wrap_external_tiers, wrap_node_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
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


def _cluster(tmp_path, nranks, **kw):
    cfg = VelocConfig(scratch=str(tmp_path), mode="sync", **kw)
    cluster = Cluster(cfg, nranks=nranks)
    clients = [VelocClient(cfg, cluster, rank=r) for r in range(nranks)]
    return cfg, cluster, clients


def _states(nranks, n=2000):
    return [{"w": np.full((n,), r, np.float32), "step": np.asarray(7 + r)}
            for r in range(nranks)]


# ---------------------------------------------------------------------------
# write-path degradation
# ---------------------------------------------------------------------------


def test_l1_write_failure_degrades_gracefully(tmp_path):
    """Every L1 put fails: the pipeline records the error, partner and L3
    still complete, and restart recovers from them."""
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=True)
    flaky = wrap_node_tiers(cluster, 0,
                            lambda t: FlakyTier(t, fail_puts=True))
    states = _states(2)
    futs = [c.checkpoint(states[r], version=1, device_snapshot=False)
            for r, c in enumerate(clients)]
    # rank 0's L1 *and* rank 1's partner copy (stored on node 0) fail
    assert "l1-local" in futs[0].module_errors
    assert "l1_error" in futs[0].results
    assert "l2-partner" in futs[1].module_errors
    # L3 completed for both; everything restores
    assert futs[0].results["l3-flush.status"] == "ok"
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 1, r)
        assert (regs["w"] == r).all()
    assert any(f.failed_puts for f in flaky)


def test_l3_write_failure_keeps_l1_l2(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=True)
    wrap_external_tiers(cluster, lambda t: FlakyTier(t, fail_puts=True,
                                                     match="shard_"))
    states = _states(2)
    futs = [c.checkpoint(states[r], version=1, device_snapshot=False)
            for r, c in enumerate(clients)]
    for f in futs:
        assert "l3-flush" in f.module_errors
        assert f.results["l1-local.status"] == "ok"
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 1, r)
        assert (regs["w"] == r).all()


# ---------------------------------------------------------------------------
# read-path fallback: L1 -> partner -> parity -> L3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["l1_lost", "l1_flaky_get",
                                      "l1_corrupt"])
def test_restart_falls_back_from_l1(tmp_path, scenario):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=True)
    states = _states(2)
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=1, device_snapshot=False)
    if scenario == "l1_lost":
        cluster.fail_node(0)
    elif scenario == "l1_flaky_get":
        wrap_node_tiers(cluster, 0, lambda t: FlakyTier(t, fail_gets=True))
    else:
        wrap_node_tiers(cluster, 0,
                        lambda t: CorruptingTier(t, match="shard_00000"))
    regs = rst.load_rank_regions(cluster, cfg.name, 1, 0)
    assert (regs["w"] == 0).all()


def test_restart_parity_after_partner_and_l1_loss(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 4, partner=False, xor_group=4,
                                     flush=False)
    states = _states(4)
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=1, device_snapshot=False)
    cluster.fail_node(1)  # shard only reconstructable from XOR parity
    regs = rst.load_rank_regions(cluster, cfg.name, 1, 1)
    assert (regs["w"] == 1).all()


def test_restart_l3_as_last_resort(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=True)
    states = _states(2)
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=1, device_snapshot=False)
    cluster.fail_node(0)
    cluster.fail_node(1)  # L1 and partner both gone; only the PFS remains
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 1, r)
        assert (regs["w"] == r).all()


def test_corrupted_l1_is_rejected_by_digest(tmp_path):
    """Manifest digests catch a silently-corrupting L1 read."""
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=False)
    states = _states(2)
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=1, device_snapshot=False)
    tiers = wrap_node_tiers(cluster, 0,
                            lambda t: CorruptingTier(t, match="shard_00000"))
    regs = rst.load_rank_regions(cluster, cfg.name, 1, 0)
    assert (regs["w"] == 0).all()
    assert any(t.corrupted_gets for t in tiers)  # fallback actually exercised


# ---------------------------------------------------------------------------
# delta chains under failure
# ---------------------------------------------------------------------------


def _delta_chain(tmp_path, nranks=1, versions=4, **kw):
    kw.setdefault("partner", nranks >= 2)
    kw.setdefault("xor_group", 0)
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, flush=True,
                                     keep_versions=10, **kw)
    rng = np.random.default_rng(13)
    states = {}
    w = [rng.standard_normal(100_000).astype(np.float32) + r
         for r in range(nranks)]
    for v in range(1, versions + 1):
        for r, c in enumerate(clients):
            wv = w[r].copy()
            lo = (v * 997) % (wv.size - 1000)
            wv[lo:lo + 1000] += 1.0
            w[r] = wv
            states[(v, r)] = wv.copy()
            c.checkpoint({"w": wv}, version=v, device_snapshot=False)
    return cfg, cluster, clients, states


@pytest.mark.parametrize("wipe", ["dram", "ssd", "pfs", "partner_node"])
def test_delta_chain_survives_single_tier_loss(tmp_path, wipe):
    nranks = 2
    cfg, cluster, clients, states = _delta_chain(tmp_path, nranks=nranks)
    if wipe == "dram":
        for r in range(nranks):
            cluster.node_tiers(r)[0].wipe()
    elif wipe == "ssd":
        for r in range(nranks):
            cluster.node_tiers(r)[1].wipe()
    elif wipe == "pfs":
        cluster.external_tiers[0].wipe()
    else:
        cluster.fail_node(1)  # rank 0's partner copies die with node 1
    for r in range(nranks):
        regs = rst.load_rank_regions(cluster, cfg.name, 4, r)
        assert regs["w"].tobytes() == states[(4, r)].tobytes(), (wipe, r)


def test_mid_chain_loss_forces_fallback(tmp_path):
    """v3 (a mid-chain delta) wiped from every tier: v4 is unrecoverable,
    restart_latest falls back to v2 and reports diagnostics."""
    cfg, cluster, clients, states = _delta_chain(tmp_path)
    prefix = fmt.version_prefix(cfg.name, 3)
    for tiers in [cluster.node_tiers(0), cluster.external_tiers]:
        for t in tiers:
            for k in t.keys(prefix):
                t.delete(k)
    with pytest.raises(IOError):
        rst.load_rank_regions(cluster, cfg.name, 4, 0)
    template = {"w": np.zeros(100_000, np.float32)}
    v, state = clients[0].restart_latest(template)
    assert v == 2
    assert np.asarray(state["w"]).tobytes() == states[(2, 0)].tobytes()
    assert any(d["version"] in (3, 4) for d in clients[0].restart_diagnostics)


def test_corrupted_delta_link_falls_back(tmp_path):
    """A corrupt delta shard mid-chain fails its digest, forcing the shard
    fetch to a healthy replica; with every replica corrupt the version is
    skipped for an older one."""
    cfg, cluster, clients, states = _delta_chain(tmp_path)
    # corrupt v3's shard in EVERY tier that holds it
    key3 = fmt.shard_key(cfg.name, 3, 0)
    for tiers in [cluster.node_tiers(0), cluster.external_tiers]:
        for t in tiers:
            blob = t.get(key3)
            if blob is not None:
                bad = bytearray(blob)
                bad[-1] ^= 0xFF
                t.put(key3, bytes(bad))
    template = {"w": np.zeros(100_000, np.float32)}
    v, state = clients[0].restart_latest(template)
    assert v == 2
    assert np.asarray(state["w"]).tobytes() == states[(2, 0)].tobytes()


def test_total_write_failure_does_not_poison_chain(tmp_path):
    """Regression: a version whose EVERY tier write failed must not anchor
    the next delta — the module detects the orphaned parent and emits a
    standalone full shard."""
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True,
                                     keep_versions=10)
    c = clients[0]
    rng = np.random.default_rng(15)
    w = rng.standard_normal(100_000).astype(np.float32)
    c.checkpoint({"w": w}, version=1, device_snapshot=False)
    # v2: every put (node-local AND external) fails
    orig_node = list(cluster._node_tiers[0])
    orig_ext = list(cluster.external_tiers)
    wrap_node_tiers(cluster, 0, lambda t: FlakyTier(t, fail_puts=True))
    wrap_external_tiers(cluster, lambda t: FlakyTier(t, fail_puts=True))
    w2 = w.copy()
    w2[:1000] += 1.0
    f2 = c.checkpoint({"w": w2}, version=2, device_snapshot=False)
    assert "l1-local" in f2.module_errors and "l3-flush" in f2.module_errors
    # every level failed: the future must NOT read as success
    exc = f2.exception(timeout=10)
    assert exc is not None and "nothing persisted" in str(exc)
    # tiers heal; v3 must NOT chain onto the never-persisted v2
    cluster._node_tiers[0] = orig_node
    cluster.external_tiers = orig_ext
    w3 = w2.copy()
    w3[2000:3000] += 1.0
    f3 = c.checkpoint({"w": w3}, version=3, device_snapshot=False)
    assert f3.results["delta_kind"] == "full"
    regs = rst.load_rank_regions(cluster, cfg.name, 3, 0)
    assert regs["w"].tobytes() == w3.tobytes()
    # and v4 chains off v3 normally again
    w4 = w3.copy()
    w4[5000:6000] += 1.0
    f4 = c.checkpoint({"w": w4}, version=4, device_snapshot=False)
    assert f4.results["delta_kind"] == "delta"
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == w4.tobytes()


@pytest.mark.parametrize("wipe", ["dram", "ssd", "pfs"])
def test_aggregated_delta_chain_survives_single_tier_loss(tmp_path, wipe):
    """The tier-loss matrix through the aggregated (segment) flush path:
    losing any single tier — including the external tier holding every
    segment — leaves the chain restorable from the survivors."""
    nranks = 2
    cfg, cluster, clients, states = _delta_chain(tmp_path, nranks=nranks,
                                                 aggregate=True)
    if wipe == "dram":
        for r in range(nranks):
            cluster.node_tiers(r)[0].wipe()
    elif wipe == "ssd":
        for r in range(nranks):
            cluster.node_tiers(r)[1].wipe()
    else:
        cluster.external_tiers[0].wipe()
    for r in range(nranks):
        regs = rst.load_rank_regions(cluster, cfg.name, 4, r)
        assert regs["w"].tobytes() == states[(4, r)].tobytes(), (wipe, r)


def test_aggregated_flush_flaky_put_falls_back(tmp_path):
    """Seal puts fail for v3 and v4 (FlakyTier): the aggregated versions
    never become externally visible; after total node loss restart falls
    back to the last sealed version."""
    from repro_torch.core.api import VelocClient as _VC

    cfg, cluster, clients, states = _delta_chain(tmp_path, nranks=2,
                                                 versions=2, aggregate=True)
    wrap_external_tiers(cluster, lambda t: FlakyTier(t, fail_puts=True,
                                                     match="segment"))
    rng = np.random.default_rng(99)
    for v in (3, 4):
        for r, c in enumerate(clients):
            w = states[(v - 1, r)].copy()
            w[:1000] += rng.standard_normal(1000).astype(np.float32)
            states[(v, r)] = w
            c.checkpoint({"w": w}, version=v, device_snapshot=False)
    fresh = Cluster(cfg, nranks=2)
    for r in range(2):
        client = _VC(cfg, fresh, rank=r)
        v, state = client.restart_latest(
            {"w": np.zeros(100_000, np.float32)})
        assert v == 2, (r, v)
        assert np.asarray(state["w"]).tobytes() == states[(2, r)].tobytes()


def test_flaky_journal_kv_restart(tmp_path):
    """KVTier journal: a corrupted entry is detected by its digest and
    skipped on reload instead of poisoning restart."""
    import os

    from repro_torch.core.storage import KVTier

    jdir = str(tmp_path / "journal")
    kv = KVTier(journal=jdir)
    kv.put("a/b", b"payload-one")
    kv.put("c/d", b"payload-two")
    # corrupt one journal entry's payload on disk
    files = sorted(os.listdir(jdir))
    victim = os.path.join(jdir, files[0])
    blob = bytearray(open(victim, "rb").read())
    blob[-2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    kv2 = KVTier(journal=jdir)
    assert len(kv2.journal_skipped) == 1
    surviving = [k for k in ("a/b", "c/d") if k not in kv2.journal_skipped]
    assert all(kv2.get(k) is not None for k in surviving)
    assert kv2.get(kv2.journal_skipped[0]) is None


# ---------------------------------------------------------------------------
# cross-tenant fault isolation
# ---------------------------------------------------------------------------


def test_wedged_tenant_does_not_starve_neighbor(tmp_path):
    """Two streams share one Cluster + ActiveBackend; stream A's external
    puts wedge (hung object store).  A's lane backs up and trips
    admission, while B — on its own lane and worker — keeps completing
    checkpoints promptly the whole time."""
    def tenant_cfg(name, **kw):
        return VelocConfig(name=name, scratch=str(tmp_path), mode="async",
                           backend_workers=2, partner=False, xor_group=0,
                           keep_versions=0, flush=True, **kw)

    cfg_a = tenant_cfg("wedged", admit_max_queued=1)
    cfg_b = tenant_cfg("healthy")
    cluster = Cluster(cfg_a, nranks=1)
    stallers = wrap_external_tiers(
        cluster, lambda t: StallingTier(t, match="wedged/", timeout_s=60.0))
    a = VelocClient(cfg_a, cluster)
    b = VelocClient(cfg_b, cluster, backend=a.backend)
    state = {"w": np.arange(4096, dtype=np.float32)}

    fut_a1 = a.checkpoint(state, version=1, device_snapshot=False)
    deadline = time.monotonic() + 10
    while not any(s.stalled for s in stallers):  # A v1 wedged in its put
        assert time.monotonic() < deadline
        time.sleep(0.01)
    # A's lane is at its high-water mark (1 running) -> a second submit
    # is admission-skipped, not queued behind the wedge
    fut_a2 = a.checkpoint(state, version=2, device_snapshot=False)
    assert fut_a2.skipped
    assert fut_a2.results["skip_reason"] == "admission"

    # B completes a run of checkpoints promptly while A stays wedged
    t0 = time.monotonic()
    for v in range(1, 4):
        fut = b.checkpoint({"w": np.full(4096, float(v), np.float32)},
                           version=v, device_snapshot=False)
        assert fut.result(timeout=15)
    b_elapsed = time.monotonic() - t0
    assert b_elapsed < 10.0, f"healthy tenant starved: {b_elapsed:.1f}s"
    assert any(s.stalled for s in stallers)  # A was wedged the whole run

    lanes = a.backend.status()["lanes"]
    assert lanes["wedged"]["rejected"] >= 1
    assert lanes["healthy"]["rejected"] == 0
    assert lanes["healthy"]["dispatched"] >= 3

    for s in stallers:
        s.release()
    assert fut_a1.result(timeout=30)
    b.shutdown()   # non-owner: drains its own kinds, backend stays up
    a.shutdown()
    regs = rst.load_rank_regions(cluster, "healthy", 3, 0)
    assert regs["w"][0] == 3.0
