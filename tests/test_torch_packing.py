"""Maintenance lane v2: cross-version segment packing, maintenance-lane GC
and the bounded seal retry.

Covers: the rolling-pack container format, put-count reduction and restart
round-trips resolved through packed segments (fresh process, mid-chain),
open-pack visibility semantics (L1/L2-only until the pack seals; sealed at
shutdown), GC re-packing survivors out of shared packs, compaction through
packs, GC running as a coalesced maintenance task off the application
thread, seal-retry upgrades to full L3 protection, and the resolved
checkpoint history / restart-miss diagnostics satellites.

The JAX package's ``tests/test_packing.py`` run against ``repro_torch``, its
imports swapped, on the plain CPU versions of the kernels."""
import threading

import numpy as np
import pytest

from torch_helpers import FlakyTier, WrappedTier, wrap_external_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.backend import ActiveBackend
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
    kw.setdefault("aggregate", True)
    kw.setdefault("keep_versions", 50)
    kw.setdefault("mode", "sync")
    cfg = VelocConfig(scratch=str(tmp_path), **kw)
    cluster = Cluster(cfg, nranks=nranks)
    clients = [VelocClient(cfg, cluster, rank=r) for r in range(nranks)]
    return cfg, cluster, clients


def _run_versions(clients, versions, n=50_000, seed=0, start=1):
    """~1%-dirty delta workload; returns {(version, rank): array}."""
    rng = np.random.default_rng(seed)
    w = [rng.standard_normal(n).astype(np.float32) + r
         for r in range(len(clients))]
    states = {}
    for v in range(start, start + versions):
        for r, c in enumerate(clients):
            wv = w[r].copy()
            lo = (v * 997 + r * 131) % (n - 500)
            wv[lo:lo + 500] += 1.0
            w[r] = wv
            states[(v, r)] = wv
            fut = c.checkpoint({"w": wv}, version=v, device_snapshot=False)
            assert not fut.module_errors, (v, r, fut.module_errors)
    return states


# ---------------------------------------------------------------------------
# rolling-pack container format
# ---------------------------------------------------------------------------


def test_pack_roundtrip_and_packing_record():
    entries = {
        "a/v00000002/shard_00000": b"two" * 50,
        "a/v00000002/manifest.L3": b"{2}",
        "a/v00000003/shard_00000": b"three" * 50,
        "a/v00000003/manifest.L3": b"{3}",
    }
    blob = fmt.encode_pack("a", entries, [3, 2], meta={"nranks": 1})
    r = fmt.PackReader(blob)
    assert r.versions == [2, 3]  # packing record, sorted
    assert r.meta["kind"] == fmt.PACK_META_KIND
    assert r.meta["nranks"] == 1
    assert sorted(r.entries_for("a", 2)) == ["a/v00000002/manifest.L3",
                                             "a/v00000002/shard_00000"]
    for k, v in entries.items():
        assert r.read(k) == v
    # pack keys live OUTSIDE every member's version prefix (prefix GC must
    # never delete a shared pack)
    assert not fmt.pack_key("a", 2).startswith(fmt.version_prefix("a", 2))
    assert fmt.pack_key("a", 2).startswith(fmt.pack_prefix("a"))
    # strict segment parsing carries over
    with pytest.raises(IOError):
        fmt.PackReader(blob[:-5])


def test_pack_versions_requires_aggregate():
    with pytest.raises(ValueError, match="aggregate"):
        VelocConfig(pack_versions=4).to_tier_topology()


# ---------------------------------------------------------------------------
# packed flush: fewer puts, restart through packs
# ---------------------------------------------------------------------------


def test_packed_flush_cuts_puts_per_version(tmp_path):
    nranks = 4
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=4)
    _run_versions(clients, 9)  # v1 full + 8 deltas
    puts = sum(t.put_calls for t in cluster.external_tiers)
    # v1 seals per-version (1 put); 8 deltas seal as two 4-version packs
    assert puts == 3, puts
    pfs = cluster.external_tiers[0]
    packs = [k for k in pfs.keys(fmt.pack_prefix(cfg.name))]
    assert len(packs) == 2, packs


def test_packed_restart_fresh_process_full_chain(tmp_path):
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    states = _run_versions(clients, 5)  # packs [2,3] and [4,5]
    fresh = Cluster(cfg, nranks=nranks)
    for r in range(nranks):
        client = VelocClient(cfg, fresh, rank=r)
        v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
        assert v == 5, (r, v, client.restart_diagnostics)
        assert np.asarray(state["w"]).tobytes() == states[(5, r)].tobytes()
    # mid-chain member of a shared pack resolves too
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()


def test_packed_parity_resolves_through_pack(tmp_path):
    """An erasure group whose parity has no node-local home (single group)
    stages parity into the version batch — it must stay reachable when the
    batch lands inside a rolling pack."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=2, flush=True, pack_versions=2)
    states = _run_versions(clients, 3)
    fresh = Cluster(cfg, nranks=nranks)
    assert fresh.fetch_parity(cfg.name, 3, 0) is not None
    # lose rank 0's shard everywhere except the parity: reconstruct
    pfs = fresh.external_tiers[0]
    skey = fmt.pack_key(cfg.name, 2)
    reader = fmt.PackReader(pfs.get(skey))
    victim = fmt.shard_key(cfg.name, 3, 0)
    entries = {n: reader.read(n) for n in reader.names() if n != victim}
    pfs.put(skey, fmt.encode_pack(cfg.name, entries, reader.versions,
                                  meta=reader.meta))
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()


def test_open_pack_invisible_until_sealed_then_flushed_at_shutdown(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=4)
    c = clients[0]
    states = _run_versions([c], 3)  # v1 sealed; v2, v3 wait in the open pack
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    v, _ = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    # deltas in the open pack are L1/L2-only: with the node-local DRAM gone
    # (fresh process) restart falls back to the last sealed version
    assert v == 1, (v, client.restart_diagnostics)
    # their miss was diagnosed, not silent
    assert any(d["version"] in (2, 3) for d in client.restart_diagnostics)
    c.shutdown()  # seals the open pack
    fresh2 = Cluster(cfg, nranks=1)
    client2 = VelocClient(cfg, fresh2, rank=0)
    v, state = client2.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 3, (v, client2.restart_diagnostics)
    assert np.asarray(state["w"]).tobytes() == states[(3, 0)].tobytes()


def test_full_version_flushes_open_pack_at_chain_boundary(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096, delta_max_chain=2,
                                     partner=False, xor_group=0, flush=True,
                                     pack_versions=8)
    c = clients[0]
    states = _run_versions([c], 4)  # max_chain=2: v1 full, v2-v3 delta,
    #                                 v4 full again -> boundary seals [2,3]
    pfs = cluster.external_tiers[0]
    packs = pfs.keys(fmt.pack_prefix(cfg.name))
    assert packs, "chain boundary should have sealed the open pack"
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 4
    assert np.asarray(state["w"]).tobytes() == states[(4, 0)].tobytes()
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()


def test_transient_pack_read_failure_is_reprobed(tmp_path):
    """Regression: a flaky get DURING the one-shot pack scan must not
    negative-cache the stream — the pack's members would read as absent
    for the whole process even after the tier recovers."""
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    states = _run_versions([clients[0]], 3)  # pack [2,3] sealed
    fresh = Cluster(cfg, nranks=1)
    wrap_external_tiers(
        fresh, lambda t: FlakyTier(t, fail_gets=True, match="/pack/",
                                   fail_first=1))
    assert fresh.fetch_shard(cfg.name, 3, 0) is None  # transient miss
    blob = fresh.fetch_shard(cfg.name, 3, 0)  # tier recovered: re-probed
    assert blob is not None
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()


def test_torn_pack_skipped_with_diagnostic(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    _run_versions([clients[0]], 3)  # pack [2,3] sealed
    fresh = Cluster(cfg, nranks=1)
    pfs = fresh.external_tiers[0]
    skey = fmt.pack_key(cfg.name, 2)
    blob = pfs.get(skey)
    pfs.put(skey, blob[:len(blob) - 30])
    client = VelocClient(cfg, fresh, rank=0)
    v, _ = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 1, (v, client.restart_diagnostics)
    assert any(d["key"] == skey for d in fresh.segment_diagnostics), \
        fresh.segment_diagnostics


# ---------------------------------------------------------------------------
# GC through packs: re-pack survivors, delete dead packs
# ---------------------------------------------------------------------------


def test_gc_repacks_survivors_and_deletes_dead_packs(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    c = clients[0]
    states = _run_versions([c], 5)  # v1 seg; packs [2,3] + [4,5]
    c.compact(5)  # folds v5 full: the chain below is GC-eligible
    cluster.gc(cfg.name, 1)
    pfs = cluster.external_tiers[0]
    assert pfs.get(fmt.pack_key(cfg.name, 2)) is None  # both members dead
    surv = fmt.PackReader(pfs.get(fmt.pack_key(cfg.name, 4)))
    assert surv.versions == [5]  # v4 re-packed away
    assert all(n.startswith(fmt.version_prefix(cfg.name, 5))
               for n in surv.names()), surv.names()
    assert pfs.get(fmt.segment_key(cfg.name, 1)) is None  # prefix delete
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 5
    assert np.asarray(state["w"]).tobytes() == states[(5, 0)].tobytes()


def test_compaction_rewrites_inside_sealed_pack(tmp_path):
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    states = _run_versions(clients, 3)  # pack [2,3] sealed
    for c in clients:
        c.compact(3)
    m3 = [m for m in cluster.manifests(cfg.name) if m["version"] == 3]
    assert m3 and all(m["parent"] is None for m in m3)
    # the pack now carries the FULL shard bytes: a fresh process restores
    # v3 without v1/v2 existing at all
    fresh = Cluster(cfg, nranks=nranks)
    pfs = fresh.external_tiers[0]
    for k in list(pfs.keys(fmt.version_prefix(cfg.name, 1))) \
            + list(pfs.keys(fmt.version_prefix(cfg.name, 2))):
        pfs.delete(k)
    skey = fmt.pack_key(cfg.name, 2)
    reader = fmt.PackReader(pfs.get(skey))
    v2pfx = fmt.version_prefix(cfg.name, 2)
    entries = {n: reader.read(n) for n in reader.names()
               if not n.startswith(v2pfx)}
    pfs.put(skey, fmt.encode_pack(cfg.name, entries, [3], meta=reader.meta))
    for r in range(nranks):
        client = VelocClient(cfg, fresh, rank=r)
        v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
        assert v == 3, (r, v, client.restart_diagnostics)
        assert np.asarray(state["w"]).tobytes() == states[(3, r)].tobytes()


def test_fresh_process_compact_of_packed_version(tmp_path):
    """Restart-then-compact through a rolling pack: the fresh process must
    hydrate the version's manifests from INSIDE the pack (regression: the
    hydration path used to hold the cluster lock while scanning packs,
    which self-deadlocks on the membership memoization)."""
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096,
                                     delta_max_chain=16, partner=False,
                                     xor_group=0, flush=True, pack_versions=2)
    states = _run_versions([clients[0]], 3)  # pack [2,3] sealed
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    done = []

    def compact():
        done.append(client.compact(3))

    t = threading.Thread(target=compact, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "compact() deadlocked in a fresh process"
    assert done == [3]
    m3 = [m for m in fresh.manifests(cfg.name) if m["version"] == 3]
    assert m3 and all(m["parent"] is None for m in m3)
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()


# ---------------------------------------------------------------------------
# maintenance-lane GC (thread identity + coalescing)
# ---------------------------------------------------------------------------


class RecordingTier(WrappedTier):
    """Records the thread name of every delete."""

    def __init__(self, inner, log):
        super().__init__(inner)
        self._log = log

    def delete(self, key):
        self._log.append(threading.current_thread().name)
        return self.inner.delete(key)


def test_gc_runs_in_maintenance_lane_not_app_thread(tmp_path):
    """Acceptance: checkpoint_end/_submit must not execute external-tier
    GC deletes on the application thread."""
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, keep_versions=1,
                      backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    deletes: list[str] = []
    wrap_external_tiers(cluster, lambda t: RecordingTier(t, deletes))
    c = VelocClient(cfg, cluster, rank=0)
    for v in range(1, 5):
        fut = c.checkpoint({"w": np.full(1000, v, np.float32)}, version=v,
                           device_snapshot=False)
        assert fut.wait(timeout=30)
    assert c.backend.wait(timeout=30)
    assert not c.backend.errors(), c.backend.errors()
    main = threading.main_thread().name
    assert deletes, "GC never deleted anything"
    assert all(t != main and t.startswith("veloc-backend") for t in deletes), \
        set(deletes)
    # GC still actually collected: only keep_versions+1 newest survive
    assert cluster.fetch_shard(cfg.name, 1, 0) is None
    assert cluster.fetch_shard(cfg.name, 4, 0) is not None
    c.shutdown()


def test_gc_inline_when_no_backend(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, partner=False, xor_group=0,
                                     flush=True, keep_versions=1)
    c = clients[0]
    for v in (1, 2, 3):
        c.checkpoint({"w": np.full(500, v, np.float32)}, version=v,
                     device_snapshot=False)
    assert cluster.fetch_shard(cfg.name, 1, 0) is None  # synchronous GC


def test_maintenance_coalesce_dedupes_queued_kind():
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    runs: list[int] = []
    b.submit("pipe", 1, lambda: gate.wait(5))  # keep the lane busy
    for v in (1, 2, 3):
        b.submit_maintenance("gc:x", v, (lambda v=v: runs.append(v)),
                             coalesce=True)
    assert b.status("gc:x", 1) == "superseded"
    assert b.status("gc:x", 2) == "superseded"
    assert b.status("gc:x", 3) == "queued"
    gate.set()
    assert b.wait(timeout=10)
    assert runs == [3]  # one sweep, the newest
    b.shutdown()


# ---------------------------------------------------------------------------
# bounded seal retry
# ---------------------------------------------------------------------------


def test_seal_retry_upgrades_version_to_l3(tmp_path):
    """Acceptance: a version whose seal put failed once is re-sealed from
    the retained batch by the maintenance lane and becomes fully
    L3-restorable in a FRESH process (node-local tiers gone)."""
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, keep_versions=10,
                      aggregate=True, seal_retries=2, backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment",
                                     fail_first=1))
    c = VelocClient(cfg, cluster, rank=0)
    fut = c.checkpoint({"w": np.full(2000, 7, np.float32)}, version=1,
                       device_snapshot=False)
    assert fut.wait(timeout=30)
    assert "l3-flush" in fut.module_errors
    assert fut.results.get("l3_seal_retry_scheduled") is True
    assert c.backend.wait(timeout=30)  # drains the maintenance re-seal
    assert cluster.seal_retry_pending(cfg.name) == []
    assert any(f.failed_puts for f in flaky)
    c.shutdown()
    fresh = Cluster(cfg, nranks=1)
    for r in range(1):
        for tier in fresh._node_tiers[r]:
            tier.wipe()  # only the external segment can serve the restore
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 1, (v, client.restart_diagnostics)
    assert (np.asarray(state["w"]) == 7).all()


def test_seal_retry_gives_up_after_budget(tmp_path):
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, keep_versions=10,
                      aggregate=True, seal_retries=2, backend_workers=1)
    cluster = Cluster(cfg, nranks=1)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment"))
    c = VelocClient(cfg, cluster, rank=0)
    fut = c.checkpoint({"w": np.full(500, 1, np.float32)}, version=1,
                       device_snapshot=False)
    assert fut.wait(timeout=30)
    assert c.backend.wait(timeout=30)
    # tier permanently down: 1 initial + 2 bounded retries, then retained
    # (visible for operators), never an unbounded loop
    assert cluster.seal_retry_pending(cfg.name) == [1]
    seal_puts = [k for f in flaky for k in f.failed_puts if "segment" in k]
    assert len(seal_puts) == 3, seal_puts
    c.shutdown()


def test_pack_seal_retry_covers_all_members(tmp_path):
    """A failed rolling-pack put retains the whole pack; the re-seal
    restores L3 protection for EVERY member version."""
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", delta=True,
                      delta_chunk_bytes=4096, delta_max_chain=16,
                      partner=False, xor_group=0, flush=True,
                      keep_versions=50, aggregate=True, pack_versions=2,
                      seal_retries=2, backend_workers=1)
    cluster = Cluster(cfg, nranks=1)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="/pack/",
                                     fail_first=1))
    c = VelocClient(cfg, cluster, rank=0)
    rng = np.random.default_rng(5)
    w = rng.standard_normal(50_000).astype(np.float32)
    states = {}
    for v in (1, 2, 3):  # v1 full; pack [2,3] seal fails once
        w = w.copy()
        w[v * 100:v * 100 + 500] += 1.0
        states[v] = w
        fut = c.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert fut.wait(timeout=30)
    assert c.backend.wait(timeout=30)
    assert cluster.seal_retry_pending(cfg.name) == []
    assert any(f.failed_puts for f in flaky)
    c.shutdown()
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 3, (v, client.restart_diagnostics)
    assert np.asarray(state["w"]).tobytes() == states[3].tobytes()


def test_chain_boundary_pack_seal_failure_is_retried(tmp_path):
    """Regression: when a FULL version's flush seals its own segment (ok)
    AND flushes the previous chain's open pack (fails), the retry must be
    scheduled for the retained PACK — whose member versions are not the
    version the failing flush was checkpointing."""
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", delta=True,
                      delta_chunk_bytes=4096, delta_max_chain=2,
                      partner=False, xor_group=0, flush=True,
                      keep_versions=50, aggregate=True, pack_versions=8,
                      seal_retries=2, backend_workers=1)
    cluster = Cluster(cfg, nranks=1)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="/pack/",
                                     fail_first=1))
    c = VelocClient(cfg, cluster, rank=0)
    rng = np.random.default_rng(8)
    w = rng.standard_normal(50_000).astype(np.float32)
    states = {}
    # max_chain=2: v1 full; v2, v3 deltas (open pack); v4 full again — the
    # chain-boundary flush of pack [2,3] fails once
    futs = {}
    for v in (1, 2, 3, 4):
        w = w.copy()
        w[v * 100:v * 100 + 500] += 1.0
        states[v] = w
        futs[v] = c.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert futs[v].wait(timeout=30)
    assert any(f.failed_puts for f in flaky)
    # v4's OWN segment sealed fine: the pack failure of older versions must
    # not be misattributed to it as an L3 error
    assert "l3_error" not in futs[4].results, futs[4].results
    assert "l3-flush" not in futs[4].module_errors
    assert c.backend.wait(timeout=30)
    assert cluster.seal_retry_pending(cfg.name) == [], \
        "chain-boundary pack was never re-sealed"
    c.shutdown()
    fresh = Cluster(cfg, nranks=1)
    # mid-pack members restore at L3 in a fresh process after the re-seal
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[3].tobytes()
    regs = rst.load_rank_regions(fresh, cfg.name, 4, 0)
    assert regs["w"].tobytes() == states[4].tobytes()


def test_stage_entry_after_failed_seal_joins_retained_batch(tmp_path):
    """Regression: a late parity/aux write racing a FAILED seal must land
    in the retained batch (so the re-seal carries it) — not open a fresh
    WriteBatch that no seal ever drains and that hijacks later writes."""
    cfg, cluster, clients = _cluster(tmp_path, 1, partner=False, xor_group=0,
                                     flush=True, seal_retries=2)
    c = clients[0]
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment",
                                     fail_first=1))
    fut = c.checkpoint({"w": np.full(800, 5, np.float32)}, version=1,
                       device_snapshot=False)
    assert "l3-flush" in fut.module_errors  # seal failed; batch retained
    pkey = fmt.parity_key(cfg.name, 1, 0)
    assert cluster.stage_entry(cfg.name, 1, pkey, b"late-parity") is True
    assert not cluster._batches, "zombie WriteBatch created"
    assert cluster.retry_seal(cfg.name, 1) is True  # fail_first=1: now ok
    _ = flaky
    fresh = Cluster(cfg, nranks=1)
    assert fresh.fetch_parity(cfg.name, 1, 0) == b"late-parity"


def test_manifest_publish_during_retained_seal_reaches_tiers(tmp_path):
    """Regression: while a failed-seal batch is retained, manifest
    publishes must still direct-put to the external tiers (the aggregated
    write path's rule) — not vanish into the retained batch until a
    re-seal that may never come."""
    cfg, cluster, clients = _cluster(tmp_path, 1, partner=False, xor_group=0,
                                     flush=True, seal_retries=0)
    c = clients[0]
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment"))
    fut = c.checkpoint({"w": np.full(800, 2, np.float32)}, version=1,
                       device_snapshot=False)
    assert "l3-flush" in fut.module_errors  # seal failed; batch retained
    assert cluster.seal_retry_pending(cfg.name) == [1]
    # compaction-free manifest republish while retained
    cluster.republish_manifest(cfg.name, 1, 0, fut.ctx.digest)
    pfs = [f.inner for f in flaky][0]
    keys = pfs.keys(f"{cfg.name}/")
    assert any("/manifest" in k for k in keys), keys  # direct put happened


# ---------------------------------------------------------------------------
# satellites: resolved history, restart-miss diagnostics
# ---------------------------------------------------------------------------


def test_history_rows_resolve_when_future_completes(tmp_path):
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, keep_versions=10)
    cluster = Cluster(cfg, nranks=1)
    c = VelocClient(cfg, cluster, rank=0)
    fut = c.checkpoint({"w": np.zeros(4000, np.float32)}, version=1,
                       device_snapshot=False)
    fut.result(timeout=30)
    row = c._history[-1]
    # regression: the submit-time snapshot held stale defaults forever;
    # rows now resolve from FINAL pipeline results by completion time
    assert row["status"] == "done", row
    assert row["shard_bytes"] == fut.results["shard_bytes"], row
    assert row["blocking_s"] == fut.results["blocking_s"]
    assert row["skipped"] is False
    c.shutdown()


def test_history_row_marks_superseded(tmp_path):
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, keep_versions=10,
                      backend_workers=1)
    cluster = Cluster(cfg, nranks=1)
    c = VelocClient(cfg, cluster, rank=0)
    gate = threading.Event()
    c.backend.submit("block", 0, lambda: gate.wait(10))  # jam the worker
    f1 = c.checkpoint({"w": np.zeros(100, np.float32)}, version=1,
                      device_snapshot=False)
    f2 = c.checkpoint({"w": np.zeros(100, np.float32)}, version=2,
                      device_snapshot=False)
    gate.set()
    f2.result(timeout=30)
    assert f1.wait(timeout=30)
    rows = {r["version"]: r for r in c._history}
    assert rows[1]["status"] == "superseded", rows
    assert rows[2]["status"] == "done"
    c.shutdown()


def test_restart_miss_surfaces_diagnostics(tmp_path, caplog):
    import logging

    cfg, cluster, clients = _cluster(tmp_path, 1, partner=False, xor_group=0,
                                     flush=True)
    c = clients[0]
    c.checkpoint({"w": np.full(500, 3, np.float32)}, version=1,
                 device_snapshot=False)
    # corrupt the only copy everywhere: every candidate now fails
    fresh = Cluster(cfg, nranks=1)
    pfs = fresh.external_tiers[0]
    skey = fmt.segment_key(cfg.name, 1)
    blob = pfs.get(skey)
    pfs.put(skey, blob[:len(blob) - 25])
    client = VelocClient(cfg, fresh, rank=0)
    with caplog.at_level(logging.WARNING, logger="repro.veloc"):
        v, state = client.restart_latest({"w": np.zeros(500, np.float32)})
    assert (v, state) == (None, None)
    # the miss is no longer silent: diagnostics returned AND logged
    assert client.restart_diagnostics, "miss path must carry diagnostics"
    assert any(d["level"] == "segment" for d in client.restart_diagnostics)
    assert any("no restorable version" in r.message for r in caplog.records)
