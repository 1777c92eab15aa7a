"""Durable stream catalog: persisted durability state per (tier, stream).

Covers: the digest-framed schema-versioned catalog container (torn /
corrupt / unknown-schema blobs fail loudly), catalog-first restart
planning — a fresh process restores the latest mid-chain delta version
with ZERO ``keys()`` listings (asserted via the StorageTier counters) —
restart-safe GC (a fresh process retires a previous run's versions and
orphaned packs without that run's registry), the scan fallback with
diagnostics when the catalog is deleted or torn, the no-resurrection
guarantee for catalog RMWs racing a concurrent GC, pre-catalog data
adoption, the maintenance-lane thread discipline, and the seal-retry
exponential backoff satellite.

The JAX package's ``tests/test_catalog.py`` run against ``repro_torch``, its
imports swapped, on the plain CPU versions of the kernels."""
import threading
import time

import numpy as np
import pytest

from torch_helpers import FlakyTier, WrappedTier, wrap_external_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.backend import ActiveBackend
from repro_torch.core.storage import read_catalog, write_catalog
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


def _cfg(tmp_path, **kw):
    kw.setdefault("mode", "sync")
    kw.setdefault("partner", False)
    kw.setdefault("xor_group", 0)
    kw.setdefault("flush", True)
    kw.setdefault("keep_versions", 50)
    kw.setdefault("catalog", True)
    return VelocConfig(scratch=str(tmp_path), **kw)


def _delta_cfg(tmp_path, **kw):
    kw.setdefault("delta", True)
    kw.setdefault("delta_chunk_bytes", 4096)
    kw.setdefault("aggregate", True)
    return _cfg(tmp_path, **kw)


def _run(client, versions, n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n).astype(np.float32)
    states = {}
    for v in range(1, versions + 1):
        w = w.copy()
        w[v * 100:v * 100 + 500] += 1.0
        states[v] = w
        fut = client.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert not fut.module_errors, (v, fut.module_errors)
    return states


def _all_tiers(cluster):
    return list(cluster.external_tiers) + \
        [t for ts in cluster._node_tiers for t in ts]


def _reset_keys_counters(cluster):
    for t in _all_tiers(cluster):
        t.keys_calls = 0


# ---------------------------------------------------------------------------
# catalog container format
# ---------------------------------------------------------------------------


def test_catalog_roundtrip():
    versions = {
        1: {"kind": "full", "parent": None, "sealed": True,
            "location": "segment", "pack": None, "entries": None,
            "levels": ["L1", "L3"], "stamp": "run-a"},
        2: {"kind": "delta", "parent": 1, "sealed": True,
            "location": "pack", "pack": "s/pack/00000002",
            "entries": ["s/v00000002/shard_00000"], "levels": ["L3"],
            "stamp": "run-a"},
    }
    tombs = [[0, "run-z"]]
    blob = fmt.encode_catalog("s", versions, tombs, gen=7, writer="run-a")
    dec = fmt.decode_catalog(blob)
    assert dec["gen"] == 7 and dec["writer"] == "run-a"
    assert dec["name"] == "s" and dec["schema"] == fmt.CATALOG_SCHEMA
    assert dec["versions"] == versions  # int keys restored
    assert dec["tombstones"] == tombs
    # the catalog key sits OUTSIDE every version prefix: per-version prefix
    # GC can never delete it
    assert not fmt.catalog_key("s").startswith(fmt.version_prefix("s", 1))


@pytest.mark.parametrize("mangle", [
    lambda b: b[:-3],                       # truncated body
    lambda b: b"XXXXXXXX" + b[8:],          # bad magic
    lambda b: b[:len(fmt.CATALOG_MAGIC) + 5] + b"?" +
    b[len(fmt.CATALOG_MAGIC) + 6:],         # corrupt digest
    lambda b: b[:-1] + bytes([b[-1] ^ 1]),  # flipped body byte
    lambda b: b[:12],                       # shorter than the frame
])
def test_catalog_decode_fails_loudly(mangle):
    blob = fmt.encode_catalog(
        "s", {1: {"kind": "full", "parent": None, "sealed": True,
                  "location": "direct", "pack": None, "entries": None,
                  "levels": ["L3"], "stamp": "x"}})
    with pytest.raises(IOError):
        fmt.decode_catalog(mangle(blob))


def test_catalog_decode_rejects_unknown_schema():
    import json

    from repro_torch.kernels import ops as kops

    body = json.dumps({"schema": fmt.CATALOG_SCHEMA + 1, "name": "s",
                       "gen": 1, "versions": {}, "tombstones": []}).encode()
    blob = fmt.CATALOG_MAGIC + kops.digest(body).encode("ascii") + body
    with pytest.raises(IOError, match="schema"):
        fmt.decode_catalog(blob)


def test_read_catalog_distinguishes_missing_from_torn(tmp_path):
    from repro_torch.core.storage import FileTier

    tier = FileTier(str(tmp_path), catalog=True)
    assert read_catalog(tier, "s") == (None, None)  # absent, no error
    write_catalog(tier, "s", {}, gen=1, writer="w")
    cat, err = read_catalog(tier, "s")
    assert err is None and cat["gen"] == 1
    tier.put(fmt.catalog_key("s"), b"garbage")
    cat, err = read_catalog(tier, "s")
    assert cat is None and err  # torn reads as an ERROR, never as empty
    # a catalog blob for a different stream under this key is refused
    tier.put(fmt.catalog_key("s"),
             fmt.encode_catalog("other", {}, gen=1, writer="w"))
    cat, err = read_catalog(tier, "s")
    assert cat is None and "other" in err


# ---------------------------------------------------------------------------
# catalog-first restart: O(1) planning, zero key listings
# ---------------------------------------------------------------------------


def test_fresh_process_restores_mid_chain_delta_with_zero_key_listings(
        tmp_path):
    """Acceptance (a): with catalogs enabled, a fresh process restores the
    latest mid-chain delta version without ANY per-tier keys() listing —
    the catalog resolves versions, chains and pack membership through
    deterministic keys only."""
    cfg = _delta_cfg(tmp_path, delta_max_chain=16, pack_versions=3)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    states = _run(client, 6)  # v1 full; v2..v6 deltas; packs [2,3,4],[5,6]
    client.shutdown()
    assert not cluster.catalog_diagnostics, cluster.catalog_diagnostics

    fresh = Cluster(cfg, nranks=1)
    for tiers in fresh._node_tiers:
        for t in tiers:
            t.wipe()  # only the external tier can serve the restore
    _reset_keys_counters(fresh)
    c2 = VelocClient(cfg, fresh, rank=0)
    v, state = c2.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 6, (v, c2.restart_diagnostics)
    assert np.asarray(state["w"]).tobytes() == states[6].tobytes()
    listings = {t.info.name: t.keys_calls for t in _all_tiers(fresh)
                if t.keys_calls}
    assert not listings, f"catalog-first restart paid key listings: " \
                         f"{listings}"


def test_plan_restart_resolves_chain_and_packs_before_any_fetch(tmp_path):
    cfg = _delta_cfg(tmp_path, delta_max_chain=16, pack_versions=2)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    _run(client, 5)
    client.shutdown()

    fresh = Cluster(cfg, nranks=1)
    _reset_keys_counters(fresh)
    plan = rst.plan_restart(fresh, cfg.name)
    assert plan["mode"] == "catalog"
    assert [c["version"] for c in plan["candidates"]] == [5, 4, 3, 2, 1]
    assert plan["chains"][5] == [5, 4, 3, 2, 1]  # down to the full base
    assert plan["chains"][1] == [1]
    # packed delta versions carry their rolling-pack key
    assert set(plan["packs"]) == {2, 3, 4, 5}
    assert all(k.startswith(fmt.pack_prefix(cfg.name))
               for k in plan["packs"].values())
    assert sum(t.keys_calls for t in _all_tiers(fresh)) == 0


def test_torn_catalog_falls_back_to_scan_with_diagnostic(tmp_path, caplog):
    import logging

    cfg = _delta_cfg(tmp_path, delta_max_chain=16, pack_versions=2)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    states = _run(client, 5)
    client.shutdown()
    pfs = cluster.external_tiers[0]
    key = fmt.catalog_key(cfg.name)
    pfs.put(key, pfs.get(key)[:-9])  # tear the catalog

    fresh = Cluster(cfg, nranks=1)
    c2 = VelocClient(cfg, fresh, rank=0)
    with caplog.at_level(logging.WARNING, logger="repro.veloc"):
        plan = rst.plan_restart(fresh, cfg.name)
        v, state = c2.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert plan["mode"] == "scan"  # degraded, not broken
    assert v == 5 and np.asarray(state["w"]).tobytes() == \
        states[5].tobytes()
    assert any("digest mismatch" in d["error"]
               for d in fresh.catalog_diagnostics), fresh.catalog_diagnostics
    assert any("fell back" in d["error"] for d in fresh.catalog_diagnostics)
    assert any("catalog" in r.message for r in caplog.records)


def test_deleted_catalog_falls_back_to_scan(tmp_path):
    cfg = _cfg(tmp_path, aggregate=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    states = _run(client, 3, n=2000)
    client.shutdown()
    cluster.external_tiers[0].delete(fmt.catalog_key(cfg.name))

    fresh = Cluster(cfg, nranks=1)
    c2 = VelocClient(cfg, fresh, rank=0)
    v, state = c2.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 3
    assert np.asarray(state["w"]).tobytes() == states[3].tobytes()
    assert any("fell back" in d["error"] for d in fresh.catalog_diagnostics)


def test_in_process_restart_sees_unsynced_versions(tmp_path):
    """The catalog-first manifest view unions the in-memory registry, and
    a missing blob with pending in-memory state self-heals (the normal
    async window between a flush and the first maintenance-lane sync) —
    no spurious fallback warning, no invisible versions."""
    cfg = _cfg(tmp_path, aggregate=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    states = _run(client, 2, n=2000)
    # wipe the persisted catalog AND the cache: only in-memory state knows
    cluster.external_tiers[0].delete(fmt.catalog_key(cfg.name))
    with cluster._lock:
        cluster._cat_cache.clear()
        cluster._cat_dirty.discard(cfg.name)
    before = list(cluster.catalog_diagnostics)
    v, state = client.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 2
    assert np.asarray(state["w"]).tobytes() == states[2].tobytes()
    # manifests() re-seeded the blob from memory instead of warning
    assert cluster.catalog_diagnostics == before
    assert cluster.external_tiers[0].exists(fmt.catalog_key(cfg.name))


# ---------------------------------------------------------------------------
# restart-safe GC: fresh process retires a previous run's state
# ---------------------------------------------------------------------------


def test_fresh_process_gc_retires_prior_run_versions_and_orphan_packs(
        tmp_path):
    """Acceptance (b): run B over run A's tiers — ``cluster.gc(keep=1)``
    retires A's versions AND the rolling pack they shared, without A's
    in-memory registry, leaving the survivor chain fully restorable."""
    cfg = _delta_cfg(tmp_path, delta_max_chain=2, pack_versions=2)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    # chains [1,2,3] and [4,5,6]; packs [2,3] and [5,6]
    states = _run(client, 6)
    client.shutdown()
    pfs = cluster.external_tiers[0]
    assert len(pfs.keys(fmt.pack_prefix(cfg.name))) == 2

    fresh = Cluster(cfg, nranks=1)  # run B: no registry of A's versions
    fresh.gc(cfg.name, keep=1)
    pfs = fresh.external_tiers[0]
    for v in (1, 2, 3):
        assert not pfs.keys(fmt.version_prefix(cfg.name, v)), v
        assert not any(t.keys(fmt.version_prefix(cfg.name, v))
                       for t in fresh._node_tiers[0]), v
    # the fully retired pack [2,3] is gone; the live pack [5,6] survives
    packs = pfs.keys(fmt.pack_prefix(cfg.name))
    assert packs == [fmt.pack_key(cfg.name, 5)], packs
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg.name)))
    assert sorted(cat["versions"]) == [4, 5, 6]
    assert sorted(v for v, _s in cat["tombstones"]) == [1, 2, 3]

    another = Cluster(cfg, nranks=1)
    c3 = VelocClient(cfg, another, rank=0)
    v, state = c3.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 6, (v, c3.restart_diagnostics)
    assert np.asarray(state["w"]).tobytes() == states[6].tobytes()


def test_fresh_process_gc_scan_fallback_when_catalog_torn(tmp_path):
    """Catalog deleted/torn: GC degrades to the manifest key-scan (with a
    diagnostic) and still retires the prior run's versions."""
    cfg = _cfg(tmp_path, aggregate=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    _run(client, 4, n=2000)  # full versions: keep=1 retires 1..3
    client.shutdown()
    pfs = cluster.external_tiers[0]
    pfs.put(fmt.catalog_key(cfg.name), b"VCATJX1\x00shredded")

    fresh = Cluster(cfg, nranks=1)
    fresh.gc(cfg.name, keep=1)
    assert any("fell back" in d["error"] for d in fresh.catalog_diagnostics)
    pfs = fresh.external_tiers[0]
    for v in (1, 2, 3):
        assert not pfs.keys(fmt.version_prefix(cfg.name, v)), v
    assert pfs.keys(fmt.version_prefix(cfg.name, 4))
    # gc's sync self-healed the torn blob: the next process plans from it
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg.name)))
    assert sorted(cat["versions"]) == [4]


def test_gc_adopts_pre_catalog_data(tmp_path):
    """Migration: run A wrote without catalogs; run B (catalogs on) GCs —
    live versions are adopted into a fresh catalog, including the pack
    membership the scan discovered, so B's NEXT restart is catalog-first."""
    cfg_a = _delta_cfg(tmp_path, delta_max_chain=2, pack_versions=2,
                       catalog=False)
    cluster = Cluster(cfg_a, nranks=1)
    client = VelocClient(cfg_a, cluster, rank=0)
    states = _run(client, 6)
    client.shutdown()

    cfg_b = _delta_cfg(tmp_path, delta_max_chain=2, pack_versions=2)
    b = Cluster(cfg_b, nranks=1)
    b.gc(cfg_b.name, keep=1)
    cat = fmt.decode_catalog(
        b.external_tiers[0].get(fmt.catalog_key(cfg_b.name)))
    assert sorted(cat["versions"]) == [4, 5, 6]
    assert cat["versions"][5]["pack"] == fmt.pack_key(cfg_b.name, 5)
    assert cat["versions"][6]["parent"] == 5

    fresh = Cluster(cfg_b, nranks=1)
    for tiers in fresh._node_tiers:
        for t in tiers:
            t.wipe()
    _reset_keys_counters(fresh)
    c2 = VelocClient(cfg_b, fresh, rank=0)
    v, state = c2.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 6 and np.asarray(state["w"]).tobytes() == \
        states[6].tobytes()
    assert sum(t.keys_calls for t in _all_tiers(fresh)) == 0


def test_first_sweep_reconciles_healthy_catalog_with_pre_catalog_data(
        tmp_path):
    """Regression: flipping catalog=True on an existing deployment used to
    leave the pre-catalog versions invisible forever — the first
    checkpoint synced a catalog listing only itself, and every later gc
    trusted the healthy blob without scanning.  The first sweep per
    process now reconciles the blob against one key scan: old versions
    are adopted, GC'd when beyond the horizon, and restorable."""
    cfg_a = _cfg(tmp_path, aggregate=True, catalog=False)
    a = Cluster(cfg_a, nranks=1)
    ca = VelocClient(cfg_a, a, rank=0)
    states = _run(ca, 4, n=2000)  # pre-catalog versions 1..4
    ca.shutdown()

    cfg_b = _cfg(tmp_path, aggregate=True, keep_versions=2)
    b = Cluster(cfg_b, nranks=1)
    cb = VelocClient(cfg_b, b, rank=0)
    w5 = np.full(2000, 5.0, np.float32)
    fut = cb.checkpoint({"w": w5}, version=5, device_snapshot=False)
    assert not fut.module_errors
    cb.shutdown()
    # the sweep ran with a HEALTHY catalog (v5 synced before gc): 1..2
    # retired, 3..4 adopted — not leaked, not invisible
    pfs = b.external_tiers[0]
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg_b.name)))
    assert sorted(cat["versions"]) == [3, 4, 5], sorted(cat["versions"])
    for v in (1, 2):
        assert not pfs.keys(fmt.version_prefix(cfg_b.name, v)), v
    assert any("adopted" in d["error"] for d in b.catalog_diagnostics)

    fresh = Cluster(cfg_b, nranks=1)
    cf = VelocClient(cfg_b, fresh, rank=0)
    v, state = cf.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 5 and np.asarray(state["w"]).tobytes() == w5.tobytes()
    assert {m["version"] for m in rst.find_restart(fresh, cfg_b.name)} == \
        {3, 4, 5}
    regs = rst.load_rank_regions(fresh, cfg_b.name, 4, 0)
    assert regs["w"].tobytes() == states[4].tobytes()


# ---------------------------------------------------------------------------
# catalog RMW vs concurrent GC: no resurrection
# ---------------------------------------------------------------------------


def test_stale_writer_does_not_resurrect_gc_retired_versions(tmp_path):
    """Two interleaved processes: A holds versions in memory, B (fresh)
    retires them and writes tombstones; A's next catalog RMW merges
    against the FRESH blob and must not republish the retired versions."""
    cfg = _cfg(tmp_path, aggregate=True)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 3, n=2000)  # A's in-memory catalog state lists 1..3

    b = Cluster(cfg, nranks=1)
    b.gc(cfg.name, keep=1)  # B retires 1, 2 and tombstones them
    pfs = b.external_tiers[0]
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg.name)))
    assert sorted(cat["versions"]) == [3]

    a.sync_catalog(cfg.name, force=True)  # A's stale state still has 1..3
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg.name)))
    assert sorted(cat["versions"]) == [3], "retired versions resurrected"
    assert sorted(v for v, _s in cat["tombstones"]) == [1, 2]
    # A adopted the merged view: its memory agrees with disk
    assert sorted(a._cat_state[cfg.name]["versions"]) == [3]


def test_rmw_losing_put_race_retries_once_against_fresh_blob(tmp_path):
    """A catalog RMW whose write is immediately overwritten by a racing GC
    (read-back mismatch) retries exactly once against the then-fresh blob
    — honouring the tombstones instead of resurrecting."""
    cfg = _cfg(tmp_path, aggregate=True)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 3, n=2000)
    pfs_raw = a.external_tiers[0]
    key = fmt.catalog_key(cfg.name)
    blob_stale = pfs_raw.get(key)  # pre-GC: versions 1..3 live

    b = Cluster(cfg, nranks=1)
    b.gc(cfg.name, keep=1)
    blob_gc = b.external_tiers[0].get(key)  # tombstones for 1, 2

    class RaceTier(WrappedTier):
        """Scripted catalog gets simulating B's write interleaving A's
        read -> put -> verify sequence: A first reads the stale pre-GC
        blob, then every read observes B's blob until A rewrites it."""

        def __init__(self, inner):
            super().__init__(inner)
            self.script = [blob_stale, blob_gc, blob_gc]
            self.puts = []

        def get(self, k):
            if k == key and self.script:
                return self.script.pop(0)
            return self.inner.get(k)

        def put(self, k, data):
            if k == key:
                self.puts.append(bytes(data))
            return self.inner.put(k, data)

    race = wrap_external_tiers(a, RaceTier)[0]
    a.sync_catalog(cfg.name, force=True)
    assert len(race.puts) == 2, "read-back mismatch must retry exactly once"
    first = fmt.decode_catalog(race.puts[0])
    assert sorted(first["versions"]) == [1, 2, 3]  # the stale (lost) write
    final = fmt.decode_catalog(race.inner.get(key))
    assert sorted(final["versions"]) == [3], "race retry failed to honour " \
                                             "the concurrent GC's tombstones"
    assert sorted(v for v, _s in final["tombstones"]) == [1, 2]


def test_orphan_sweep_spares_packs_of_reused_version_numbers(tmp_path):
    """Regression: the GC orphan-pack sweep knows only version NUMBERS,
    while tombstones are (number, stamp) pairs — a later run's pack that
    legitimately reuses retired numbers must survive the sweep."""
    cfg = _delta_cfg(tmp_path, delta_max_chain=2, pack_versions=2)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    a_states = _run(ca, 6)  # chains [1,2,3], [4,5,6]; packs [2,3], [5,6]
    ca.shutdown()
    b = Cluster(cfg, nranks=1)
    b.gc(cfg.name, keep=1)  # tombstones 1..3; pack [2,3] deleted

    # run C cold-restarts from scratch, REUSING version numbers 1..3 —
    # its pack [2,3] lands on the same pack key the tombstoned one had
    c = Cluster(cfg, nranks=1)
    cc = VelocClient(cfg, c, rank=0)
    states = _run(cc, 3, seed=9)
    cc.shutdown()
    pfs = c.external_tiers[0]
    assert pfs.exists(fmt.pack_key(cfg.name, 2))

    d = Cluster(cfg, nranks=1)  # fresh process: first gc runs the sweep
    d.gc(cfg.name, keep=5)      # drops nothing — everything is live
    assert d.external_tiers[0].exists(fmt.pack_key(cfg.name, 2)), \
        "orphan sweep deleted a live pack of reused version numbers"
    e = Cluster(cfg, nranks=1)
    ce = VelocClient(cfg, e, rank=0)
    # newest overall is still run A's v6 (B's keep=1 kept chain [4,5,6]);
    # C's reused v3 must ALSO be restorable — its pack survived the sweep
    v, state = ce.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 6 and np.asarray(state["w"]).tobytes() == \
        a_states[6].tobytes(), (v, ce.restart_diagnostics)
    regs = rst.load_rank_regions(e, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[3].tobytes()


def test_raced_out_sync_keeps_stream_dirty(tmp_path):
    """Regression: a catalog RMW that loses the read-back verify twice
    returns False — the stream must STAY dirty so a later sync retries,
    or this process's updates would never reach the durable catalog."""
    cfg = _cfg(tmp_path, aggregate=True)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 2, n=2000)
    key = fmt.catalog_key(cfg.name)
    foreign = fmt.encode_catalog(cfg.name, {}, gen=99, writer="other")

    class AlwaysRaced(WrappedTier):
        """Read-back never matches what we wrote (a permanently racing
        concurrent writer)."""

        def get(self, k):
            if k == key:
                return foreign
            return self.inner.get(k)

    wrap_external_tiers(a, AlwaysRaced)
    with a._lock:
        a._cat_dirty.add(cfg.name)
    assert a.sync_catalog(cfg.name) is False
    with a._lock:
        assert cfg.name in a._cat_dirty, \
            "raced-out sync silently dropped the pending catalog updates"


def test_flaky_verify_read_is_not_a_race(tmp_path):
    """Regression: a read-back that RAISES after a successful put is a
    transient tier flake, not a racing writer — the RMW trusts its write
    (the put succeeded) instead of burning the race retry and
    misreporting concurrent writers."""
    cfg = _cfg(tmp_path, aggregate=True)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 2, n=2000)
    key = fmt.catalog_key(cfg.name)

    class FlakyVerify(WrappedTier):
        def __init__(self, inner):
            super().__init__(inner)
            self.arm = False

        def get(self, k):
            if k == key and self.arm:
                self.arm = False
                raise IOError("transient verify-read flake")
            return self.inner.get(k)

    flaky = wrap_external_tiers(a, FlakyVerify)[0]
    flaky.arm = True
    with a._lock:
        a._cat_dirty.add(cfg.name)
    assert a.sync_catalog(cfg.name) is True
    with a._lock:
        assert cfg.name not in a._cat_dirty
    assert not any("raced twice" in d["error"]
                   for d in a.catalog_diagnostics), a.catalog_diagnostics
    cat = fmt.decode_catalog(flaky.inner.get(key))
    assert sorted(cat["versions"]) == [1, 2]  # the write really landed


def test_failed_first_sweep_retries_on_next_gc(tmp_path):
    """Regression: a transient keys() failure during the first orphan
    sweep must leave the stream unswept, so the NEXT gc retries it —
    orphaned packs must not leak for the whole process lifetime."""
    cfg = _delta_cfg(tmp_path, delta_max_chain=2, pack_versions=2)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 6)  # packs [2,3] (chain 1-3 retirable), [5,6]
    ca.shutdown()

    b = Cluster(cfg, nranks=1)

    class FlakyKeys(WrappedTier):
        def __init__(self, inner):
            super().__init__(inner)
            self.fail_pack_listings = 0

        def _keys(self, prefix=""):
            if prefix.startswith(fmt.pack_prefix(cfg.name)) and \
                    self.fail_pack_listings > 0:
                self.fail_pack_listings -= 1
                raise IOError("transient listing failure")
            return self.inner.keys(prefix)

    flaky = wrap_external_tiers(b, FlakyKeys)[0]
    flaky.fail_pack_listings = 1
    b.gc(cfg.name, keep=1)  # versions retire; the pack sweep flaked
    assert cfg.name not in b._gc_swept
    b.gc(cfg.name, keep=1)  # retry completes the sweep
    assert cfg.name in b._gc_swept
    assert not flaky.inner.exists(fmt.pack_key(cfg.name, 2)), \
        "orphaned pack leaked past the retried sweep"


def test_tombstone_does_not_suppress_new_incarnation(tmp_path):
    """Retirement tombstones carry the writing run's stamp: a LATER run
    legitimately reusing a retired version number is not suppressed."""
    cfg = _cfg(tmp_path, aggregate=True)
    a = Cluster(cfg, nranks=1)
    ca = VelocClient(cfg, a, rank=0)
    _run(ca, 3, n=2000)
    ca.shutdown()
    b = Cluster(cfg, nranks=1)
    b.gc(cfg.name, keep=1)  # tombstones (1, stampA), (2, stampA)

    c = Cluster(cfg, nranks=1)  # cold restart re-seeding from version 1
    cc = VelocClient(cfg, c, rank=0)
    fut = cc.checkpoint({"w": np.full(2000, 9, np.float32)}, version=1,
                        device_snapshot=False)
    assert not fut.module_errors
    cc.shutdown()
    cat = fmt.decode_catalog(
        c.external_tiers[0].get(fmt.catalog_key(cfg.name)))
    assert 1 in cat["versions"], "new incarnation of v1 was suppressed"
    fresh = Cluster(cfg, nranks=1)
    cf = VelocClient(cfg, fresh, rank=0)
    v, state = cf.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 3  # newest by number; v1's new incarnation is also listed
    assert {m["version"] for m in rst.find_restart(fresh, cfg.name)} >= {1, 3}


# ---------------------------------------------------------------------------
# maintenance-lane discipline
# ---------------------------------------------------------------------------


def test_catalog_writes_never_run_on_the_app_thread(tmp_path):
    cfg = _cfg(tmp_path, mode="async", aggregate=True, backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    key = fmt.catalog_key(cfg.name)
    threads = []

    class Recorder(WrappedTier):
        def put(self, k, data):
            if k == key:
                threads.append(threading.current_thread().name)
            return self.inner.put(k, data)

    wrap_external_tiers(cluster, Recorder)
    client = VelocClient(cfg, cluster, rank=0)
    fut = client.checkpoint({"w": np.full(2000, 3, np.float32)}, version=1,
                            device_snapshot=False)
    assert fut.wait(timeout=30)
    assert client.backend.wait(timeout=30)
    assert threads, "catalog never persisted"
    assert all(t.startswith("veloc-backend") for t in threads), threads
    client.shutdown()


def test_catalog_survives_async_pipeline(tmp_path):
    """Async end-to-end: seal + catalog sync in the backend, fresh-process
    zero-listing restore afterwards."""
    cfg = _delta_cfg(tmp_path, mode="async", delta_max_chain=16,
                     pack_versions=2, backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    rng = np.random.default_rng(3)
    w = rng.standard_normal(50_000).astype(np.float32)
    last = None
    for v in range(1, 5):
        w = w.copy()
        w[v * 50:v * 50 + 300] += 1.0
        last = w
        fut = client.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert fut.wait(timeout=30)
    client.shutdown()  # drains maintenance, seals open packs, syncs catalog

    fresh = Cluster(cfg, nranks=1)
    for tiers in fresh._node_tiers:
        for t in tiers:
            t.wipe()
    _reset_keys_counters(fresh)
    c2 = VelocClient(cfg, fresh, rank=0)
    v, state = c2.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 4, (v, c2.restart_diagnostics)
    assert np.asarray(state["w"]).tobytes() == last.tobytes()
    assert sum(t.keys_calls for t in _all_tiers(fresh)) == 0


# ---------------------------------------------------------------------------
# satellite: seal-retry exponential backoff
# ---------------------------------------------------------------------------


def test_maintenance_delay_defers_task_start():
    b = ActiveBackend(workers=1)
    ran = []
    t0 = time.monotonic()
    b.submit_maintenance("d", 1, lambda: ran.append(time.monotonic() - t0),
                         delay_s=0.3)
    time.sleep(0.1)
    assert not ran, "delayed task started early"
    assert b.wait(timeout=10)
    assert ran and ran[0] >= 0.25, ran
    b.shutdown()


def test_shutdown_collapses_maintenance_backoff():
    b = ActiveBackend(workers=1)
    ran = []
    b.submit_maintenance("d", 1, lambda: ran.append(1), delay_s=30.0)
    t0 = time.monotonic()
    b.shutdown()  # must not sit out the 30s backoff
    assert ran and time.monotonic() - t0 < 5.0


def test_seal_retries_back_off_exponentially(tmp_path):
    cfg = _cfg(tmp_path, mode="async", aggregate=True, seal_retries=3,
               seal_backoff_base_s=0.2, seal_backoff_cap_s=5.0,
               backend_workers=1, catalog=False)
    cluster = Cluster(cfg, nranks=1)

    class TimedFlaky(FlakyTier):
        def __init__(self, inner, **kw):
            super().__init__(inner, **kw)
            self.fail_times = []

        def put(self, key, data):
            if self.fail_puts and "segment" in key:
                self.fail_times.append(time.monotonic())
            return super().put(key, data)

    flaky = wrap_external_tiers(
        cluster, lambda t: TimedFlaky(t, fail_puts=True, match="segment"))
    client = VelocClient(cfg, cluster, rank=0)
    fut = client.checkpoint({"w": np.full(500, 1, np.float32)}, version=1,
                            device_snapshot=False)
    assert fut.wait(timeout=30)
    # the deadline of the backed-off next attempt is visible to operators
    det = cluster.seal_retry_pending(cfg.name, detail=True)
    assert len(det) == 1 and det[0]["versions"] == [1]
    assert det[0]["scheduled"] and det[0]["next_attempt_in_s"] is not None
    assert client.backend.wait(timeout=60)
    times = flaky[0].fail_times
    assert len(times) == 4, times  # initial + 3 bounded retries
    gaps = [b - a for a, b in zip(times, times[1:])]
    # attempt N waits >= base * 2**N (scheduling jitter only adds delay)
    assert gaps[0] >= 0.18 and gaps[1] >= 0.36 and gaps[2] >= 0.72, gaps
    det = cluster.seal_retry_pending(cfg.name, detail=True)
    assert det[0]["attempts"] == 3 and det[0]["next_attempt_in_s"] is None
    assert cluster.seal_retry_pending(cfg.name) == [1]  # legacy shape kept
    client.shutdown()


def test_successful_seal_retry_reaches_the_catalog(tmp_path):
    """A re-sealed version's upgrade to full L3 must land in the durable
    catalog (the re-seal runs on the maintenance lane already)."""
    cfg = _cfg(tmp_path, mode="async", aggregate=True, seal_retries=2,
               seal_backoff_base_s=0.05, backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment",
                                     fail_first=1))
    client = VelocClient(cfg, cluster, rank=0)
    fut = client.checkpoint({"w": np.full(2000, 7, np.float32)}, version=1,
                            device_snapshot=False)
    assert fut.wait(timeout=30)
    assert client.backend.wait(timeout=60)
    assert cluster.seal_retry_pending(cfg.name) == []
    client.shutdown()
    cat, err = read_catalog(cluster.external_tiers[0], cfg.name)
    assert err is None
    assert cat["versions"][1]["sealed"] is True
    assert cat["versions"][1]["location"] == "segment"


def test_manual_retry_seal_syncs_catalog_before_crash(tmp_path):
    """Write-behind narrowing: the catalog RMW is queued (or run) right
    after EVERY successful seal — including a manual ``retry_seal`` with
    no maintenance lane behind it — so a crash between the seal and the
    next scheduled sync no longer hides the newest sealed version from
    catalog-first restore planning."""
    cfg = _delta_cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True,
                                     match=fmt.segment_key(cfg.name, 2),
                                     fail_first=1))
    client = VelocClient(cfg, cluster, rank=0)
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal(50_000).astype(np.float32)
    assert not client.checkpoint({"w": w1}, version=1,
                                 device_snapshot=False).module_errors
    w2 = w1.copy()
    w2[:500] += 1.0
    fut = client.checkpoint({"w": w2}, version=2, device_snapshot=False)
    assert fut.module_errors, "injected seal failure did not surface"
    assert cluster.seal_retry_pending(cfg.name) == [2]
    assert cluster.retry_seal(cfg.name, 2)
    # "crash": no shutdown, no explicit sync_catalog.  A fresh process on
    # new hardware must still see v2 sealed — catalog-first, zero listings.
    fresh = Cluster(cfg, nranks=1)
    for tiers in fresh._node_tiers:
        for t in tiers:
            t.wipe()
    _reset_keys_counters(fresh)
    plan = rst.plan_restore(fresh, cfg.name)
    assert plan.mode == "catalog"
    assert plan.candidates and plan.candidates[0]["version"] == 2
    regs = rst.load_rank_regions(fresh, cfg.name, 2, 0, plan=plan)
    assert regs["w"].tobytes() == w2.tobytes()
    assert sum(t.keys_calls for t in _all_tiers(fresh)) == 0
    cat, err = read_catalog(fresh.external_tiers[0], cfg.name)
    assert err is None
    assert cat["versions"][2]["sealed"] is True
