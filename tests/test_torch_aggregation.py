"""Aggregated write path (segment store) + background maintenance lane.

Covers: one-segment-per-version sealing and the put-count reduction, restart
round-trips resolved entirely through segments (fresh process, delta
chains), torn/truncated/corrupt segment handling (skipped with diagnostics,
never silently decoded), the exact backend status + idle-only rate-limited
maintenance lane, auto-compaction (inline vs maintenance lane) with the
post-compaction parity refresh, and the KVTier log-structured journal.

The JAX package's ``tests/test_aggregation.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import os
import threading
import time

import numpy as np
import pytest

from torch_helpers import FlakyTier, wrap_external_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.backend import ActiveBackend
from repro_torch.core.storage import KVTier
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
    kw.setdefault("keep_versions", 10)
    cfg = VelocConfig(scratch=str(tmp_path), mode="sync", **kw)
    cluster = Cluster(cfg, nranks=nranks)
    clients = [VelocClient(cfg, cluster, rank=r) for r in range(nranks)]
    return cfg, cluster, clients


def _run_versions(clients, versions, n=50_000, seed=0):
    """Drive a ~1%-dirty delta workload; returns the final per-rank arrays."""
    rng = np.random.default_rng(seed)
    w = [rng.standard_normal(n).astype(np.float32) + r
         for r in range(len(clients))]
    for v in range(1, versions + 1):
        for r, c in enumerate(clients):
            wv = w[r].copy()
            lo = (v * 997 + r * 131) % (n - 500)
            wv[lo:lo + 500] += 1.0
            w[r] = wv
            fut = c.checkpoint({"w": wv}, version=v, device_snapshot=False)
            assert not fut.module_errors, (v, r, fut.module_errors)
    return w


# ---------------------------------------------------------------------------
# segment format
# ---------------------------------------------------------------------------


def test_segment_roundtrip_and_torn_detection():
    entries = {"a/shard_0": b"alpha" * 100, "a/manifest.L3": b"{}",
               "a/parity_0": bytes(range(256))}
    blob = fmt.encode_segment(entries, meta={"version": 7})
    r = fmt.SegmentReader(blob)
    assert sorted(r.names()) == sorted(entries)
    assert r.meta["version"] == 7
    for k, v in entries.items():
        assert r.read(k) == v
    # truncation anywhere in the payload fails loudly at parse time
    with pytest.raises(IOError):
        fmt.SegmentReader(blob[:-10])
    # truncation inside the header too
    with pytest.raises(IOError):
        fmt.SegmentReader(blob[:20])
    with pytest.raises(IOError):
        fmt.SegmentReader(b"NOTASEG!" + blob[8:])
    # a flipped payload byte is caught by the per-entry digest
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    r2 = fmt.SegmentReader(bytes(bad))
    with pytest.raises(IOError):
        r2.read("a/parity_0")


def test_log_record_scan_skips_corrupt_and_torn():
    recs = (fmt.encode_log_record("k1", b"v1")
            + fmt.encode_log_record("k2", b"v2")
            + fmt.encode_log_record("k1", None))  # tombstone
    out, skipped = fmt.scan_log_records(recs)
    assert out == [("k1", b"v1"), ("k2", b"v2"), ("k1", None)]
    assert skipped == []
    # corrupt k2's payload: frame intact -> skipped, scan continues
    bad = bytearray(recs)
    k2_off = len(fmt.encode_log_record("k1", b"v1"))
    bad[k2_off + len(fmt.encode_log_record("k2", b"v2")) - 1] ^= 0xFF
    out, skipped = fmt.scan_log_records(bytes(bad))
    assert ("k1", b"v1") in out and ("k1", None) in out
    assert skipped == ["k2"]
    # torn tail: scan stops at the torn frame
    out, skipped = fmt.scan_log_records(recs[:-5])
    assert out == [("k1", b"v1"), ("k2", b"v2")]
    assert len(skipped) == 1 and "torn" in skipped[0]
    # mid-log FRAME corruption (bad magic) resyncs to the next record: one
    # record lost, not everything after it
    bad = bytearray(recs)
    bad[k2_off] ^= 0xFF  # clobber k2's magic
    out, skipped = fmt.scan_log_records(bytes(bad))
    assert ("k1", b"v1") in out and ("k1", None) in out
    assert len(skipped) == 1 and "resynced" in skipped[0]


# ---------------------------------------------------------------------------
# aggregated flush: one put per version, restart through segments
# ---------------------------------------------------------------------------


def test_aggregated_flush_one_put_per_version(tmp_path):
    nranks = 4
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=4, flush=True)
    w = _run_versions(clients, 3)
    puts = sum(t.put_calls for t in cluster.external_tiers)
    # one sealed segment per version — not 4 shards + parity + manifests
    assert puts == 3, puts
    pfs = cluster.external_tiers[0]
    assert all(k.endswith("/segment") for k in pfs.keys(f"{cfg.name}/")), \
        pfs.keys(f"{cfg.name}/")
    for r in range(nranks):
        regs = rst.load_rank_regions(cluster, cfg.name, 3, r)
        assert regs["w"].tobytes() == w[r].tobytes(), r


def test_aggregated_restart_fresh_process_delta_chain(tmp_path):
    """All node-local tiers gone (new machine): the full delta chain
    resolves through the external segments alone."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True)
    w = _run_versions(clients, 4)
    fresh = Cluster(cfg, nranks=nranks)
    for r in range(nranks):
        client = VelocClient(cfg, fresh, rank=r)
        v, state = client.restart_latest(
            {"w": np.zeros(50_000, np.float32)})
        assert v == 4
        assert np.asarray(state["w"]).tobytes() == w[r].tobytes()


def test_aggregated_gc_deletes_segments(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, partner=False, xor_group=0,
                                     flush=True, keep_versions=1)
    c = clients[0]
    for v in (1, 2, 3):
        c.checkpoint({"w": np.full(1000, v, np.float32)}, version=v,
                     device_snapshot=False)
    pfs = cluster.external_tiers[0]
    vers = {k.split("/")[1] for k in pfs.keys(f"{cfg.name}/")}
    assert vers == {"v00000002", "v00000003"}


def test_segments_readable_with_aggregation_off(tmp_path):
    """The aggregate flag steers the WRITE path only: checkpoints sealed
    into segments must restore in a process restarted with aggregation
    disabled (regression: reads used to be gated on tier.info.aggregate)."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True)
    w = _run_versions(clients, 3)
    off = VelocConfig(scratch=str(tmp_path), mode="sync", delta=True,
                      delta_chunk_bytes=4096, partner=False, xor_group=0,
                      flush=True, keep_versions=10, aggregate=False)
    fresh = Cluster(off, nranks=nranks)
    for r in range(nranks):
        client = VelocClient(off, fresh, rank=r)
        v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
        assert v == 3, (r, v, client.restart_diagnostics)
        assert np.asarray(state["w"]).tobytes() == w[r].tobytes()


# ---------------------------------------------------------------------------
# torn / corrupt segments at restart
# ---------------------------------------------------------------------------


def test_torn_segment_skipped_with_diagnostic(tmp_path):
    """A segment truncated mid-entry makes its version invisible (its
    manifests live inside) — restart falls back to the previous version and
    the cluster records WHY, instead of decoding garbage."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True)
    w = _run_versions(clients, 3)
    # tear v3's segment on disk, then restart from a fresh cluster (no
    # caches, no node-local tiers — only the external segments)
    fresh = Cluster(cfg, nranks=nranks)
    pfs = fresh.external_tiers[0]
    skey = fmt.segment_key(cfg.name, 3)
    blob = pfs.get(skey)
    pfs.put(skey, blob[:len(blob) - 40])
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 2
    assert any(d["key"] == skey and "truncated" in d["error"].lower()
               for d in fresh.segment_diagnostics), fresh.segment_diagnostics
    # v2's state is the pre-v3 array: rebuild it for comparison
    regs = rst.load_rank_regions(fresh, cfg.name, 2, 0)
    assert np.asarray(state["w"]).tobytes() == regs["w"].tobytes()
    _ = w  # final arrays unused: v3 is unreachable by design


def test_corrupt_segment_entry_falls_back(tmp_path):
    """A single corrupted entry (digest mismatch) reads as a miss for that
    shard only; restart falls back across versions with a diagnostic."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True)
    _run_versions(clients, 3)
    fresh = Cluster(cfg, nranks=nranks)
    pfs = fresh.external_tiers[0]
    skey = fmt.segment_key(cfg.name, 3)
    reader = fmt.SegmentReader(pfs.get(skey))
    victim = fmt.shard_key(cfg.name, 3, 0)
    entries = {}
    for n in reader.names():
        blob = reader.read(n)
        entries[n] = blob
    seg = bytearray(fmt.encode_segment(entries, meta=reader.meta))
    # flip a byte inside the victim entry's payload region
    r2 = fmt.SegmentReader(bytes(seg))
    e = r2.entry(victim)
    hdr_len = len(seg) - sum(x["length"] for x in map(r2.entry, r2.names()))
    seg[hdr_len + e["offset"]] ^= 0xFF
    pfs.put(skey, bytes(seg))
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 2
    assert any(d["version"] == 3 for d in client.restart_diagnostics)
    assert any(victim in d["key"] for d in fresh.segment_diagnostics)


def test_seal_put_failure_degrades_and_falls_back(tmp_path):
    """FlakyTier on the external tier fails the segment put: the sealing
    rank records the L3 error, L1 still restores in-process, and a fresh
    process falls back to the previous (sealed) version."""
    nranks = 2
    cfg, cluster, clients = _cluster(tmp_path, nranks, partner=False,
                                     xor_group=0, flush=True)
    states = [{"w": np.full(2000, r, np.float32)} for r in range(nranks)]
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=1, device_snapshot=False)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_puts=True, match="segment"))
    futs = [c.checkpoint(states[r], version=2, device_snapshot=False)
            for r, c in enumerate(clients)]
    # the sealing (last) rank saw the failure; earlier ranks only staged
    assert "l3-flush" in futs[1].module_errors
    assert "l3_error" in futs[1].results
    assert any(f.failed_puts for f in flaky)
    # v2 is still restorable in-process from L1
    for r in range(nranks):
        regs = rst.load_rank_regions(cluster, cfg.name, 2, r)
        assert (regs["w"] == r).all()
    # a fresh process only sees sealed versions -> v1
    fresh = Cluster(cfg, nranks=nranks)
    client = VelocClient(cfg, fresh, rank=0)
    v, state = client.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 1


# ---------------------------------------------------------------------------
# backend: exact status + maintenance lane
# ---------------------------------------------------------------------------


def test_backend_status_is_exact_while_busy():
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    b.submit("pipe", 1, lambda: gate.wait(5))
    deadline = time.monotonic() + 5
    while b.status("pipe", 1) != "running":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    # the historical bug: ANY busy worker made unrelated pairs "running"
    assert b.status("other", 99) == "unknown"
    assert b.status("pipe", 2) == "unknown"
    gate.set()
    assert b.wait(timeout=10)
    assert b.status("pipe", 1) == "done"
    assert b.status("other", 99) == "unknown"
    b.shutdown()


def test_maintenance_waits_for_idle_checkpoint_lanes():
    b = ActiveBackend(workers=2)
    gate = threading.Event()
    order = []
    b.submit("pipe", 1, lambda: (gate.wait(5), order.append("ckpt")))
    b.submit_maintenance("maint", 1, lambda: order.append("maint"))
    time.sleep(0.15)
    assert order == []  # a running checkpoint defers maintenance
    assert b.status("maint", 1) == "queued"
    gate.set()
    assert b.wait(timeout=10)
    assert order == ["ckpt", "maint"]
    assert b.status("maint", 1) == "done"
    b.shutdown()


def test_maintenance_rate_limited():
    b = ActiveBackend(workers=2, maintenance_interval_s=0.15)
    stamps = []
    b.submit_maintenance("m", 1, lambda: stamps.append(time.monotonic()))
    b.submit_maintenance("m", 2, lambda: stamps.append(time.monotonic()))
    assert b.wait(timeout=10)
    assert len(stamps) == 2
    assert stamps[1] - stamps[0] >= 0.12, stamps
    b.shutdown()


# ---------------------------------------------------------------------------
# auto-compaction: inline vs maintenance lane, parity refresh
# ---------------------------------------------------------------------------


def _dirty_step(w, v):
    wv = w.copy()
    wv[v * 100:v * 100 + 500] += 1.0
    return wv


def test_inline_auto_compaction_runs_in_caller_thread(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 1, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=0, flush=True,
                                     compact_threshold=2)
    c = clients[0]
    threads = []
    orig = c.compact
    c.compact = lambda v=None: (threads.append(
        threading.current_thread().name), orig(v))[1]
    rng = np.random.default_rng(3)
    w = rng.standard_normal(50_000).astype(np.float32)
    for v in range(1, 4):
        w = _dirty_step(w, v)
        c.checkpoint({"w": w}, version=v, device_snapshot=False)
    assert threads == [threading.main_thread().name]
    m = [m for m in cluster.manifests(cfg.name) if m["version"] == 3]
    assert m and all(x["parent"] is None for x in m)
    # next delta chains off the compacted base
    w = _dirty_step(w, 4)
    fut = c.checkpoint({"w": w}, version=4, device_snapshot=False)
    assert fut.results["delta_kind"] == "delta"
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == w.tobytes()


def test_async_compaction_runs_in_maintenance_lane(tmp_path):
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", delta=True,
                      delta_chunk_bytes=4096, partner=False, xor_group=0,
                      flush=True, keep_versions=10, aggregate=True,
                      compact_threshold=2, compact_async=True,
                      backend_workers=2)
    cluster = Cluster(cfg, nranks=1)
    c = VelocClient(cfg, cluster, rank=0)
    threads = []
    orig = c.compact
    c.compact = lambda v=None: (threads.append(
        threading.current_thread().name), orig(v))[1]
    rng = np.random.default_rng(4)
    w = rng.standard_normal(50_000).astype(np.float32)
    for v in range(1, 6):
        w = _dirty_step(w, v)
        fut = c.checkpoint({"w": w}, version=v, device_snapshot=False)
        assert fut.wait(timeout=30)
    assert c.backend.wait(timeout=30)
    assert not c.backend.errors(), c.backend.errors()
    # compact() ran, and NEVER on the application thread
    assert threads and all(t.startswith("veloc-backend") for t in threads), \
        threads
    v, state = c.restart_latest({"w": np.zeros(50_000, np.float32)})
    assert v == 5
    assert np.asarray(state["w"]).tobytes() == w.tobytes()
    c.shutdown()


def test_post_compaction_xor_loss_restores_via_refreshed_parity(tmp_path):
    """Compaction rewrites every rank's shard; the maintenance task then
    re-encodes the group parity, so an XOR-reconstruct of a lost shard
    succeeds against the COMPACTED bytes (the pre-refresh parity would
    decode garbage)."""
    nranks = 4
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, partner=False,
                                     xor_group=4, flush=True,
                                     compact_threshold=2)
    w = _run_versions(clients, 3)
    m3 = [m for m in cluster.manifests(cfg.name) if m["version"] == 3]
    assert m3 and all(m["parent"] is None for m in m3)  # fully compacted
    # fresh cluster; remove rank 1's shard from the segment so only the
    # refreshed parity can reconstruct it
    fresh = Cluster(cfg, nranks=nranks)
    pfs = fresh.external_tiers[0]
    skey = fmt.segment_key(cfg.name, 3)
    reader = fmt.SegmentReader(pfs.get(skey))
    victim = fmt.shard_key(cfg.name, 3, 1)
    entries = {n: reader.read(n) for n in reader.names() if n != victim}
    pfs.put(skey, fmt.encode_segment(entries, meta=reader.meta))
    regs = rst.load_rank_regions(fresh, cfg.name, 3, 1)
    assert regs["w"].tobytes() == w[1].tobytes()


# ---------------------------------------------------------------------------
# KVTier log-structured journal
# ---------------------------------------------------------------------------


def test_kv_journal_single_log_file(tmp_path):
    jdir = str(tmp_path / "j")
    kv = KVTier(journal=jdir)
    for i in range(20):
        kv.put(f"k{i}", f"value-{i}".encode())
    kv.delete("k3")
    kv.put("k5", b"rewritten")
    files = sorted(os.listdir(jdir))
    assert files == ["log"]  # ONE file, not one per key
    kv2 = KVTier(journal=jdir)
    assert kv2.get("k3") is None
    assert kv2.get("k5") == b"rewritten"
    assert kv2.get("k7") == b"value-7"
    assert len(kv2.keys()) == 19


def test_kv_journal_compaction_folds_log(tmp_path):
    jdir = str(tmp_path / "j")
    kv = KVTier(journal=jdir, compact_every=10)
    for i in range(25):  # crosses the compaction threshold twice
        kv.put(f"k{i % 7}", f"v{i}".encode())
    assert os.path.exists(os.path.join(jdir, "snapshot"))
    # the log was truncated at the last fold: far smaller than 25 records
    assert os.path.getsize(os.path.join(jdir, "log")) < \
        25 * len(fmt.encode_log_record("k0", b"v00"))
    kv2 = KVTier(journal=jdir)
    assert not kv2.journal_skipped
    for i in range(7):
        last = max(j for j in range(25) if j % 7 == i)
        assert kv2.get(f"k{i}") == f"v{last}".encode()


def test_kv_journal_migrates_legacy_per_key_files(tmp_path):
    from repro_torch.core.storage import KV_JOURNAL_MAGIC
    from repro_torch.core.storage import escape_key
    from repro_torch.kernels import ops as kops

    jdir = str(tmp_path / "j")
    os.makedirs(jdir)
    # hand-write a legacy (pre-log) per-key journal entry
    data = b"legacy-payload"
    with open(os.path.join(jdir, escape_key("old/key")), "wb") as f:
        f.write(KV_JOURNAL_MAGIC + kops.digest(data).encode("ascii") + data)
    kv = KVTier(journal=jdir, compact_every=2)
    assert kv.get("old/key") == data
    kv.put("new", b"x")
    kv.put("new2", b"y")  # triggers compaction -> legacy file absorbed
    assert sorted(os.listdir(jdir)) == ["log", "snapshot"]
    kv2 = KVTier(journal=jdir)
    assert kv2.get("old/key") == data and kv2.get("new2") == b"y"


def test_kv_journal_torn_tail_skipped(tmp_path):
    jdir = str(tmp_path / "j")
    kv = KVTier(journal=jdir)
    kv.put("a", b"payload-a")
    kv.put("b", b"payload-b")
    log = os.path.join(jdir, "log")
    blob = open(log, "rb").read()
    open(log, "wb").write(blob[:-4])  # crash mid-append
    kv2 = KVTier(journal=jdir)
    assert kv2.get("a") == b"payload-a"
    assert kv2.get("b") is None
    assert any("torn" in s for s in kv2.journal_skipped)
    # regression: the torn tail is truncated on load, so records appended
    # AFTER the crash stay reachable on the next reload (appending behind
    # a torn frame used to strand them — the scanner stops at bad bytes)
    kv2.put("c", b"payload-c")
    kv3 = KVTier(journal=jdir)
    assert kv3.get("a") == b"payload-a"
    assert kv3.get("c") == b"payload-c"
    assert not any("torn" in s for s in kv3.journal_skipped)
