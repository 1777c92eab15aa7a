"""Concurrency contract checker: runtime prong (tracked locks,
IO-under-lock) + static prong (tools/check_concurrency.py), seeded with
reconstructions of three historical bugs fixed in review.

The JAX package's ``tests/test_concurrency.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import concurrency
from repro_torch.core.api import Cluster, VelocClient, VelocConfig
from repro_torch.core.backend import ActiveBackend
from repro_torch.core.concurrency import (IOUnderLockError, LockOrderError,
                                          TrackedCondition, TrackedLock,
                                          TrackedRLock)
from repro_torch.core.storage import DRAMTier, FileTier, KVTier
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "tools", "check_concurrency.py")
sys.path.insert(0, os.path.join(REPO, "tools"))
import check_concurrency as lint  # noqa: E402


def _cluster(tmp_path, **cfg_kw):
    cfg_kw.setdefault("keep_versions", 10)
    cfg = VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                      xor_group=0, flush=True, **cfg_kw)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    return cfg, cluster, client


# ---------------------------------------------------------------------------
# tracked primitives
# ---------------------------------------------------------------------------


def test_disabled_tracker_is_passthrough():
    concurrency.disable()
    try:
        inner = TrackedLock("t.inner", 10)
        outer = TrackedLock("t.outer", 20)
        # inverted nesting does NOT raise while disabled
        with outer:
            with inner:
                pass
        assert concurrency.violations() == []
        assert concurrency.lock_stats() == {}
    finally:
        concurrency.enable("raise")


def test_rank_inversion_raises_and_is_recorded():
    lo = TrackedLock("t.lo", 10)
    hi = TrackedLock("t.hi", 20)
    with lo:
        with hi:
            pass  # canonical direction is fine
    with hi:
        with pytest.raises(LockOrderError):
            lo.acquire()
    assert any("inversion" in v for v in concurrency.violations())
    concurrency.clear_violations()


def test_equal_rank_distinct_locks_refused():
    a = TrackedLock("t.a", 30)
    b = TrackedLock("t.b", 30)
    with a:
        with pytest.raises(LockOrderError):
            b.acquire()
    concurrency.clear_violations()


def test_self_deadlock_raises_instead_of_hanging():
    lk = TrackedLock("t.self", 10)
    with lk:
        with pytest.raises(LockOrderError, match="self-deadlock"):
            lk.acquire()
    concurrency.clear_violations()


def test_rlock_reentry_is_legal():
    lk = TrackedRLock("t.rlock", 10)
    with lk:
        with lk:
            assert lk.locked()
    assert not lk.locked()
    assert concurrency.violations() == []


def test_condition_wait_releases_held_entry():
    cv = TrackedCondition("t.cv", 40)
    tier_lock = TrackedLock("t.leaf", 60)
    woke = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            woke.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    # let the waiter block, then prove this thread can take the cv (the
    # waiter's held entry was dropped for the duration of wait())
    import time
    time.sleep(0.1)
    with cv:
        with tier_lock:  # rank 60 under 40: canonical
            pass
        cv.notify_all()
    t.join(timeout=5)
    assert woke and not t.is_alive()
    assert concurrency.violations() == []


def test_lock_stats_track_contention_and_hold_time():
    lk = TrackedLock("t.stats", 10)
    import time

    def holder():
        with lk:
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    with lk:
        t.start()
        time.sleep(0.05)
    t.join()
    st = concurrency.lock_stats()["t.stats"]
    assert st["acquisitions"] == 2
    assert st["contentions"] >= 1
    assert st["wait_s"] > 0
    assert st["hold_s"] > 0
    assert st["hold_max_s"] >= 0.04


def test_io_under_lock_only_flags_external_tiers(tmp_path):
    ext = FileTier(str(tmp_path / "pfs"), name="pfs", node_local=False)
    local = DRAMTier(name="dram0")
    guard = TrackedLock("t.cluster", concurrency.RANK_CLUSTER,
                        io_forbidden=True)
    with guard:
        local.put("k", b"x")  # node-local under the lock: allowed (L1)
        with pytest.raises(IOUnderLockError):
            ext.put("k", b"x")
        with pytest.raises(IOUnderLockError):
            ext.get("k")
        with pytest.raises(IOUnderLockError):
            ext.delete("k")
        with pytest.raises(IOUnderLockError):
            ext.keys()
    ext.put("k", b"x")  # lock released: fine
    assert ext.get("k") == b"x"
    concurrency.clear_violations()


def test_io_under_lock_warn_mode_records_without_raising(tmp_path):
    ext = FileTier(str(tmp_path / "pfs"), name="pfs", node_local=False)
    guard = TrackedLock("t.cluster2", concurrency.RANK_CLUSTER,
                        io_forbidden=True)
    concurrency.enable("raise", io_mode="warn")
    try:
        with guard:
            with pytest.warns(UserWarning):
                ext.put("k", b"x")
    finally:
        concurrency.enable("raise")
    assert any("IO-under-lock" in v for v in concurrency.violations())
    concurrency.clear_violations()


# ---------------------------------------------------------------------------
# get/delete lifetime counters (satellite)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda p: DRAMTier(),
    lambda p: FileTier(str(p / "f")),
    lambda p: KVTier(),
])
def test_tier_get_delete_counters(tmp_path, make):
    t = make(tmp_path)
    assert (t.get_calls, t.delete_calls) == (0, 0)
    t.put("a", b"1")
    t.get("a")
    t.get("missing")
    t.delete("a")
    t.delete("missing")  # idempotent deletes still count
    assert t.get_calls == 2
    assert t.delete_calls == 2
    assert t.put_calls == 1


# ---------------------------------------------------------------------------
# historical bug reconstructions
# ---------------------------------------------------------------------------


def test_seal_put_under_cluster_lock_detected(tmp_path):
    """The aggregated write path first shipped with the segment seal put
    executed while still holding the cluster lock (fixed in review: the
    seal moved outside).  Re-create that shape: the detector raises."""
    cfg, cluster, client = _cluster(tmp_path, aggregate=True)
    client.checkpoint({"w": np.zeros(64, np.float32)}, version=1,
                      device_snapshot=False)
    ext = cluster.external_tiers[0]
    with cluster._lock:  # the buggy seal ran exactly here
        with pytest.raises(IOUnderLockError):
            ext.put("ckpt/seal-under-lock", b"segment-bytes")
    concurrency.clear_violations()


def test_republish_hydration_self_deadlock_detected(tmp_path):
    """republish_manifest's hydration once held the cluster lock across
    manifests()/has_shard_record(), which re-acquire it — a fresh-process
    compact of a packed version self-deadlocked (hung forever).  With the
    checker on, the same shape raises immediately instead of hanging."""
    cfg, cluster, client = _cluster(tmp_path)
    client.checkpoint({"w": np.zeros(64, np.float32)}, version=1,
                      device_snapshot=False)
    with cluster._lock:
        with pytest.raises(LockOrderError, match="self-deadlock"):
            cluster.has_shard_record(cfg.name, 1, 0)
    concurrency.clear_violations()


def test_catalog_rmw_under_cluster_lock_detected(tmp_path):
    """The catalog's lesson: the per-stream catalog RMW is outermost —
    entering it while holding the cluster lock stalls every rank's
    staging behind external I/O (and inverts the canonical order).
    Re-create the inversion: sync_catalog under the cluster lock raises."""
    cfg, cluster, client = _cluster(tmp_path, aggregate=True, catalog=True)
    client.checkpoint({"w": np.zeros(64, np.float32)}, version=1,
                      device_snapshot=False)
    assert cluster.catalog_tiers(), "config should provision a catalog tier"
    with cluster._lock:
        with pytest.raises(LockOrderError):
            cluster.sync_catalog(cfg.name, force=True)
    concurrency.clear_violations()


# ---------------------------------------------------------------------------
# backend.status() lock-stats export
# ---------------------------------------------------------------------------


def test_backend_status_exports_lock_stats():
    b = ActiveBackend(workers=1)
    try:
        b.submit("k", 1, lambda: None)
        assert b.wait(timeout=10)
        snap = b.status()
        assert snap["queued"] == 0 and snap["running"] == []
        assert "backend._cv" in snap["locks"]
        assert snap["locks"]["backend._cv"]["acquisitions"] > 0
        # the two-arg form still answers per-task states
        assert b.status("k", 1) == "done"
        with pytest.raises(TypeError):
            b.status("k")
    finally:
        b.shutdown()


# ---------------------------------------------------------------------------
# static prong: AST lint
# ---------------------------------------------------------------------------

_BAD_FIXTURE = '''\
import threading
import time


class Cluster:
    def __init__(self):
        self._lock = threading.Lock()

    def seal(self, tier, key, blob):
        with self._lock:
            self._sealed = key
            tier.put(key, blob)

    def scan(self, ext_tier):
        with self._lock:
            return ext_tier.keys("ckpt/")

    def pace(self):
        with self._lock:
            time.sleep(0.1)

    def sweep(self):
        try:
            self.seal(None, "k", b"")
        except:
            pass
'''

_CLEAN_FIXTURE = '''\
import time

from repro_torch.core import concurrency


class Cluster:
    def __init__(self):
        self._lock = concurrency.TrackedLock("c", 20, io_forbidden=True)

    def seal(self, tier, key, blob):
        with self._lock:
            job = (key, blob)
        tier.put(*job)  # I/O outside the lock

    def defer(self, tier, key, blob):
        with self._lock:
            # nested defs run LATER, not under this with-block
            def publish():
                time.sleep(0.0)
                tier.put(key, blob)
        return publish
'''


def test_lint_flags_synthetic_tier_put_under_lock():
    vs = lint.check_source("fixture.py", _BAD_FIXTURE)
    rules = {v.rule for v in vs}
    assert "tier-io-under-lock" in rules
    assert "raw-lock" in rules
    assert "sleep-under-lock" in rules
    assert "swallowed-except" in rules
    io = [v for v in vs if v.rule == "tier-io-under-lock"]
    assert len(io) == 2  # the seal put and the keys scan
    assert all("tier" in v.message for v in io)


def test_lint_passes_clean_fixture():
    assert lint.check_source("fixture.py", _CLEAN_FIXTURE) == []


def test_lint_respects_suppression_comments():
    src = ("import threading\n"
           "lock = threading.Lock()  # noqa: tracked wrapper bootstrap\n"
           "other = threading.Lock()  # lint: allow\n")
    assert lint.check_source("fixture.py", src) == []
    src_hot = "import threading\nlock = threading.Lock()\n"
    assert [v.rule for v in lint.check_source("f.py", src_hot)] == ["raw-lock"]


def test_lint_clean_on_current_source_tree():
    vs = lint.check_paths([os.path.join(REPO, "src", "repro_torch"),
                           os.path.join(REPO, "tools")])
    assert vs == [], "\n".join(str(v) for v in vs)


def test_lint_cli_standalone(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_BAD_FIXTURE)
    r = subprocess.run([sys.executable, CHECKER, str(bad)],
                       capture_output=True, text=True)
    assert r.returncode == 1
    assert "tier-io-under-lock" in r.stdout
    r = subprocess.run([sys.executable, CHECKER,
                        os.path.join(REPO, "src", "repro_torch")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
