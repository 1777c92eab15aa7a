"""VELOC core unit tests: storage tiers, backend, engine pipeline, modules.

The JAX package's ``tests/test_core.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import threading
import time

import pytest

from repro_torch.core import concurrency as tconc
from repro_torch.core.backend import ActiveBackend, RateLimiter
from repro_torch.core.engine import Engine
from repro_torch.core.modules import CheckpointContext, IntervalModule, Module
from repro_torch.core.storage import DRAMTier, FileTier, KVTier, pick_tier
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
# storage
# ---------------------------------------------------------------------------


def test_tiers_roundtrip(tmp_path):
    tiers = [DRAMTier(), FileTier(str(tmp_path / "f")),
             KVTier(journal=str(tmp_path / "kv"))]
    for t in tiers:
        t.put("a/b", b"hello")
        assert t.get("a/b") == b"hello"
        assert t.exists("a/b")
        assert "a/b" in t.keys("a/")
        t.delete("a/b")
        assert t.get("a/b") is None


def test_file_tier_atomic_publish(tmp_path):
    t = FileTier(str(tmp_path))
    t.put("k", b"v1")
    t.put("k", b"v2")
    assert t.get("k") == b"v2"
    assert not any(k.endswith(".tmp") for k in t.keys())


def test_kv_tier_journal_survives_restart(tmp_path):
    j = str(tmp_path / "journal")
    t = KVTier(journal=j)
    t.put("x", b"123")
    t2 = KVTier(journal=j)  # "new process"
    assert t2.get("x") == b"123"


def test_pick_tier_prefers_fast_then_idle(tmp_path):
    fast = DRAMTier(gbps=100)
    slow = FileTier(str(tmp_path), gbps=5)
    assert pick_tier([fast, slow]) is fast
    # fast tier under producer-consumer pressure loses (paper [4])
    fast._inflight = 40
    assert pick_tier([fast, slow]) is slow
    # persistence requirement excludes DRAM
    fast._inflight = 0
    assert pick_tier([fast, slow], need_persistent=True) is slow


# ---------------------------------------------------------------------------
# rate limiter / backend
# ---------------------------------------------------------------------------


def test_rate_limiter_enforces_budget():
    clock = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        clock[0] += s

    rl = RateLimiter(1000.0, burst=1.0, clock=lambda: clock[0], sleep=sleep)
    rl.acquire(1000)  # consumes the initial burst
    rl.acquire(500)   # must wait ~0.5s
    assert sum(slept) >= 0.45


def test_backend_priority_and_wait():
    order = []
    b = ActiveBackend(workers=1)
    started, ev = threading.Event(), threading.Event()

    def first():
        started.set()
        ev.wait(5)
        order.append("first")

    b.submit("k", 0, first, priority=10)
    assert started.wait(5)  # worker is busy on "first"; queue the rest
    b.submit("k", 1, lambda: order.append("low"), priority=90)
    b.submit("k", 2, lambda: order.append("high"), priority=5)
    ev.set()
    assert b.wait(timeout=10)
    assert order == ["first", "high", "low"]
    b.shutdown()


def test_backend_supersede_drops_stale_versions():
    b = ActiveBackend(workers=1)
    ev = threading.Event()
    ran = []
    b.submit("flush", 1, lambda: ev.wait(5), priority=10)
    b.submit("flush", 2, lambda: ran.append(2), priority=50)
    b.submit("flush", 3, lambda: ran.append(3), priority=50, supersede=True)
    ev.set()
    assert b.wait(timeout=10)
    assert ran == [3]
    assert b.status("flush", 2) == "superseded"
    b.shutdown()


def test_backend_deadline_miss():
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    b.submit("x", 1, lambda: gate.wait(2), priority=1)
    b.submit("x", 2, lambda: None, priority=50, deadline_s=0.05)
    time.sleep(0.3)
    gate.set()
    b.wait(timeout=10)
    assert b.status("x", 2) == "deadline-miss"
    b.shutdown()


def test_backend_error_recorded_not_fatal():
    b = ActiveBackend(workers=1)

    def boom():
        raise RuntimeError("boom")

    b.submit("x", 1, boom)
    b.submit("x", 2, lambda: None)
    assert b.wait(timeout=10)
    assert b.status("x", 1) == "error"
    assert b.status("x", 2) == "done"
    assert "boom" in b.errors()[0]
    b.shutdown()


# ---------------------------------------------------------------------------
# engine pipeline semantics
# ---------------------------------------------------------------------------


class _Recorder(Module):
    def __init__(self, name, priority, log):
        self.name, self.priority, self.log = name, priority, log
        self.enabled = True

    def process(self, ctx):
        self.log.append(self.name)
        return "ok"


def _ctx():
    return CheckpointContext(name="t", version=1, rank=0, nranks=1,
                             regions=[], meta={}, cluster=None)


def test_engine_priority_order_and_switch():
    log = []
    mods = [_Recorder("c", 30, log), _Recorder("a", 1, log), _Recorder("b", 20, log)]
    eng = Engine(mods, backend=None, blocking_cut=100)
    eng.submit(_ctx())
    assert log == ["a", "b", "c"]
    # runtime module switch (the paper's "simple switch")
    log.clear()
    eng.set_enabled("b", False)
    eng.submit(_ctx())
    assert log == ["a", "c"]


def test_engine_async_split():
    log = []
    mods = [_Recorder("front", 1, log), _Recorder("back", 50, log)]
    backend = ActiveBackend(workers=1)
    eng = Engine(mods, backend, blocking_cut=10)
    eng.submit(_ctx())
    assert log[0] == "front"  # ran inline
    assert eng.wait("t", 0, 1, timeout=10)
    assert log == ["front", "back"]
    backend.shutdown()


def test_interval_module_skips_defensive_only():
    clock = [0.0]
    m = IntervalModule(100.0, clock=lambda: clock[0])
    c1 = _ctx()
    assert m.process(c1) == "ok"
    clock[0] = 50.0
    c2 = _ctx()
    assert m.process(c2) == "skip" and c2.skipped
    c3 = _ctx()
    c3.defensive = False  # productive checkpoints always pass
    assert m.process(c3) == "pass"
    clock[0] = 150.0
    assert m.process(_ctx()) == "ok"
