"""Multi-tenant backend coverage: per-stream lanes with deficit-weighted
fair dispatch, admission control (high-water marks -> skipped-with-
diagnostic), per-stream rate budgets carved from the global limiter, the
shared Cluster+ActiveBackend configuration, and the per-lane counters in
``ActiveBackend.status()``.

The JAX package's ``tests/test_multitenant.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import threading
import time

import numpy as np
import pytest

from torch_helpers import StallingTier, wrap_external_tiers
from repro_torch.core import (ActiveBackend, AdmissionError, Cluster,
                              RateLimiter, VelocClient, VelocConfig)
from repro_torch.core import restart as rst
from repro_torch.core.pipeline import PipelineSpec
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


def _drain(b):
    b.shutdown()


# ---------------------------------------------------------------------------
# lane dispatch fairness
# ---------------------------------------------------------------------------


def test_lane_round_robin_dispatch():
    """Equal-weight lanes alternate: with one worker and two backlogged
    streams, dispatch interleaves a/b instead of draining a's whole
    backlog first (the old single-heap FIFO behaviour)."""
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    order = []
    b.submit("jam", 0, lambda: gate.wait(10), stream="jam")
    time.sleep(0.05)  # the jam task occupies the only worker
    for v in range(1, 4):
        b.submit("ka", v, lambda v=v: order.append(("a", v)), stream="a")
    for v in range(1, 4):
        b.submit("kb", v, lambda v=v: order.append(("b", v)), stream="b")
    gate.set()
    assert b.wait(timeout=10)
    assert order == [("a", 1), ("b", 1), ("a", 2), ("b", 2),
                     ("a", 3), ("b", 3)]
    _drain(b)


def test_lane_weighted_dispatch():
    """A weight-2 lane is served ~twice as often as a weight-1 lane while
    both have work, and the light lane is never starved."""
    b = ActiveBackend(workers=1)
    b.configure_stream("heavy", weight=2.0)
    b.configure_stream("light", weight=1.0)
    gate = threading.Event()
    order = []
    b.submit("jam", 0, lambda: gate.wait(10), stream="jam")
    time.sleep(0.05)
    for v in range(1, 10):
        b.submit("kh", v, lambda: order.append("heavy"), stream="heavy")
    for v in range(1, 10):
        b.submit("kl", v, lambda: order.append("light"), stream="light")
    gate.set()
    assert b.wait(timeout=10)
    first9 = order[:9]
    assert first9.count("heavy") > first9.count("light")
    assert first9.count("light") >= 2  # fairness floor: no starvation
    _drain(b)


def test_priority_order_preserved_within_lane():
    """Within one lane the historical (priority, seq) order still holds."""
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    order = []
    b.submit("jam", 0, lambda: gate.wait(10), stream="s")
    time.sleep(0.05)
    b.submit("low", 1, lambda: order.append("low"), priority=90, stream="s")
    b.submit("high", 2, lambda: order.append("high"), priority=5, stream="s")
    gate.set()
    assert b.wait(timeout=10)
    assert order == ["high", "low"]
    _drain(b)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_rejects_over_task_high_water():
    b = ActiveBackend(workers=1)
    b.configure_stream("s", max_queued=2)
    gate = threading.Event()
    b.submit("k", 1, lambda: gate.wait(10), stream="s")
    time.sleep(0.05)  # running: depth 1
    b.submit("k2", 2, lambda: None, stream="s")  # queued: depth 2
    with pytest.raises(AdmissionError) as ei:
        b.submit("k3", 3, lambda: None, stream="s")
    assert "max_queued=2" in str(ei.value)
    assert ei.value.stream == "s"
    lanes = b.status()["lanes"]
    assert lanes["s"]["rejected"] == 1
    assert lanes["s"]["admitted"] == 2
    gate.set()
    assert b.wait(timeout=10)
    _drain(b)


def test_admission_rejects_over_byte_high_water():
    b = ActiveBackend(workers=1)
    b.configure_stream("s", max_queued_bytes=100)
    gate = threading.Event()
    b.submit("k", 1, lambda: gate.wait(10), stream="s", nbytes=1000)
    time.sleep(0.05)  # running tasks don't count queued bytes
    b.submit("k2", 2, lambda: None, stream="s", nbytes=80)
    with pytest.raises(AdmissionError) as ei:
        b.submit("k3", 3, lambda: None, stream="s", nbytes=30)
    assert "max_queued_bytes=100" in str(ei.value)
    assert b.status()["lanes"]["s"]["rejected"] == 1
    gate.set()
    assert b.wait(timeout=10)
    _drain(b)


def test_admission_checked_after_supersede_frees_slot():
    """Superseding the queued older version frees its slot first — a
    stream that keeps only the newest queued version is not rejected."""
    b = ActiveBackend(workers=1)
    b.configure_stream("s", max_queued=2)
    gate = threading.Event()
    b.submit("k", 1, lambda: gate.wait(10), stream="s")
    time.sleep(0.05)
    b.submit("k", 2, lambda: None, stream="s", supersede=True)
    # v3 supersedes v2 in place: depth stays 2, no rejection
    b.submit("k", 3, lambda: None, stream="s", supersede=True)
    assert b.status()["lanes"]["s"]["rejected"] == 0
    assert b.status("k", 2) == "superseded"
    gate.set()
    assert b.wait(timeout=10)
    _drain(b)


def test_client_admission_resolves_skipped(tmp_path):
    """End to end: a wedged external tier backs up stream A; once its lane
    hits the high-water mark, ``checkpoint()`` resolves *skipped* with an
    admission diagnostic (the IntervalModule contract) instead of queueing
    behind the wedge."""
    cfg = VelocConfig(name="adm", scratch=str(tmp_path), mode="async",
                      backend_workers=1, partner=False, xor_group=0,
                      keep_versions=0, admit_max_queued=1)
    cluster = Cluster(cfg, nranks=1)
    stallers = wrap_external_tiers(
        cluster, lambda t: StallingTier(t, match="adm/"))
    client = VelocClient(cfg, cluster)
    state = {"w": np.arange(512, dtype=np.float32)}
    fut1 = client.checkpoint(state, version=1, device_snapshot=False)
    deadline = time.monotonic() + 10
    while not any(s.stalled for s in stallers):  # v1 is wedged in its put
        assert time.monotonic() < deadline
        time.sleep(0.01)
    fut2 = client.checkpoint(state, version=2, device_snapshot=False)
    assert fut2.skipped
    assert fut2.results["skip_reason"] == "admission"
    assert "high-water" in fut2.results["admission"]
    assert client.backend.status()["lanes"]["adm"]["rejected"] == 1
    row = next(r for r in client._history if r["version"] == 2)
    for s in stallers:
        s.release()
    assert fut1.result(timeout=30)
    assert row["status"] == "skipped"
    client.shutdown()


# ---------------------------------------------------------------------------
# per-stream rate budgets
# ---------------------------------------------------------------------------


def test_lane_rate_share_carves_global_budget():
    b = ActiveBackend(workers=1, rate_limiter=RateLimiter(1000.0))
    b.configure_stream("half", rate_share=0.5)
    b.configure_stream("explicit", rate_bps=123.0)
    b.configure_stream("unbounded")
    assert b.lane_limiter("half").rate == 500.0
    assert b.lane_limiter("explicit").rate == 123.0
    assert b.lane_limiter("unbounded") is None
    assert b.lane_limiter("never-configured") is None
    st = b.status()["lanes"]
    assert st["half"]["rate_bps"] == 500.0
    with pytest.raises(ValueError):
        b.configure_stream("both", rate_bps=1.0, rate_share=0.5)
    with pytest.raises(ValueError):
        b.configure_stream("bad-share", rate_share=1.5)
    with pytest.raises(ValueError):
        b.configure_stream("bad-weight", weight=0.0)
    _drain(b)


def test_rate_share_of_unlimited_global_is_unlimited():
    b = ActiveBackend(workers=1)  # no global rate
    b.configure_stream("s", rate_share=0.25)
    assert b.lane_limiter("s") is None
    _drain(b)


def test_flush_charges_lane_budget(tmp_path):
    """With a lane budget configured, flushed bytes drain the stream's
    private token bucket (on top of the shared global bucket)."""
    cfg = VelocConfig(name="paced", scratch=str(tmp_path), mode="async",
                      backend_workers=1, partner=False, xor_group=0,
                      keep_versions=0, lane_rate_bps=200e6)
    client = VelocClient(cfg, Cluster(cfg, nranks=1))
    lim = client.backend.lane_limiter("paced")
    tokens0 = lim._tokens
    state = {"w": np.zeros(4096, dtype=np.float32)}
    fut = client.checkpoint(state, version=1, device_snapshot=False)
    assert fut.result(timeout=30)
    assert lim._tokens < tokens0  # shard bytes were charged to the lane
    client.shutdown()


# ---------------------------------------------------------------------------
# shared Cluster + backend (the multi-tenant configuration)
# ---------------------------------------------------------------------------


def _tenant_cfg(tmp_path, name, **kw):
    return VelocConfig(name=name, scratch=str(tmp_path), mode="async",
                       partner=False, xor_group=0, keep_versions=0, **kw)


def test_two_tenants_share_cluster_and_backend(tmp_path):
    cfg_a = _tenant_cfg(tmp_path, "tenant-a", backend_workers=2)
    cfg_b = _tenant_cfg(tmp_path, "tenant-b", lane_weight=2.0)
    cluster = Cluster(cfg_a, nranks=1)
    a = VelocClient(cfg_a, cluster)
    b = VelocClient(cfg_b, cluster, backend=a.backend)
    assert b.backend is a.backend
    sa = {"w": np.full(256, 1.0, np.float32)}
    sb = {"w": np.full(256, 2.0, np.float32)}
    assert a.checkpoint(sa, version=1, device_snapshot=False).result(30)
    assert b.checkpoint(sb, version=1, device_snapshot=False).result(30)
    lanes = a.backend.status()["lanes"]
    assert lanes["tenant-a"]["dispatched"] >= 1
    assert lanes["tenant-b"]["dispatched"] >= 1
    assert lanes["tenant-b"]["weight"] == 2.0
    va, ra = a.restart_latest({"w": np.zeros(256, np.float32)})
    vb, rb = b.restart_latest({"w": np.zeros(256, np.float32)})
    assert (va, vb) == (1, 1)
    assert (ra["w"] == 1.0).all() and (rb["w"] == 2.0).all()
    # non-owner shutdown drains b's lane but leaves the backend running
    b.shutdown()
    assert not a.backend._stop
    assert a.checkpoint(sa, version=2, device_snapshot=False).result(30)
    a.shutdown()


def test_shared_backend_requires_async():
    b = ActiveBackend(workers=1)
    with pytest.raises(ValueError, match="async"):
        VelocClient(PipelineSpec(name="s", mode="sync"), backend=b,
                    scratch="/tmp/veloc-mt-sync")
    _drain(b)


def test_same_stream_ranks_share_backend(tmp_path):
    """The ranks of ONE stream can also share a backend: their pipe task
    kinds differ by rank, so supersede/wait semantics stay per-rank."""
    cfg = _tenant_cfg(tmp_path, "ranks", backend_workers=2)
    cluster = Cluster(cfg, nranks=2)
    c0 = VelocClient(cfg, cluster, rank=0)
    c1 = VelocClient(cfg, cluster, rank=1, backend=c0.backend)
    states = [{"w": np.full(128, r, np.float32)} for r in range(2)]
    futs = [c.checkpoint(states[r], version=1, device_snapshot=False)
            for r, c in enumerate((c0, c1))]
    assert all(f.result(30) for f in futs)
    for r in range(2):
        regs = rst.load_rank_regions(cluster, cfg.name, 1, r)
        assert (regs["w"] == r).all()
    c1.shutdown()
    c0.shutdown()


# ---------------------------------------------------------------------------
# config validation + status counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"lane_weight": 0.0},
    {"lane_weight": -1.0},
    {"max_age_s": 0.0},
    {"max_age_s": -5.0},
    {"keep_versions": -1},
    {"lane_rate_bps": -1.0},
    {"lane_rate_share": 0.0},
    {"lane_rate_share": 1.5},
    {"lane_rate_bps": 1.0, "lane_rate_share": 0.5},
    {"admit_max_queued": 0},
    {"admit_max_queued_bytes": 0},
])
def test_tenant_knob_validation_rejects(kw):
    with pytest.raises(ValueError):
        PipelineSpec(name="bad", **kw).compile(backend=None)


def test_status_exposes_lane_counters():
    b = ActiveBackend(workers=1)
    gate = threading.Event()
    b.submit("k", 1, lambda: gate.wait(10), stream="s", nbytes=11)
    time.sleep(0.05)
    b.submit("k2", 2, lambda: None, stream="s", nbytes=7)
    snap = b.status()
    lane = snap["lanes"]["s"]
    assert lane["queued"] == 1 and lane["queued_bytes"] == 7
    assert lane["running"] == 1
    assert lane["admitted"] == 2 and lane["rejected"] == 0
    assert snap["queued"] == 1  # backend-wide total still reported
    gate.set()
    assert b.wait(timeout=10)
    lane = b.status()["lanes"]["s"]
    assert lane["queued"] == 0 and lane["queued_bytes"] == 0
    assert lane["dispatched"] == 2
    assert lane["wait_max_s"] >= lane["wait_total_s"] / 2 >= 0.0
    _drain(b)
