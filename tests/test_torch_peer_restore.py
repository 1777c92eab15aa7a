"""Peer-assisted multi-source restore: per-tier read telemetry, adaptive
source ranking, partner-tier serving and hedged reads.

Covers: the ``StorageTier`` read-telemetry counters (EWMA get latency,
bytes served, miss/error streaks) and the ``read_cost`` ranking signal;
``Cluster.shard_sources`` enumerating every copy a shard could live in
(own node, partner node, consistent-hash peer seal copy, external
tiers); ``ReaderPool.hedged`` first-success semantics; the ranked-walk
scheduler's hedge attribution; a FULL restore (mid-chain delta hops +
packed versions) with L3 completely unavailable served from partner L2
copies with ZERO external gets; seal-time peer blob replication; hedged
restores staying byte-identical under an intermittently stalling
source; and the backend ``status()["tiers"]`` operator surface.

The JAX package's ``tests/test_peer_restore.py`` run against
``repro_torch``, its imports swapped, on the plain CPU versions of the
kernels."""
import time

import numpy as np

from torch_helpers import FlakyTier, WrappedTier, wrap_external_tiers, \
    wrap_node_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.backend import ReaderPool
from repro_torch.core.storage import DRAMTier
import pytest
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


def _delta_chain(tmp_path, nranks=2, versions=5, **kw):
    """Mid-chain delta + rolling-pack + catalog corpus, partner replicas
    on (the partner module direct-puts EVERY version's shard, packed
    deltas included, onto the partner rank's fastest node tier)."""
    kw.setdefault("partner", nranks >= 2)
    kw.setdefault("xor_group", 0)
    kw.setdefault("aggregate", True)
    kw.setdefault("pack_versions", 2)
    kw.setdefault("catalog", True)
    cfg, cluster, clients = _cluster(tmp_path, nranks, delta=True,
                                     delta_chunk_bytes=4096, flush=True,
                                     keep_versions=10, **kw)
    rng = np.random.default_rng(13)
    states = {}
    w = [rng.standard_normal(60_000).astype(np.float32) + r
         for r in range(nranks)]
    for v in range(1, versions + 1):
        for r, c in enumerate(clients):
            wv = w[r].copy()
            lo = (v * 997) % (wv.size - 1000)
            wv[lo:lo + 1000] += 1.0
            w[r] = wv
            states[(v, r)] = wv.copy()
            fut = c.checkpoint({"w": wv}, version=v, device_snapshot=False)
            assert not fut.module_errors, (v, r, fut.module_errors)
    return cfg, cluster, clients, states


# ---------------------------------------------------------------------------
# per-tier read telemetry + read_cost ranking signal
# ---------------------------------------------------------------------------


def test_tier_read_telemetry_counters():
    t = DRAMTier("d")
    t.put("k", b"x" * 100)
    assert t.ewma_get_s is None and t.bytes_read == 0
    assert t.get("k") == b"x" * 100
    assert t.ewma_get_s is not None and t.ewma_get_s > 0
    assert t.bytes_read == 100 and t.miss_streak == 0
    # misses grow the streak without counting bytes
    assert t.get("absent") is None
    assert t.get("absent") is None
    assert t.miss_streak == 2 and t.bytes_read == 100
    # a hit resets the miss streak
    t.get("k")
    assert t.miss_streak == 0
    stats = t.read_stats()
    assert stats["gets"] == 4 and stats["bytes"] == 200
    assert stats["ewma_get_ms"] > 0
    assert stats["hedge_wins"] == 0 and stats["hedge_losses"] == 0


def test_tier_error_streak_and_reset():
    class Exploding(DRAMTier):
        def _get(self, key):
            raise IOError("dead device")

    t = Exploding("x")
    for _ in range(2):
        try:
            t.get("k")
        except IOError:
            pass
    assert t.error_streak == 2
    healthy_cost = DRAMTier("h").read_cost()
    assert t.read_cost() > healthy_cost * 2  # error streak inflates cost
    t.hedge_wins = 3
    t.reset_io_counters()
    assert t.error_streak == 0 and t.hedge_wins == 0 and t.bytes_read == 0
    # the EWMA is a live latency estimate, not a phase counter: it survives
    assert t.ewma_get_s is not None


def test_read_cost_orders_fast_before_slow():
    fast, slow = DRAMTier("fast", gbps=100.0), DRAMTier("slow", gbps=0.5)
    assert fast.read_cost() < slow.read_cost()
    # observed latency dominates nominal bandwidth once measured
    fast.ewma_get_s = 0.5
    slow.ewma_get_s = 0.0001
    assert slow.read_cost() < fast.read_cost()
    # repeated misses demote a tier even when it is nominally fast
    hot = DRAMTier("hot", gbps=100.0)
    cold = DRAMTier("cold", gbps=100.0)
    for _ in range(8):
        cold.get("absent")
    assert cold.read_cost() > hot.read_cost()


# ---------------------------------------------------------------------------
# shard_sources: every copy a shard could live in, one probe thunk each
# ---------------------------------------------------------------------------


def test_shard_sources_enumerates_all_copies(tmp_path):
    cfg, cluster, clients, states = _delta_chain(
        tmp_path, nranks=2, versions=3, peer_seal_copies=True)
    srcs = cluster.shard_sources(cfg.name, 3, 0)
    kinds = [s["kind"] for s in srcs]
    assert kinds.count("local") == len(cluster.node_tiers(0))
    assert kinds.count("partner") == len(cluster.node_tiers(1))
    assert "peer-seal" in kinds and "external" in kinds
    # every source either misses or yields the rank's true shard bytes
    want = cluster.fetch_shard(cfg.name, 3, 0)
    assert want is not None
    hits = 0
    for s in srcs:
        got = s["fetch"]()
        if got is not None:
            assert got == want, s["kind"]
            hits += 1
    assert hits >= 2  # at least the local L1 copy and one other source


def test_plan_penalty_demotes_and_recovers():
    plan = rst.RestorePlan("s", "catalog", [], {}, {}, {}, set())
    t = DRAMTier("d")
    assert plan.penalty(t) == 1.0
    for _ in range(10):
        plan.note_source(t, False)
    assert plan.penalty(t) == rst.RestorePlan._PENALTY_CAP
    for _ in range(10):
        plan.note_source(t, True)
    assert plan.penalty(t) == 1.0


# ---------------------------------------------------------------------------
# ReaderPool.hedged: first success wins, single-flight preserved
# ---------------------------------------------------------------------------


def test_hedged_fast_primary_never_fires_hedge():
    pool = ReaderPool(2)
    try:
        fired_hedge = []
        value, winner, outcomes = pool.hedged(
            lambda: b"fast", lambda: fired_hedge.append(1) or b"hedge", 5.0)
        assert (value, winner, outcomes) == (b"fast", "primary", [])
        assert not fired_hedge
    finally:
        pool.shutdown()


def test_hedged_slow_primary_loses_to_hedge():
    pool = ReaderPool(2)
    try:
        def slow():
            time.sleep(0.5)
            return b"slow"
        value, winner, outcomes = pool.hedged(slow, lambda: b"hedge", 0.01)
        assert (value, winner, outcomes) == (b"hedge", "hedge", ["win"])
    finally:
        pool.shutdown()


def test_hedged_missing_hedge_waits_for_primary():
    pool = ReaderPool(2)
    try:
        def slowish():
            time.sleep(0.05)
            return b"primary"
        value, winner, outcomes = pool.hedged(slowish, lambda: None, 0.001)
        assert (value, winner, outcomes) == (b"primary", "primary", ["miss"])
    finally:
        pool.shutdown()


def test_hedged_escalates_past_empty_leg():
    # first hedge candidate misses instantly; the pool must escalate to
    # the second candidate instead of riding out the stalled primary
    pool = ReaderPool(2)
    try:
        def stalled():
            time.sleep(0.5)
            return b"slow"
        value, winner, outcomes = pool.hedged(
            stalled, [lambda: None, lambda: b"second"], 0.01)
        assert (value, winner) == (b"second", "hedge")
        assert outcomes == ["miss", "win"]
    finally:
        pool.shutdown()


def test_hedged_primary_error_propagates():
    pool = ReaderPool(2)
    try:
        def boom():
            raise IOError("dead")
        try:
            pool.hedged(boom, lambda: None, 5.0)
            raise AssertionError("expected IOError")
        except IOError:
            pass
    finally:
        pool.shutdown()


def test_ranked_walk_attributes_hedge_win(tmp_path):
    """The scheduler hedges to the next-ranked source when the primary
    overruns its budget, and attributes the win to the HEDGE tier's
    counters (the primary's exactly-once accounting is untouched)."""
    slow_t, fast_t = DRAMTier("slow"), DRAMTier("fast")
    slow_t.ewma_get_s = 0.001  # seeded: budget = 2 * 1ms
    fast_t.ewma_get_s = 0.002  # costlier estimate -> ranks second

    def slow_fetch():
        time.sleep(0.3)
        return b"data"

    sources = [
        {"tier": slow_t, "kind": "a", "fetch": slow_fetch},
        {"tier": fast_t, "kind": "b", "fetch": lambda: b"data"},
    ]
    pool = ReaderPool(2)

    class Shim:
        restore_hedge_factor = 2.0

        def reader_pool(self):
            return pool

    try:
        got = rst._fetch_ranked(Shim(), sources, lambda b: b, None)
        assert got == b"data"
        assert fast_t.hedge_wins == 1 and fast_t.hedge_losses == 0
        assert slow_t.hedge_wins == 0
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# fault injection: restore with L3 completely unavailable
# ---------------------------------------------------------------------------


def test_full_restore_from_partner_with_l3_down(tmp_path):
    """Node 0 lost AND the external tier completely dead: a full
    mid-chain restore (delta hops through packed versions) is served
    entirely from the partner rank's L2 copies — zero external gets."""
    cfg, cluster, clients, states = _delta_chain(tmp_path, nranks=2,
                                                 versions=5)
    plan = rst.plan_restore(cluster, cfg.name)  # built while healthy
    assert plan.mode == "catalog"
    cluster.fail_node(0)
    flaky = wrap_external_tiers(
        cluster, lambda t: FlakyTier(t, fail_gets=True))
    baseline = [f.inner.get_calls for f in flaky]  # pre-restore gets
    for v in (4, 5):  # v4 is mid-chain and lives inside a rolling pack
        regs = rst.load_rank_regions(cluster, cfg.name, v, 0, plan=plan)
        assert regs["w"].tobytes() == states[(v, 0)].tobytes(), v
    # "zero L3 get_calls": the dead tier was never even probed
    for f, before in zip(flaky, baseline):
        assert f.failed_gets == [], f.failed_gets
        assert f.inner.get_calls == before


def test_peer_seal_copy_written_and_served(tmp_path):
    """With ``peer_seal_copies`` on, every sealed segment/pack blob also
    lands on its consistent-hash home node's fastest tier, and
    ``fetch_partner_copy`` serves shard entries out of that copy after
    the direct ``.partner`` replicas are gone."""
    cfg, cluster, clients, states = _delta_chain(
        tmp_path, nranks=2, versions=2, peer_seal_copies=True)
    skey = fmt.segment_key(cfg.name, 1)
    with cluster._lock:
        packed = cluster._packed.get((cfg.name, 1))
    skey = packed if packed is not None else skey
    home = cluster._peer_seal_home(skey)
    assert cluster.node_tiers(home)[0].get(skey) is not None
    # drop the direct partner replicas: the blob copy still serves reads
    for r in range(2):
        for t in cluster.node_tiers(r):
            for k in list(t.keys(cfg.name)):
                if k.endswith(".partner"):
                    t.delete(k)
    for r in range(2):
        got = cluster.fetch_partner_copy(cfg.name, 1, r, 1)
        want = cluster.fetch_shard(cfg.name, 1, r)
        assert got is not None and got == want


# ---------------------------------------------------------------------------
# hedged restore end to end: byte-identical under an intermittent staller
# ---------------------------------------------------------------------------


class IntermittentSlowTier(WrappedTier):
    """Every ``every``-th get stalls ``delay_s`` — a degraded-but-alive
    device (throttled NVMe, contended PFS client) rather than a dead one.
    Overrides ``_get`` so the wrapper's own telemetry template observes
    the stalls (that is what arms the hedge budget)."""

    def __init__(self, inner, *, every=3, delay_s=0.05):
        super().__init__(inner)
        self.every = every
        self.delay_s = delay_s
        self.slow_gets = 0

    def _get(self, key):
        if self.get_calls % self.every == 0:
            self.slow_gets += 1
            time.sleep(self.delay_s)
        return self.inner.get(key)


def test_hedged_restore_byte_identical(tmp_path):
    """An intermittently stalling primary source with hedging on: the
    restore stays byte-identical, and the hedge leg demonstrably fired
    (wins or losses recorded on the next-ranked tiers)."""
    cfg, cluster, clients, states = _delta_chain(
        tmp_path, nranks=2, versions=4, restore_hedge_factor=2.0)
    cluster.fail_node(0)  # rank 0 served from partner (rank 1) tiers
    stallers = wrap_node_tiers(
        cluster, 1, lambda t: IntermittentSlowTier(t, every=2,
                                                   delay_s=0.04))
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == states[(4, 0)].tobytes()
    assert any(s.slow_gets for s in stallers)
    fired = sum(t.hedge_wins + t.hedge_losses
                for ts in cluster._node_tiers for t in ts) + \
        sum(getattr(t, "hedge_wins", 0) + getattr(t, "hedge_losses", 0)
            for t in cluster.external_tiers)
    assert fired > 0, "hedge never fired despite stalling primary"


def test_hedging_off_keeps_exactly_once(tmp_path):
    """Default config (hedge factor 0): no hedge threads, no extra gets —
    the hedge counters across the whole fabric stay zero."""
    cfg, cluster, clients, states = _delta_chain(tmp_path, nranks=2,
                                                 versions=3)
    regs = rst.load_rank_regions(cluster, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[(3, 0)].tobytes()
    for name, stats in cluster.tier_read_stats().items():
        assert stats["hedge_wins"] == 0 and stats["hedge_losses"] == 0, name


# ---------------------------------------------------------------------------
# operator surface: per-tier read stats through backend.status()
# ---------------------------------------------------------------------------


def test_backend_status_reports_tier_read_stats(tmp_path):
    cfg = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                      xor_group=0, flush=True, catalog=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    try:
        w = np.arange(1000, dtype=np.float32)
        client.checkpoint({"w": w}, version=1, device_snapshot=False).wait()
        rst.load_rank_regions(cluster, cfg.name, 1, 0)
        snap = client.backend.status()
        assert "tiers" in snap and snap["tiers"]
        read_any = False
        for key, stats in snap["tiers"].items():
            for field in ("gets", "bytes", "ewma_get_ms",
                          "hedge_wins", "hedge_losses"):
                assert field in stats, (key, field)
            read_any = read_any or stats["gets"] > 0
        assert read_any
        assert any(k.startswith("node0/") for k in snap["tiers"])
    finally:
        client.shutdown()
