"""Concurrent restore serving path: one-shot restore planning, parallel
chain-hop fetches through the bounded reader pool, and the single-flight
shared segment/pack blob cache.

Covers: N concurrent readers of the same mid-chain packed delta version
cost the external tier exactly ONE get per segment/pack blob (counter-
asserted, zero key listings on the catalog path); a flaky tier dropping
a hop mid-fetch fails at most that one reader and never poisons the
shared cache for the others; the planner removes per-hop manifest
re-resolution; ``chain_versions`` resolves chains from metadata with
zero shard-blob downloads (blob reads only for hops with no metadata at
all); chain-hop fetches genuinely overlap; and the ``ReaderPool`` /
cache-bound config knobs behave.

The JAX package's ``tests/test_restore_serving.py`` run against
``repro_torch``, its imports swapped, on the plain CPU versions of the
kernels."""
import threading

import numpy as np
import pytest

from torch_helpers import CountingTier, FlakyTier, wrap_external_tiers
from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
from repro_torch.core.backend import ReaderPool
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
    kw.setdefault("delta", True)
    kw.setdefault("delta_chunk_bytes", 4096)
    kw.setdefault("delta_max_chain", 16)
    return VelocConfig(scratch=str(tmp_path), **kw)


def _packed_cfg(tmp_path, **kw):
    kw.setdefault("aggregate", True)
    kw.setdefault("pack_versions", 2)
    kw.setdefault("catalog", True)
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


def _build(tmp_path, versions=5, **kw):
    cfg = _packed_cfg(tmp_path, **kw)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster, rank=0)
    states = _run(client, versions)
    client.shutdown()
    return cfg, states


def _fresh_external_only(cfg, **cluster_kw):
    """A fresh-process cluster whose node tiers are empty — every read
    must come from the external tier, like a restart on new hardware."""
    fresh = Cluster(cfg, nranks=1, **cluster_kw)
    for tiers in fresh._node_tiers:
        for t in tiers:
            t.wipe()
    return fresh


def _blob_keys(name, counts):
    """The segment/pack keys among a CountingTier's observed gets."""
    return [k for k in counts
            if k.startswith(fmt.pack_prefix(name))
            or k.endswith("/segment")]


def _serve(fn, readers):
    """Run ``fn(i)`` on N threads with a common start barrier; returns
    [(value, error), ...] in thread order."""
    barrier = threading.Barrier(readers)
    results = [None] * readers

    def worker(i):
        barrier.wait()
        try:
            results[i] = (fn(i), None)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            results[i] = (None, e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(readers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


# ---------------------------------------------------------------------------
# concurrent multi-reader matrix: shared cache, exactly-once fetches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("readers", [2, 8])
def test_concurrent_readers_fetch_each_blob_once(tmp_path, readers):
    """N readers restoring the same mid-chain packed delta version hit
    the external tier exactly once per segment/pack blob — and zero
    ``keys()`` listings on the catalog path."""
    cfg, states = _build(tmp_path, versions=5)
    fresh = _fresh_external_only(cfg)
    counting = wrap_external_tiers(fresh, CountingTier)

    target = 4  # mid-chain, lives inside a rolling pack
    out = _serve(lambda i: rst.load_rank_regions(fresh, cfg.name, target, 0),
                 readers)
    for regions, err in out:
        assert err is None, err
        assert regions["w"].tobytes() == states[target].tobytes()

    for t in counting:
        for key in _blob_keys(cfg.name, t.get_counts):
            assert t.get_counts[key] == 1, \
                f"{key} fetched {t.get_counts[key]}x by {readers} readers"
        assert t.keys_calls == 0, "catalog-first serving paid key listings"


def test_concurrent_restart_latest_shares_blobs(tmp_path):
    """The client-level entry point (plan built once per request) keeps
    the exactly-once blob property across concurrent readers."""
    cfg, states = _build(tmp_path, versions=5)
    fresh = _fresh_external_only(cfg)
    counting = wrap_external_tiers(fresh, CountingTier)
    clients = [VelocClient(cfg, fresh, rank=0) for _ in range(4)]

    def restore(i):
        return clients[i].restart_latest(
            {"w": np.zeros(50_000, np.float32)})

    out = _serve(restore, 4)
    for (got, err) in out:
        assert err is None, err
        v, state = got
        assert v == 5
        assert np.asarray(state["w"]).tobytes() == states[5].tobytes()
    for t in counting:
        for key in _blob_keys(cfg.name, t.get_counts):
            assert t.get_counts[key] == 1, (key, t.get_counts[key])


def test_flaky_hop_does_not_poison_shared_cache(tmp_path):
    """One reader losing a blob get mid-fetch must not cache the failure:
    at most that reader fails, every other reader (and a later retry)
    restores correctly, and the blob is re-fetched exactly once."""
    cfg, states = _build(tmp_path, versions=5)
    # resolve v5's pack key on a THROWAWAY cluster: the cluster under
    # test must start with a cold cache or the flake never fires
    pk = rst.plan_restore(Cluster(cfg, nranks=1), cfg.name).packs[5]
    fresh = _fresh_external_only(cfg)
    flaky = wrap_external_tiers(
        fresh, lambda t: FlakyTier(t, fail_gets=True, match=pk,
                                   fail_first=1))
    counting = wrap_external_tiers(fresh, CountingTier)

    out = _serve(lambda i: rst.load_rank_regions(fresh, cfg.name, 5, 0), 8)
    failures = [err for _, err in out if err is not None]
    assert len(failures) <= 1, failures
    oks = [regions for regions, err in out if err is None]
    assert len(oks) >= 7
    for regions in oks:
        assert regions["w"].tobytes() == states[5].tobytes()
    # the injected failure fired exactly once, and the single-flight
    # retry paid exactly one more get — not one per waiting reader
    assert sum(len(f.failed_gets) for f in flaky) == 1
    total = sum(t.get_counts.get(pk, 0) for t in counting)
    assert total == 2, f"pack re-fetched {total - 1}x after one failure"
    # the cache is healthy afterwards: a fresh reader is served from it
    regions = rst.load_rank_regions(fresh, cfg.name, 5, 0)
    assert regions["w"].tobytes() == states[5].tobytes()
    assert sum(t.get_counts.get(pk, 0) for t in counting) == 2


# ---------------------------------------------------------------------------
# planner: no per-hop manifest re-resolution, metadata-first chains
# ---------------------------------------------------------------------------


def test_load_resolves_manifests_once_not_per_hop(tmp_path):
    """A planned chain restore calls ``cluster.manifests`` exactly once
    (plan build) — the pre-planner walk re-resolved it twice per hop."""
    cfg, states = _build(tmp_path, versions=5)
    fresh = _fresh_external_only(cfg)
    calls = []
    inner = fresh.manifests
    fresh.manifests = lambda name: (calls.append(name), inner(name))[1]

    regions = rst.load_rank_regions(fresh, cfg.name, 5, 0)
    assert regions["w"].tobytes() == states[5].tobytes()
    assert len(calls) == 1, f"manifests re-resolved {len(calls)}x"


def test_chain_versions_zero_blob_reads_on_metadata_path(tmp_path):
    """With a plan in hand, ``chain_versions`` touches NO tier at all —
    parent links come from manifests/catalog records."""
    cfg, _ = _build(tmp_path, versions=5)
    fresh = _fresh_external_only(cfg)
    counting = wrap_external_tiers(fresh, CountingTier)
    plan = rst.plan_restore(fresh, cfg.name)
    before = {id(t): dict(t.get_counts) for t in counting}

    assert rst.chain_versions(fresh, cfg.name, 5, plan=plan) == \
        [5, 4, 3, 2, 1]
    assert rst.chain_versions(fresh, cfg.name, 4, plan=plan) == [4, 3, 2, 1]
    for t in counting:
        assert t.get_counts == before[id(t)], "metadata chain walk " \
            "performed tier gets"


def test_chain_versions_blob_fallback_for_unknown_hop(tmp_path):
    """A hop with no metadata anywhere (manifests deleted) falls back to
    reading THAT blob's parent pointer — and only that blob."""
    cfg, _ = _build(tmp_path, versions=3, aggregate=False, pack_versions=0,
                    catalog=False)
    pfs_scratch = Cluster(cfg, nranks=1)
    for t in pfs_scratch.external_tiers:
        for level in ("L1", "L2", "L3"):
            t.delete(fmt.manifest_key(cfg.name, 2) + f".{level}")
    fresh = _fresh_external_only(cfg)
    counting = wrap_external_tiers(fresh, CountingTier)

    assert rst.chain_versions(fresh, cfg.name, 3) == [3, 2, 1]
    shard = fmt.shard_key(cfg.name, 2, 0)
    for t in counting:
        for key, count in t.get_counts.items():
            if key == shard:
                assert count == 1
            else:
                assert not key.endswith("/shard_00000"), \
                    f"metadata-resolved hop fetched its blob: {key}"


def test_plan_restart_dict_contract_unchanged(tmp_path):
    """``plan_restart`` (the public dict view) still reports mode,
    newest-first candidates, full chains and pack locations."""
    cfg, _ = _build(tmp_path, versions=4)
    fresh = Cluster(cfg, nranks=1)
    plan = rst.plan_restart(fresh, cfg.name)
    assert plan["mode"] == "catalog"
    assert [c["version"] for c in plan["candidates"]] == [4, 3, 2, 1]
    assert plan["chains"][4] == [4, 3, 2, 1]
    assert set(plan["packs"]) == {2, 3, 4}


# ---------------------------------------------------------------------------
# reader pool: overlap, bounds, inline fallbacks
# ---------------------------------------------------------------------------


def test_chain_hop_fetches_overlap(tmp_path):
    """With a reader pool, the hops of one restore are in flight
    concurrently (the serial walk's per-hop latency no longer adds up)."""
    cfg, states = _build(tmp_path, versions=4, aggregate=False,
                         pack_versions=0, catalog=False)
    fresh = _fresh_external_only(cfg)
    counting = wrap_external_tiers(
        fresh, lambda t: CountingTier(t, hold_s=0.05))

    regions = rst.load_rank_regions(fresh, cfg.name, 4, 0)
    assert regions["w"].tobytes() == states[4].tobytes()
    assert max(t.max_inflight for t in counting) >= 2, \
        "chain hops were fetched strictly serially"


def test_serial_cluster_has_no_pool_and_still_restores(tmp_path):
    cfg, states = _build(tmp_path, versions=4)
    fresh = _fresh_external_only(cfg, restore_readers=1)
    assert fresh.reader_pool() is None
    regions = rst.load_rank_regions(fresh, cfg.name, 4, 0)
    assert regions["w"].tobytes() == states[4].tobytes()


def test_reader_pool_orders_results_and_defers_errors():
    pool = ReaderPool(3)
    try:
        def mk(i):
            def fn():
                if i == 2:
                    raise IOError(f"boom {i}")
                return i * 10
            return fn

        out = pool.run_all([mk(i) for i in range(5)])
        assert [v for v, _ in out] == [0, 10, None, 30, 40]
        assert [type(e) for _, e in out] == \
            [type(None), type(None), IOError, type(None), type(None)]

        # nested run_all from a worker runs inline — no deadlock
        def outer():
            return pool.run_all([lambda: 1, lambda: 2])

        nested = pool.run_all([outer, outer])
        assert [v for v, _ in nested] == [[(1, None), (2, None)]] * 2
    finally:
        pool.shutdown()


def test_restore_cache_bound_is_configurable(tmp_path):
    cfg, states = _build(tmp_path, versions=5)
    fresh = _fresh_external_only(cfg, restore_cache_blobs=2)
    assert fresh._segcache_max == 2
    regions = rst.load_rank_regions(fresh, cfg.name, 5, 0)
    assert regions["w"].tobytes() == states[5].tobytes()
    assert len(fresh._segcache) <= 2


# ---------------------------------------------------------------------------
# regression: republish refreshes stale direct manifest copies
# ---------------------------------------------------------------------------


def test_compact_refreshes_stale_direct_manifests(tmp_path):
    """A fresh-process compact() must clear parent/delta metadata in the
    DIRECT manifest copies too (all levels) — the stale pre-seal blobs
    used to survive beside the rewritten in-segment/pack manifests and
    win last-writer key-scan discovery (a regression pair)."""
    cfg, states = _build(tmp_path, versions=3, compact_threshold=0)
    fresh = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, fresh, rank=0)
    assert client.compact(3) == 3
    for t in fresh.external_tiers:
        for level in ("L1", "L3"):
            blob = t.get(fmt.manifest_key(cfg.name, 3) + f".{level}")
            if blob is None:
                continue  # level lives only inside the segment/pack
            m = fmt.parse_manifest(blob)
            assert m.get("parent") is None, (level, m)
            assert (m.get("meta", {}).get("delta") or {}).get("kind") \
                != "delta", (level, m)
    regions = rst.load_rank_regions(fresh, cfg.name, 3, 0)
    assert regions["w"].tobytes() == states[3].tobytes()
