"""Per-stream retention policy: ``keep=N`` and/or ``max_age_s``, their
interaction with delta chains (a kept delta pins its full base), rolling
packs, and the durable catalog across a fresh process.

The JAX package's ``tests/test_retention.py`` run against ``repro_torch``,
its imports swapped, on the plain CPU versions of the kernels."""
import time

import numpy as np
import pytest

from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core import concurrency as tconc
from repro_torch.core import format as fmt
from repro_torch.core import restart as rst
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


FUTURE = 3600.0  # "one hour later" clock override for age tests


def _cfg(tmp_path, name="ret", **kw):
    kw.setdefault("keep_versions", 0)
    return VelocConfig(name=name, scratch=str(tmp_path), mode="sync",
                       partner=False, xor_group=0, **kw)


def _versions(cluster, name):
    return sorted({v for (n, v, _l) in cluster._registry if n == name})


def _run(client, n, base=1000):
    states = {}
    for v in range(1, n + 1):
        w = np.full(base, float(v), np.float32)
        client.checkpoint({"w": w}, version=v, device_snapshot=False)
        states[v] = w
    return states


# ---------------------------------------------------------------------------
# max_age_s basics
# ---------------------------------------------------------------------------


def test_max_age_retires_old_versions_keeps_newest(tmp_path):
    cfg = _cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    states = _run(client, 3)
    # an hour later, everything is past a 10s age limit — but the newest
    # version always survives
    cluster.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    assert _versions(cluster, cfg.name) == [3]
    assert cluster.fetch_shard(cfg.name, 1, 0) is None
    regs = rst.load_rank_regions(cluster, cfg.name, 3, 0)
    assert regs["w"].tobytes() == states[3].tobytes()


def test_young_versions_survive_age_gc(tmp_path):
    cfg = _cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    _run(client, 3)
    cluster.gc(cfg.name, 0, max_age_s=FUTURE)  # real clock: all young
    assert _versions(cluster, cfg.name) == [1, 2, 3]


def test_keep_and_age_compose(tmp_path):
    """keep bounds the count, age prunes inside the window: keep=3 of four
    versions, of which the two oldest survivors are over-age."""
    cfg = _cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    _run(client, 4)
    cluster.gc(cfg.name, 3, max_age_s=10.0, now=time.time() + FUTURE)
    assert _versions(cluster, cfg.name) == [4]


def test_unknown_timestamp_is_never_age_retired(tmp_path):
    """Conservative: a version whose creation time is unknown (no catalog,
    registry predates the stamp) is not age-eligible."""
    cfg = _cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    _run(client, 3)
    cluster._vtimes.clear()  # simulate versions of unknown age
    cluster.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    assert _versions(cluster, cfg.name) == [1, 2, 3]


def test_keep_zero_means_no_count_limit(tmp_path):
    """Regression for the keep=0 semantics change: age-only retention must
    not count-retire anything."""
    cfg = _cfg(tmp_path, keep_versions=0, max_age_s=FUTURE)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    _run(client, 4)  # every submit schedules an inline age-only gc
    assert _versions(cluster, cfg.name) == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# interaction with delta chains
# ---------------------------------------------------------------------------


def _delta_cfg(tmp_path, **kw):
    kw.setdefault("delta_max_chain", 8)
    return _cfg(tmp_path, delta=True, delta_chunk_bytes=4096,
                flush=True, **kw)


def _delta_run(client, n):
    rng = np.random.default_rng(3)
    w = rng.standard_normal(50_000).astype(np.float32)
    states = {}
    for v in range(1, n + 1):
        if v > 1:  # dirty ~1% contiguously so deltas stay deltas
            w = w.copy()
            lo = (v * 131) % (w.size - 500)
            w[lo:lo + 500] += 1.0
        client.checkpoint({"w": w}, version=v, device_snapshot=False)
        states[v] = w
    return states


def test_age_gc_pins_live_delta_chain(tmp_path):
    """Every ancestor of the surviving newest delta is over-age, but the
    chain refcount keeps them: a kept delta pins its full base."""
    cfg = _delta_cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    states = _delta_run(client, 4)  # v1 full, v2..v4 deltas
    cluster.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    assert _versions(cluster, cfg.name) == [1, 2, 3, 4]
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == states[4].tobytes()


def test_age_gc_drops_chain_after_compaction(tmp_path):
    """Once the newest version folds full (compact), its over-age
    ancestors lose their last reference and age out."""
    cfg = _delta_cfg(tmp_path)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    states = _delta_run(client, 4)
    assert client.compact() == 4
    cluster.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    assert _versions(cluster, cfg.name) == [4]
    regs = rst.load_rank_regions(cluster, cfg.name, 4, 0)
    assert regs["w"].tobytes() == states[4].tobytes()
    assert rst.chain_versions(cluster, cfg.name, 4) == [4]


# ---------------------------------------------------------------------------
# interaction with rolling packs + the durable catalog
# ---------------------------------------------------------------------------


def test_age_gc_repacks_surviving_pack_members(tmp_path):
    """Age-retired members of a shared rolling pack trigger a re-pack of
    the survivors; a fully-dead pack is deleted whole."""
    cfg = _delta_cfg(tmp_path, aggregate=True, pack_versions=2,
                     delta_max_chain=2, catalog=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    # chains [1,2,3] and [4,5,6]; packs [2,3] and [5,6]
    states = _delta_run(client, 6)
    client.shutdown()
    pfs = cluster.external_tiers[0]
    assert len(pfs.keys(fmt.pack_prefix(cfg.name))) == 2
    cluster.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    # chain [4,5,6] pins itself through the newest; [1,2,3] ages out
    assert _versions(cluster, cfg.name) == [4, 5, 6]
    packs = pfs.keys(fmt.pack_prefix(cfg.name))
    assert packs == [fmt.pack_key(cfg.name, 5)], packs
    regs = rst.load_rank_regions(cluster, cfg.name, 6, 0)
    assert regs["w"].tobytes() == states[6].tobytes()


def test_fresh_process_age_gc_via_catalog_ts(tmp_path):
    """The catalog record carries the version's creation time, so a FRESH
    process (empty registry, no _vtimes) can age-retire a previous run's
    versions — and the newest survives, restorable, with tombstones
    persisted."""
    cfg = _cfg(tmp_path, flush=True, catalog=True)
    cluster = Cluster(cfg, nranks=1)
    client = VelocClient(cfg, cluster)
    states = _run(client, 3, base=2000)
    client.shutdown()

    fresh = Cluster(cfg, nranks=1)
    fresh.gc(cfg.name, 0, max_age_s=10.0, now=time.time() + FUTURE)
    pfs = fresh.external_tiers[0]
    for v in (1, 2):
        assert not pfs.keys(fmt.version_prefix(cfg.name, v)), v
    cat = fmt.decode_catalog(pfs.get(fmt.catalog_key(cfg.name)))
    assert sorted(cat["versions"]) == [3]
    assert sorted(v for v, _s in cat["tombstones"]) == [1, 2]

    another = Cluster(cfg, nranks=1)
    c2 = VelocClient(cfg, another)
    v, state = c2.restart_latest({"w": np.zeros(2000, np.float32)})
    assert v == 3
    assert np.asarray(state["w"]).tobytes() == states[3].tobytes()


# ---------------------------------------------------------------------------
# per-stream independence
# ---------------------------------------------------------------------------


def test_retention_policies_are_per_stream(tmp_path):
    """Two streams on ONE cluster retain independently: keep=1 vs
    keep=3."""
    cfg_a = _cfg(tmp_path, name="short", keep_versions=1)
    cfg_b = _cfg(tmp_path, name="long", keep_versions=3)
    cluster = Cluster(cfg_a, nranks=1)
    a = VelocClient(cfg_a, cluster)
    b = VelocClient(cfg_b, cluster)
    _run(a, 4)
    _run(b, 4)
    # client gc keeps keep_versions+1 (the newest N plus the one just
    # submitted)
    assert _versions(cluster, "short") == [3, 4]
    assert _versions(cluster, "long") == [1, 2, 3, 4]
