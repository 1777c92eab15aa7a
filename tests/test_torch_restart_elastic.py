"""Restart/recovery matrix over failure scenarios + elastic re-partitioning
(multi-rank cluster simulated in-process; numpy states).

The JAX package's ``tests/test_restart_elastic.py`` run against
``repro_torch``, its imports swapped, on the plain CPU versions of the
kernels."""
import numpy as np
import pytest

from repro_torch.core import Cluster, VelocClient, VelocConfig
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


def _states(nranks, n=500):
    return [{"w": np.full((n,), r, np.float32),
             "step": np.asarray(7 + r)} for r in range(nranks)]


def _ckpt_all(clients, states, version=1):
    for r, c in enumerate(clients):
        c.checkpoint(states[r], version=version, device_snapshot=False)


@pytest.mark.parametrize("fail,kw", [
    ([1], dict(partner=True, xor_group=0, flush=False)),           # partner
    ([2], dict(partner=False, xor_group=4, flush=False)),          # xor
    # one loss per group, avoiding parity homes (0 and 4): the host-level
    # module stores whole-group parity cross-group (losing a parity home +
    # a data rank of its protected group together is out of XOR's budget;
    # the device-level ring in core/partner.py stripes parity within the
    # group, SCR-style, and has no such coupling).
    ([1, 5], dict(partner=False, xor_group=4, flush=False)),       # xor, 2 groups
    ([1, 2], dict(partner=False, xor_group=4, rs_parity=2, flush=False)),  # RS
    ([0, 1, 2, 3], dict(partner=False, xor_group=0, flush=True)),  # L3 only
])
def test_recovery_matrix(tmp_path, fail, kw):
    nranks = 8
    cfg, cluster, clients = _cluster(tmp_path, nranks, **kw)
    states = _states(nranks)
    _ckpt_all(clients, states)
    for fr in fail:
        cluster.fail_node(fr)
    for r in range(nranks):
        regs = rst.load_rank_regions(cluster, cfg.name, 1, r)
        assert (regs["w"] == r).all(), (fail, kw, r)
        assert regs["step"] == 7 + r


def test_unrecoverable_raises(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 4, partner=False, xor_group=4,
                                     flush=False)
    _ckpt_all(clients, _states(4))
    cluster.fail_node(1)
    cluster.fail_node(2)  # two losses in one XOR group: gone
    with pytest.raises(IOError):
        rst.load_rank_regions(cluster, cfg.name, 1, 1)


def test_restart_prefers_newest_version(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=True, xor_group=0,
                                     flush=True, keep_versions=5)
    states = _states(2)
    for v in (1, 2, 3):
        for r, c in enumerate(clients):
            st = {"w": states[r]["w"] + v, "step": np.asarray(v)}
            c.checkpoint(st, version=v, device_snapshot=False)
    found = rst.find_restart(cluster, cfg.name)
    assert found[0]["version"] == 3
    regs = rst.load_rank_regions(cluster, cfg.name, found[0]["version"], 0)
    assert regs["step"] == 3


def test_fallback_to_older_version_when_newest_torn(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=False, xor_group=0,
                                     flush=False, keep_versions=5)
    _ckpt_all(clients, _states(2), version=1)
    # version 2 only written by rank 0 (rank 1 "died mid-checkpoint"):
    clients[0].checkpoint(_states(2)[0], version=2, device_snapshot=False)
    # no complete manifest for v2 -> restart finds v1
    found = rst.find_restart(cluster, cfg.name)
    assert found[0]["version"] == 1


def test_gc_keeps_recent(tmp_path):
    cfg, cluster, clients = _cluster(tmp_path, 2, partner=False, xor_group=0,
                                     flush=True, keep_versions=2)
    for v in range(1, 6):
        _ckpt_all(clients, _states(2), version=v)
    assert cluster.fetch_shard(cfg.name, 5, 0) is not None
    assert cluster.fetch_shard(cfg.name, 1, 0) is None  # GC'd


# ---------------------------------------------------------------------------
# elastic re-partitioning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("old,new", [(4, 2), (2, 4), (4, 8), (8, 4)])
def test_elastic_resharding(old, new):
    glob = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    piece = 64 // old
    per_rank = {r: {"w": glob[r * piece:(r + 1) * piece],
                    "step": np.asarray(9)} for r in range(old)}
    out = rst.elastic_regions(per_rank, new)
    assert len(out) == new
    np.testing.assert_array_equal(
        np.concatenate([out[r]["w"] for r in range(new)], axis=0), glob)
    for r in range(new):
        assert out[r]["step"] == 9  # replicated region broadcast


def test_elastic_end_to_end(tmp_path):
    """Checkpoint with 4 ranks, restart with 2."""
    cfg, cluster, clients = _cluster(tmp_path, 4, partner=False, xor_group=0,
                                     flush=True)
    glob = np.arange(128, dtype=np.float32)
    for r, c in enumerate(clients):
        c.checkpoint({"w": glob[r * 32:(r + 1) * 32]}, version=1,
                     device_snapshot=False)
    per_rank = rst.load_all_regions(cluster, cfg.name, 1)
    new = rst.elastic_regions(per_rank, 2)
    np.testing.assert_array_equal(new[0]["w"], glob[:64])
    np.testing.assert_array_equal(new[1]["w"], glob[64:])


def test_elastic_scale_up_lands_on_mid_chain_delta(tmp_path):
    """Scale-up restart from a MID-CHAIN delta version: the overlay walk
    must resolve each rank's full bytes through the parent chain before
    re-sharding, and the re-shard must reflect exactly that version's
    state — not the tip's, not the base's (groundwork for delta-aware
    elastic restart)."""
    old_n, new_n = 4, 8
    cfg, cluster, clients = _cluster(tmp_path, old_n, delta=True,
                                     delta_chunk_bytes=1024, partner=False,
                                     xor_group=0, flush=True, keep_versions=10)
    rows, cols = 64, 256  # 16 KiB per old-rank shard: a dirtied row is one
    #                         1 KiB chunk, well under the delta cutoff
    glob = {1: np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)}
    piece = rows // old_n
    for v in (2, 3, 4):  # sparse dirty steps -> delta shards
        g = glob[v - 1].copy()
        g[(v * 7) % rows, :] += 100.0 * v
        glob[v] = g
    for v in (1, 2, 3, 4):
        for r, c in enumerate(clients):
            fut = c.checkpoint(
                {"w": glob[v][r * piece:(r + 1) * piece],
                 "step": np.asarray(v)}, version=v, device_snapshot=False)
            assert not fut.module_errors, (v, r, fut.module_errors)
            if v >= 2:
                assert fut.results["delta_kind"] == "delta", (v, r)
    # land on v3: a delta whose parent (v2) is itself a delta over v1
    per_rank = rst.load_all_regions(cluster, cfg.name, 3)
    out = rst.elastic_regions(per_rank, new_n)
    assert len(out) == new_n
    np.testing.assert_array_equal(
        np.concatenate([out[r]["w"] for r in range(new_n)], axis=0), glob[3])
    new_piece = rows // new_n
    for r in range(new_n):
        assert out[r]["w"].shape == (new_piece, cols)
        assert out[r]["step"] == 3  # replicated region broadcast
    # same walk from a FRESH process (chain resolved via external tiers)
    fresh = Cluster(cfg, nranks=old_n)
    per_rank = rst.load_all_regions(fresh, cfg.name, 3)
    out = rst.elastic_regions(per_rank, new_n)
    np.testing.assert_array_equal(
        np.concatenate([out[r]["w"] for r in range(new_n)], axis=0), glob[3])
