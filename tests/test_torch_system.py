"""The slice as a whole against the JAX package: the JAX smoke train state,
split over the 4 ranks of one XOR group, checkpointed through the default
``VelocConfig`` pipeline (serialize -> L1 -> partner -> XOR group -> L3) by
both packages.  Shards and parity are byte-identical, a checkpoint written
by either package restores through the other in a fresh ``Cluster`` over
the same scratch directory, and a rank whose node, partner and L3 copy are
all gone is rebuilt from parity to the same arrays in both packages."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import smoke_config
from repro.core import format as jfmt
from repro.train.steps import init_train_state as jax_init
import repro_torch.core as tcore
from repro_torch.core import concurrency as tconc
from repro_torch.core import format as tfmt
from repro_torch.kernels import ops
from repro_torch.train.steps import state_from_numpy

NRANKS = 4
NAME = "ckpt"


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


@pytest.fixture(scope="module")
def rank_states():
    """Per rank, a flat ``{path: numpy leaf}`` quarter of the JAX smoke
    train state (leaves dealt round-robin in path order)."""
    state = jax_init(jax.random.PRNGKey(0), smoke_config("veloc-demo-100m"))
    leaves = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path), np.asarray(leaf))
              for path, leaf in jax.tree_util.tree_leaves_with_path(state)]
    return [dict(leaves[r::NRANKS]) for r in range(NRANKS)]


_PKG = {"jax": (jcore, jfmt), "torch": (tcore, tfmt)}


def _as_input(pkg, state):
    return state if pkg == "jax" else state_from_numpy(state, "cpu")


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.numpy()
    return np.asarray(leaf)


def _checkpoint(pkg, scratch, states, mode="sync", version=1):
    core, _ = _PKG[pkg]
    cfg = core.VelocConfig(scratch=str(scratch), mode=mode)
    cluster = core.Cluster(cfg, nranks=NRANKS)
    clients = [core.VelocClient(cfg, cluster, rank=r) for r in range(NRANKS)]
    futs = [c.checkpoint(_as_input(pkg, states[r]), version=version)
            for r, c in enumerate(clients)]
    for c in clients:
        assert c.wait(timeout=60)
    for f in futs:
        assert not f.module_errors, f.module_errors
    return cluster, clients


def _restore(pkg, scratch, states, rank, clients=None):
    core, _ = _PKG[pkg]
    if clients is None:  # a fresh process: only persistent tiers survive
        cfg = core.VelocConfig(scratch=str(scratch), mode="sync")
        cluster = core.Cluster(cfg, nranks=NRANKS)
        client = core.VelocClient(cfg, cluster, rank=rank)
    else:
        client = clients[rank]
    version, state = client.restart_latest(_as_input(pkg, states[rank]))
    assert version == 1, client.restart_diagnostics
    return {k: _to_numpy(v) for k, v in state.items()}


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_shards_and_parity_identical(tmp_path, rank_states, mode):
    out = {}
    for pkg in _PKG:
        cluster, clients = _checkpoint(pkg, tmp_path / pkg, rank_states, mode)
        out[pkg] = ([cluster.fetch_shard(NAME, 1, r) for r in range(NRANKS)],
                    cluster.fetch_parity(NAME, 1, 0))
        for c in clients:
            c.shutdown()
    shards, parity = out["torch"]
    assert all(s is not None for s in shards) and parity is not None
    for r in range(NRANKS):
        assert shards[r] == out["jax"][0][r], f"rank {r} shard differs"
    assert parity == out["jax"][1]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_cross_package_restore(tmp_path, rank_states, writer, reader):
    _, clients = _checkpoint(writer, tmp_path, rank_states)
    for c in clients:
        c.shutdown()
    for r in range(NRANKS):
        got = _restore(reader, tmp_path, rank_states, r)
        assert sorted(got) == sorted(rank_states[r])
        for k, want in rank_states[r].items():
            np.testing.assert_array_equal(got[k], want)


def test_rank_rebuilt_from_parity_in_both_packages(tmp_path, rank_states):
    restored = {}
    for pkg in _PKG:
        _, fmt = _PKG[pkg]
        cluster, clients = _checkpoint(pkg, tmp_path / pkg, rank_states)
        cluster.fail_node(2)  # rank 2's L1, and rank 1's partner copy
        cluster.fail_node(3)  # rank 2's partner copy
        for t in cluster.external_tiers:
            t.delete(fmt.shard_key(NAME, 1, 2))
        assert cluster.fetch_shard(NAME, 1, 2) is None
        assert cluster.fetch_partner_copy(NAME, 1, 2, 1) is None
        restored[pkg] = _restore(pkg, None, rank_states, 2, clients)
        for c in clients:
            c.shutdown()
    for k, want in rank_states[2].items():
        np.testing.assert_array_equal(restored["torch"][k], want)
        np.testing.assert_array_equal(restored["torch"][k],
                                      restored["jax"][k])
