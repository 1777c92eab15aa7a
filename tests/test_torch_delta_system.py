"""Delta checkpointing in the PyTorch port against the JAX package, on the
CPU: patch bytes, whole checkpoints and cross-package restore.

  - ``encode_patch`` of the port's host patch and device patch equals the
    JAX package's host and device patches, byte for byte;
  - the JAX smoke train state plus one bfloat16 leaf, split over the 4 ranks
    of one XOR group, checkpointed as v1 (full) plus 3 deltas: every blob
    each package stores (shards, partner copies, parity, manifests) is
    byte-identical, sync and async, host and device delta;
  - a chain written by either package restores through the other in a
    fresh ``Cluster`` over the same scratch directory, and so does a chain
    folded by ``compact()``.

Every comparison is exact.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import smoke_config
from repro.core import delta as jdlt
from repro.core import restart as jrst
from repro.core.capture import DeviceDeltaCapture as JCapture
from repro.train.steps import init_train_state as jax_init
import repro_torch.core as tcore
from repro_torch.core import concurrency as tconc
from repro_torch.core import delta as tdlt
from repro_torch.core import restart as trst
from repro_torch.core.capture import DeviceDeltaCapture as TCapture
from repro_torch.kernels import ops
from repro_torch.train.steps import state_from_numpy

NRANKS = 4
NAME = "ckpt"
CHUNK = 4096
STREAM = ("t", 0)


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


def _port_tensor(a: np.ndarray) -> torch.Tensor:
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# patch bytes
# ---------------------------------------------------------------------------


def _dirty(a: np.ndarray, chunk_ids) -> np.ndarray:
    out = a.copy()
    flat = out.reshape(-1).view(np.uint8)
    for c in chunk_ids:
        flat[c * CHUNK] ^= 0x01  # a low-bit flip
    return out


@pytest.mark.parametrize("dtype,n", [("float32", 30_001), ("bfloat16", 20_001),
                                     ("float32", 1024 * 8)])
def test_patch_bytes_identical_across_packages(dtype, n):
    rng = np.random.default_rng(n)
    base = rng.standard_normal(n).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    rows = -(-base.nbytes // CHUNK)
    new = _dirty(base, sorted({0, rows // 2, rows - 1}))
    fp0 = jdlt.fingerprints(base, CHUNK)
    jhost, _ = jdlt.make_patch(new, fp0, chunk_bytes=CHUNK, base_version=1)
    thost, tfp = tdlt.make_patch(_port_tensor(new), fp0, chunk_bytes=CHUNK,
                                 base_version=1)
    want = jdlt.encode_patch(jhost)
    assert tdlt.encode_patch(thost) == want
    assert tdlt.DELTA_MAGIC == jdlt.DELTA_MAGIC and want.startswith(
        tdlt.DELTA_MAGIC)

    jcap, tcap = JCapture(chunk_bytes=CHUNK), TCapture(chunk_bytes=CHUNK)
    jcap.commit(jcap.plan(STREAM, "w", jnp.asarray(base)))
    tcap.commit(tcap.plan(STREAM, "w", _port_tensor(base)))
    jdiff = jcap.gather(jcap.plan(STREAM, "w", jnp.asarray(new)))
    tplan = tcap.plan(STREAM, "w", _port_tensor(new))
    assert tplan.dtype == dtype
    tdiff = tcap.gather(tplan)
    jdev, _ = jdlt.make_patch(None, None, chunk_bytes=CHUNK, base_version=1,
                              precomputed=jdiff)
    tdev, tdev_fp = tdlt.make_patch(None, None, chunk_bytes=CHUNK,
                                    base_version=1, precomputed=tdiff)
    assert tdlt.encode_patch(tdev) == jdlt.encode_patch(jdev) == want
    np.testing.assert_array_equal(tdev_fp, tfp)
    # either package overlays the other's patch over its own kind of base
    out = tdlt.overlay(_port_tensor(base), jdlt.decode_patch(want))
    np.testing.assert_array_equal(
        np.asarray(_as_numpy(out)).view(np.uint8), new.view(np.uint8))
    jout = jdlt.overlay(base, jdlt.decode_patch(tdlt.encode_patch(tdev)))
    assert jout.tobytes() == new.tobytes()


# ---------------------------------------------------------------------------
# whole checkpoints, 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def versions():
    """Per version (1..4), per rank, a flat ``{path: numpy leaf}`` quarter
    of the JAX smoke train state plus a bfloat16 leaf.  Each later version
    bumps ``opt/step`` and flips one byte in one chunk of three leaves."""
    state = jax_init(jax.random.PRNGKey(0), smoke_config("veloc-demo-100m"))
    leaves = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path), np.asarray(leaf))
              for path, leaf in jax.tree_util.tree_leaves_with_path(state)]
    rng = np.random.default_rng(5)
    ranks = [dict(leaves[r::NRANKS]) for r in range(NRANKS)]
    for r, st in enumerate(ranks):
        st["h"] = rng.standard_normal(3001 + r).astype(ml_dtypes.bfloat16)
    out = [ranks]
    for _ in range(3):
        nxt = []
        for st in out[-1]:
            st = {k: v.copy() for k, v in st.items()}
            if "opt/step" in st:
                st["opt/step"] = st["opt/step"] + np.int32(1)
            big = sorted(k for k, v in st.items() if v.nbytes > 2 * CHUNK)
            for k in [big[int(i)] for i in rng.choice(len(big), 3, False)]:
                rows = -(-st[k].nbytes // CHUNK)
                st[k] = _dirty(st[k], [int(rng.integers(rows))])
            nxt.append(st)
        out.append(nxt)
    return out


_PKG = {"jax": jcore, "torch": tcore}


def _as_input(pkg, state):
    if pkg == "jax":
        return {k: jnp.asarray(v) for k, v in state.items()}
    return state_from_numpy(state, "cpu")


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    return np.asarray(leaf)


def _config(pkg, scratch, mode="sync", device_delta=False):
    return _PKG[pkg].VelocConfig(
        scratch=str(scratch), mode=mode, delta=True,
        device_delta=device_delta, delta_chunk_bytes=CHUNK, keep_versions=10)


def _write_chain(pkg, scratch, versions, mode="sync", device_delta=False):
    core = _PKG[pkg]
    cfg = _config(pkg, scratch, mode, device_delta)
    cluster = core.Cluster(cfg, nranks=NRANKS)
    clients = [core.VelocClient(cfg, cluster, rank=r) for r in range(NRANKS)]
    kinds = []
    for v, states in enumerate(versions, start=1):
        for r, c in enumerate(clients):
            fut = c.checkpoint(_as_input(pkg, states[r]), version=v)
            # one rank at a time: the ranks report in the same order in
            # both packages, so the manifests' digest tables match
            assert c.wait(timeout=60)
            assert not fut.module_errors, fut.module_errors
            kinds.append(fut.results["delta_kind"])
    assert kinds == ["full"] * NRANKS + ["delta"] * (3 * NRANKS), kinds
    return cluster, clients


def _blobs(cluster) -> dict:
    out = {}
    tiers = [(f"node{r}", t) for r in range(NRANKS)
             for t in cluster.node_tiers(r)] \
        + [("ext", t) for t in cluster.external_tiers]
    for where, t in tiers:
        for key in t.keys(""):
            out[(where, t.info.name, key)] = t.get(key)
    return out


@pytest.mark.parametrize("device_delta", [False, True])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_stored_blobs_identical(tmp_path, versions, mode, device_delta):
    got = {}
    for pkg in _PKG:
        cluster, clients = _write_chain(pkg, tmp_path / pkg, versions, mode,
                                        device_delta)
        got[pkg] = _blobs(cluster)
        for c in clients:
            c.shutdown()
    assert sorted(got["torch"]) == sorted(got["jax"])
    kinds = {k[2].rsplit("/", 1)[-1].split("_")[0] for k in got["torch"]}
    assert {"shard", "parity", "manifest.L1"} <= kinds, kinds
    for key, blob in got["jax"].items():
        assert got["torch"][key] == blob, f"{key} differs"


def _restore(pkg, scratch, versions, rank):
    core = _PKG[pkg]
    cfg = _config(pkg, scratch)
    cluster = core.Cluster(cfg, nranks=NRANKS)  # a fresh process
    client = core.VelocClient(cfg, cluster, rank=rank)
    template = _as_input(pkg, {k: np.zeros_like(v)
                               for k, v in versions[-1][rank].items()})
    version, state = client.restart_latest(template)
    assert version == len(versions), client.restart_diagnostics
    return cluster, {k: _as_numpy(v) for k, v in state.items()}


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("device_delta", [False, True])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_chain_restores_across_packages(tmp_path, versions, writer, reader,
                                        device_delta):
    _, clients = _write_chain(writer, tmp_path, versions,
                              device_delta=device_delta)
    for c in clients:
        c.shutdown()
    rst = jrst if reader == "jax" else trst
    for r in range(NRANKS):
        cluster, got = _restore(reader, tmp_path, versions, r)
        _assert_state(got, versions[-1][r])
    assert rst.chain_versions(cluster, NAME, 4) == [4, 3, 2, 1]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_compacted_chain_reads_across_packages(tmp_path, versions, writer,
                                               reader):
    shards = {}
    for pkg in (writer, reader):  # the reader's own fold, for the bytes
        cluster, clients = _write_chain(pkg, tmp_path / pkg, versions)
        for c in clients:
            assert c.compact() == 4
        shards[pkg] = [cluster.fetch_shard(NAME, 4, r)
                       for r in range(NRANKS)]
        for c in clients:
            c.shutdown()
    assert shards[writer] == shards[reader]
    rst = jrst if reader == "jax" else trst
    for r in range(NRANKS):
        cluster, got = _restore(reader, tmp_path / writer, versions, r)
        _assert_state(got, versions[-1][r])
        assert rst.chain_versions(cluster, NAME, 4, r) == [4]
