"""Regressions for storage-key handling: the FileTier escape must be
reversible (the historical ``__`` scheme was lossy) and prefix listing must
stay exact, or prefix GC mis-lists artifacts.

The JAX package's ``tests/test_storage_keys.py`` run against
``repro_torch``, its imports swapped, on the plain CPU versions of the
kernels."""
import numpy as np

from repro_torch.core import Cluster, VelocClient, VelocConfig
from repro_torch.core.storage import FileTier, escape_key, unescape_key
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


def test_escape_roundtrip_adversarial():
    keys = ["plain", "a/b/c", "a__b", "a__b/c__d", "_", "__", "___",
            "_u", "_s", "a_/b", "a/_b", "run__v2/shard_00001",
            "_s_u/__x"]
    for k in keys:
        assert unescape_key(escape_key(k)) == k, k
    # escapes are unique (reversibility implies it; check directly anyway)
    assert len({escape_key(k) for k in keys}) == len(keys)


def test_escape_preserves_prefix_relation():
    pairs = [("a/b", "a/b/c"), ("a__", "a__b"), ("x_", "x_y"),
             ("ck__pt/v1/", "ck__pt/v1/shard_00000")]
    for p, k in pairs:
        assert escape_key(k).startswith(escape_key(p)), (p, k)
    # and non-prefixes stay non-prefixes
    assert not escape_key("a_/b").startswith(escape_key("a__"))


def test_filetier_keys_roundtrip_with_double_underscore(tmp_path):
    """Regression: a checkpoint name containing ``__`` used to round-trip
    wrongly through keys() (``replace("__", "/")`` was lossy), so prefix
    listing/GC could miss or mis-list artifacts."""
    t = FileTier(str(tmp_path / "ft"))
    t.put("my__run/v00000001/shard_00000", b"a")
    t.put("my__run/v00000001/manifest.L1", b"b")
    t.put("my/run/v00000001/shard_00000", b"c")  # the collision victim
    got = sorted(t.keys("my__run/"))
    assert got == ["my__run/v00000001/manifest.L1",
                   "my__run/v00000001/shard_00000"]
    assert t.keys("my/run/") == ["my/run/v00000001/shard_00000"]
    assert t.get("my__run/v00000001/shard_00000") == b"a"
    assert t.get("my/run/v00000001/shard_00000") == b"c"
    t.delete("my__run/v00000001/shard_00000")
    assert t.get("my/run/v00000001/shard_00000") == b"c"  # untouched


def test_gc_with_double_underscore_name(tmp_path):
    """End-to-end: GC of a ``__``-named checkpoint deletes exactly that
    checkpoint's artifacts."""
    cfg = VelocConfig(name="my__run", scratch=str(tmp_path), mode="sync",
                      partner=False, xor_group=0, flush=True,
                      keep_versions=1)
    cluster = Cluster(cfg, nranks=1)
    c = VelocClient(cfg, cluster)
    for v in (1, 2, 3):
        c.checkpoint({"w": np.full(100, v, np.float32)}, version=v,
                     device_snapshot=False)
    pfs = cluster.external_tiers[0]
    vers = {k.split("/")[1] for k in pfs.keys("my__run/")}
    assert vers == {"v00000002", "v00000003"}  # keep+1 newest


def test_kv_journal_escape_roundtrip(tmp_path):
    from repro_torch.core.storage import KVTier

    jdir = str(tmp_path / "j")
    kv = KVTier(journal=jdir)
    kv.put("a__b/c", b"x")
    kv.put("a/b/c", b"y")
    kv2 = KVTier(journal=jdir)
    assert kv2.get("a__b/c") == b"x"
    assert kv2.get("a/b/c") == b"y"
    assert sorted(kv2.keys("a__b/")) == ["a__b/c"]
