"""The port's ``restart.elastic_regions`` against the JAX package's on the
same per-rank regions, including the case where both go wrong: an axis-0
sharded region whose shards are equal (freshly zeroed optimizer moments)
is read as replicated and broadcast, one old shard per new rank (ROADMAP
queue 3, item 4).  The port keeps the reference's behaviour; this test
fails if either package changes it alone."""
import numpy as np
import pytest

from repro.core import restart as jrst
from repro_torch.core import concurrency as tconc
from repro_torch.core import restart as trst
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


@pytest.mark.parametrize("old,new", [(4, 2), (2, 4), (4, 1)])
def test_elastic_regions_match_reference(old, new):
    rng = np.random.default_rng(old * 10 + new)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    m = np.zeros((8, 3), np.float32)  # equal shards
    step = np.asarray(7, np.int32)    # replicated
    k = 8 // old
    per_rank = {r: {"w": w[r * k:(r + 1) * k], "m": m[r * k:(r + 1) * k],
                    "step": step} for r in range(old)}
    got = trst.elastic_regions(per_rank, new)
    want = jrst.elastic_regions(per_rank, new)
    assert sorted(got) == sorted(want) == list(range(new))
    for r in range(new):
        for name in ("w", "m", "step"):
            np.testing.assert_array_equal(got[r][name], want[r][name])
        # the sharded region with distinct shards is re-split ...
        np.testing.assert_array_equal(
            got[r]["w"], w[r * (8 // new):(r + 1) * (8 // new)])
        # ... the one with equal shards comes back as one old shard
        assert got[r]["m"].shape == (k, 3)
