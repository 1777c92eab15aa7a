"""``test_datastates_lineage_clone_search`` of the JAX package's
``tests/test_misc_units.py`` run against ``repro_torch``, its imports
swapped, on the plain CPU versions of the kernels.  The file's sharding and
HLO cases have no counterpart in the port yet."""
import pytest

from repro_torch.core import Cluster, DataStates, VelocConfig
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


# ---------------------------------------------------------------------------
# DataStates lineage
# ---------------------------------------------------------------------------


def test_datastates_lineage_clone_search(tmp_path):
    cluster = Cluster(VelocConfig(scratch=str(tmp_path)), nranks=1)
    ds = DataStates(cluster)
    a = ds.record(10, metrics={"loss": 2.0})
    b = ds.record(20, metrics={"loss": 1.5})
    c = ds.clone(a.id, "branch-x")
    d = ds.record(30, branch="branch-x", metrics={"loss": 1.2})
    assert [s.id for s in ds.lineage(d.id)] == [a.id, c.id, d.id]
    assert ds.best("loss").id == d.id
    assert set(ds.branches()) == {"main", "branch-x"}
    assert len(ds.search(lambda s: "clone" in s.tags)) == 1
    # persistence across "process restart"
    ds2 = DataStates(cluster)
    assert [s.id for s in ds2.lineage(d.id)] == [a.id, c.id, d.id]
