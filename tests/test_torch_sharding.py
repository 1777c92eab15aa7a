"""The port's logical sharding (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``): ``test_misc_units.py``'s three
``resolve_spec`` cases with the imports swapped; every leaf of every
config's full-size train state, decode cache and batch specs resolved on
the production mesh shapes (16, 16) and (2, 16, 16), with FSDP on and off,
equal to ``repro.sharding.pspec_tree`` of the JAX package's own specs and
``jax.eval_shape`` shapes (the port's shapes from its ``meta`` device);
``placements()`` of a dim over two mesh axes; and ``make_production_mesh``
over torch's fake process group of 256 and 512 ranks, each rank's shard
at the global start JAX's device order gives it."""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.sharding import pspec_tree as jpspec_tree
from repro.train import steps as jsteps
from repro_torch import runtime
from repro_torch import sharding as tsh
from repro_torch.configs import base as tbase
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps


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


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


M = _FakeMesh({"pod": 2, "data": 16, "model": 16})
P = tsh.P


def test_resolve_spec_basic():
    assert tsh.resolve_spec((4096, 32, 128), ("fsdp", "model", None), M,
                            True) == P(("pod", "data"), "model")
    # fsdp off -> dropped
    assert tsh.resolve_spec((4096, 32, 128), ("fsdp", "model", None), M,
                            False) == P(None, "model")
    # non-divisible head count falls back to replication
    assert tsh.resolve_spec((4096, 40, 64), ("fsdp", "model", None), M,
                            True) == P(("pod", "data"))


def test_resolve_spec_claiming_left_to_right():
    # kimi MoE weights: E=384 divides 16 -> expert dim claims "model"
    assert tsh.resolve_spec((384, 7168, 2048), ("model", "fsdp", "model"),
                            M, True) == P("model", ("pod", "data"))
    # grok: E=8 does not divide -> d_ff claims instead
    assert tsh.resolve_spec((8, 6144, 32768), ("model", "fsdp", "model"), M,
                            True) == P(None, ("pod", "data"), "model")


def test_resolve_spec_batch_indivisible_replicates():
    assert tsh.resolve_spec((1, 128), ("batch", None), M, False) == P()


# ---------------------------------------------------------------------------
# every config's specs against the JAX package's
# ---------------------------------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
TRAIN = "train_4k"
DECODE = "decode_32k"


def _flat_jax(tree) -> dict:
    """{path: spec as a tuple} of a JAX PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, spec in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[name] = tuple(spec)
    return out


def _flat_port(tree, path=()) -> dict:
    """{path: spec} of a port spec tree (dict keys sorted)."""
    if isinstance(tree, P):
        return {"/".join(str(p) for p in path): tuple(tree)}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = list(enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_flat_port(v, path + (k,)))
    return out


def _jax_trees(name: str) -> dict:
    """(shapes, logical specs) of the JAX package's train state, decode
    cache and train batch, from ``jax.eval_shape`` (no allocation)."""
    cfg = jbase.get_config(name)
    dec = jbase.SHAPES[DECODE]
    state = jax.eval_shape(
        lambda: jsteps.init_train_state(jax.random.PRNGKey(0), cfg))
    cache = jax.eval_shape(
        lambda: jmodel.cache_init(cfg, dec.global_batch, dec.seq_len))
    shape = jbase.SHAPES[TRAIN]
    return {
        "state": (state, jsteps.train_state_specs(cfg)),
        "cache": (cache, jmodel.cache_specs(cfg)),
        "batch": (jmodel.batch_struct(cfg, shape),
                  jmodel.batch_specs(cfg, shape)),
    }


def _port_trees(name: str) -> dict:
    """The same three trees of the port, laid out on the ``meta`` device."""
    cfg = tbase.get_config(name)
    dec = tbase.SHAPES[DECODE]
    params = tmodel.init_model(cfg, generator=torch.Generator(),
                               device="meta")
    state = {"params": params, "opt": topt.adamw_init(params, cfg.opt_dtype)}
    cache = tmodel.cache_init(cfg, dec.global_batch, dec.seq_len,
                              device="meta")
    shape = tbase.SHAPES[TRAIN]
    return {
        "state": (state, tsteps.train_state_specs(cfg)),
        "cache": (cache, tmodel.cache_specs(cfg)),
        "batch": (tmodel.batch_struct(cfg, shape),
                  tmodel.batch_specs(cfg, shape)),
    }


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.list_configs())
def test_resolved_specs_match_jax(arch, mesh):
    """Every leaf of the train state (params and AdamW moments), the
    decode cache (``decode_32k``: 128 rows, 32,768 slots) and the train
    batch (``train_4k``) resolves, with FSDP on and off, to the spec JAX
    resolves it to."""
    fake = _FakeMesh(MESHES[mesh])
    jt, pt = _jax_trees(arch), _port_trees(arch)
    for part in ("state", "cache", "batch"):
        for fsdp in (True, False):
            want = _flat_jax(jpspec_tree(*jt[part], fake, fsdp))
            got = _flat_port(tsh.pspec_tree(*pt[part], fake, fsdp))
            assert got == want, (part, fsdp)
            assert want, part


def test_placements_two_axes():
    """A dim over ("pod", "data") is sharded over both mesh axes, pod
    first in mesh order; an unnamed axis replicates, a partial one sums."""
    from torch.distributed.tensor import Partial

    assert tsh.placements(P(("pod", "data"), "model"), M) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements(P(None, ("pod", "data")), M) == (
        Shard(1), Shard(1), Replicate())
    assert tsh.placements(P(), M) == (Replicate(),) * 3
    assert tsh.placements(P("model"), M, partial=("pod", "data")) == (
        Partial(), Partial(), Shard(0))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_fake_group(multi_pod):
    """``make_production_mesh`` over torch's fake process group: its axes
    and sizes are JAX's, and a (pod, data)-sharded dim puts rank (p, d,
    m)'s shard at global start (p * 16 + d) * rows, JAX's device order."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_box
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        assert runtime.mesh_axes(mesh) == dict(
            zip(names, (2, 16, 16) if multi_pod else (16, 16)))
        assert runtime.data_axes(mesh) == names[:-1]
        rows = 64
        n_data = world // 16
        spec = tsh.resolve_spec((rows * n_data, 32), ("batch", "model"),
                                mesh, False)
        assert spec == P(names[:-1] if multi_pod else "data", "model")
        pl = tsh.placements(spec, mesh)
        grid = mesh.mesh  # rank ids laid out by coordinate
        for coord in ((0, 3, 5), (1, 15, 0), (1, 0, 15)) if multi_pod \
                else ((3, 5), (15, 0)):
            # the shard the rank at ``coord`` would hold
            local, starts = local_box((rows * n_data, 32), mesh.shape,
                                      list(coord), pl)
            data_index = coord[0] * 16 + coord[1] if multi_pod else coord[0]
            assert tuple(local) == (rows, 2)
            assert tuple(starts) == (data_index * rows, coord[-1] * 2)
            assert int(grid[coord]) == sum(
                c * s for c, s in zip(coord, (256, 16, 1)[-len(coord):]))
    finally:
        dist.destroy_process_group()
