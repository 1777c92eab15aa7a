"""The port's training state against the JAX package: the same tree paths,
shapes and dtypes as ``repro.train.steps.init_train_state``, and a lossless
numpy round trip (bfloat16 included) between the two packages."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train.steps import init_train_state as jax_init
from repro_torch import configs as tconfigs
from repro_torch.core import concurrency as tconc
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.train.steps import (init_train_state, state_from_numpy,
                                     state_to_numpy)


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


def _jax_layout(cfg):
    shapes = jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.PRNGKey(0))
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)]


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_init_train_state_layout_matches_jax(size):
    get = "smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)("veloc-demo-100m")
    tcfg = getattr(tconfigs, get)("veloc-demo-100m")
    # the full state is ~1 GB: lay it out on the meta device, no allocation
    device = "cpu" if size == "smoke" else "meta"
    state = init_train_state(tcfg, generator=torch.Generator().manual_seed(0),
                             device=device)
    got = [(name, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in leaves_with_paths(state)]
    assert got == _jax_layout(jcfg)
    assert len(got) == 37


def test_init_train_state_is_seeded():
    cfg = tconfigs.smoke_config("veloc-demo-100m")
    a = init_train_state(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    b = init_train_state(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    for (na, ta), (nb, tb) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert na == nb and torch.equal(ta, tb)
    emb = a["params"]["emb"]
    assert emb.dtype == torch.float32 and float(emb.std()) > 0


def test_numpy_round_trip_keeps_values_dtypes_and_structure():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "h": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
            "blocks": ({"step": np.asarray(9, np.int32)},),
            "empty": ()}
    port = state_from_numpy(tree, "cpu")
    assert port["h"].dtype == torch.bfloat16
    assert isinstance(port["blocks"], tuple) and port["empty"] == ()
    back = state_to_numpy(port)
    assert [n for n, _ in leaves_with_paths(back)] == \
        [n for n, _ in leaves_with_paths(tree)]
    for (_, a), (_, b) in zip(leaves_with_paths(tree), leaves_with_paths(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_jax_train_state_round_trip():
    cfg = jconfigs.smoke_config("veloc-demo-100m")
    jstate = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), cfg))
    back = state_to_numpy(state_from_numpy(jstate, "cpu"))
    flat = jax.tree.leaves(back)
    assert len(flat) == len(jax.tree.leaves(jstate))
    for a, b in zip(jax.tree.leaves(jstate), flat):
        np.testing.assert_array_equal(a, b)
