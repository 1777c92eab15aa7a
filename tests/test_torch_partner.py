"""The port's device-level L2 (``repro_torch.core.partner``) against the JAX
package's: ``encode_l2`` in ``partner`` and ``xor`` mode, slot by slot and
bit for bit, against the JAX ``shard_map`` on the ``data=4, model=2`` mesh
of 8 host devices (run in a subprocess, since the device count is fixed at
jax's start; it writes each device's local blocks and outputs); the leaf
flattening over every dtype class; the XOR-pair plain version against
``repro.kernels.ops.xor_pair``; and the host oracles' rebuild of a lost
slot."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import partner as jpartner
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import concurrency as tconc
from repro_torch.core import partner as tpartner
from repro_torch.kernels import ops
from repro_torch.kernels import ref

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
G = 4  # data slots
M = 2  # model slots


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


_JAX_ENCODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.partner import encode_l2
from repro.launch.mesh import make_host_mesh

mesh = make_host_mesh(data=4, model=2)
rng = np.random.default_rng(7)
state = {
    "a": jnp.asarray(rng.standard_normal((24, 512)), jnp.float32),
    "b": jnp.asarray(rng.standard_normal((2, 256)), jnp.bfloat16),
    "h": jnp.asarray(rng.standard_normal((4, 3)), jnp.float16),
    "i": jnp.asarray(rng.integers(-128, 128, (4, 5)), jnp.int8),
    "s": jnp.asarray(-3, jnp.int32),
    "u": jnp.asarray(rng.integers(0, 256, (7,)), jnp.uint8),
}
pspecs = {"a": P("data", None), "b": P(None, "model"), "h": P("data", None),
          "i": P("data", None), "s": P(), "u": P()}
state = {k: jax.device_put(v, NamedSharding(mesh, pspecs[k]))
         for k, v in state.items()}
coords = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(mesh.devices)}
out = {}
for k, leaf in state.items():
    for sh in leaf.addressable_shards:
        d, m = coords[sh.device.id]
        block = np.asarray(sh.data)
        if k == "b":
            block = block.view(np.uint16)
        out[f"local/{d}/{m}/{k}"] = block
for mode in ("partner", "xor"):
    res = np.asarray(encode_l2(state, pspecs, mesh, mode=mode))
    n = res.shape[0] // 8
    for (d, m), _ in np.ndenumerate(mesh.devices):
        i = d * 2 + m
        out[f"{mode}/{d}/{m}"] = res[i * n:(i + 1) * n]
np.savez(sys.argv[1], **out)
print("ok")
"""

_DTYPES = {"a": torch.float32, "b": torch.bfloat16, "h": torch.float16,
           "i": torch.int8, "s": torch.int32, "u": torch.uint8}


@pytest.fixture(scope="module")
def jax_l2(tmp_path_factory):
    """Each device's local blocks and its ``encode_l2`` outputs, from the
    JAX package on 8 host devices."""
    path = tmp_path_factory.mktemp("jax_l2") / "l2.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_ENCODE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(path) as z:
        return dict(z)


def _local_trees(jax_l2, m):
    """The G local trees along the data axis at model slot ``m``, as CPU
    tensors (bf16 from its bit patterns)."""
    trees = []
    for d in range(G):
        tree = {}
        for k, dt in _DTYPES.items():
            block = jax_l2[f"local/{d}/{m}/{k}"]
            t = torch.from_numpy(np.array(block))
            tree[k] = t.view(torch.bfloat16) if k == "b" else t.to(dt)
        trees.append(tree)
    return trees


@pytest.mark.parametrize("m", range(M))
@pytest.mark.parametrize("mode", ["partner", "xor"])
def test_encode_l2_matches_jax_per_slot(jax_l2, mode, m):
    local = _local_trees(jax_l2, m)
    out = tpartner.encode_l2(local, mode=mode)
    assert len(out) == G
    for d in range(G):
        want = jax_l2[f"{mode}/{d}/{m}"]
        got = out[d]
        assert got.dtype == torch.int32 and got.shape == want.shape, d
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_ring_parity_rebuilds_a_lost_slot(jax_l2):
    """Ported from tests/test_multidevice.py: the partner copy is the
    previous slot's padded buffer, the parity stripes equal the host oracle,
    and a lost slot is rebuilt from the survivors and the parity."""
    local = _local_trees(jax_l2, 0)
    bufs = [tpartner._pad_to(tpartner.flatten_local_u32(t), 1024)
            .numpy().view(np.uint32) for t in local]
    partner = tpartner.encode_l2(local, mode="partner")
    for d in range(G):
        np.testing.assert_array_equal(partner[d].numpy().view(np.uint32),
                                      bufs[(d - 1) % G])
    par = [p.numpy().view(np.uint32) for p in
           tpartner.encode_l2(local, mode="xor")]
    want = tpartner.ring_xor_parity_ref(bufs)
    for d in range(G):
        np.testing.assert_array_equal(par[d], want[d])
    lost = 2
    rec = tpartner.xor_reconstruct_group(
        {d: bufs[d] for d in range(G) if d != lost},
        {d: par[d] for d in range(G) if d != lost}, lost, G, len(bufs[lost]))
    np.testing.assert_array_equal(rec, bufs[lost])


def test_encode_l2_counts_one_xor_pair_per_step_and_slot():
    local = [{"w": torch.full((3000,), float(g))} for g in range(G)]
    before = ops.KERNEL_DISPATCHES["xor_pair"]
    tpartner.encode_l2(local, mode="xor")
    assert ops.KERNEL_DISPATCHES["xor_pair"] == before + G * (G - 1)
    tpartner.encode_l2(local, mode="partner", distance=2)
    assert ops.KERNEL_DISPATCHES["xor_pair"] == before + G * (G - 1)


def test_encode_l2_refuses_what_a_shard_map_cannot_express():
    with pytest.raises(ValueError, match="unequal"):
        tpartner.encode_l2([{"w": torch.zeros(2000)}, {"w": torch.zeros(10)}])
    with pytest.raises(ValueError):
        tpartner.encode_l2([{"w": torch.zeros(10)}])
    with pytest.raises(ValueError):
        tpartner.encode_l2([{"w": torch.zeros(10)}] * 2, mode="mirror")


def _leaf_cases():
    rng = np.random.default_rng(3)
    return {
        "f32": rng.standard_normal((5, 3)).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31, (7,), dtype=np.int32),
        "u32": rng.integers(0, 2**32, (4,), dtype=np.uint32),
        "bf16_odd": rng.integers(0, 2**16, (3, 3), dtype=np.uint16),
        "bf16_even": rng.integers(0, 2**16, (4,), dtype=np.uint16),
        "f16_odd": rng.standard_normal(5).astype(np.float16),
        "int8": rng.integers(-128, 128, (9,), dtype=np.int8),
        "int16": rng.integers(-2**15, 2**15, (3,), dtype=np.int16),
        "uint8": rng.integers(0, 256, (6,), dtype=np.uint8),
        "bool": rng.integers(0, 2, (5,)).astype(bool),
        "scalar_f32": np.asarray(-1.5, np.float32),
        "scalar_int8": np.asarray(-1, np.int8),
    }


@pytest.mark.parametrize("name", list(_leaf_cases()))
def test_flatten_local_u32_matches_jax(name):
    arr = _leaf_cases()[name]
    if name.startswith("bf16"):
        jleaf = jnp.asarray(arr.view(ml_dtypes.bfloat16))
        tleaf = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        jleaf, tleaf = jnp.asarray(arr), torch.from_numpy(arr)
    tree = {"x": tleaf, "y": torch.tensor([1.0, 2.0])}
    want = np.asarray(jpartner.flatten_local_u32(
        {"x": jleaf, "y": jnp.asarray([1.0, 2.0], jnp.float32)}))
    got = tpartner.flatten_local_u32(tree)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [1, 5, 1024, 4099])
def test_xor_pair_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**32, n, dtype=np.uint32)
    b = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = np.asarray(jops.xor_pair(a, b))
    np.testing.assert_array_equal(want, np.asarray(
        jref.xor_pair_ref(jnp.asarray(a), jnp.asarray(b))))
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(
        b.view(np.int32))
    np.testing.assert_array_equal(
        ref.xor_pair_ref(ta, tb).numpy().view(np.uint32), want)
    got = ops.xor_pair(a, b)  # host words in, host words out
    assert isinstance(got, np.ndarray) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    tgot = ops.xor_pair(ta, tb)  # tensors stay tensors
    assert isinstance(tgot, torch.Tensor) and tgot.device == ta.device
    np.testing.assert_array_equal(tgot.numpy().view(np.uint32), want)
