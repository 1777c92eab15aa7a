"""The port's kernel seam against the JAX package: the plain checksum and
XOR versions, and ``repro_torch.kernels.ops``, bit for bit against
``repro.kernels`` (Pallas in interpret mode on the CPU, as the JAX package's
own tests run it).  The CUDA kernels themselves run only on the card and are
held against the same plain versions by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.checksum import checksum_pallas
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import xor_parity as txp


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


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("rows", [1, 3, 64, 65])
def test_checksum_ref_matches_jax(rows):
    x = _u32(np.random.default_rng(rows), (rows, 2048))
    x[0, :4] = 0xFFFFFFFF  # carries through the mod-2**32 sums
    got = _bits(ref.checksum_ref(torch.from_numpy(x.view(np.int32))))
    want_ref = np.asarray(jref.checksum_ref(jnp.asarray(x)))
    want_pallas = np.asarray(checksum_pallas(
        jnp.asarray(x), block_rows=64 if rows % 64 == 0 else rows,
        interpret=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)
    # the wrapper takes the plain version for a CPU tensor (uint32 too)
    np.testing.assert_array_equal(
        _bits(tck.checksum(torch.from_numpy(x.copy()))), want_ref)


_BUFFERS = {
    "empty": b"",
    **{f"{n}B": bytes(range(1, n + 1)) for n in range(1, 8)},
    "one_row": np.random.default_rng(1).bytes(4 * 2048),
    "65_rows_ragged": np.random.default_rng(2).bytes(4 * 2048 * 65 + 3),
    "130_rows": np.random.default_rng(3).bytes(4 * 2048 * 130),
}


@pytest.mark.parametrize("name", list(_BUFFERS))
def test_ops_digest_matches_jax(name):
    buf = _BUFFERS[name]
    words = ops.bytes_to_u32(buf)
    np.testing.assert_array_equal(words, jops.bytes_to_u32(buf))
    np.testing.assert_array_equal(ops.fletcher_chunks(words),
                                  jops.fletcher_chunks(words))
    assert ops.digest(buf) == jops.digest(buf)
    assert ops.digest(np.frombuffer(buf, np.uint8)) == jops.digest(buf)


def test_chunk_digests_mixed_lengths_match_jax():
    rng = np.random.default_rng(7)
    blobs = [b"", b"a", rng.bytes(5), rng.bytes(8192), rng.bytes(8193),
             rng.bytes(4 * 2048 * 3 + 1), rng.bytes(8192),
             rng.bytes(4 * 2048 * 66)]
    got = ops.chunk_digests(blobs)
    assert got == jops.chunk_digests(blobs)
    assert got == [jops.digest(b) for b in blobs]


@pytest.mark.parametrize("k", [2, 4, 16])
def test_xor_reduce_matches_jax(k):
    x = _u32(np.random.default_rng(k), (k, 1001))
    got = ops.xor_reduce(x)
    assert got.dtype == np.uint32 and got.shape == (1001,)
    np.testing.assert_array_equal(got, np.asarray(jops.xor_reduce(x)))
    np.testing.assert_array_equal(
        _bits(ref.xor_reduce_ref(torch.from_numpy(x.view(np.int32)))),
        np.asarray(jref.xor_reduce_ref(jnp.asarray(x))))


def test_xor_reduce_wrapper_takes_padded_rows():
    """Rows ``ld`` words apart (the layout ops builds on the card)."""
    x = _u32(np.random.default_rng(5), (4, 7))
    padded = torch.zeros((4, 8), dtype=torch.int32)
    padded[:, :7] = torch.from_numpy(x.view(np.int32))
    got = _bits(txp.xor_reduce(padded[:, :7]))
    np.testing.assert_array_equal(got, x[0] ^ x[1] ^ x[2] ^ x[3])


def test_dispatch_counters_count_ops_calls():
    before = dict(ops.KERNEL_DISPATCHES)
    ops.digest(b"abcdefgh")
    ops.digest(b"")  # empty: no dispatch
    ops.xor_reduce(np.ones((2, 3), np.uint32))
    assert ops.KERNEL_DISPATCHES["checksum"] == before["checksum"] + 1
    assert ops.KERNEL_DISPATCHES["xor_reduce"] == before["xor_reduce"] + 1


def test_cpu_versions_launch_nothing():
    c0, x0 = tck.LAUNCHES.value, txp.LAUNCHES.value
    ops.digest(b"x" * 10000)
    ops.xor_reduce(np.ones((3, 5), np.uint32))
    assert (tck.LAUNCHES.value, txp.LAUNCHES.value) == (c0, x0)


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        tck.checksum(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        txp.xor_reduce(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        ref.checksum_ref(torch.zeros((1, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.set_device("meta")
