"""The delta properties of the JAX package's tests/test_property_roundtrip.py
for the PyTorch port: delta encode/overlay under randomized dirty masks, the
"delta" region encoding through the shard container, and corruption that is
never silent.  The random cases are drawn from seeded numpy generators (one
test case per seed) instead of hypothesis lists, whose large draws fail
hypothesis's health check.  The randomized-mask case also holds the port's
patch bytes equal to the JAX package's, exactly."""
import numpy as np
import pytest

from repro.core import delta as jdlt
from repro_torch.core import concurrency as tconc
from repro_torch.core import delta as dlt
from repro_torch.core import format as fmt
from repro_torch.kernels import ops

DTYPES = [np.float32, np.float64, np.int32, np.uint8, np.int8]


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


def _array(rng, dtype, n):
    """``n`` values of ``dtype``: floats of float32 width in [-1e6, 1e6],
    integers over the dtype's whole range (the JAX tests' strategies)."""
    if np.dtype(dtype).kind == "f":
        return rng.uniform(-1e6, 1e6, n).astype(np.float32).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(int(info.min), int(info.max), size=n,
                        endpoint=True).astype(dtype)


@pytest.mark.parametrize("seed", range(25))
def test_delta_overlay_randomized_dirty_masks(seed):
    """overlay(base, diff(new, base)) == new, byte-identical, for random
    dirty masks, any dtype, empty and non-multiple-of-chunk regions; the
    patch bytes equal the JAX package's."""
    rng = np.random.default_rng(seed)
    dtype = DTYPES[seed % len(DTYPES)]
    n = 0 if seed == 0 else int(rng.integers(0, 2001))
    chunk_bytes = int(rng.integers(1, 65)) * 4
    base = _array(rng, dtype, n)
    new = base.copy()
    if n > 0:
        k = min(int(rng.integers(0, 41)), n)
        for i in rng.choice(n, size=k, replace=False):
            new.view(np.uint8)[i * new.itemsize:(i + 1) * new.itemsize] ^= \
                0xFF  # every bit of the element flipped
    _, fp0 = dlt.make_patch(base, None, chunk_bytes=chunk_bytes)
    patch, _ = dlt.make_patch(new, fp0, chunk_bytes=chunk_bytes,
                              base_version=1)
    blob = dlt.encode_patch(patch)
    _, jfp0 = jdlt.make_patch(base, None, chunk_bytes=chunk_bytes)
    np.testing.assert_array_equal(fp0, jfp0)
    jpatch, _ = jdlt.make_patch(new, jfp0, chunk_bytes=chunk_bytes,
                                base_version=1)
    assert blob == jdlt.encode_patch(jpatch)
    out = dlt.overlay(base, dlt.decode_patch(blob))
    assert out.tobytes() == new.tobytes()
    assert out.dtype == new.dtype and out.shape == new.shape


@pytest.mark.parametrize("seed", range(15))
def test_delta_region_through_shard_container(seed):
    """The "delta" region encoding round-trips through the shard container
    next to raw regions."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 501))
    chunk_bytes = int(rng.integers(1, 33)) * 4
    base = _array(rng, np.float32, n)
    new = base.copy()
    new[int(rng.integers(0, n))] += 1.0
    _, fp0 = dlt.make_patch(base, None, chunk_bytes=chunk_bytes)
    patch, _ = dlt.make_patch(new, fp0, chunk_bytes=chunk_bytes,
                              base_version=7)
    other = _array(rng, np.int32, 5)
    blob = fmt.serialize_shard(
        [fmt.Region("w", new, patch=patch), fmt.Region("o", other)],
        {"delta": {"kind": "delta", "parent": 7}})
    reader = fmt.ShardReader(blob)
    assert reader.delta_regions() == ["w"]
    assert reader.entry("w")["base_version"] == 7
    assert reader.read("w", base=base).tobytes() == new.tobytes()
    assert reader.read("o").tobytes() == other.tobytes()
    assert reader.read_patch("w").base_version == 7
    with pytest.raises(ValueError, match="base"):
        reader.read("w")


@pytest.mark.parametrize("seed", range(15))
def test_delta_blob_corruption_never_silent(seed):
    """Flipping any byte of an encoded patch either raises on decode/overlay
    or still yields the correct array (flips in dead padding don't exist:
    every byte is header, table or chunk data)."""
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(4, 401))
    base = _array(rng, np.float32, n)
    new = base.copy()
    new[n // 2] += 1.0
    _, fp0 = dlt.make_patch(base, None, chunk_bytes=16)
    patch, _ = dlt.make_patch(new, fp0, chunk_bytes=16, base_version=1)
    blob = bytearray(dlt.encode_patch(patch))
    blob[int(rng.integers(0, len(blob)))] ^= 0x01
    try:
        out = dlt.overlay(base, dlt.decode_patch(bytes(blob)))
    except Exception:  # noqa: BLE001 — any raise is a detection
        return
    assert out.tobytes() == new.tobytes()
