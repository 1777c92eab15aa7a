"""The port's on-disk format against the JAX package: identical shard,
segment, pack and catalog bytes for the same inputs, and each package's
readers read the other's blobs — bfloat16 regions included (the JAX side
holds them as ml_dtypes arrays, the port as ``torch.bfloat16``)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import format as jfmt
from repro_torch.core import concurrency as tconc
from repro_torch.core import format as tfmt
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


def _arrays():
    rng = np.random.default_rng(11)
    bf_bits = rng.integers(0, 2**16, size=(4, 3), dtype=np.uint16)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "step": np.asarray(7, np.int32),
        "bytes": rng.integers(0, 256, size=(17,), dtype=np.uint8),
        "bf16": bf_bits,  # bit patterns; each side wraps them its own way
    }


def _jax_regions():
    a = _arrays()
    return [jfmt.Region("f32", a["f32"]), jfmt.Region("step", a["step"]),
            jfmt.Region("bytes", a["bytes"]),
            jfmt.Region("bf16", a["bf16"].view(ml_dtypes.bfloat16))]


def _port_regions(form):
    a = _arrays()
    if form == "numpy":
        return [tfmt.Region("f32", a["f32"]), tfmt.Region("step", a["step"]),
                tfmt.Region("bytes", a["bytes"]),
                tfmt.Region("bf16", a["bf16"], dtype="bfloat16")]
    bf16 = torch.from_numpy(a["bf16"].view(np.int16)).view(torch.bfloat16)
    return [tfmt.Region("f32", torch.from_numpy(a["f32"])),
            tfmt.Region("step", torch.tensor(7, dtype=torch.int32)),
            tfmt.Region("bytes", torch.from_numpy(a["bytes"])),
            tfmt.Region("bf16", bf16)]


META = {"rank": 2, "note": "x"}


@pytest.mark.parametrize("encoding", ["raw", "zlib"])
@pytest.mark.parametrize("form", ["tensor", "numpy"])
def test_serialize_shard_bytes_identical(encoding, form):
    want = jfmt.serialize_shard(_jax_regions(), META, encoding=encoding)
    got = tfmt.serialize_shard(_port_regions(form), META, encoding=encoding)
    assert got == want


@pytest.mark.parametrize("encoding", ["raw", "zlib"])
def test_readers_read_each_others_shards(encoding):
    a = _arrays()
    jblob = jfmt.serialize_shard(_jax_regions(), META, encoding=encoding)
    tblob = tfmt.serialize_shard(_port_regions("tensor"), META,
                                 encoding=encoding)
    port_reader = tfmt.ShardReader(jblob)
    assert port_reader.meta == META
    for name in ("f32", "step", "bytes"):
        assert port_reader.verify(name)
        np.testing.assert_array_equal(port_reader.read(name),
                                      a[name].reshape(-1) if name == "step"
                                      else a[name])
    bf = port_reader.read("bf16")
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.view(torch.int16).numpy().view(np.uint16),
                                  a["bf16"])
    jax_reader = jfmt.ShardReader(tblob)
    for name in ("f32", "bytes"):
        np.testing.assert_array_equal(jax_reader.read(name), a[name])
    jbf = jax_reader.read("bf16")
    assert str(jbf.dtype) == "bfloat16"
    np.testing.assert_array_equal(jbf.view(np.uint16), a["bf16"])


def test_reader_detects_corruption():
    blob = bytearray(tfmt.serialize_shard(_port_regions("tensor"), META))
    blob[-1] ^= 0xFF  # last payload byte: inside the bf16 region
    reader = tfmt.ShardReader(bytes(blob))
    assert not reader.verify("bf16")
    with pytest.raises(IOError):
        reader.read("bf16")


def test_unported_encodings_raise():
    with pytest.raises(NotImplementedError, match="q8"):
        tfmt.serialize_shard(_port_regions("tensor"), META, encoding="q8")


def test_segment_pack_and_catalog_bytes_identical():
    rng = np.random.default_rng(3)
    entries = {"ckpt/v00000001/shard_00000": rng.bytes(1000),
               "ckpt/v00000001/parity_00000": rng.bytes(9000),
               "ckpt/v00000001/manifest": b""}
    meta = {"version": 1}
    seg = tfmt.encode_segment(entries, meta=meta)
    assert seg == jfmt.encode_segment(entries, meta=meta)
    for name in entries:
        assert tfmt.SegmentReader(seg).read(name) == entries[name]
        assert jfmt.SegmentReader(seg).read(name) == entries[name]
    assert tfmt.encode_pack("ckpt", entries, [1, 2]) == \
        jfmt.encode_pack("ckpt", entries, [1, 2])
    versions = {1: {"kind": "full", "parent": None, "levels": ["L1"],
                    "entries": {"b", "a"}}}
    cat = tfmt.encode_catalog("ckpt", versions, [(3, "s")], gen=4, writer="w")
    assert cat == jfmt.encode_catalog("ckpt", versions, [(3, "s")], gen=4,
                                      writer="w")
    assert tfmt.decode_catalog(cat) == jfmt.decode_catalog(cat)
    rec = tfmt.encode_log_record("k", rng.bytes(77))
    assert rec == jfmt.encode_log_record("k", rec[-77:])
