"""The port's kernel seam against the JAX package: the plain checksum, XOR,
block-hash, fused hash-diff and row-gather versions, and
``repro_torch.kernels.ops``, bit for bit against ``repro.kernels`` (Pallas
in interpret mode on the CPU, as the JAX package's own tests run it).  Every
comparison is exact.  The CUDA kernels themselves run only on the card and
are held against the same plain versions by ``chip_smoke.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.checksum import (blockhash_diff_pallas, blockhash_pallas,
                                    checksum_pallas, gather_rows_pallas)
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import blockhash as tbh
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import gather as tga
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


@pytest.mark.parametrize("nbytes", [0, 3, 4 * 2048 * 3, 4 * 2048 * 3 + 5,
                                    4 * 2048 * 7 + 8, 4 * 2048 * 9])
def test_fletcher_chunks_piecewise_equals_one_shot(nbytes):
    """Streamed through a piece of 3 rows (so ``4 * 2048 * 3`` bytes is
    exactly one piece, and 9 rows three whole pieces), the table and the
    digest equal the one-shot ones (a single piece of every row) and the
    JAX package's, for ragged lengths, empty input and bytes, numpy words
    and tensors alike."""
    buf = np.random.default_rng(nbytes).bytes(nbytes)
    piece = 3 * 2048
    one_shot = ops.fletcher_chunks(buf, piece_words=1 << 30)
    want = jops.fletcher_chunks(jops.bytes_to_u32(buf))
    np.testing.assert_array_equal(one_shot, want)
    words = ops.bytes_to_u32(buf)
    for src in (buf, np.frombuffer(buf, np.uint8), words,
                torch.from_numpy(words.view(np.int32))):
        np.testing.assert_array_equal(
            ops.fletcher_chunks(src, piece_words=piece), want)
    assert ops.fold_digest(ops.fletcher_chunks(buf, piece_words=piece),
                           len(words)) == jops.digest(buf) == ops.digest(buf)


def test_fletcher_chunks_bounds_the_device_buffer(monkeypatch):
    """The copy to the device goes through one buffer of at most one
    piece, whatever the input's length; a piece that is not a whole number
    of rows is refused."""
    sizes = []
    real_empty = torch.empty

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(ops.torch, "empty", spy)
    buf = np.random.default_rng(0).bytes(4 * 2048 * 10 + 7)
    ops.fletcher_chunks(buf, piece_words=2 * 2048)
    monkeypatch.undo()
    assert sizes == [2 * 2048]
    with pytest.raises(ValueError, match="whole number"):
        ops.fletcher_chunks(buf, piece_words=2048 + 4)


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
    counters = (tck.LAUNCHES, txp.LAUNCHES, tbh.LAUNCHES, tbh.DIFF_LAUNCHES,
                tga.LAUNCHES)
    before = [c.value for c in counters]
    ops.digest(b"x" * 10000)
    ops.xor_reduce(np.ones((3, 5), np.uint32))
    words = torch.arange(10, dtype=torch.int32)
    fp = ops.device_fingerprints(words, 4)
    ops.fingerprint_diff(words, fp, 4)
    ops.gather_rows(words, [0, 2], 4)
    ops.block_fingerprints(b"y" * 100, 8)
    assert [c.value for c in counters] == before


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        tck.checksum(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        txp.xor_reduce(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        ref.checksum_ref(torch.zeros((1, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.set_device("meta")
    words = torch.arange(10, dtype=torch.int32)  # 3 rows of 4 words
    for bad in ([3], [-1], [0.5]):
        with pytest.raises(ValueError):
            tga.gather_rows(words, bad, 4)
    with pytest.raises(ValueError):  # prev of the wrong row count
        tbh.blockhash_diff(words, torch.zeros((2, 2), dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        tbh.blockhash(torch.zeros(8, dtype=torch.float32), 4)
    with pytest.raises(ValueError):  # flat words need a chunk
        tbh.blockhash(words)


# ---------------------------------------------------------------------------
# block hash, fused hash-diff, row gather (delta dirty tracking)
# ---------------------------------------------------------------------------


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("rows,chunk", [(1, 1), (3, 7), (5, 2048), (64, 16),
                                        (65, 12), (2, 16384)])
def test_blockhash_refs_match_jax(rows, chunk):
    rng = np.random.default_rng(rows * chunk)
    x = _u32(rng, (rows, chunk))
    x[0, 0] = 0xFFFFFFFF
    block = 64 if rows % 64 == 0 else rows
    want = np.asarray(jref.blockhash_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(
        np.asarray(blockhash_pallas(jnp.asarray(x), block_rows=block,
                                    interpret=True)), want)
    np.testing.assert_array_equal(_bits(ref.blockhash_ref(_i32(x))), want)
    # the previous fingerprints: equal rows, plus one low-bit flip per
    # other row — every flipped row is dirty, every equal row is clean
    prev = want.copy()
    prev[1::2, 0] ^= 1
    jfp, jdirty = blockhash_diff_pallas(jnp.asarray(x), jnp.asarray(prev),
                                        block_rows=block, interpret=True)
    fp, dirty = ref.blockhash_diff_ref(_i32(x), _i32(prev))
    np.testing.assert_array_equal(_bits(fp), np.asarray(jfp))
    np.testing.assert_array_equal(_bits(dirty), np.asarray(jdirty))
    assert dirty.shape == (rows, 1)
    assert _bits(dirty)[:, 0].tolist() == [r % 2 for r in range(rows)]
    idx = np.asarray([rows - 1, 0, rows // 2, rows - 1], np.int32)
    np.testing.assert_array_equal(
        _bits(ref.gather_rows_ref(_i32(x), torch.from_numpy(idx))),
        np.asarray(gather_rows_pallas(jnp.asarray(x), jnp.asarray(idx),
                                      interpret=True)))


def test_blockhash_ragged_zero_words_are_hashed():
    """Words past the end of a ragged row hash as zeros: a zero word adds
    ``w2 * w2`` to h2, so a row of 1 word and the same word followed by
    zeros give the same pair, and differ from the 1-word row hashed alone."""
    x = np.asarray([0xDEADBEEF], np.uint32)
    padded = np.zeros((1, 16384), np.uint32)
    padded[0, 0] = x[0]
    want = np.asarray(jref.blockhash_ref(jnp.asarray(padded)))
    np.testing.assert_array_equal(_bits(tbh.blockhash(_i32(x), 16384)), want)
    alone = np.asarray(jref.blockhash_ref(jnp.asarray(x[None, :])))
    assert alone[0, 1] != want[0, 1] and alone[0, 0] == want[0, 0]


def _leaf(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, size=n, dtype=np.uint8)
    if dtype == "bfloat16":
        return rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    return rng.standard_normal(n).astype(np.float32)


def _port_tensor(a: np.ndarray) -> torch.Tensor:
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


_LEAVES = [("float32", 40_000), ("float32", 1), ("uint8", 40_001),
           ("uint8", 3), ("bfloat16", 20_001), ("bfloat16", 1)]


@pytest.mark.parametrize("chunk_bytes", [8192, 28, 4096 + 8])
@pytest.mark.parametrize("dtype,n", _LEAVES)
def test_ops_fingerprints_diff_gather_match_jax(dtype, n, chunk_bytes):
    """Host and device fingerprints, the fused diff and the gather of the
    port against the JAX package, for u8/bf16/f32 leaves with ragged last
    chunks and chunk widths that are not a multiple of 4 words (7 and 1026
    words); the new version flips the lowest bit of one word."""
    base = _leaf(dtype, n, seed=n)
    new = base.copy()
    new.view(np.uint8)[-1] ^= 1  # a low-bit flip in the ragged last chunk
    host = ops.block_fingerprints(base, chunk_bytes)
    np.testing.assert_array_equal(
        host, jops.block_fingerprints(base, chunk_bytes))
    words, n_words, rows = ops.device_words(_port_tensor(new), chunk_bytes)
    jwords, jn, jrows = jops.device_words(jnp.asarray(new), chunk_bytes)
    assert (n_words, rows) == (jn, jrows) and words.shape == (n_words,)
    np.testing.assert_array_equal(
        _bits(words), np.asarray(jwords).reshape(-1)[:n_words])
    np.testing.assert_array_equal(
        _bits(ops.device_fingerprints(words, chunk_bytes // 4)),
        np.asarray(jops.device_fingerprints(jwords))[:rows])
    jprev = np.zeros((jwords.shape[0], 2), np.uint32)
    jprev[:rows] = host
    jfp, jdirty = jops.fingerprint_diff(jwords, jnp.asarray(jprev))
    fp, dirty = ops.fingerprint_diff(words, _i32(host), chunk_bytes // 4)
    np.testing.assert_array_equal(_bits(fp), np.asarray(jfp)[:rows])
    np.testing.assert_array_equal(_bits(dirty), np.asarray(jdirty)[:rows])
    assert _bits(dirty)[:, 0].tolist() == [0] * (rows - 1) + [1]
    idx = np.asarray([rows - 1, 0], np.int64)
    np.testing.assert_array_equal(
        _bits(ops.gather_rows(words, idx, chunk_bytes // 4)),
        np.asarray(jops.gather_rows(jwords, idx)))
