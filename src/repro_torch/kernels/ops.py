"""Public wrappers over the port's kernels: the primitives the VELOC modules
call (integrity digests, L2 erasure parity and the device L2 ring, delta
dirty tracking, q8 compression), with the public names of the JAX package's
``repro.kernels.ops``.

Device rule: host bytes (``bytes``, numpy arrays, CPU tensors) are copied to
the package's device before the kernel runs, as ``jnp.asarray`` moves them
in the JAX package.  The device is ``cuda`` unless ``set_device("cpu")``
says otherwise; with ``cuda`` every call goes through the CUDA kernels and
raises when there is no GPU or a kernel fails to build or launch.  Only the
``cpu`` device runs the plain versions in ``ref.py``.

Results are byte-identical to the JAX package's: digests fold the same
per-row table, and the only padding is the last partial 2048-word row of a
checksum (zero rows fold as the identity, ``fold_digest``).  Block
fingerprints hash a ragged last chunk as if it were zero-padded, as the JAX
package pads it, but the kernels read the words in place: no leaf is copied
to pad it.  q8 codes and scales are bit-identical too: the quantize
kernel reads a ragged last block's missing values as zeros, as the JAX
package pads them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import blockhash as _bh
from repro_torch.kernels import checksum as _ck
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import xor_parity as _xp

#: Lifetime kernel-dispatch counters (benchmarks and tests read deltas to
#: assert batching actually collapses per-chunk dispatches into one).
KERNEL_DISPATCHES = {"checksum": 0, "xor_reduce": 0, "xor_pair": 0,
                     "blockhash": 0, "gather": 0, "quantize": 0,
                     "dequantize": 0}

_device = torch.device("cuda")


def set_device(device) -> None:
    """Where host bytes go before a kernel runs: "cuda" (the default; the
    CUDA kernels) or "cpu" (the plain versions)."""
    global _device
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    _device = dev


def get_device() -> torch.device:
    return _device


def check_device(device=None) -> torch.device:
    """``device`` (the package's device when None) as a ``torch.device``;
    a CUDA device with no GPU raises: the port never falls back to the
    CPU unasked."""
    device = torch.device(_device if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: the device is cuda but no GPU is available (pass "
            "device='cpu' to run on the CPU)")
    return device


def _on_device(t: torch.Tensor) -> bool:
    """Whether ``t`` already lies on the package's device ("cuda" matches
    any CUDA device: the wrappers launch on the tensor's own)."""
    return t.device.type == _device.type


def _words_tensor(words) -> torch.Tensor:
    """A 1-D or 2-D int32 tensor of uint32 words, without a copy where the
    input allows (numpy arrays and tensors keep their memory)."""
    if isinstance(words, torch.Tensor):
        return words.view(torch.int32) if words.dtype == torch.uint32 \
            else words
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _check_device():
    if _device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch kernels: the device is cuda but no GPU is available "
            "(call repro_torch.kernels.ops.set_device('cpu') to run the plain "
            "versions)")


def bytes_to_u32(buf: bytes | np.ndarray) -> np.ndarray:
    if isinstance(buf, (bytes, bytearray, memoryview)):
        a = np.frombuffer(buf, dtype=np.uint8)
    else:
        a = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    pad = (-a.size) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    return a.view(np.uint32)


# ---------------------------------------------------------------------------
# XOR parity
# ---------------------------------------------------------------------------


def xor_reduce(x) -> np.ndarray:
    """x: (K, N) uint32 words (host array or tensor) -> (N,) uint32 parity,
    on the host.  On a CUDA device the rows are laid out 16-byte aligned
    (row stride rounded up to 4 words) for the kernel's vector loads; rows
    already on the device in that layout are used in place."""
    src = _words_tensor(x)
    k, n = src.shape
    if n == 0:
        return np.zeros((0,), np.uint32)
    _check_device()
    KERNEL_DISPATCHES["xor_reduce"] += 1
    if _on_device(src) and (_device.type == "cpu" or (
            src.stride(1) == 1 and src.stride(0) % 4 == 0
            and src.data_ptr() % 16 == 0)):
        dev = src
    else:
        ld = -(-n // 4) * 4 if _device.type == "cuda" else n
        dev = torch.empty((k, ld), dtype=torch.int32, device=_device)[:, :n]
        dev.copy_(src)
    out = _xp.xor_reduce(dev)
    return out.cpu().numpy().view(np.uint32)


def _aligned_on_device(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it already lies on the package's device (16-byte aligned
    on a CUDA device, for the kernels' vector loads), else an aligned copy
    there."""
    if _on_device(t) and (_device.type == "cpu" or (
            t.is_contiguous() and t.data_ptr() % 16 == 0)):
        return t
    return t.to(_device, copy=True, memory_format=torch.contiguous_format)


def xor_pair(a, b):
    """a, b: (N,) uint32 words -> ``a ^ b``: the combiner of the device L2
    ring (``core/partner.py``).  Tensors on the package's device stay there
    and the result is a tensor on that device; host words (numpy arrays, CPU
    tensors with a CUDA device) are copied to the device, and the result
    comes back as they came: numpy for numpy, a CPU tensor for a CPU
    tensor."""
    host = not isinstance(a, torch.Tensor)
    ta, tb = _words_tensor(a).reshape(-1), _words_tensor(b).reshape(-1)
    if ta.shape != tb.shape:
        raise ValueError(f"xor_pair: {tuple(ta.shape)} vs {tuple(tb.shape)}")
    if ta.shape[0] == 0:
        out = ta.new_empty((0,))
    else:
        _check_device()
        KERNEL_DISPATCHES["xor_pair"] += 1
        out = _xp.xor_pair(_aligned_on_device(ta), _aligned_on_device(tb))
    if host:
        return out.cpu().numpy().view(np.uint32)
    return out.to(ta.device)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------


#: Words a checksum copies to the device at a time: 32,768 rows of
#: ``CHUNK_WORDS`` (256 MiB).  A shard of any size (22 GB for xlstm-1.3b's
#: train state) streams through one buffer of this size.
DIGEST_PIECE_WORDS = 32768 * _ck.CHUNK_WORDS


def _byte_view(buf) -> torch.Tensor:
    """The bytes of ``buf`` (bytes, a numpy array or a tensor) as a 1-D
    uint8 tensor sharing its memory."""
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8)
    if isinstance(buf, (bytes, bytearray, memoryview)):
        a = np.frombuffer(buf, dtype=np.uint8)
    else:
        a = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    return torch.from_numpy(a)


def fletcher_chunks(words, chunk: int = _ck.CHUNK_WORDS,
                    piece_words: int = DIGEST_PIECE_WORDS) -> np.ndarray:
    """words: uint32 words or raw bytes (host array, bytes or tensor) ->
    (n_chunks, 2) uint32 per-chunk checksums, on the host; a last partial
    word or row reads as zeros.

    A tensor already on the package's device in whole, aligned rows is
    read in place.  Anything else is copied to the device in pieces of
    ``piece_words`` words (a whole number of rows) through one buffer of
    at most that size, and the pieces' tables are concatenated: the table
    is the one-shot table, whatever the input's length."""
    if piece_words <= 0 or piece_words % chunk:
        raise ValueError(f"piece of {piece_words} words is not a whole "
                         f"number of {chunk}-word rows")
    src = _byte_view(words)
    nbytes = src.shape[0]
    row_bytes = 4 * chunk
    rows = -(-nbytes // row_bytes)
    if rows == 0:
        return np.zeros((0, 2), np.uint32)
    _check_device()
    if isinstance(words, torch.Tensor) and _on_device(src) and \
            nbytes == rows * row_bytes and (
                _device.type == "cpu" or src.data_ptr() % 16 == 0):
        KERNEL_DISPATCHES["checksum"] += 1
        table = _ck.checksum(src.view(torch.int32).view(rows, chunk))
        return table.cpu().numpy().view(np.uint32)
    out = np.empty((rows, 2), np.uint32)
    piece_bytes = 4 * piece_words
    buf = torch.empty((min(piece_words, rows * chunk),), dtype=torch.int32,
                      device=_device)
    for start in range(0, nbytes, piece_bytes):
        m = min(piece_bytes, nbytes - start)
        prows = -(-m // row_bytes)
        dev = buf[:prows * chunk]
        dev.view(torch.uint8)[m:].zero_()  # only the last piece is short
        dev.view(torch.uint8)[:m].copy_(src[start:start + m])
        KERNEL_DISPATCHES["checksum"] += 1
        r0 = start // row_bytes
        out[r0:r0 + prows] = _ck.checksum(dev.view(prows, chunk)) \
            .cpu().numpy().view(np.uint32)
    return out


def fold_digest(chunks: np.ndarray, n_words: int) -> str:
    """Fold a (n, 2) per-chunk checksum table into the canonical hex digest
    of a buffer of ``n_words`` uint32 words.  All-zero rows fold as the
    identity (xor 0 / + 0), so a table over a zero-padded tiling folds to
    the same digest as the unpadded buffer — what lets ``chunk_digests``
    batch many buffers into one kernel pass."""
    chunks = np.asarray(chunks)
    h1 = np.bitwise_xor.reduce(chunks[:, 0]) if len(chunks) else np.uint32(0)
    h2 = np.uint32(np.sum(chunks[:, 1], dtype=np.uint64) & 0xFFFFFFFF) \
        if len(chunks) else np.uint32(0)
    return f"{int(h1):08x}{int(h2):08x}{int(n_words):08x}"


def digest(buf: bytes | np.ndarray) -> str:
    """Hex digest of a byte buffer (chunk checksums folded host-side).  The
    bytes stream to the device in pieces: no copy of the whole buffer is
    made, on the host or on the device."""
    return fold_digest(fletcher_chunks(buf), -(-_byte_view(buf).shape[0] // 4))


def chunk_digests(blobs) -> list[str]:
    """``[digest(b) for b in blobs]`` in one checksum-kernel dispatch per
    distinct row count instead of one per buffer.

    Buffers are padded to whole 2048-word rows (zero rows fold as the
    identity, see ``fold_digest``), stacked by equal row count, and checksummed
    in a single launch per group — for a patch of N equal-size dirty
    chunks that is 1 dispatch, not N.  Byte-identical output to per-buffer
    ``digest``."""
    blobs = list(blobs)
    out: list = [None] * len(blobs)
    words_of: list = [None] * len(blobs)
    groups: dict[int, list[int]] = {}
    for j, b in enumerate(blobs):
        w = bytes_to_u32(b)
        if w.shape[0] == 0:
            out[j] = fold_digest(np.zeros((0, 2), np.uint32), 0)
            continue
        words_of[j] = w
        groups.setdefault(-(-w.shape[0] // _ck.CHUNK_WORDS), []).append(j)
    for rows, members in groups.items():
        span = rows * _ck.CHUNK_WORDS
        stacked = np.zeros(len(members) * span, np.uint32)
        for slot, j in enumerate(members):
            w = words_of[j]
            stacked[slot * span:slot * span + w.shape[0]] = w
        table = fletcher_chunks(stacked)
        for slot, j in enumerate(members):
            out[j] = fold_digest(table[slot * rows:(slot + 1) * rows],
                                 words_of[j].shape[0])
    return out


# ---------------------------------------------------------------------------
# block fingerprints (incremental-checkpoint dirty detection)
# ---------------------------------------------------------------------------


def _check_chunk_bytes(chunk_bytes: int):
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes must be a positive multiple of 4, "
                         f"got {chunk_bytes}")


def block_fingerprints(buf: bytes | np.ndarray,
                       chunk_bytes: int = 4 * _ck.CHUNK_WORDS) -> np.ndarray:
    """Per-chunk mixed fingerprints of a byte buffer: (n_chunks, 2) uint32,
    on the host.

    ``chunk_bytes`` must be a multiple of 4; the trailing partial chunk
    hashes as if zero-padded (same rule as the delta encoder, so
    fingerprints of the same logical chunk always agree).  The bytes are
    copied to the device once, unpadded."""
    _check_chunk_bytes(chunk_bytes)
    words = bytes_to_u32(buf)
    if words.shape[0] == 0:
        return np.zeros((0, 2), np.uint32)
    _check_device()
    KERNEL_DISPATCHES["blockhash"] += 1
    dev = _words_tensor(words).to(_device)
    return _bh.blockhash(dev, chunk_bytes // 4).cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# device-side dirty tracking (fused fingerprint-diff + gather, in device
# memory)
# ---------------------------------------------------------------------------


def device_words(x: torch.Tensor, chunk_bytes: int):
    """The uint32 words of a tensor's bytes, as the fingerprint kernels read
    them, without leaving its device: ``(words, n_words, rows)`` with
    ``words`` a flat int32 tensor of ``n_words`` words (a view of ``x`` for
    4-byte dtypes) and ``rows`` the chunk count.

    Bit-identical to ``bytes_to_u32`` of the host bytes: 1- and 2-byte
    dtypes are viewed as their little-endian bytes, zero-padded to a whole
    word (a copy only then), and viewed as words — the JAX package's
    shift-combine (``repro.kernels.ops._device_words_j``).  The ragged last
    chunk is not padded: the kernels hash its missing words as zeros."""
    _check_chunk_bytes(chunk_bytes)
    flat = x.detach().contiguous().reshape(-1)
    nbytes = flat.numel() * flat.element_size()
    n_words = -(-nbytes // 4)
    rows = -(-n_words // (chunk_bytes // 4))
    if flat.element_size() == 4:
        return flat.view(torch.int32), n_words, rows
    b = flat.view(torch.uint8)
    pad = (-nbytes) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32), n_words, rows


def device_fingerprints(words: torch.Tensor, chunk: int = None
                        ) -> torch.Tensor:
    """Block fingerprints (rows, 2) of device words (flat with ``chunk``, or
    (rows, chunk)); the result STAYS on the device (same kernel and values
    as ``block_fingerprints``, no copy to the host)."""
    KERNEL_DISPATCHES["blockhash"] += 1
    return _bh.blockhash(words, chunk)


def fingerprint_diff(words: torch.Tensor, prev_fp: torch.Tensor,
                     chunk: int = None):
    """Fused fingerprint + dirty detection in one pass: returns
    ``(new_fp (rows, 2), dirty (rows, 1))``, both on the device; neither
    fingerprint input leaves it.  Only the chunk-sized dirty mask (and
    whatever chunks it selects) needs to cross to the host."""
    KERNEL_DISPATCHES["blockhash"] += 1
    return _bh.blockhash_diff(words, prev_fp, chunk)


def gather_rows(words: torch.Tensor, idx, chunk: int = None) -> torch.Tensor:
    """Device-side compaction: pack the selected chunk rows contiguously,
    so the following device-to-host copy moves ``len(idx)`` chunks instead
    of the whole region.  ``idx`` are host row indices."""
    KERNEL_DISPATCHES["gather"] += 1
    return _ga.gather_rows(words, idx, chunk)


# ---------------------------------------------------------------------------
# block quantization (compression module)
# ---------------------------------------------------------------------------


def quantize(x):
    """x: any-shape float array (host array or tensor) -> ``(q int8 (rows,
    256), scales f32 (rows,), n, shape)`` on the host, ``rows =
    ceil(n / 256)``.  Values are cast to float32 on the device (as the JAX
    package casts outside the kernel) and quantized there."""
    if isinstance(x, torch.Tensor):
        src = x.detach()
    else:
        src = torch.from_numpy(np.ascontiguousarray(x))
    shape = tuple(src.shape)
    flat = src.reshape(-1)
    n = flat.shape[0]
    _check_device()
    KERNEL_DISPATCHES["quantize"] += 1
    dev = flat.to(_device, dtype=torch.float32,
                  memory_format=torch.contiguous_format)
    q, s = _qz.quantize(dev)
    return q.cpu().numpy(), s.cpu().numpy(), n, shape


def dequantize(q, scales, n: int, shape) -> np.ndarray:
    """Inverse of ``quantize``: ``(n,)`` float32 values ``q * s`` reshaped
    to ``shape``, on the host."""
    _check_device()
    KERNEL_DISPATCHES["dequantize"] += 1
    tq = torch.as_tensor(np.ascontiguousarray(q)).to(_device)
    ts = torch.as_tensor(np.ascontiguousarray(scales)).to(_device)
    out = _qz.dequantize(tq, ts, n)
    return out.cpu().numpy().reshape(shape)
