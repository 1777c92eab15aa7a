"""Public wrappers over the port's kernels: the primitives the VELOC modules
call (integrity digests, L2 erasure parity), with the public names of the
JAX package's ``repro.kernels.ops``.

Device rule: host bytes (``bytes``, numpy arrays, CPU tensors) are copied to
the package's device before the kernel runs, as ``jnp.asarray`` moves them
in the JAX package.  The device is ``cuda`` unless ``set_device("cpu")``
says otherwise; with ``cuda`` every call goes through the CUDA kernels and
raises when there is no GPU or a kernel fails to build or launch.  Only the
``cpu`` device runs the plain versions in ``ref.py``.

Results are byte-identical to the JAX package's: digests fold the same
per-row table, and the only padding is the last partial 2048-word row of a
checksum (zero rows fold as the identity, ``fold_digest``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import checksum as _ck
from repro_torch.kernels import xor_parity as _xp

#: Lifetime kernel-dispatch counters (benchmarks and tests read deltas to
#: assert batching actually collapses per-chunk dispatches into one).
KERNEL_DISPATCHES = {"checksum": 0, "xor_reduce": 0}

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
    if src.device == _device and (_device.type == "cpu" or (
            src.stride(1) == 1 and src.stride(0) % 4 == 0
            and src.data_ptr() % 16 == 0)):
        dev = src
    else:
        ld = -(-n // 4) * 4 if _device.type == "cuda" else n
        dev = torch.empty((k, ld), dtype=torch.int32, device=_device)[:, :n]
        dev.copy_(src)
    out = _xp.xor_reduce(dev)
    return out.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------


def fletcher_chunks(words, chunk: int = _ck.CHUNK_WORDS) -> np.ndarray:
    """words: (n,) uint32 (host array or tensor) -> (n_chunks, 2) uint32
    per-chunk checksums, on the host."""
    src = _words_tensor(words).reshape(-1)
    n = src.shape[0]
    if n == 0:
        return np.zeros((0, 2), np.uint32)
    _check_device()
    KERNEL_DISPATCHES["checksum"] += 1
    rows = -(-n // chunk)
    total = rows * chunk
    if src.device == _device and total == n and (
            _device.type == "cpu" or src.data_ptr() % 16 == 0):
        dev = src
    else:
        # one copy to the device; only the last partial row is zero-padded
        dev = torch.empty((total,), dtype=torch.int32, device=_device)
        dev[n:].zero_()
        dev[:n].copy_(src)
    table = _ck.checksum(dev.view(rows, chunk))
    return table.cpu().numpy().view(np.uint32)


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
    """Hex digest of a byte buffer (chunk checksums folded host-side)."""
    words = bytes_to_u32(buf)
    return fold_digest(fletcher_chunks(words), len(words))


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
