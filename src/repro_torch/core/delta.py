"""Incremental (differential) checkpointing: chunk diffing and delta patches.

Full checkpoints re-serialize every protected byte each step even when the
step touched a fraction of them — the write amplification that "Towards
Aggregated Asynchronous Checkpointing" identifies as the dominant cost of
frequent checkpointing.  This module cuts a checkpoint down to its *dirty
chunks*:

  1. the block-hash kernel (``csrc/blockhash.cu``, through
     repro_torch.kernels.ops) fingerprints fixed-size chunks of each
     protected region;
  2. ``diff`` compares against the fingerprints of the last persisted
     version and yields the dirty-chunk index set;
  3. ``make_patch`` packs only the dirty chunks + a chunk table into a
     ``DeltaPatch``, serialized as the ``"delta"`` region encoding in
     repro_torch.core.format;
  4. ``overlay(base, patch)`` reapplies a patch on restart, verifying each
     chunk digest and the full-array digest — byte-identical reconstruction
     or an IOError, never silent corruption.

``DeltaTracker`` holds the per-(name, rank) fingerprint state and the chain
bookkeeping (base version, parent version, chain length) that the pipeline's
DeltaModule and the restart chain-walk rely on.

Patches are byte-identical to the JAX package's, ``DELTA_MAGIC`` included.
dtypes travel by their on-disk names (``format.host_array``): a bfloat16
region is "bfloat16" whether it arrives as a ``torch.bfloat16`` tensor or
as its uint16 bit patterns, and ``overlay`` rebuilds it as a
``torch.bfloat16`` tensor (``format.array_from_bytes``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.core.format import array_from_bytes, host_array
from repro_torch.kernels import ops as kops

#: Default diff granularity.  Smaller chunks shrink deltas on scattered
#: updates but grow the chunk table and fingerprint state; 64 KiB keeps the
#: table under 0.1% of region bytes while matching SSD write granularity.
DEFAULT_CHUNK_BYTES = 64 * 1024

DELTA_MAGIC = b"VDLT1\x00"


@dataclass
class DeltaPatch:
    """Dirty chunks of one region relative to its parent version."""

    shape: tuple
    dtype: str
    nbytes: int                 # raw (decoded) byte length of the region
    chunk_bytes: int
    base_version: int           # immediate parent version this diffs against
    indices: np.ndarray         # (n_dirty,) int64, sorted ascending
    data: bytes                 # concatenated dirty chunks (tail may be short)
    chunk_digests: list = field(default_factory=list)  # per dirty chunk
    full_digest: str = ""       # digest of the full raw buffer after overlay

    @property
    def n_chunks(self) -> int:
        return -(-self.nbytes // self.chunk_bytes) if self.nbytes else 0


@dataclass
class PrecomputedDiff:
    """A diff the capture layer already computed ON DEVICE (fused
    fingerprint-diff + gather in device memory —
    repro_torch.core.capture.DeviceDeltaCapture):
    ``make_patch`` packs it into a DeltaPatch verbatim instead of re-hashing
    and re-copying bytes the device already diffed."""

    shape: tuple
    dtype: str
    nbytes: int
    chunk_bytes: int
    indices: np.ndarray         # (n_dirty,) int64, sorted ascending
    data: bytes                 # gathered dirty chunks (tail may be short)
    chunk_digests: list
    full_digest: str
    fps: np.ndarray             # host copy of the new fingerprints (tracker
    #                             state — keeps the host diff path viable if
    #                             device capture is later disabled)


def fingerprints(buf: bytes | np.ndarray,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> np.ndarray:
    """(n_chunks, 2) uint32 per-chunk fingerprints (block-hash kernel)."""
    return kops.block_fingerprints(buf, chunk_bytes=chunk_bytes)


def dirty_chunks(new_fp: np.ndarray, prev_fp: Optional[np.ndarray]
                 ) -> np.ndarray:
    """Sorted indices of chunks whose fingerprints differ (all chunks when
    there is no previous state or the chunk count changed)."""
    if prev_fp is None or prev_fp.shape != new_fp.shape:
        return np.arange(new_fp.shape[0], dtype=np.int64)
    return np.nonzero((new_fp != prev_fp).any(axis=1))[0].astype(np.int64)


def _chunk_slices(nbytes: int, chunk_bytes: int, idx: int) -> slice:
    lo = idx * chunk_bytes
    return slice(lo, min(lo + chunk_bytes, nbytes))


def make_patch(arr: Any, prev_fp: Optional[np.ndarray], *,
               chunk_bytes: int = DEFAULT_CHUNK_BYTES, base_version: int = -1,
               precomputed: Optional[PrecomputedDiff] = None,
               dtype: Optional[str] = None
               ) -> tuple[DeltaPatch, np.ndarray]:
    """Diff ``arr`` against ``prev_fp`` -> (patch, new fingerprints).

    The patch contains every chunk when ``prev_fp`` is None (full rewrite);
    callers decide whether serializing it as a delta still pays off (see
    DeltaModule's dirty-ratio cutoff).

    ``arr`` is a numpy array or a tensor; ``dtype`` overrides its on-disk
    dtype name (``Region.dtype``: "bfloat16" for uint16 bit patterns).

    With ``precomputed`` (device-side dirty tracking), the diff was already
    taken in device memory and only the dirty chunks crossed to the host —
    the patch is packed from it directly, no host hashing or copying
    (``arr`` and ``prev_fp`` are unused and may be None)."""
    if precomputed is not None:
        p = precomputed
        patch = DeltaPatch(shape=tuple(p.shape), dtype=p.dtype,
                           nbytes=p.nbytes, chunk_bytes=p.chunk_bytes,
                           base_version=base_version,
                           indices=np.asarray(p.indices, np.int64),
                           data=p.data, chunk_digests=list(p.chunk_digests),
                           full_digest=p.full_digest)
        return patch, p.fps
    arr, name = host_array(arr)
    raw = arr.reshape(-1).view(np.uint8)  # zero-copy byte view
    nbytes = raw.shape[0]
    new_fp = fingerprints(raw, chunk_bytes)
    idx = dirty_chunks(new_fp, prev_fp)
    # slice dirty chunks through the view (no full-buffer duplicate), batch
    # all their digests into one checksum-kernel dispatch, and copy only the
    # dirty bytes into the patch payload.
    views = [raw[_chunk_slices(nbytes, chunk_bytes, int(i))] for i in idx]
    digests = kops.chunk_digests(views)
    packed = np.empty(int(sum(v.shape[0] for v in views)), np.uint8)
    off = 0
    for v in views:
        packed[off:off + v.shape[0]] = v
        off += v.shape[0]
    patch = DeltaPatch(shape=tuple(arr.shape), dtype=dtype or name,
                       nbytes=nbytes, chunk_bytes=chunk_bytes,
                       base_version=base_version, indices=idx,
                       data=packed.tobytes(), chunk_digests=digests,
                       full_digest=kops.digest(raw))
    return patch, new_fp


def encode_patch(p: DeltaPatch) -> bytes:
    header = json.dumps({
        "shape": list(p.shape), "dtype": p.dtype, "nbytes": p.nbytes,
        "chunk_bytes": p.chunk_bytes, "base_version": p.base_version,
        "indices": [int(i) for i in p.indices],
        "chunk_digests": p.chunk_digests, "full_digest": p.full_digest,
    }).encode()
    return (DELTA_MAGIC + np.uint64(len(header)).tobytes() + header + p.data)


def decode_patch(blob: bytes | memoryview) -> DeltaPatch:
    blob = bytes(blob)
    if blob[:6] != DELTA_MAGIC:
        raise IOError("bad delta patch magic")
    hlen = int(np.frombuffer(blob[6:14], np.uint64)[0])
    h = json.loads(blob[14:14 + hlen].decode())
    return DeltaPatch(shape=tuple(h["shape"]), dtype=h["dtype"],
                      nbytes=h["nbytes"], chunk_bytes=h["chunk_bytes"],
                      base_version=h["base_version"],
                      indices=np.asarray(h["indices"], np.int64),
                      data=blob[14 + hlen:],
                      chunk_digests=h["chunk_digests"],
                      full_digest=h["full_digest"])


def overlay(base, patch: DeltaPatch, *, verify: bool = True):
    """Reapply ``patch`` over ``base`` (numpy, or a ``torch.bfloat16``
    tensor as ``ShardReader.read`` returns one) -> the patched array,
    byte-identical to the array the patch was made from, in the form
    ``format.array_from_bytes`` gives.  Verifies each applied chunk and the
    final full-array digest; raises IOError on any mismatch."""
    base, base_dtype = host_array(base)
    if tuple(base.shape) != tuple(patch.shape) or base_dtype != patch.dtype:
        raise IOError(
            f"delta base mismatch: have {base.shape}/{base_dtype}, patch "
            f"expects {patch.shape}/{patch.dtype}")
    buf = bytearray(base.tobytes())
    if len(buf) != patch.nbytes:
        raise IOError(f"delta base is {len(buf)}B, patch expects "
                      f"{patch.nbytes}B")
    off = 0
    data = memoryview(patch.data)
    spans: list[tuple[int, int, slice, memoryview]] = []
    for j, i in enumerate(patch.indices):
        sl = _chunk_slices(patch.nbytes, patch.chunk_bytes, int(i))
        n = sl.stop - sl.start
        chunk = data[off:off + n]
        if len(chunk) != n:
            raise IOError(f"delta chunk {int(i)} truncated "
                          f"({len(chunk)}B < {n}B)")
        spans.append((j, int(i), sl, chunk))
        off += n
    if verify and patch.chunk_digests:
        # one checksum-kernel dispatch for every chunk's digest, not one per
        # chunk (same batching as make_patch)
        got = kops.chunk_digests([c for (_, _, _, c) in spans])
        for (j, i, _, _), d in zip(spans, got):
            if d != patch.chunk_digests[j]:
                raise IOError(f"delta chunk {i} checksum mismatch")
    for _, _, sl, chunk in spans:
        buf[sl] = chunk
    out = bytes(buf)
    if verify and patch.full_digest and \
            kops.digest(out) != patch.full_digest:
        raise IOError("delta overlay full-array checksum mismatch")
    return array_from_bytes(out, patch.dtype, patch.shape)


class DeltaTracker:
    """Fingerprint + chain state for one (checkpoint name, rank) stream.

    ``fps`` maps region name -> fingerprint array of the *last version that
    went through the pipeline*; ``base_version`` is the most recent full
    shard, ``last_version`` the immediate parent for the next delta, and
    ``chain_len`` the number of deltas since the base."""

    def __init__(self):
        self.fps: dict[str, np.ndarray] = {}
        self.base_version: Optional[int] = None
        self.last_version: Optional[int] = None
        self.chain_len: int = 0

    @property
    def empty(self) -> bool:
        return self.base_version is None

    def note_full(self, version: int, fps: dict[str, np.ndarray]):
        self.fps = fps
        self.base_version = version
        self.last_version = version
        self.chain_len = 0

    def note_delta(self, version: int, fps: dict[str, np.ndarray]):
        self.fps = fps
        self.last_version = version
        self.chain_len += 1

    def note_compacted(self, version: int):
        """A chain up to ``version`` was folded into a full shard: same
        bytes, new base — fingerprints stay valid."""
        if self.last_version == version:
            self.base_version = version
            self.chain_len = 0

    def needs_compaction(self, threshold: int) -> bool:
        """True when the live chain carries at least ``threshold`` deltas
        since its full base — the client's auto-compaction trigger (the
        fold itself runs inline or in the backend's maintenance lane,
        depending on ``compact_async``)."""
        return bool(threshold) and self.last_version is not None \
            and self.chain_len >= threshold
