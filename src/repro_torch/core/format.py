"""Checkpoint shard binary format + global manifest (two-phase commit).

Shard layout:  [MAGIC 8B][header_len u64][header JSON][payload bytes...]
The header's region table records (name, shape, dtype, offset, nbytes,
digest, encoding) per protected region — the on-disk realization of the
VELOC ``mem_protect`` declarations.  Encodings: "raw" and "zlib"; "q8"
(block int8) and "delta" are not ported yet and raise NotImplementedError.
The bytes are identical to the JAX package's, so either package reads the
other's checkpoints.  bfloat16 regions, which numpy cannot hold, travel as
their 16-bit patterns with the dtype name "bfloat16" and read back as
``torch.bfloat16`` tensors.

The manifest is the collective-commit record: shards are written first
(atomic per-tier), then the manifest is published atomically; a checkpoint
version exists iff its manifest does — torn checkpoints are impossible.

The *segment* container (aggregated write path, Gossman et al. "Towards
Aggregated Asynchronous Checkpointing") coalesces many small per-version
blobs — every rank's shard, the group parity, the manifests — into ONE
sequential object:  [SEG magic 8B][header_len u64][header JSON][payload].
The header's entry index records (name, offset, length, digest) per staged
blob; ``SegmentReader`` validates every entry's bounds up front, so a torn
or truncated segment fails loudly at parse time and restart can skip it
with a diagnostic instead of silently decoding garbage.  The same
record-level framing (``encode_log_record`` / ``scan_log_records``) backs
the KVTier's append-only journal log.
"""
from __future__ import annotations

import io
import json
import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

MAGIC = b"VELOCJX1"


@dataclass
class Region:
    name: str
    #: host bytes of the region: a numpy array, or a tensor (copied to the
    #: host at serialization, see ``host_array``)
    array: Any
    # global layout metadata for elastic restart:
    global_shape: tuple = ()
    shard_axis: int = -1  # axis this rank's piece slices (-1 = replicated)
    shard_index: int = 0
    shard_count: int = 1
    #: on-disk dtype name when it is not ``str(array.dtype)``: "bfloat16"
    #: for a uint16 array holding bfloat16 bit patterns
    dtype: Optional[str] = None


_NOT_PORTED_Q8 = ('the "q8" encoding is not ported yet (ROADMAP.md queue 1, '
                  "item 6)")
_NOT_PORTED_DELTA = ("delta-encoded regions are not ported yet (ROADMAP.md "
                     "queue 1, item 4)")


def host_array(value) -> tuple[np.ndarray, str]:
    """``(contiguous numpy array, on-disk dtype name)`` of a region value.

    A tensor is copied to the host here (the device-to-host stage of the
    pipeline).  numpy has no bfloat16, so a bfloat16 tensor comes back as
    its uint16 bit patterns named "bfloat16" — the name the JAX package
    writes for its ml_dtypes arrays."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).cpu().numpy()
            return np.ascontiguousarray(bits).view(np.uint16), "bfloat16"
        arr = np.ascontiguousarray(t.cpu().numpy())
        return arr, str(arr.dtype)
    arr = np.ascontiguousarray(value)
    return arr, str(arr.dtype)


def array_from_bytes(buf, dtype: str, shape) -> Any:
    """Inverse of ``host_array`` over raw bytes: a numpy array, or a
    ``torch.bfloat16`` tensor for "bfloat16" (decoded without ml_dtypes)."""
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def serialize_shard(regions: list[Region], meta: dict, *, encoding: str = "raw",
                    checksums: bool = True) -> bytes:
    if encoding == "q8":
        raise NotImplementedError(_NOT_PORTED_Q8)
    payload = io.BytesIO()
    table = []
    for r in regions:
        arr, dtype = host_array(r.array)
        entry = {
            "name": r.name,
            "shape": list(arr.shape),
            "dtype": r.dtype or dtype,
            "global_shape": list(r.global_shape or arr.shape),
            "shard_axis": r.shard_axis,
            "shard_index": r.shard_index,
            "shard_count": r.shard_count,
            "encoding": encoding,
        }
        if encoding == "zlib":
            blob = zlib.compress(arr.tobytes(), level=1)
        else:
            entry["encoding"] = "raw"
            blob = arr.tobytes()
        if checksums:
            entry["digest"] = kops.digest(blob)
        entry["offset"] = payload.tell()
        entry["nbytes"] = len(blob)
        payload.write(blob)
        table.append(entry)
    header = json.dumps({"regions": table, "meta": meta}).encode()
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(np.uint64(len(header)).tobytes())
    out.write(header)
    out.write(payload.getbuffer())
    return out.getvalue()


class ShardReader:
    def __init__(self, blob: bytes):
        assert blob[:8] == MAGIC, "bad shard magic"
        hlen = int(np.frombuffer(blob[8:16], np.uint64)[0])
        self.header = json.loads(blob[16:16 + hlen].decode())
        self._payload = memoryview(blob)[16 + hlen:]

    @property
    def meta(self) -> dict:
        return self.header["meta"]

    @property
    def region_names(self) -> list[str]:
        return [r["name"] for r in self.header["regions"]]

    def entry(self, name: str) -> dict:
        for r in self.header["regions"]:
            if r["name"] == name:
                return r
        raise KeyError(name)

    def verify(self, name: str) -> bool:
        e = self.entry(name)
        if "digest" not in e:
            return True
        blob = bytes(self._payload[e["offset"]:e["offset"] + e["nbytes"]])
        return kops.digest(blob) == e["digest"]

    def delta_regions(self) -> list[str]:
        """Names of regions stored as deltas (need a base to reconstruct)."""
        return [r["name"] for r in self.header["regions"]
                if r["encoding"] == "delta"]

    def read(self, name: str, *, verify: bool = True, base=None):
        """The region's array: numpy, or a ``torch.bfloat16`` tensor for a
        bfloat16 region (see ``array_from_bytes``)."""
        e = self.entry(name)
        if e["encoding"] == "delta":
            raise NotImplementedError(_NOT_PORTED_DELTA)
        if e["encoding"] == "q8":
            raise NotImplementedError(_NOT_PORTED_Q8)
        blob = bytes(self._payload[e["offset"]:e["offset"] + e["nbytes"]])
        if verify and "digest" in e and kops.digest(blob) != e["digest"]:
            raise IOError(f"checksum mismatch in region {name!r}")
        shape = tuple(e["shape"])
        if e["encoding"] == "zlib":
            blob = zlib.decompress(blob)
        return array_from_bytes(blob, e["dtype"], shape)


# ---------------------------------------------------------------------------
# segment container (aggregated write path)
# ---------------------------------------------------------------------------

SEGMENT_MAGIC = b"VSEGJX1\x00"


def segment_key(name: str, version: int) -> str:
    """Key of the aggregated segment holding one version's small blobs."""
    return f"{name}/v{version:08d}/segment"


def encode_segment(entries, meta: dict | None = None) -> bytes:
    """Pack named blobs into one sequential segment object.

    ``entries`` is a dict or (key, bytes) iterable; each entry lands in the
    header index as (name, offset, length, digest) so readers can resolve
    and verify a single entry without touching the rest of the payload."""
    items = entries.items() if isinstance(entries, dict) else entries
    payload = io.BytesIO()
    table = []
    for key, blob in items:
        blob = bytes(blob)
        table.append({"name": key, "offset": payload.tell(),
                      "length": len(blob), "digest": kops.digest(blob)})
        payload.write(blob)
    header = json.dumps({"entries": table, "meta": meta or {}}).encode()
    out = io.BytesIO()
    out.write(SEGMENT_MAGIC)
    out.write(np.uint64(len(header)).tobytes())
    out.write(header)
    out.write(payload.getbuffer())
    return out.getvalue()


class SegmentReader:
    """Index + entry access over one segment blob.

    Parsing is strict: bad magic, an unparseable header, or any entry whose
    (offset, length) extends past the payload raises IOError immediately —
    a segment truncated mid-entry can never be half-read.  ``read`` verifies
    the per-entry digest (IOError on mismatch)."""

    def __init__(self, blob: bytes):
        blob = bytes(blob)
        if len(blob) < 16 or blob[:8] != SEGMENT_MAGIC:
            raise IOError("bad segment magic")
        hlen = int(np.frombuffer(blob[8:16], np.uint64)[0])
        if 16 + hlen > len(blob):
            raise IOError(f"segment header truncated "
                          f"({len(blob) - 16}B < {hlen}B)")
        try:
            header = json.loads(blob[16:16 + hlen].decode())
            table = header["entries"]
        except Exception as e:  # noqa: BLE001 — any parse failure = torn
            raise IOError(f"segment header unparseable: {e}") from None
        self._payload = memoryview(blob)[16 + hlen:]
        self.meta: dict = header.get("meta", {})
        self._index: dict[str, dict] = {}
        for e in table:
            if e["offset"] + e["length"] > len(self._payload):
                raise IOError(
                    f"segment entry {e['name']!r} truncated: needs bytes "
                    f"[{e['offset']}, {e['offset'] + e['length']}) of a "
                    f"{len(self._payload)}B payload")
            self._index[e["name"]] = e

    def names(self) -> list[str]:
        return list(self._index)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def entry(self, name: str) -> dict:
        return self._index[name]

    def read(self, name: str, *, verify: bool = True) -> bytes:
        e = self._index[name]
        blob = bytes(self._payload[e["offset"]:e["offset"] + e["length"]])
        if verify and kops.digest(blob) != e["digest"]:
            raise IOError(f"segment entry {name!r} checksum mismatch")
        return blob


# ---------------------------------------------------------------------------
# rolling pack (cross-version segment packing)
# ---------------------------------------------------------------------------

#: ``meta["kind"]`` marker distinguishing a rolling pack from a per-version
#: segment (both share the segment container framing).
PACK_META_KIND = "rolling-pack"


def pack_key(name: str, seq: int) -> str:
    """Key of a rolling segment packing several consecutive *delta*
    versions of one stream.  Deliberately OUTSIDE every version's key
    prefix (``version_prefix``): a pack is shared by its member versions,
    so per-version prefix GC must never delete it — retiring one member is
    a maintenance-lane re-pack of the survivors instead."""
    return f"{name}/pack/{seq:08d}"


def pack_prefix(name: str) -> str:
    """Key prefix every rolling pack of ``name`` lives under."""
    return f"{name}/pack/"


def encode_pack(name: str, entries, versions: list[int],
                meta: dict | None = None) -> bytes:
    """Pack several versions' staged blobs into one rolling segment.

    ``entries`` keys keep their full per-version form
    (``name/vNNNNNNNN/...``), so one container carries many versions and a
    reader can slice out any member; the *packing record* —
    ``meta["versions"]`` — names the member versions so a fresh process can
    index packs without parsing every entry key."""
    m = dict(meta or {})
    m["kind"] = PACK_META_KIND
    m["name"] = name
    m["versions"] = sorted(int(v) for v in versions)
    return encode_segment(entries, meta=m)


class PackReader(SegmentReader):
    """SegmentReader over a rolling pack: same strict parse + per-entry
    digests, plus the packing record (which versions live inside)."""

    @property
    def versions(self) -> list[int]:
        return [int(v) for v in self.meta.get("versions", [])]

    def entries_for(self, name: str, version: int) -> list[str]:
        """Entry names belonging to one member version."""
        pfx = version_prefix(name, version)
        return [n for n in self.names() if n.startswith(pfx)]


# ---------------------------------------------------------------------------
# durable stream catalog
# ---------------------------------------------------------------------------

CATALOG_MAGIC = b"VCATJX1\x00"
#: bump when the catalog record layout changes; decoders refuse unknown
#: schemas loudly instead of guessing.
CATALOG_SCHEMA = 1
_CATALOG_DIGEST_LEN = 24


def catalog_key(name: str) -> str:
    """Key of the stream's durable catalog blob.  Like pack keys it lives
    OUTSIDE every version prefix (``version_prefix``), so per-version
    prefix GC can never delete it."""
    return f"{name}/catalog"


def encode_catalog(name: str, versions: dict, tombstones=(), *,
                   gen: int = 1, writer: str = "") -> bytes:
    """One small digest-framed blob persisting a stream's durability state.

    ``versions`` maps version number -> record: ``kind`` ("full"/"delta"),
    ``parent`` link, ``sealed`` state, ``location``
    ("direct"/"segment"/"pack"), the ``pack`` key + ``entries`` set for
    packed versions, completed ``levels``, and the writing run's ``stamp``
    (its incarnation identity — a later run may legitimately reuse the
    version number).  ``tombstones`` is an iterable of ``(version, stamp)``
    retirement markers: a record whose stamp matches a tombstone is dead
    and must never be resurrected by a concurrent read-modify-write.
    ``gen`` is the monotonically increasing write generation used by RMW
    staleness checks.  Layout: MAGIC + body digest + JSON body."""
    recs = {}
    for v, rec in versions.items():
        r = dict(rec)
        if r.get("entries") is not None:
            r["entries"] = sorted(r["entries"])
        recs[str(int(v))] = r
    body = json.dumps(
        {"schema": CATALOG_SCHEMA, "name": name, "gen": int(gen),
         "writer": writer, "versions": recs,
         "tombstones": [[int(v), str(s)] for v, s in tombstones]},
        sort_keys=True).encode()
    return CATALOG_MAGIC + kops.digest(body).encode("ascii") + body


def decode_catalog(blob: bytes) -> dict:
    """Parse a catalog blob; version keys come back as ints.

    Strict by design: bad magic, a digest mismatch (torn or corrupt
    write), unparseable JSON or an unknown schema all raise IOError — a
    damaged catalog must make the caller fall back to scan discovery, not
    silently drop versions from GC's or restart's view."""
    blob = bytes(blob)
    head = len(CATALOG_MAGIC)
    if len(blob) < head + _CATALOG_DIGEST_LEN or blob[:head] != CATALOG_MAGIC:
        raise IOError("bad catalog magic")
    want = blob[head:head + _CATALOG_DIGEST_LEN].decode("ascii", "replace")
    body = blob[head + _CATALOG_DIGEST_LEN:]
    if kops.digest(bytes(body)) != want:
        raise IOError("catalog digest mismatch (torn or corrupt write)")
    try:
        d = json.loads(body.decode())
    except Exception as e:  # noqa: BLE001 — any parse failure = corrupt
        raise IOError(f"catalog body unparseable: {e}") from None
    if not isinstance(d, dict) or d.get("schema") != CATALOG_SCHEMA:
        found = d.get("schema") if isinstance(d, dict) else None
        raise IOError(f"unsupported catalog schema {found!r} "
                      f"(this reader speaks schema {CATALOG_SCHEMA})")
    d["versions"] = {int(v): rec for v, rec in d.get("versions", {}).items()}
    d["tombstones"] = [[int(v), str(s)] for v, s in d.get("tombstones", [])]
    return d


# ---------------------------------------------------------------------------
# append-only log records (KV journal)
# ---------------------------------------------------------------------------

LOG_RECORD_MAGIC = b"VLOGJX1\x00"
_LOG_DIGEST_LEN = 24


def encode_log_record(key: str, data: bytes | None) -> bytes:
    """One self-framing journal record: magic + key length (u32) + data
    length (i64, -1 = tombstone) + key + digest + data.  The digest makes a
    corrupted record detectable; the explicit lengths let a scanner resync
    past it when the framing itself is intact."""
    kb = key.encode()
    payload = b"" if data is None else bytes(data)
    out = io.BytesIO()
    out.write(LOG_RECORD_MAGIC)
    out.write(np.uint32(len(kb)).tobytes())
    out.write(np.int64(-1 if data is None else len(payload)).tobytes())
    out.write(kb)
    out.write(kops.digest(payload).encode("ascii"))
    out.write(payload)
    return out.getvalue()


def scan_log_records(blob: bytes
                     ) -> tuple[list[tuple[str, bytes | None]], list[str]]:
    """Replay an append-only log -> (records, skipped).

    ``records`` preserves append order; a ``None`` value is a tombstone.
    A record whose digest fails is skipped (its key lands in ``skipped``)
    and the scan continues.  A corrupt FRAME (bad magic or lying lengths)
    resyncs by scanning forward to the next record magic, so a flipped
    byte mid-log costs that record, not every record after it; only a torn
    tail with no further magic stops the scan."""
    records: list[tuple[str, bytes | None]] = []
    skipped: list[str] = []
    off, total = 0, len(blob)
    hdr = len(LOG_RECORD_MAGIC) + 4 + 8

    def resync(bad_off: int) -> int:
        nxt = blob.find(LOG_RECORD_MAGIC, bad_off + 1)
        if nxt < 0:
            skipped.append(f"<torn log frame at offset {bad_off}>")
            return total
        skipped.append(f"<corrupt log frame at offset {bad_off}, "
                       f"resynced at {nxt}>")
        return nxt

    while off < total:
        if off + hdr > total or \
                blob[off:off + len(LOG_RECORD_MAGIC)] != LOG_RECORD_MAGIC:
            off = resync(off)
            continue
        klen = int(np.frombuffer(
            blob[off + len(LOG_RECORD_MAGIC):off + len(LOG_RECORD_MAGIC) + 4],
            np.uint32)[0])
        dlen = int(np.frombuffer(
            blob[off + len(LOG_RECORD_MAGIC) + 4:off + hdr], np.int64)[0])
        body = off + hdr
        nbytes = max(dlen, 0)
        if body + klen + _LOG_DIGEST_LEN + nbytes > total:
            off = resync(off)
            continue
        key = blob[body:body + klen].decode("utf-8", "replace")
        want = blob[body + klen:body + klen + _LOG_DIGEST_LEN] \
            .decode("ascii", "replace")
        data = blob[body + klen + _LOG_DIGEST_LEN:
                    body + klen + _LOG_DIGEST_LEN + nbytes]
        if kops.digest(data) != want:
            skipped.append(key)
        else:
            records.append((key, None if dlen < 0 else bytes(data)))
        off = body + klen + _LOG_DIGEST_LEN + nbytes
    return records, skipped


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def version_prefix(name: str, version: int) -> str:
    """Key prefix shared by every artifact of one checkpoint version
    (shards, partner copies, parity blobs, per-level manifests)."""
    return f"{name}/v{version:08d}/"


def manifest_key(name: str, version: int) -> str:
    return f"{name}/v{version:08d}/manifest"


def shard_key(name: str, version: int, rank: int) -> str:
    return f"{name}/v{version:08d}/shard_{rank:05d}"


def parity_key(name: str, version: int, group: int) -> str:
    return f"{name}/v{version:08d}/parity_{group:05d}"


def make_manifest(name: str, version: int, nranks: int, *, level: str,
                  shard_digests: dict[int, str], meta: dict | None = None,
                  parent: int | None = None, group_size: int = 0) -> bytes:
    return json.dumps({
        "name": name, "version": version, "nranks": nranks, "level": level,
        "shard_digests": {str(k): v for k, v in shard_digests.items()},
        "meta": meta or {}, "parent": parent, "group_size": group_size,
        "complete": True,
    }).encode()


def parse_manifest(blob: bytes) -> dict:
    m = json.loads(blob.decode())
    m["shard_digests"] = {int(k): v for k, v in m["shard_digests"].items()}
    return m
