"""Heterogeneous storage-tier abstraction (VELOC §2, "hidden complexity of
heterogeneous storage").

One put/get API over every tier so upper layers never see vendor APIs:

  DRAMTier  — node-local memory (fastest, volatile; dies with the node)
  FileTier  — node-local SSD or the external parallel file system (a POSIX
              directory; Lustre stand-in)
  KVTier    — key-value object store (DAOS stand-in; the paper's recent
              DAOS module uses exactly a low-level put/get pair)

Tiers carry nominal bandwidth/persistency metadata used by the tier
*scheduler* (pick_tier) — faithful to the paper's observation that the
fastest tier is not always optimal under producer-consumer concurrency
[IPDPS'19]: a tier busy draining to the next level is deprioritized.

The v2 surface makes the tier stack *declarative*: ``TierSpec`` names a
registered tier kind + its options, ``TierTopology`` lists the node-local
and external specs, and ``Cluster`` builds its fabric from the topology.
New tier kinds (burst buffer, object store, ...) plug in via
``@register_tier("kind")`` without touching the cluster or the modules.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import concurrency
from repro_torch.core.concurrency import TrackedLock

_UNESCAPE_RE = re.compile(r"_[us]")


def escape_key(key: str) -> str:
    """Filesystem-safe, *reversible* encoding of a storage key.

    The historical ``key.replace("/", "__")`` was lossy: a checkpoint name
    containing ``__`` round-tripped through ``keys()`` as ``/``, so prefix
    GC could miss or mis-list artifacts.  This is a character homomorphism
    ("_" -> "_u", "/" -> "_s"), so it is bijective AND prefix-preserving:
    ``escape(p)`` is a prefix of ``escape(k)`` iff ``p`` is a prefix of
    ``k`` — exactly what prefix listing needs."""
    return key.replace("_", "_u").replace("/", "_s")


def unescape_key(name: str) -> str:
    return _UNESCAPE_RE.sub(
        lambda m: "_" if m.group(0) == "_u" else "/", name)


@dataclass
class TierInfo:
    name: str
    kind: str  # dram | file | kv
    gbps: float  # nominal bandwidth
    persistent: bool  # survives node failure
    node_local: bool  # dies with the node
    #: opt-in to the aggregated write path: per-version small blobs are
    #: coalesced into one segment put on this tier (high-latency external
    #: stores benefit; DRAM/node-local tiers keep direct puts).
    aggregate: bool = False
    #: cross-version packing (requires ``aggregate``): up to this many
    #: consecutive *delta* versions of a stream share one rolling segment,
    #: sealed in a single put at the pack boundary.  0/1 = one segment per
    #: version (the plain aggregated path).  Delta versions waiting in an
    #: open pack are L1/L2-protected only until the pack seals.
    pack_versions: int = 0
    #: durable stream catalog: this tier holds one small digest-framed
    #: catalog blob per stream (repro_torch.core.format.encode_catalog) recording
    #: every externally visible version's kind/parent/seal/pack state —
    #: what makes GC restart-safe and restart planning O(1) key listings.
    catalog: bool = False


class StorageTier:
    info: TierInfo

    #: EWMA smoothing for the observed get latency: heavy enough that one
    #: outlier doesn't whipsaw the source ranking, light enough that a tier
    #: going slow is noticed within a handful of gets.
    _EWMA_ALPHA = 0.2
    #: Winsorization cap for each latency sample, as a multiple of the
    #: current EWMA.  A single straggler (GC pause, one stalled RPC) must
    #: not blow up the estimate — hedge budgets are ``factor x EWMA``, so
    #: a poisoned EWMA silently disables hedging for the very stalls it
    #: exists to cover.  A genuine regime change still converges: samples
    #: keep clamping at the cap, growing the EWMA geometrically
    #: (x ``1 + alpha*(cap-1)`` per get) until it meets the new level.
    _EWMA_SAMPLE_CAP = 4.0

    def __init__(self, info: TierInfo):
        self.info = info
        self._lock = TrackedLock(f"tier:{info.name}._lock",
                                 concurrency.RANK_TIER)
        self._inflight = 0  # concurrent writers (producer-consumer pressure)
        self.put_calls = 0  # lifetime put count (small-write accounting)
        self.get_calls = 0  # lifetime get count (read-amplification audit)
        self.delete_calls = 0  # lifetime delete count (GC amplification)
        self.keys_calls = 0  # lifetime keys() listings (restart-planning
        #                      accounting: catalog-first restart needs zero)
        # -- read telemetry (multi-source restore scheduling) -------------
        # Updated lock-free like the counters above: single attribute
        # stores are GIL-atomic and an occasionally-stale read only skews
        # a heuristic ranking, never correctness.
        self.bytes_read = 0  # payload bytes served by get() hits
        self.ewma_get_s: Optional[float] = None  # observed get latency
        self.miss_streak = 0   # consecutive gets that returned None
        self.error_streak = 0  # consecutive gets that raised
        self.hedge_wins = 0    # hedged restore reads this tier won
        self.hedge_losses = 0  # hedges launched here beaten by the primary

    # -- accounting used by pick_tier ------------------------------------
    def busy(self) -> int:
        return self._inflight

    def reset_io_counters(self) -> None:
        """Zero the lifetime put/get/delete/keys counters so a benchmark
        or test can audit one phase in isolation (e.g. "this restore
        performed zero listings") without tracking deltas by hand.  Read
        telemetry counters reset too; the latency EWMA survives — it is a
        live estimate, not a phase counter."""
        with self._lock:
            self.put_calls = 0
            self.get_calls = 0
            self.delete_calls = 0
            self.keys_calls = 0
            self.bytes_read = 0
            self.miss_streak = 0
            self.error_streak = 0
            self.hedge_wins = 0
            self.hedge_losses = 0

    def _note_get(self, dt_s: float, blob: Optional[bytes],
                  error: bool = False) -> None:
        prev = self.ewma_get_s
        if prev is None:
            self.ewma_get_s = dt_s
        else:
            dt_s = min(dt_s, self._EWMA_SAMPLE_CAP * prev)  # tail-resistant
            self.ewma_get_s = prev + self._EWMA_ALPHA * (dt_s - prev)
        if error:
            self.error_streak += 1
            return
        self.error_streak = 0
        if blob is None:
            self.miss_streak += 1
        else:
            self.miss_streak = 0
            self.bytes_read += len(blob)

    def read_cost(self, nbytes: int = 1 << 20) -> float:
        """Estimated seconds to serve ``nbytes`` from this tier right now:
        observed get latency (EWMA; the nominal transfer time before any
        get completed) plus the nominal transfer time, scaled by write
        pressure like ``pick_tier`` — and penalized by the current
        miss/error streak so a source that keeps coming up empty or keeps
        raising sinks in the restore ranking until it serves again."""
        xfer = nbytes / (max(self.info.gbps, 1e-3) * 1e9)
        lat = self.ewma_get_s if self.ewma_get_s is not None else xfer
        cost = (lat + xfer) * (1 + self.busy())
        return cost * (1 + self.miss_streak + 2 * self.error_streak)

    def read_stats(self) -> dict:
        """Operator snapshot of the read telemetry (surfaced cluster-wide
        via ``Cluster.tier_read_stats`` and ``backend.status()["tiers"]``)."""
        return {"gets": self.get_calls,
                "bytes": self.bytes_read,
                "ewma_get_ms": round((self.ewma_get_s or 0.0) * 1e3, 4),
                "miss_streak": self.miss_streak,
                "error_streak": self.error_streak,
                "hedge_wins": self.hedge_wins,
                "hedge_losses": self.hedge_losses}

    def _enter(self):
        concurrency.note_tier_io(self, "put")
        with self._lock:
            self._inflight += 1
            self.put_calls += 1

    def _exit(self):
        with self._lock:
            self._inflight -= 1

    # -- API --------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        """Fetch one key (None when absent).  Counted in ``get_calls``,
        checked by the IO-under-lock detector, and timed into the read
        telemetry (EWMA latency, bytes served, miss/error streaks) that
        drives ``read_cost`` source ranking; subclasses implement
        ``_get``."""
        self.get_calls += 1
        concurrency.note_tier_io(self, "get")
        t0 = time.perf_counter()
        try:
            blob = self._get(key)
        except BaseException:
            self._note_get(time.perf_counter() - t0, None, error=True)
            raise
        self._note_get(time.perf_counter() - t0, blob)
        return blob

    def _get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove one key (idempotent).  Counted in ``delete_calls`` and
        checked by the IO-under-lock detector; subclasses implement
        ``_delete``."""
        self.delete_calls += 1
        concurrency.note_tier_io(self, "delete")
        self._delete(key)

    def _delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> list[str]:
        """List keys under ``prefix``.  Counted in ``keys_calls`` so the
        restart planner's O(versions) -> O(1) listing claim is auditable;
        subclasses implement ``_keys``."""
        self.keys_calls += 1
        concurrency.note_tier_io(self, "keys")
        return self._keys(prefix)

    def _keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def wipe(self) -> None:
        """Simulate losing this tier (node failure)."""
        for k in list(self.keys()):
            self.delete(k)


class DRAMTier(StorageTier):
    def __init__(self, name="dram", gbps=100.0):
        super().__init__(TierInfo(name, "dram", gbps, persistent=False,
                                  node_local=True))
        self._store: dict[str, bytes] = {}

    def put(self, key, data):
        self._enter()
        try:
            self._store[key] = bytes(data)
        finally:
            self._exit()

    def _get(self, key):
        return self._store.get(key)

    def exists(self, key):
        return key in self._store

    def _delete(self, key):
        self._store.pop(key, None)

    def _keys(self, prefix=""):
        return [k for k in self._store if k.startswith(prefix)]


class FileTier(StorageTier):
    def __init__(self, root: str, name="file", gbps=5.0, persistent=True,
                 node_local=False, aggregate=False, pack_versions=0,
                 catalog=False):
        super().__init__(TierInfo(name, "file", gbps, persistent, node_local,
                                  aggregate=aggregate,
                                  pack_versions=pack_versions,
                                  catalog=catalog))
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, escape_key(key))

    def put(self, key, data):
        self._enter()
        try:
            tmp = self._path(key) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(key))  # atomic publish
        finally:
            self._exit()

    def _get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, key):
        return os.path.exists(self._path(key))

    def _delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def _keys(self, prefix=""):
        safe = escape_key(prefix)
        return [unescape_key(f) for f in os.listdir(self.root)
                if f.startswith(safe) and not f.endswith(".tmp")]


#: Legacy per-key KV journal framing (pre-log format): magic + 24-hex-char
#: digest + payload, one file per key.  Still readable on load; folded into
#: the snapshot at the next journal compaction.
KV_JOURNAL_MAGIC = b"VKVJ1\x00"
_KV_DIGEST_LEN = 24

#: Files the log-structured journal owns inside its directory; anything
#: else in there is a legacy per-key entry.
_KV_LOG_FILE = "log"
_KV_SNAPSHOT_FILE = "snapshot"


class KVTier(StorageTier):
    """DAOS stand-in: optimized low-level put/get of key-value pairs, with an
    optional journal directory for persistence across restarts.

    The journal is log-structured (the historical one-file-per-key layout
    grew an unbounded directory and paid a create+fsync+rename per put):
    puts and deletes append digest-framed records to a single ``log`` file
    (fsync per append — a crash can tear at most the final record, and the
    scanner detects it), and every ``compact_every`` records the store is
    folded into a ``snapshot`` segment (repro_torch.core.format segment framing,
    atomic publish) and the log truncated.  Legacy per-key files are still
    loaded and are absorbed into the snapshot at the first compaction.
    Records that fail their digest on reload are skipped, never trusted —
    a poisoned value would defeat restart's fallback."""

    def __init__(self, name="kv", gbps=20.0, journal: Optional[str] = None,
                 compact_every: int = 512, aggregate: bool = False,
                 pack_versions: int = 0, catalog: bool = False):
        super().__init__(TierInfo(name, "kv", gbps, persistent=journal is not None,
                                  node_local=False, aggregate=aggregate,
                                  pack_versions=pack_versions,
                                  catalog=catalog))
        self._store: dict[str, bytes] = {}
        self._journal = journal
        self._compact_every = compact_every
        self._log_records = 0  # appended since the last snapshot
        self._log_f = None
        self._journal_lock = TrackedLock(  # append/compact serialization
            f"tier:{name}._journal_lock", concurrency.RANK_JOURNAL)
        self.journal_skipped: list[str] = []  # corrupted entries on reload
        if journal and os.path.isdir(journal):
            self._load_journal()

    # -- journal persistence ---------------------------------------------
    def _load_journal(self):
        from repro_torch.core import format as fmt
        from repro_torch.kernels import ops as kops

        j = self._journal
        # legacy per-key entries FIRST: they predate the log format, so the
        # snapshot/log must override them (a legacy file that survives a
        # crash mid-compaction must not resurrect its stale value).
        for f in os.listdir(j):
            if f in (_KV_LOG_FILE, _KV_SNAPSHOT_FILE) or f.endswith(".tmp"):
                continue
            with open(os.path.join(j, f), "rb") as fh:
                blob = fh.read()
            key = unescape_key(f)
            if not blob.startswith(KV_JOURNAL_MAGIC):
                self.journal_skipped.append(key)
                continue
            head = len(KV_JOURNAL_MAGIC)
            want = blob[head:head + _KV_DIGEST_LEN].decode("ascii", "replace")
            data = blob[head + _KV_DIGEST_LEN:]
            if kops.digest(data) != want:
                self.journal_skipped.append(key)
                continue
            self._store[key] = data
        snap = os.path.join(j, _KV_SNAPSHOT_FILE)
        if os.path.exists(snap):
            with open(snap, "rb") as fh:
                blob = fh.read()
            try:
                reader = fmt.SegmentReader(blob)
            except Exception as e:  # noqa: BLE001 — torn snapshot: the log
                # (and any legacy files) still carry every live record.
                self.journal_skipped.append(f"<snapshot: {e}>")
            else:
                for k in reader.names():
                    try:
                        self._store[k] = reader.read(k)
                    except IOError:
                        self.journal_skipped.append(k)
        log = os.path.join(j, _KV_LOG_FILE)
        if os.path.exists(log):
            with open(log, "rb") as fh:
                blob = fh.read()
            records, skipped = fmt.scan_log_records(blob)
            for key, data in records:  # replay in append order
                if data is None:
                    self._store.pop(key, None)
                else:
                    self._store[key] = data
            self.journal_skipped.extend(skipped)
            self._log_records = len(records) + len(skipped)
            if any(s.startswith(("<torn", "<corrupt")) for s in skipped):
                # bad frame bytes must not stay in the file: a torn tail
                # would swallow every FUTURE append (the scanner stops
                # there), and resynced garbage would be re-skipped on every
                # reload — rewrite the log from the surviving records.
                tmp = log + ".tmp"
                with open(tmp, "wb") as fh:
                    for key, data in records:
                        fh.write(fmt.encode_log_record(key, data))
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, log)
                self._log_records = len(records)

    def _append_record(self, key: str, data: Optional[bytes]):
        from repro_torch.core import format as fmt

        with self._journal_lock:
            os.makedirs(self._journal, exist_ok=True)
            if self._log_f is None:
                self._log_f = open(
                    os.path.join(self._journal, _KV_LOG_FILE), "ab")
            self._log_f.write(fmt.encode_log_record(key, data))
            self._log_f.flush()
            os.fsync(self._log_f.fileno())
            self._log_records += 1
            want_compact = self._compact_every and \
                self._log_records >= self._compact_every
        if want_compact:
            self.compact_journal()

    def compact_journal(self):
        """Fold the journal into a fresh snapshot segment and truncate the
        log.  Crash-safe: the snapshot publishes atomically, and replaying a
        stale log over it is idempotent (the snapshot already reflects every
        record in it)."""
        from repro_torch.core import format as fmt

        if not self._journal:
            return
        with self._journal_lock:
            os.makedirs(self._journal, exist_ok=True)
            snap = os.path.join(self._journal, _KV_SNAPSHOT_FILE)
            blob = fmt.encode_segment(dict(self._store),
                                      meta={"kind": "kv-journal"})
            with open(snap + ".tmp", "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(snap + ".tmp", snap)  # atomic publish
            # absorb legacy per-key files BEFORE truncating the log: if we
            # crash in between, the log (with any tombstones for legacy
            # keys) still replays over the snapshot — removing them after
            # the truncate could resurrect a deleted legacy key.
            for f in os.listdir(self._journal):
                if f in (_KV_LOG_FILE, _KV_SNAPSHOT_FILE) or \
                        f.endswith(".tmp"):
                    continue
                try:
                    os.remove(os.path.join(self._journal, f))
                except FileNotFoundError:
                    pass
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None
            open(os.path.join(self._journal, _KV_LOG_FILE), "wb").close()
            self._log_records = 0

    # -- API --------------------------------------------------------------
    def put(self, key, data):
        self._enter()
        try:
            self._store[key] = bytes(data)
            if self._journal:
                self._append_record(key, self._store[key])
        finally:
            self._exit()

    def _get(self, key):
        return self._store.get(key)

    def exists(self, key):
        return key in self._store

    def _delete(self, key):
        existed = self._store.pop(key, None) is not None
        if self._journal and existed:
            self._append_record(key, None)  # tombstone

    def _keys(self, prefix=""):
        return [k for k in self._store if k.startswith(prefix)]


# ---------------------------------------------------------------------------
# declarative tier specs (v2 API)
# ---------------------------------------------------------------------------


@dataclass
class TierSpec:
    """One tier in a topology: a registered kind + placement metadata.

    ``name`` (and path-like options) may contain ``{rank}``, substituted
    when the tier is instantiated for a node ("dram{rank}" -> "dram0").
    ``options`` carries kind-specific settings (e.g. ``subdir`` for file
    tiers, ``journal`` for kv tiers), resolved by the kind's builder.
    """

    kind: str
    name: str = ""
    gbps: float = 1.0
    persistent: bool = True
    node_local: bool = False
    #: opt this tier into the aggregated write path (see TierInfo.aggregate)
    aggregate: bool = False
    #: cross-version packing width (see TierInfo.pack_versions); only
    #: meaningful together with ``aggregate=True``
    pack_versions: int = 0
    #: this tier holds the durable stream catalog (see TierInfo.catalog)
    catalog: bool = False
    options: dict = field(default_factory=dict)

    def resolved_name(self, rank: Optional[int] = None) -> str:
        return (self.name or self.kind).format(
            rank="" if rank is None else rank)


class TierRegistry:
    """Open kind -> tier-builder registry.  A builder is called as
    ``builder(spec, scratch=..., rank=...)`` and returns a StorageTier."""

    def __init__(self):
        self._builders: dict[str, Callable] = {}

    def register(self, kind: str, builder: Optional[Callable] = None, *,
                 override: bool = False):
        def do_register(b):
            if not override and kind in self._builders:
                raise ValueError(
                    f"tier kind {kind!r} already registered "
                    f"(pass override=True to replace)")
            self._builders[kind] = b
            return b

        if builder is not None:
            return do_register(builder)
        return do_register

    def create(self, spec: TierSpec, *, scratch: str,
               rank: Optional[int] = None) -> StorageTier:
        try:
            builder = self._builders[spec.kind]
        except KeyError:
            raise KeyError(
                f"unknown tier kind {spec.kind!r}; registered: "
                f"{sorted(self._builders)}") from None
        return builder(spec, scratch=scratch, rank=rank)

    def kinds(self) -> list[str]:
        return sorted(self._builders)

    def __contains__(self, kind: str) -> bool:
        return kind in self._builders


#: Default registry with the built-in kinds below.
TIERS = TierRegistry()


def register_tier(kind: str, builder: Optional[Callable] = None, *,
                  registry: Optional[TierRegistry] = None,
                  override: bool = False):
    """``@register_tier("bb")`` — add a tier builder to the default
    registry (or ``registry`` when given)."""
    return (registry or TIERS).register(kind, builder, override=override)


@register_tier("dram")
def _build_dram(spec: TierSpec, *, scratch: str, rank: Optional[int] = None):
    return DRAMTier(name=spec.resolved_name(rank), gbps=spec.gbps)


@register_tier("file")
def _build_file(spec: TierSpec, *, scratch: str, rank: Optional[int] = None):
    sub = spec.options.get("subdir", spec.name or "file")
    sub = sub.format(rank="" if rank is None else rank)
    return FileTier(os.path.join(scratch, sub), name=spec.resolved_name(rank),
                    gbps=spec.gbps, persistent=spec.persistent,
                    node_local=spec.node_local, aggregate=spec.aggregate,
                    pack_versions=spec.pack_versions, catalog=spec.catalog)


@register_tier("kv")
def _build_kv(spec: TierSpec, *, scratch: str, rank: Optional[int] = None):
    journal = spec.options.get("journal")
    if journal:
        journal = os.path.join(
            scratch, journal.format(rank="" if rank is None else rank))
    return KVTier(name=spec.resolved_name(rank), gbps=spec.gbps,
                  journal=journal, aggregate=spec.aggregate,
                  pack_versions=spec.pack_versions, catalog=spec.catalog,
                  compact_every=spec.options.get("compact_every", 512))


def default_node_specs() -> list[TierSpec]:
    return [
        TierSpec("dram", name="dram{rank}", gbps=100.0, persistent=False,
                 node_local=True),
        TierSpec("file", name="ssd{rank}", gbps=3.0, persistent=True,
                 node_local=True, options={"subdir": "node{rank}"}),
    ]


def default_external_specs() -> list[TierSpec]:
    return [TierSpec("file", name="pfs", gbps=1.0, persistent=True,
                     node_local=False, options={"subdir": "pfs"})]


@dataclass
class TierTopology:
    """Declarative cluster storage layout: per-node tier stack + shared
    external tiers, both lists of TierSpec.  Defaults reproduce the classic
    DRAM + node-local SSD + shared-PFS layout."""

    scratch: str = "/tmp/veloc"
    node: list[TierSpec] = field(default_factory=default_node_specs)
    external: list[TierSpec] = field(default_factory=default_external_specs)

    def build_node(self, rank: int) -> list[StorageTier]:
        return [TIERS.create(s, scratch=self.scratch, rank=rank)
                for s in self.node]

    def build_external(self) -> list[StorageTier]:
        return [TIERS.create(s, scratch=self.scratch) for s in self.external]


# ---------------------------------------------------------------------------
# durable stream catalog helpers
# ---------------------------------------------------------------------------


def read_catalog(tier: StorageTier, name: str):
    """Fetch + decode the stream's durable catalog from one tier.

    Returns ``(catalog, error)``: ``(dict, None)`` on success, ``(None,
    None)`` when the tier simply holds no catalog, and ``(None, "...")``
    when the blob is torn/corrupt/unreadable — the error string is the
    caller's diagnostic, and the caller MUST treat it as
    catalog-unavailable (scan fallback), never as an empty catalog."""
    from repro_torch.core import format as fmt

    try:
        blob = tier.get(fmt.catalog_key(name))
    except Exception as e:  # noqa: BLE001 — flaky tier reads as unreadable
        return None, f"{type(e).__name__}: {e}"
    if blob is None:
        return None, None
    try:
        cat = fmt.decode_catalog(blob)
    except Exception as e:  # noqa: BLE001 — torn/corrupt/unknown-schema
        return None, f"{type(e).__name__}: {e}"
    if cat.get("name") != name:
        return None, f"catalog names {cat.get('name')!r}, expected {name!r}"
    return cat, None


def write_catalog(tier: StorageTier, name: str, versions: dict,
                  tombstones=(), *, gen: int = 1, writer: str = "") -> bytes:
    """Encode + publish one stream catalog blob; returns the bytes written
    (so read-modify-write callers can verify their write landed)."""
    from repro_torch.core import format as fmt

    blob = fmt.encode_catalog(name, versions, tombstones, gen=gen,
                              writer=writer)
    tier.put(fmt.catalog_key(name), blob)
    return blob


class WriteBatch:
    """Staged entries for one version's aggregated segment put.

    FlushModule, XorGroupModule and the manifest publishers stage their
    blobs here instead of issuing per-blob puts; the last rank to stage its
    L3 shard seals the batch into a single sequential segment write
    (repro_torch.core.format.encode_segment).  Mutated only under the cluster
    lock."""

    def __init__(self, name: str, version: int):
        self.name = name
        self.version = version
        self.entries: dict[str, bytes] = {}

    def stage(self, key: str, data: bytes):
        self.entries[key] = bytes(data)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.entries.values())


class RollingBatch:
    """Open cross-version pack: consecutive *delta* versions' segment
    entries accumulate here (entry keys keep their per-version form) until
    ``TierInfo.pack_versions`` member versions — or a chain boundary —
    seal the whole pack in ONE put (repro_torch.core.format.encode_pack).
    Mutated only under the cluster lock."""

    def __init__(self, name: str, seq: int):
        self.name = name
        self.seq = seq  # first member version; names the pack key
        self.versions: list[int] = []
        self.entries: dict[str, bytes] = {}

    def absorb(self, version: int, entries: dict[str, bytes]):
        if version not in self.versions:
            self.versions.append(version)
        for key, blob in entries.items():
            self.entries[key] = bytes(blob)

    def has(self, version: int) -> bool:
        return version in self.versions

    def stage(self, key: str, data: bytes):
        self.entries[key] = bytes(data)

    def drop_version(self, version: int, prefix: str):
        """Retire one member (GC): its entries and membership go away."""
        if version in self.versions:
            self.versions.remove(version)
        for key in [k for k in self.entries if k.startswith(prefix)]:
            self.entries.pop(key, None)

    def __len__(self) -> int:
        return len(self.entries)


def pick_tier(tiers: list[StorageTier], *, need_persistent=False,
              need_survives_node=False) -> StorageTier:
    """Heterogeneous-tier scheduler: among eligible tiers, prefer the highest
    *effective* bandwidth = nominal / (1 + inflight writers).  This encodes
    the paper's producer-consumer observation: a nominally faster tier that
    is currently draining loses to an idle slower one."""
    elig = [t for t in tiers
            if (not need_persistent or t.info.persistent)
            and (not need_survives_node or not t.info.node_local)]
    if not elig:
        raise RuntimeError("no eligible storage tier")
    return max(elig, key=lambda t: t.info.gbps / (1.0 + t.busy()))
