"""VELOC public API: the Cluster storage fabric and the VelocClient.

Client API mirrors VELOC's C interface (mem_protect / checkpoint_begin /
checkpoint_mem / checkpoint_end / restart_*) plus a pythonic high-level pair
``checkpoint(state, version)`` / ``restart_latest(template)`` for trees
of tensors (nested dicts, lists and tuples).

v2 surface: the client is configured by a declarative ``PipelineSpec``
(which modules run, with what options — see repro_torch.core.pipeline) over a
``Cluster`` built from a ``TierTopology`` (which storage tiers exist where —
see repro_torch.core.storage), and ``checkpoint`` / ``checkpoint_end`` return a
``CheckpointFuture`` completion handle (repro_torch.core.future).

``VelocConfig`` remains as a *legacy convenience shim*: it is a closed set
of switches that compiles down to the open specs via ``to_pipeline_spec()``
/ ``to_tier_topology()`` and produces byte-identical on-disk layouts.
Prefer the specs for new code — new modules and tier kinds only plug in
there.

Async semantics are the paper's: ``checkpoint`` blocks only while the L1
device snapshot is taken (a device-memory clone on the caller's stream,
or nothing when the caller passes its own ``snap``); D2H, serialization,
local persist, partner/XOR and the external flush all run in the
ActiveBackend.
"""
from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

from repro_torch.core import concurrency
from repro_torch.core import format as fmt
from repro_torch.core.backend import ActiveBackend, RateLimiter
from repro_torch.core.capture import (iter_host_regions, snapshot_device,
                                      tree_from_regions)
from repro_torch.core.future import CheckpointFuture
from repro_torch.core.modules import CheckpointContext
from repro_torch.core.phases import EMAPhasePredictor
from repro_torch.core.pipeline import ModuleSpec, PipelineSpec
from repro_torch.core.storage import (RollingBatch, StorageTier, TierSpec,
                                TierTopology, WriteBatch,
                                default_external_specs, default_node_specs,
                                pick_tier, read_catalog, write_catalog)

_log = logging.getLogger("repro_torch.veloc")


@dataclass
class VelocConfig:
    """Legacy closed-set configuration (deprecated in favour of the specs).

    Kept as a thin convenience: every field maps onto the open v2 surface
    through ``to_pipeline_spec()`` + ``to_tier_topology()``, and
    ``VelocClient(VelocConfig(...))`` routes through exactly that mapping —
    the on-disk layout is byte-identical to the historical behaviour.  New
    resilience modules or storage tiers cannot be expressed here; use
    ``PipelineSpec`` / ``TierTopology`` directly for those.
    """

    name: str = "ckpt"
    mode: str = "async"                 # async | sync
    scratch: str = "/tmp/veloc"         # node-local + external roots
    interval_s: Optional[float] = None  # defensive-checkpoint interval
    encoding: str = "raw"               # raw | q8 | zlib  (compression module)
    checksums: bool = True
    delta: bool = False                 # incremental (differential) shards
    delta_chunk_bytes: int = 64 * 1024  # dirty-detection granularity
    delta_max_chain: int = 8            # deltas before a forced full shard
    device_delta: bool = False          # device-side dirty tracking
    #                                     (requires delta=True; neither is
    #                                     ported yet)
    aggregate: bool = False             # coalesce L3 blobs into one segment
    pack_versions: int = 0              # >=2: pack that many consecutive
    #                                     delta versions into one rolling
    #                                     segment put (requires aggregate)
    seal_retries: int = 2               # maintenance-lane re-seal attempts
    #                                     after a failed segment/pack put
    seal_backoff_base_s: float = 0.25   # re-seals back off base*2**attempt
    seal_backoff_cap_s: float = 15.0    # ... capped here (0 base = legacy
    #                                     maintenance_interval_s spacing)
    catalog: bool = False               # durable stream catalog on external
    #                                     tiers: restart-safe GC + O(1)
    #                                     restart planning
    compact_threshold: int = 0          # deltas before auto-compaction (0=off)
    compact_async: bool = False         # auto-compact in the maintenance lane
    partner: bool = True
    partner_distance: int = 1
    xor_group: int = 4                  # 0 disables the XOR module
    rs_parity: int = 0                  # >0: Reed-Solomon instead of XOR
    flush: bool = True
    verify: bool = False
    rate_limit_bps: Optional[float] = None
    backend_workers: int = 2
    phase_predictor: str = "none"       # none | ema | gru
    use_kv_external: bool = False       # add the DAOS-style KV tier
    keep_versions: int = 3              # GC horizon (0 = no count limit)
    max_age_s: Optional[float] = None   # age-based retention: versions older
    #                                     than this are retired by GC (the
    #                                     newest always survives; a kept
    #                                     delta pins its chain regardless)
    lane_weight: float = 1.0            # deficit-RR share vs other streams
    #                                     on a shared backend
    lane_rate_bps: Optional[float] = None    # private flush budget (bytes/s)
    lane_rate_share: Optional[float] = None  # ... or fraction of the global
    #                                          rate_limit_bps (exclusive)
    admit_max_queued: Optional[int] = None   # admission high-water mark:
    #                                          queued+running tasks on this
    #                                          stream's lane before new
    #                                          checkpoints resolve skipped
    admit_max_queued_bytes: Optional[int] = None  # ... or queued payload
    #                                               bytes (None = unlimited)
    restore_readers: int = 4            # bounded fetch pool width for the
    #                                     concurrent restore serving path
    #                                     (<=1 = serial chain walk)
    restore_cache_blobs: int = 16       # shared segment/pack blob cache
    #                                     bound (whole blobs pinned in RAM)
    restore_hedge_factor: float = 0.0   # hedged restore reads: when the
    #                                     primary source's fetch exceeds
    #                                     this multiple of its EWMA get
    #                                     latency, launch the next-ranked
    #                                     source and take the first hit
    #                                     (0 = off)
    peer_seal_copies: bool = False      # replicate each sealed segment /
    #                                     pack blob to one peer node's
    #                                     fastest tier (consistent-hash
    #                                     home) so restores can read it
    #                                     from L2 instead of the external
    #                                     store

    # -- compilation to the v2 specs ------------------------------------
    def to_pipeline_spec(self) -> PipelineSpec:
        """Compile the boolean switches into the declarative module list."""
        mods = [ModuleSpec("interval", {"interval_s": self.interval_s}),
                ModuleSpec("serialize", {"encoding": self.encoding,
                                         "checksums": self.checksums}),
                ModuleSpec("local")]
        if self.delta or self.device_delta:
            raise NotImplementedError(
                "delta=True / device_delta=True: delta checkpointing is not "
                "ported yet (ROADMAP.md queue 1, items 4-5)")
        if self.partner:
            mods.append(ModuleSpec("partner",
                                   {"distance": self.partner_distance}))
        if self.xor_group >= 2:
            mods.append(ModuleSpec("xor", {"group_size": self.xor_group,
                                           "rs_parity": self.rs_parity}))
        if self.flush:
            mods.append(ModuleSpec("flush"))
        if self.verify:
            mods.append(ModuleSpec("verify"))
        # async mode: only the interval gate blocks the app (priority<=5);
        # sync mode: the whole pipeline runs inline.
        return PipelineSpec(name=self.name, mode=self.mode, modules=mods,
                            blocking_cut=5,
                            backend_workers=self.backend_workers,
                            phase_predictor=self.phase_predictor,
                            keep_versions=self.keep_versions,
                            max_age_s=self.max_age_s,
                            lane_weight=self.lane_weight,
                            lane_rate_bps=self.lane_rate_bps,
                            lane_rate_share=self.lane_rate_share,
                            admit_max_queued=self.admit_max_queued,
                            admit_max_queued_bytes=self.admit_max_queued_bytes,
                            aggregate=self.aggregate,
                            seal_retries=self.seal_retries,
                            seal_backoff_base_s=self.seal_backoff_base_s,
                            seal_backoff_cap_s=self.seal_backoff_cap_s,
                            compact_threshold=self.compact_threshold,
                            compact_async=self.compact_async,
                            device_delta=self.device_delta)

    def to_tier_topology(self) -> TierTopology:
        """Compile the storage switches into the declarative tier layout
        (the default DRAM + node-local SSD + shared PFS, optionally + KV).
        ``aggregate=True`` opts every external tier into the segment write
        path (node-local tiers keep direct puts)."""
        if self.pack_versions >= 2 and not self.aggregate:
            # silently producing zero packs would defeat the knob's point
            raise ValueError(
                "pack_versions requires aggregate=True (rolling packs ride "
                "the aggregated segment write path)")
        external = default_external_specs()
        if self.use_kv_external:
            external.append(TierSpec("kv", name="kv", gbps=2.0,
                                     options={"journal": "kvstore"}))
        if self.aggregate:
            for s in external:
                s.aggregate = True
                s.pack_versions = self.pack_versions
        if self.catalog:
            for s in external:
                s.catalog = True
        return TierTopology(scratch=self.scratch, node=default_node_specs(),
                            external=external)


class Cluster:
    """Storage fabric + collective-commit coordination for ``nranks``
    simulated nodes (one process).  On a real deployment this maps to: node
    tiers = each host's DRAM/NVMe; external tiers = the shared PFS/DAOS;
    note_shard coordination via the shared file system.

    Built from a ``TierTopology`` (v2) or a legacy ``VelocConfig`` (which
    compiles to one).  ``group_size`` is the erasure-group width recorded in
    manifests and used to locate parity homes; with a VelocConfig it
    defaults to ``cfg.xor_group``.
    """

    def __init__(self, topology: Union[TierTopology, VelocConfig],
                 nranks: int = 1, *, group_size: Optional[int] = None,
                 rate_limit_bps: Optional[float] = None,
                 aggregate: Optional[bool] = None,
                 restore_readers: Optional[int] = None,
                 restore_cache_blobs: Optional[int] = None,
                 restore_hedge_factor: Optional[float] = None,
                 peer_seal_copies: Optional[bool] = None):
        if isinstance(topology, VelocConfig):
            self.cfg: Optional[VelocConfig] = topology
            if group_size is None:
                group_size = topology.xor_group
            if rate_limit_bps is None:
                rate_limit_bps = topology.rate_limit_bps
            if aggregate is None:
                aggregate = topology.aggregate
            if restore_readers is None:
                restore_readers = getattr(topology, "restore_readers", None)
            if restore_cache_blobs is None:
                restore_cache_blobs = getattr(
                    topology, "restore_cache_blobs", None)
            if restore_hedge_factor is None:
                restore_hedge_factor = getattr(
                    topology, "restore_hedge_factor", None)
            if peer_seal_copies is None:
                peer_seal_copies = getattr(
                    topology, "peer_seal_copies", None)
            topology = topology.to_tier_topology()
        else:
            self.cfg = None
        self.topology = topology
        self.nranks = nranks
        self.group_size = int(group_size or 0)
        #: aggregated write path: None = undecided (adopted from the first
        #: client's PipelineSpec), else the explicit on/off switch.  Takes
        #: effect only on external tiers whose TierInfo opted in.
        self.aggregate = aggregate
        # THE cluster lock: protects registry/meta/batch state.  Declared
        # io_forbidden — the runtime checker (repro_torch.core.concurrency)
        # raises if any external-tier put/get/delete/keys runs under it.
        self._lock = concurrency.TrackedLock(
            "cluster._lock", concurrency.RANK_CLUSTER, io_forbidden=True)
        self._node_tiers = [topology.build_node(r) for r in range(nranks)]
        self.external_tiers: list[StorageTier] = topology.build_external()
        self.rate_limiter = RateLimiter(rate_limit_bps)
        self.phase_gate: Optional[Callable[[], float]] = None
        # registry[(name, version, level)] = {rank: digest}
        self._registry: dict[tuple, dict[int, str]] = {}
        self._meta: dict[tuple, dict] = {}
        #: (name, version) -> wall-clock creation time, noted on first
        #: shard commit/stage.  Age-based retention (``gc(max_age_s=...)``)
        #: reads this; the durable catalog carries the same stamp so a
        #: FRESH process can age out a previous run's versions too.
        self._vtimes: dict[tuple, float] = {}
        # (name, version) -> parent version of a delta shard (None = full);
        # GC refcounts through these links so a base is never dropped while
        # a live delta chain still references it.
        self._parents: dict[tuple, Optional[int]] = {}
        # (name, version) -> ranks that folded their shard full (compact());
        # the parent link is only cleared once EVERY rank has — earlier,
        # other ranks' delta shards still need the chain.
        self._compacted: dict[tuple, set] = {}
        # -- aggregated write path state --------------------------------
        self._batches: dict[tuple, WriteBatch] = {}  # (name, version) open
        self._sealed: dict[tuple, str] = {}  # (name, version) -> tier name
        self._seal_errors: dict[tuple, str] = {}
        #: name -> open cross-version rolling pack (delta versions batching
        #: toward one pack put; see TierInfo.pack_versions)
        self._rolling: dict[str, RollingBatch] = {}
        #: (name, version) -> pack key of the sealed rolling segment the
        #: version's L3 entries live in (also memoized from disk scans)
        self._packed: dict[tuple, str] = {}
        #: (tier name, stream name) pairs whose pack keys were already
        #: scanned from disk (negative cache for _pack_skey_for)
        self._pack_scanned: set = set()
        #: segment/pack key -> retained failed-seal state (entries + attempt
        #: count) for the bounded maintenance-lane re-seal.  Kept OUT of
        #: ``_batches`` so later manifest/compaction writes publish directly
        #: instead of silently staging into a dead batch.
        self._seal_retry: dict[str, dict] = {}
        #: per-version rewrite locks (rank VERSION: nested inside the
        #: cluster lock, outside pack locks and _seg_lock)
        self._vlocks: dict[tuple, concurrency.TrackedLock] = {}
        self._plocks: dict[str, concurrency.TrackedLock] = {}  # per-pack
        self._plock_guard = concurrency.TrackedLock(
            "cluster._plock_guard", concurrency.RANK_GUARD)
        #: shared cross-reader blob cache condition (rank READCACHE):
        #: single-flight — concurrent readers of one (tier, key) elect a
        #: winner to fetch+parse (with NO lock held) while losers wait
        #: here, so N readers cost the external tier exactly one get
        self._seg_lock = concurrency.TrackedCondition(
            "cluster._seg_lock", concurrency.RANK_READCACHE)
        self._segcache: dict[tuple, fmt.SegmentReader] = {}
        #: (tier, key) -> {"done", "reader"} for blob fetches in flight:
        #: the loader hands its parsed reader to waiters THROUGH the
        #: entry, so a concurrent eviction from the bounded LRU between
        #: the loader caching it and a waiter waking can never force the
        #: waiter to re-pay the fetch it just waited out
        self._seg_loading: dict = {}
        self._segcache_max = int(restore_cache_blobs
                                 if restore_cache_blobs is not None
                                 else self._SEGCACHE_MAX)
        #: adaptive external probe order: per-tier count of consecutive
        #: direct-key misses that then resolved inside the per-version
        #: segment.  Past ``_SEG_BIAS_THRESHOLD`` the probe flips
        #: segment-first, so sealed streams stop paying a guaranteed
        #: miss round trip on every shard fetch (benign-racy counters:
        #: worst case is one extra cheap probe, never a wrong answer)
        self._seg_bias: dict[str, int] = {}
        #: restore serving: bounded fetch pool width (<=1 = serial walk)
        self.restore_readers = int(restore_readers
                                   if restore_readers is not None else 4)
        self._reader_pool = None
        #: hedged restore reads: budget = factor * primary EWMA latency
        #: before the next-ranked source is launched (0 = off)
        self.restore_hedge_factor = float(restore_hedge_factor or 0.0)
        #: seal-time peer replication of segment/pack blobs (see
        #: ``_peer_seal_home``); read side always probes the home when the
        #: knob is on, so writer and reader agree without coordination
        self.peer_seal_copies = bool(peer_seal_copies)
        #: narrowed write-behind window: when set, a successful seal /
        #: re-seal queues this hook (maintenance-lane catalog sync) instead
        #: of syncing inline — async clients install a coalesced
        #: ``submit_maintenance`` here.  Unset, the post-seal sync runs
        #: inline on the sealing thread.
        self.catalog_sync_soon: Optional[Callable[[str, int], None]] = None
        #: torn / corrupt segments observed while reading (restart surfaces
        #: these per candidate instead of silently decoding garbage)
        self.segment_diagnostics: list[dict] = []
        self._seg_diagnosed: set = set()
        # -- durable stream catalog state -------------------------------
        #: this process's incarnation identity; stamps every catalog record
        #: it creates, so retirement tombstones never suppress a LATER
        #: run's legitimate reuse of the same version number
        self._run_stamp = uuid.uuid4().hex[:12]
        #: name -> {"versions": {v: rec}, "tombstones": {v: {stamps}}}
        #: (this process's authoritative view; mutated under the cluster
        #: lock, persisted by maintenance-lane ``sync_catalog`` RMWs)
        self._cat_state: dict[str, dict] = {}
        self._cat_dirty: set = set()  # streams with unpersisted updates
        self._cat_cache: dict[str, dict] = {}  # merged on-disk view
        #: per-stream catalog RMW locks (rank CATALOG: outermost — a
        #: catalog RMW must never be entered while the cluster lock is
        #: held, the catalog lock inversion)
        self._cat_locks: dict[str, concurrency.TrackedLock] = {}
        self._cat_guard = concurrency.TrackedLock(
            "cluster._cat_guard", concurrency.RANK_GUARD)
        #: torn / missing / raced catalog blobs observed (operators +
        #: tests see WHY the scan fallback engaged)
        self.catalog_diagnostics: list[dict] = []
        self._cat_diagnosed: set = set()
        self._gc_swept: set = set()  # streams orphan-pack-swept once

    # ------------------------------------------------------------------
    def node_tiers(self, rank: int) -> list[StorageTier]:
        return self._node_tiers[rank]

    @staticmethod
    def _tier_get(tier: StorageTier, key: str) -> Optional[bytes]:
        """A tier that *raises* (flaky hardware, injected fault) reads as a
        miss — restart keeps probing cheaper-to-costlier sources."""
        try:
            return tier.get(key)
        except Exception:  # noqa: BLE001
            return None

    # ------------------------------------------------------------------
    # aggregated write path: staging, sealing, segment-resolved reads
    # ------------------------------------------------------------------
    def aggregate_target(self) -> Optional[StorageTier]:
        """The external tier aggregated segments land on, or None when
        aggregation is off / no external tier opted in (direct puts)."""
        if not self.aggregate:
            return None
        elig = [t for t in self.external_tiers if t.info.aggregate]
        if not elig:
            return None
        return pick_tier(elig)

    def _diagnose_segment(self, tier_name: str, key: str, err: Exception):
        sig = (tier_name, key, f"{type(err).__name__}: {err}")
        with self._seg_lock:
            if sig in self._seg_diagnosed:
                return
            self._seg_diagnosed.add(sig)
            self.segment_diagnostics.append(
                {"tier": tier_name, "key": key,
                 "error": f"{type(err).__name__}: {err}"})

    #: cached SegmentReaders pin their whole blob in memory; keep only the
    #: most recently touched segments (restart walks newest-first anyway).
    _SEGCACHE_MAX = 16

    def _cache_segment(self, tier_name: str, skey: str,
                       reader: fmt.SegmentReader):
        with self._seg_lock:
            self._cache_segment_locked(tier_name, skey, reader)

    def _cache_segment_locked(self, tier_name: str, skey: str,
                              reader: fmt.SegmentReader):
        self._segcache.pop((tier_name, skey), None)
        self._segcache[(tier_name, skey)] = reader
        while len(self._segcache) > self._segcache_max:
            self._segcache.pop(next(iter(self._segcache)))

    def _cached_blob_reader(self, tier: StorageTier, skey: str, parse):
        """Single-flight fetch+parse of one segment/pack blob through the
        shared cross-reader cache.  Among N concurrent readers of the same
        (tier, key) exactly one performs the external ``get`` (and the
        parse) — with NO lock held — while the rest wait on ``_seg_lock``
        and reuse the cached reader.  A failed fetch or torn parse caches
        NOTHING: the next waiter retries itself, so one reader racing a
        flaky tier never poisons the cache for the others.  Returns
        ``(reader_or_None, fresh)`` — ``fresh`` is True when this call did
        the fetch (callers memoize side effects once, not per cache hit)."""
        ck = (tier.info.name, skey)
        with self._seg_lock:
            while True:
                reader = self._segcache.get(ck)
                if reader is not None:
                    # LRU touch
                    self._segcache.pop(ck)
                    self._segcache[ck] = reader
                    return reader, False
                entry = self._seg_loading.get(ck)
                if entry is None:
                    entry = {"done": False, "reader": None}
                    self._seg_loading[ck] = entry
                    break
                self._seg_lock.wait(1.0)
                if entry["done"]:
                    # direct handoff from the loader: immune to the LRU
                    # evicting the reader before this waiter woke up
                    if entry["reader"] is not None:
                        return entry["reader"], False
                    # loader failed — loop and retry (maybe as loader)
        reader, err = None, None
        try:
            blob = self._tier_get(tier, skey)
            if blob is not None:
                try:
                    reader = parse(blob)
                except Exception as e:  # noqa: BLE001 — torn blob
                    err = e
        finally:
            with self._seg_lock:
                if reader is not None:
                    self._cache_segment_locked(tier.info.name, skey, reader)
                entry["done"] = True
                entry["reader"] = reader
                if self._seg_loading.get(ck) is entry:
                    del self._seg_loading[ck]
                self._seg_lock.notify_all()
        if err is not None:
            self._diagnose_segment(tier.info.name, skey, err)
        return reader, True

    def _segment_reader(self, tier: StorageTier, name: str, version: int
                        ) -> Optional[fmt.SegmentReader]:
        """Cached index over this tier's segment for one version.  A torn /
        truncated segment parses to None with a diagnostic — never half-
        decoded.  Deliberately NOT gated on ``tier.info.aggregate``: the
        flag steers the WRITE path only, a segment that exists on disk must
        stay readable even when the process restarts with aggregation off."""
        skey = fmt.segment_key(name, version)
        reader, _ = self._cached_blob_reader(tier, skey, fmt.SegmentReader)
        return reader

    def reader_pool(self):
        """The shared bounded restore fetch pool (None when
        ``restore_readers <= 1`` — chain walks stay serial).  Created
        lazily so write-only processes never spawn reader threads; shared
        across every concurrent reader of this cluster so total restore
        fan-out stays bounded no matter how many readers arrive."""
        if self.restore_readers <= 1:
            return None
        with self._seg_lock:
            if self._reader_pool is None:
                from repro_torch.core.backend import ReaderPool
                self._reader_pool = ReaderPool(self.restore_readers)
            return self._reader_pool

    def _segment_entry(self, tier: StorageTier, name: str, version: int,
                       key: str) -> Optional[bytes]:
        reader = self._segment_reader(tier, name, version)
        if reader is None or key not in reader:
            return None
        try:
            return reader.read(key)
        except Exception as e:  # noqa: BLE001 — corrupt entry reads as miss
            self._diagnose_segment(tier.info.name,
                                   fmt.segment_key(name, version) + "#" + key,
                                   e)
            return None

    # -- rolling packs (cross-version segments) --------------------------
    def _pack_reader(self, tier: StorageTier, name: str, skey: str
                     ) -> Optional[fmt.PackReader]:
        """Cached index over one rolling pack, memoizing which versions it
        carries (so a fresh process resolves pack membership once per
        blob).  Torn packs parse to None with a diagnostic."""
        reader, fresh = self._cached_blob_reader(tier, skey, fmt.PackReader)
        if reader is None or not isinstance(reader, fmt.PackReader):
            return None
        if fresh:
            with self._lock:
                for v in reader.versions:
                    self._packed.setdefault((name, v), skey)
        return reader

    def _pack_skey_for(self, tier: StorageTier, name: str, version: int
                       ) -> Optional[str]:
        """The pack key holding ``version``'s entries: from the in-memory
        index when this process sealed it, else discovered (and memoized)
        by scanning the tier's pack keys — how a fresh process finds packed
        versions.  The scan runs at most once per (tier, stream): every
        pack this process seals later lands in ``_packed`` directly, so a
        version absent after one scan stays absent (a torn pack's members
        read as unpacked either way — the per-blob diagnostic covers it)."""
        with self._lock:
            skey = self._packed.get((name, version))
            if skey is not None:
                return skey
            if (tier.info.name, name) in self._pack_scanned:
                return None
        try:
            keys = tier.keys(fmt.pack_prefix(name))
        except Exception:  # noqa: BLE001 — flaky tier reads as no packs
            return None    # (and stays unscanned, so it is probed again)
        complete = True
        for key in sorted(keys):
            if self._pack_reader(tier, name, key) is not None:
                continue  # parsed + memoized
            with self._seg_lock:
                torn = any(t == tier.info.name and k == key
                           for (t, k, _e) in self._seg_diagnosed)
            if not torn:
                # TRANSIENT read failure (flaky get), not deterministic
                # corruption: don't cache this scan as complete, or the
                # pack's members would read as absent for the whole process
                complete = False
        with self._lock:
            if complete:
                self._pack_scanned.add((tier.info.name, name))
            return self._packed.get((name, version))

    def _pack_entry(self, tier: StorageTier, name: str, version: int,
                    key: str) -> Optional[bytes]:
        skey = self._pack_skey_for(tier, name, version)
        if skey is None:
            return None
        reader = self._pack_reader(tier, name, skey)
        if reader is None or key not in reader:
            return None
        try:
            return reader.read(key)
        except Exception as e:  # noqa: BLE001 — corrupt entry reads as miss
            self._diagnose_segment(tier.info.name, skey + "#" + key, e)
            return None

    # -- durable stream catalog ------------------------------------------
    def catalog_tiers(self) -> list[StorageTier]:
        """External tiers opted into holding the durable stream catalog."""
        return [t for t in self.external_tiers
                if getattr(t.info, "catalog", False)]

    def _diagnose_catalog(self, tier_name: Optional[str], name: str,
                          err: str):
        sig = (tier_name, name, err)
        with self._seg_lock:
            if sig in self._cat_diagnosed:
                return
            self._cat_diagnosed.add(sig)
            self.catalog_diagnostics.append(
                {"tier": tier_name, "stream": name, "error": err})
        _log.warning("stream %r: catalog on %s: %s", name,
                     tier_name or "<all tiers>", err)

    def _note_catalog_fallback(self, name: str, context: str):
        self._diagnose_catalog(
            None, name,
            f"no healthy catalog blob; {context} fell back to key-scan "
            f"discovery")

    def _cat_lock(self, name: str) -> concurrency.TrackedLock:
        with self._cat_guard:
            lk = self._cat_locks.get(name)
            if lk is None:
                lk = self._cat_locks[name] = concurrency.TrackedLock(
                    f"cluster._cat_locks[{name}]", concurrency.RANK_CATALOG)
            return lk

    def _cat_note_locked(self, name: str, version: int, *,
                         level: Optional[str] = None,
                         sealed: Optional[bool] = None,
                         location: Optional[str] = None,
                         pack: Optional[str] = None,
                         entries=None,
                         compacted: bool = False):
        """Record a durability-state change for one version (cluster lock
        held).  Cheap bookkeeping only — the durable RMW happens later in
        ``sync_catalog`` on the maintenance lane."""
        if not self.catalog_tiers():
            return
        st = self._cat_state.setdefault(
            name, {"versions": {}, "tombstones": {}})
        if self._run_stamp in st["tombstones"].get(version, ()):
            return  # our own GC already retired it; a late racer must not
            #         resurrect the record
        rec = st["versions"].get(version)
        if rec is None:
            rec = st["versions"][version] = {
                "kind": "full", "parent": None, "sealed": False,
                "location": "direct", "pack": None, "entries": None,
                "levels": [], "stamp": self._run_stamp,
                "ts": self._vtimes.get((name, version)) or time.time()}
        if compacted:
            rec["kind"], rec["parent"] = "full", None
        else:
            p = self._parents.get((name, version))
            rec["parent"] = p
            rec["kind"] = "delta" if p is not None else "full"
        if level is not None and level not in rec["levels"]:
            rec["levels"] = sorted(rec["levels"] + [level])
        if sealed is not None:
            rec["sealed"] = sealed
        if location is not None:
            rec["location"] = location
        if pack is not None:
            rec["pack"] = pack
        if entries is not None:
            rec["entries"] = sorted(entries)
        self._cat_dirty.add(name)

    def _cat_note_seal_locked(self, name: str, job: dict):
        """Catalog bookkeeping for a successful segment/pack seal."""
        for v in job["versions"]:
            ents = None
            if job["pack"]:
                pfx = fmt.version_prefix(name, v)
                ents = [k for k in job["entries"] if k.startswith(pfx)]
            self._cat_note_locked(
                name, v, level="L3", sealed=True,
                location="pack" if job["pack"] else "segment",
                pack=job["skey"] if job["pack"] else None, entries=ents)

    def _cat_merge_locked(self, name: str, disk: Optional[dict]):
        """Merge the fresh on-disk catalog into this process's state
        (cluster lock held).  Tombstones win: a record whose stamp matches
        a retirement tombstone stays dead — this is what stops a stale
        writer from resurrecting a version a concurrent GC retired.  The
        merged view is ADOPTED in memory, so other writers' versions (and
        their tombstones) become visible to this process too."""
        st = self._cat_state.setdefault(
            name, {"versions": {}, "tombstones": {}})
        tombs: dict[int, set] = {v: set(s)
                                 for v, s in st["tombstones"].items()}
        merged: dict[int, dict] = {}
        if disk:
            for v, rec in disk.get("versions", {}).items():
                merged[int(v)] = dict(rec)
            for v, stamp in disk.get("tombstones", []):
                tombs.setdefault(int(v), set()).add(stamp)
        merged.update({v: dict(r) for v, r in st["versions"].items()})
        merged = {v: r for v, r in merged.items()
                  if r.get("stamp") not in tombs.get(v, ())}
        if len(tombs) > 256:  # bound the blob: oldest tombstones age out
            for v in sorted(tombs)[:len(tombs) - 256]:
                tombs.pop(v)
        st["versions"] = {v: dict(r) for v, r in merged.items()}
        st["tombstones"] = {v: set(s) for v, s in tombs.items()}
        return merged, [[v, s] for v in sorted(tombs)
                        for s in sorted(tombs[v])]

    def _cat_rmw(self, tier: StorageTier, name: str) -> bool:
        """One catalog read-modify-write against one tier.  Always merges
        against the FRESH blob (never a cached copy), and verifies the
        write landed; when another writer raced us past the put, the RMW
        retries exactly once against the then-fresh blob — losing the race
        with a concurrent GC must not republish a retired version."""
        key = fmt.catalog_key(name)
        last_gen = 0
        for attempt in (0, 1):
            disk, err = read_catalog(tier, name)
            if err:
                # torn/corrupt blob: diagnose, then self-heal by rewriting
                # from the merged live state (the decoder never let the
                # damage silently drop versions — we are the writer here)
                self._diagnose_catalog(tier.info.name, name, err)
            with self._lock:
                versions, tombs = self._cat_merge_locked(name, disk)
                # floor on the gen WE already wrote: a torn/unreadable
                # re-read must not reset a gen-N blob back to gen 1
                gen = max(int((disk or {}).get("gen", 0)), last_gen) + 1
            last_gen = gen
            blob = write_catalog(tier, name, versions, tombs, gen=gen,
                                 writer=self._run_stamp)
            try:
                back = tier.get(key)
            except Exception:  # noqa: BLE001 — the put itself succeeded;
                # a flaky verify read is NOT a racing writer.  Trust the
                # write rather than burning the race retry on it.
                return True
            if back == blob:
                return True
            # raced: someone overwrote between our put and the read-back
        self._diagnose_catalog(
            tier.info.name, name,
            "concurrent catalog writers raced twice; deferring to the "
            "other writer's blob")
        return False

    def sync_catalog(self, name: str, *, force: bool = False) -> bool:
        """Persist this stream's catalog to every catalog tier (no-op when
        nothing changed, unless ``force``).  Maintenance-lane discipline:
        call WITHOUT the cluster lock — bookkeeping reads take it briefly,
        the tier I/O runs under the per-stream catalog lock only."""
        tiers = self.catalog_tiers()
        if not tiers:
            return False
        with self._cat_lock(name):
            with self._lock:
                if name not in self._cat_dirty and not force:
                    return False
                self._cat_dirty.discard(name)
            wrote = False
            redirty = False
            for tier in tiers:
                try:
                    ok = self._cat_rmw(tier, name)
                except Exception as e:  # noqa: BLE001 — tier down
                    self._diagnose_catalog(
                        tier.info.name, name,
                        f"sync failed: {type(e).__name__}: {e}")
                    ok = False
                wrote = ok or wrote
                # an RMW that raced out (returned False) must NOT eat the
                # dirty bit, or this process's updates would never reach
                # the durable catalog on any later sync
                redirty = redirty or not ok
            if redirty:
                with self._lock:
                    self._cat_dirty.add(name)
            with self._lock:
                self._cat_cache.pop(name, None)
        return wrote

    def load_catalog(self, name: str, *, refresh: bool = False
                     ) -> Optional[dict]:
        """The stream's merged durable-catalog view ``{"versions": {v:
        rec}, "tombstones": {v: {stamps}}}``, or None when no catalog tier
        holds a healthy blob (each torn/unreadable blob is diagnosed).
        Successful loads seed the pack-membership index, so catalog-first
        restarts resolve packed versions without any ``keys()`` listing.
        The view is cached per stream; ``refresh=True`` re-reads (GC does,
        so another process's retirements are honoured)."""
        tiers = self.catalog_tiers()
        if not tiers:
            return None
        if not refresh:
            with self._lock:
                if name in self._cat_cache:
                    return self._cat_cache[name]
        blobs = []
        for tier in tiers:
            disk, err = read_catalog(tier, name)
            if err:
                self._diagnose_catalog(tier.info.name, name, err)
            elif disk is not None:
                blobs.append(disk)
        if not blobs:
            return None
        blobs.sort(key=lambda d: int(d.get("gen", 0)))
        versions: dict[int, dict] = {}
        tombs: dict[int, set] = {}
        for d in blobs:  # oldest gen first: newest generation wins
            for v, rec in d.get("versions", {}).items():
                versions[int(v)] = dict(rec)
            for v, stamp in d.get("tombstones", []):
                tombs.setdefault(int(v), set()).add(stamp)
        versions = {v: r for v, r in versions.items()
                    if r.get("stamp") not in tombs.get(v, ())}
        view = {"versions": versions, "tombstones": tombs}
        with self._lock:
            # seed pack membership POSITIVELY only: a catalog-complete
            # restore then resolves every packed entry without a listing,
            # while a fetch of a version a STALE catalog doesn't know
            # still falls back to the one-shot pack scan — staleness must
            # never make durable data undiscoverable
            for v, rec in versions.items():
                if rec.get("pack"):
                    self._packed.setdefault((name, v), rec["pack"])
            self._cat_cache[name] = view
        return view

    def stage_l3(self, name: str, version: int, rank: int, shard: bytes,
                 digest: str, meta: Optional[dict] = None) -> bool:
        """Aggregated L3 write: stage this rank's shard into the version's
        WriteBatch; the LAST rank to stage closes the batch — L3 manifest
        included.  A full version seals immediately into ONE per-version
        segment put; with ``pack_versions >= 2`` on the target tier a
        *delta* version is instead absorbed into the stream's open rolling
        pack, which seals in one put once ``pack_versions`` members
        accumulated (or at the next chain boundary).  Returns True when
        this call performed a seal put; raises if a seal put fails (the
        caller records the L3 error, the batch is retained for the bounded
        maintenance-lane re-seal, and restart falls back meanwhile)."""
        with self._lock:
            batch = self._batches.setdefault(
                (name, version), WriteBatch(name, version))
            batch.stage(fmt.shard_key(name, version, rank), shard)
            reg = self._registry.setdefault((name, version, "L3"), {})
            reg[rank] = digest
            if meta:
                self._note_meta_locked(name, version, meta)
            if len(reg) < self.nranks:
                return False
            tier = self.aggregate_target()
            if tier is None:  # tiers swapped out mid-flight
                raise RuntimeError("no aggregating external tier to seal to")
            batch = self._close_version_batch_locked(name, version, reg)
            pv = int(getattr(tier.info, "pack_versions", 0) or 0)
            is_delta = self._parents.get((name, version)) is not None
            if pv >= 2 and is_delta:
                rb = self._rolling.get(name)
                if rb is None:
                    rb = self._rolling[name] = RollingBatch(name, version)
                rb.absorb(version, batch.entries)
                if len(rb.versions) < pv:
                    # pack still open: the version is L1/L2-protected only
                    # until the pack boundary seals it (deferred-durability
                    # window bounded by pack_versions)
                    return False
                jobs = self._prepare_pack_seal_locked(tier, name)
            else:
                self._sealed[(name, version)] = tier.info.name
                jobs = [{"name": name, "skey": fmt.segment_key(name, version),
                         "entries": dict(batch.entries),
                         "versions": [version], "pack": False}]
                # a full version is a chain boundary: flush the previous
                # chain's open rolling pack too — its deltas must not wait
                # on checkpoints that may never come
                jobs += self._prepare_pack_seal_locked(tier, name)
        # seal puts — the largest writes in the system — run OUTSIDE the
        # cluster lock so other ranks' staging/notes are never serialized
        # behind slow external I/O.
        err_own: Optional[Exception] = None
        for job in jobs:
            try:
                self._do_seal_io(tier, job)
            except Exception as e:  # noqa: BLE001 — finish remaining jobs;
                # each failure retains its own batch.  Only a failure of
                # THIS version's job is raised (= this checkpoint's L3
                # error); a failed chain-boundary pack of EARLIER versions
                # must not misattribute an error to a version that is fully
                # durable — its retained batch is surfaced via seal_errors
                # and picked up by the caller's retry scheduling.
                if version in job["versions"]:
                    err_own = e
        if err_own is not None:
            raise err_own
        return True

    def stage_entry(self, name: str, version: int, key: str, data: bytes
                    ) -> bool:
        """Stage an auxiliary version blob (e.g. the erasure-group parity)
        into the pending batch — or the stream's open rolling pack once the
        version's own batch was absorbed there, or the retained failed-seal
        batch (the re-seal carries it; opening a NEW batch here would
        create a zombie no seal ever drains).  False once the version
        already sealed — the caller falls back to a direct put."""
        with self._lock:
            if (name, version) in self._sealed:
                return False
            rb = self._rolling.get(name)
            if rb is not None and rb.has(version):
                rb.stage(key, data)
                return True
            found = self._find_seal_retry_locked(name, version)
            if found is not None:
                found[1]["entries"][key] = bytes(data)
                return True
            batch = self._batches.setdefault(
                (name, version), WriteBatch(name, version))
            batch.stage(key, data)
            return True

    def _close_version_batch_locked(self, name: str, version: int,
                                    reg: dict[int, str]) -> WriteBatch:
        """Pop the version's batch and stage its L3 manifest into it (the
        manifest travels inside the segment/pack, so the version becomes
        externally visible atomically at seal)."""
        batch = self._batches.pop((name, version))
        batch.stage(
            fmt.manifest_key(name, version) + ".L3",
            fmt.make_manifest(name, version, self.nranks, level="L3",
                              shard_digests=reg,
                              meta=self._meta.get((name, version), {}),
                              parent=self._parents.get((name, version)),
                              group_size=self.group_size))
        return batch

    def _prepare_pack_seal_locked(self, tier: StorageTier, name: str
                                  ) -> list[dict]:
        """Close the stream's open rolling pack and optimistically mark its
        member versions sealed (late ``stage_entry`` racers fall back to
        direct puts during the in-flight put) — the actual I/O happens in
        ``_do_seal_io`` outside the lock."""
        rb = self._rolling.pop(name, None)
        if rb is None or not rb.versions:
            return []
        skey = fmt.pack_key(name, rb.seq)
        for v in rb.versions:
            self._sealed[(name, v)] = tier.info.name
            self._packed[(name, v)] = skey
        return [{"name": name, "skey": skey, "entries": dict(rb.entries),
                 "versions": sorted(rb.versions), "pack": True}]

    def _seal_job_blob(self, job: dict) -> bytes:
        """Encode one seal job's entries — rolling pack or per-version
        segment framing (shared by the first seal and every re-seal)."""
        if job["pack"]:
            return fmt.encode_pack(job["name"], job["entries"],
                                   job["versions"],
                                   meta={"nranks": self.nranks})
        return fmt.encode_segment(
            job["entries"], meta={"name": job["name"],
                                  "version": job["versions"][0],
                                  "nranks": self.nranks})

    def _cache_seal_job(self, tier: StorageTier, job: dict, seg: bytes):
        self._cache_segment(
            tier.info.name, job["skey"],
            fmt.PackReader(seg) if job["pack"] else fmt.SegmentReader(seg))

    def _do_seal_io(self, tier: StorageTier, job: dict):
        name, versions = job["name"], job["versions"]
        seg = self._seal_job_blob(job)
        try:
            tier.put(job["skey"], seg)
        except Exception as e:  # noqa: BLE001 — the batch is RETAINED for
            # the bounded maintenance-lane re-seal (``retry_seal``), keyed
            # away from ``_batches`` so later compaction/manifest writes
            # publish directly instead of silently staging into it.  The
            # versions read as unsealed; restart falls back meanwhile.
            with self._lock:
                for v in versions:
                    self._sealed.pop((name, v), None)
                    self._packed.pop((name, v), None)
                    self._seal_errors[(name, v)] = f"{type(e).__name__}: {e}"
                self._seal_retry[job["skey"]] = {
                    "name": name, "versions": list(versions),
                    "entries": job["entries"], "pack": job["pack"],
                    "attempts": 0, "scheduled": False}
            raise
        self._cache_seal_job(tier, job, seg)
        self._peer_replicate_seal(job, seg)
        with self._lock:
            self._cat_note_seal_locked(name, job)
        self._post_seal_sync(name, max(versions))

    def _peer_replicate_seal(self, job: dict, seg: bytes):
        """Best-effort L2 copy of a freshly sealed segment/pack blob onto
        its consistent-hash home node (``peer_seal_copies``).  A pure read
        accelerator: durability already landed on the external tier, so a
        failed copy is diagnosed and ignored.  Runs with NO locks held —
        this is tier I/O."""
        if not self.peer_seal_copies or self.nranks <= 1:
            return
        home = self._peer_seal_home(job["skey"])
        tiers = self._node_tiers[home] if 0 <= home < self.nranks else []
        if not tiers:
            return
        tier = tiers[0]
        try:
            tier.put(job["skey"], seg)
        except Exception as e:  # noqa: BLE001 — accelerator only; the
            # sealed blob is durable on the external tier regardless
            self._diagnose_segment(tier.info.name, job["skey"], e)

    def _post_seal_sync(self, name: str, version: int):
        """Queue (or run) the catalog sync RIGHT AFTER a successful seal,
        narrowing the write-behind window: without this, a crash between
        the seal and the next scheduled sync left the newest sealed
        version invisible to catalog-first restore planning.  Prefers the
        client-installed ``catalog_sync_soon`` hook (coalesced maintenance
        work off the critical path); falls back to an inline sync.  Called
        with NO locks held — ``sync_catalog`` takes RANK_CATALOG
        outermost."""
        if not self.catalog_tiers():
            return
        hook = self.catalog_sync_soon
        if hook is not None:
            try:
                hook(name, version)
                return
            except RuntimeError as e:  # backend stopped mid-shutdown:
                # fall through to the inline sync so the seal still lands
                self._diagnose_catalog(None, name,
                                       f"post-seal sync hook: {e}")
        self.sync_catalog(name)

    # -- bounded seal retry ---------------------------------------------
    def _find_seal_retry_locked(self, name: str, version: int
                                ) -> Optional[tuple[str, dict]]:
        for skey, item in self._seal_retry.items():
            if item["name"] == name and version in item["versions"]:
                return skey, item
        return None

    def seal_retry_pending(self, name: str, *, detail: bool = False):
        """Versions whose failed seal batch is retained awaiting a re-seal.
        ``detail=True`` returns per-batch operator records instead: the
        segment/pack key, member versions, attempts burned, and
        ``next_attempt_in_s`` — seconds until the backed-off next re-seal
        (None when no attempt is currently scheduled)."""
        with self._lock:
            if not detail:
                return sorted(v for item in self._seal_retry.values()
                              if item["name"] == name
                              for v in item["versions"])
            now = time.monotonic()
            out = []
            for skey in sorted(self._seal_retry):
                item = self._seal_retry[skey]
                if item["name"] != name:
                    continue
                na = item.get("next_attempt")
                out.append({
                    "skey": skey, "versions": sorted(item["versions"]),
                    "attempts": item["attempts"],
                    "scheduled": item["scheduled"],
                    "next_attempt_in_s":
                        max(0.0, na - now) if na is not None else None})
            return out

    def retry_seal(self, name: str, version: int) -> bool:
        """One re-seal attempt for the retained batch holding ``version``.
        Returns True when the batch is gone (this attempt sealed it, or it
        was already sealed / GC'd), False when the put failed again."""
        with self._lock:
            found = self._find_seal_retry_locked(name, version)
            if found is None:
                return True
            skey = found[0]
        return self._retry_seal_key(skey)

    def _retry_seal_key(self, skey: str) -> bool:
        """Re-seal one retained batch by its segment/pack key."""
        with self._lock:
            item = self._seal_retry.get(skey)
            if item is None:
                return True
            name = item["name"]
            # count the attempt BEFORE any early-out: a cluster whose
            # aggregating tier was swapped out must burn retry budget too,
            # or the maintenance task would resubmit itself forever
            item["attempts"] += 1
            tier = self.aggregate_target()
            if tier is None:
                return False
            # refresh complete manifests from the live registry: levels or
            # digests republished since the failed seal (compaction, late
            # L2 notes) must beat the stale staging-time blobs
            for (n, v, level), reg in self._registry.items():
                if n != name or v not in item["versions"] \
                        or len(reg) != self.nranks:
                    continue
                item["entries"][fmt.manifest_key(n, v) + f".{level}"] = \
                    fmt.make_manifest(
                        n, v, self.nranks, level=level, shard_digests=reg,
                        meta=self._meta.get((n, v), {}),
                        parent=self._parents.get((n, v)),
                        group_size=self.group_size)
            job = {"name": name, "skey": skey,
                   "entries": dict(item["entries"]),
                   "versions": list(item["versions"]), "pack": item["pack"]}
        # NOTE: a GC racing this put could at worst resurrect one orphan
        # segment of already-retired versions — same exposure the in-flight
        # seal itself has, accepted for lock-free seal I/O.
        seg = self._seal_job_blob(job)
        try:
            tier.put(skey, seg)
        except Exception as e:  # noqa: BLE001 — still down; stays retained
            with self._lock:
                for v in job["versions"]:
                    self._seal_errors[(name, v)] = f"{type(e).__name__}: {e}"
            return False
        with self._lock:
            self._seal_retry.pop(skey, None)
            for v in job["versions"]:
                self._sealed[(name, v)] = tier.info.name
                if job["pack"]:
                    self._packed[(name, v)] = skey
                self._seal_errors.pop((name, v), None)
            self._cat_note_seal_locked(name, job)
        self._cache_seal_job(tier, job, seg)
        self._peer_replicate_seal(job, seg)
        self._post_seal_sync(name, max(job["versions"]))
        return True

    def schedule_seal_retry(self, backend, name: str, retries: int, *,
                            backoff_base: float = 0.0,
                            backoff_cap: float = 15.0) -> bool:
        """Queue up to ``retries`` maintenance-lane re-seal attempts for
        EVERY retained batch of stream ``name`` not already scheduled
        (idle-gated and rate-limited like all maintenance).  Keyed on the
        stream, not a version: the flush that observed the failure may
        have been sealing its own version's segment, the chain-boundary
        rolling pack of EARLIER versions, or both.  Deduplicated: one
        scheduled chain per retained batch.

        Attempts back off exponentially — attempt N starts no earlier than
        ``backoff_base * 2**N`` seconds after it is scheduled (capped at
        ``backoff_cap``) — so an external tier that is down for minutes is
        probed a handful of times, not hammered every maintenance window.
        ``backoff_base=0`` keeps the legacy ``maintenance_interval_s``-only
        spacing.  The deadline is visible to operators via
        ``seal_retry_pending(name, detail=True)``."""

        def delay_for(attempts: int) -> float:
            if backoff_base <= 0:
                return 0.0
            return min(backoff_base * (2 ** attempts), backoff_cap)

        targets = []
        with self._lock:
            for skey, item in self._seal_retry.items():
                if item["name"] != name or item["scheduled"] \
                        or item["attempts"] >= retries:
                    continue
                item["scheduled"] = True
                delay = delay_for(item["attempts"])
                item["next_attempt"] = time.monotonic() + delay
                targets.append((skey, max(item["versions"]), delay))
        kind = f"seal-retry:{name}"
        for skey, ver, delay in targets:
            def attempt(skey=skey, ver=ver):
                ok = self._retry_seal_key(skey)
                resubmit: Optional[float] = None
                with self._lock:
                    it = self._seal_retry.get(skey)
                    if it is not None:
                        it["scheduled"] = False
                        it.pop("next_attempt", None)
                        if not ok and it["attempts"] < retries:
                            it["scheduled"] = True
                            resubmit = delay_for(it["attempts"])
                            it["next_attempt"] = time.monotonic() + resubmit
                if ok:
                    # the upgrade to full L3 must reach the durable catalog
                    # too (we are already on the maintenance lane)
                    self.sync_catalog(name)
                if resubmit is not None:
                    backend.submit_maintenance(kind, ver, attempt,
                                               delay_s=resubmit)

            backend.submit_maintenance(kind, ver, attempt, delay_s=delay)
        return bool(targets)

    def flush_open_packs(self, name: Optional[str] = None) -> int:
        """Seal any open rolling pack now (client shutdown, or an operator
        bounding the L1/L2-only window of a quiescent stream).  Returns the
        number of packs sealed; raises on a failed put (the batch is
        retained for retry like any seal)."""
        with self._lock:
            tier = self.aggregate_target()
            if tier is None:
                return 0
            jobs = []
            for n in list(self._rolling):
                if name is not None and n != name:
                    continue
                jobs += self._prepare_pack_seal_locked(tier, n)
        err: Optional[Exception] = None
        for job in jobs:
            try:
                self._do_seal_io(tier, job)
            except Exception as e:  # noqa: BLE001
                err = err or e
        if err is not None:
            raise err
        return len(jobs)

    def _version_rewrite_lock_locked(self, name: str, version: int
                                     ) -> concurrency.TrackedLock:
        """Per-version rewrite lock (cluster lock must be held to fetch).
        Segment read-modify-writes serialize on THIS lock and run with the
        global lock released — maintenance-lane compaction of one version
        must not stall every rank's staging/notes behind external I/O
        (lock order: cluster lock -> version lock -> pack lock ->
        _seg_lock)."""
        lk = self._vlocks.get((name, version))
        if lk is None:
            lk = self._vlocks[(name, version)] = concurrency.TrackedLock(
                f"cluster._vlocks[{name}:v{version}]",
                concurrency.RANK_VERSION)
        return lk

    def _pack_lock(self, skey: str) -> concurrency.TrackedLock:
        """Per-pack rewrite lock: a rolling segment is shared by several
        versions, so their rewrites (compaction, GC re-pack) serialize on
        the PACK, not just the version.  Guarded by its own tiny lock (not
        the cluster lock) so it is reachable from paths that already hold
        the cluster lock."""
        with self._plock_guard:
            lk = self._plocks.get(skey)
            if lk is None:
                lk = self._plocks[skey] = concurrency.TrackedLock(
                    f"cluster._plocks[{skey}]", concurrency.RANK_PACK)
            return lk

    def _stage_into_batch_locked(self, name: str, version: int,
                                 repl: dict[str, bytes]) -> bool:
        """Replace staged bytes while the version is still batching — in
        its own open WriteBatch, or in the stream's open rolling pack once
        absorbed there (the seal must write current — e.g. compacted —
        blobs, not the stale staging-time ones).  Cluster lock held; False
        when neither is open."""
        batch = self._batches.get((name, version))
        if batch is not None:
            for key, blob in repl.items():
                batch.stage(key, blob)
            return True
        rb = self._rolling.get(name)
        if rb is not None and rb.has(version):
            for key, blob in repl.items():
                rb.stage(key, blob)
            return True
        return False

    def _rewrite_segments_io(self, name: str, version: int,
                             repl: dict[str, bytes]) -> set:
        """Replace entries inside every external segment of this version
        (read-modify-write, atomic per tier).  Caller holds the version's
        rewrite lock, NOT the cluster lock.  Returns the tier names whose
        segment was rewritten."""
        out: set = set()
        skey = fmt.segment_key(name, version)
        for tier in self.external_tiers:
            # no aggregate gate: a segment written by an aggregating run
            # must stay maintainable after a restart with aggregation off
            blob = self._tier_get(tier, skey)
            if blob is None:
                continue
            try:
                reader = fmt.SegmentReader(blob)
            except Exception as e:  # noqa: BLE001
                self._diagnose_segment(tier.info.name, skey, e)
                continue
            # verify=False: untouched entries are copied byte-for-byte —
            # a pre-existing corrupt entry stays corrupt, it must not make
            # the rewrite abort and strand the replacement blobs.
            entries = {n: reader.read(n, verify=False)
                       for n in reader.names()}
            entries.update(repl)
            seg = fmt.encode_segment(entries, meta=reader.meta)
            tier.put(skey, seg)
            self._cache_segment(tier.info.name, skey, fmt.SegmentReader(seg))
            out.add(tier.info.name)
        return out

    def _pack_rmw(self, name: str, skey: str, transform, *,
                  drop_torn: bool = False) -> set:
        """Read-modify-write the rolling pack ``skey`` on every external
        tier holding it, under the pack's rewrite lock (caller must NOT
        hold it, nor the cluster lock).  ``transform(reader)`` returns the
        new ``(entries, versions)`` — or None to delete the pack.  A torn
        pack is skipped with a diagnostic, or deleted when ``drop_torn``
        (GC re-pack: its members are already retired, nothing inside is
        readable anyway).  Returns the tier names whose pack was
        rewritten."""
        out: set = set()
        with self._pack_lock(skey):
            for tier in self.external_tiers:
                blob = self._tier_get(tier, skey)
                if blob is None:
                    continue
                try:
                    reader = fmt.PackReader(blob)
                except Exception as e:  # noqa: BLE001
                    self._diagnose_segment(tier.info.name, skey, e)
                    if drop_torn:
                        tier.delete(skey)
                        with self._seg_lock:
                            self._segcache.pop((tier.info.name, skey), None)
                    continue
                res = transform(reader)
                if res is None:
                    tier.delete(skey)
                    with self._seg_lock:
                        self._segcache.pop((tier.info.name, skey), None)
                    continue
                entries, versions = res
                seg = fmt.encode_pack(name, entries, versions,
                                      meta={"nranks":
                                            reader.meta.get("nranks",
                                                            self.nranks)})
                tier.put(skey, seg)
                self._cache_segment(tier.info.name, skey,
                                    fmt.PackReader(seg))
                out.add(tier.info.name)
        return out

    def _rewrite_pack_io(self, name: str, skey: str, repl: dict[str, bytes]
                         ) -> set:
        """Replace entries inside the rolling pack ``skey`` (atomic per
        tier); returns the tier names whose pack was rewritten."""

        def transform(reader):
            entries = {n: reader.read(n, verify=False)
                       for n in reader.names()}
            entries.update(repl)
            return entries, reader.versions

        return self._pack_rmw(name, skey, transform)

    def rewrite_entries(self, name: str, version: int,
                        repl: dict[str, bytes]) -> set:
        """Public segment rewrite hook (compaction, parity refresh):
        routes through the open batch / rolling pack, a retained
        failed-seal batch, the sealed per-version segment, or the sealed
        rolling pack — whichever currently owns the version's L3 bytes."""
        with self._lock:
            if self._stage_into_batch_locked(name, version, repl):
                return {"(pending-batch)"}
            found = self._find_seal_retry_locked(name, version)
            if found is not None:
                # the re-seal must publish current (e.g. compacted) bytes
                _, item = found
                for key, blob in repl.items():
                    item["entries"][key] = bytes(blob)
                return {"(seal-retry)"}
            vlock = self._version_rewrite_lock_locked(name, version)
        out: set = set()
        with vlock:
            out |= self._rewrite_segments_io(name, version, repl)
        pack_keys = {sk for sk in
                     (self._pack_skey_for(t, name, version)
                      for t in self.external_tiers) if sk is not None}
        for skey in pack_keys:
            out |= self._rewrite_pack_io(name, skey, repl)
        return out

    def _stage_pubs_locked(self, name: str, version: int,
                           pubs: dict[str, bytes]) -> str:
        """Route version artifacts (manifests) while holding the cluster
        lock.  Returns how the caller must finish OUTSIDE the lock:

          "staged"   — landed in the open batch / rolling pack; done.
          "retained" — copied into a retained failed-seal batch (the
                       re-seal will carry them); direct puts are STILL
                       needed so healthy tiers — and a fresh process — see
                       the manifest now, not only after a successful
                       re-seal.
          "publish"  — not batching anywhere; publish via _publish_many.
        """
        if self._stage_into_batch_locked(name, version, pubs):
            return "staged"
        found = self._find_seal_retry_locked(name, version)
        if found is not None:
            _, item = found
            for key, blob in pubs.items():
                item["entries"][key] = bytes(blob)
            return "retained"
        return "publish"

    def _publish_many(self, name: str, version: int,
                      pubs: dict[str, bytes], *,
                      probe_segments: bool = True):
        """Tier I/O half of a manifest publish — call WITHOUT the cluster
        lock (segment/pack read-modify-writes serialize on the version and
        pack rewrite locks; holding the global lock across external I/O
        would stall every rank's staging).  Writes inside the sealed
        segment or pack where one exists, direct puts elsewhere.
        ``probe_segments=False`` skips the per-tier lookups for versions
        that cannot have one (the direct write path, retained batches)."""
        if not pubs:
            return
        seg_tiers: set = set()
        if probe_segments:
            with self._lock:
                vlock = self._version_rewrite_lock_locked(name, version)
                skey = self._packed.get((name, version))
            with vlock:
                seg_tiers = self._rewrite_segments_io(name, version, pubs)
            if skey is not None:
                seg_tiers |= self._rewrite_pack_io(name, skey, pubs)
        for tier in self.external_tiers:
            if tier.info.name in seg_tiers:
                # the fresh bytes landed INSIDE this tier's segment/pack —
                # but a DIRECT copy published before the seal (L1/L2
                # manifests go out via note_shard while the batch is still
                # open) would keep the stale parent/delta metadata and win
                # last-writer key-scan discovery.  Refresh any that exist;
                # never create new direct duplicates beside a sealed blob.
                for key, blob in pubs.items():
                    if tier.exists(key):
                        tier.put(key, blob)
                continue
            for key, blob in pubs.items():
                tier.put(key, blob)

    def _note_meta_locked(self, name: str, version: int, meta: dict):
        self._meta[(name, version)] = dict(meta)
        dmeta = meta.get("delta") or {}
        self._parents[(name, version)] = dmeta.get("parent") \
            if dmeta.get("kind") == "delta" else None

    #: consecutive direct-miss-then-segment-hit probes before an external
    #: tier's shard probe flips segment-first (see ``_seg_bias``)
    _SEG_BIAS_THRESHOLD = 2

    def _external_shard_probe(self, tier: StorageTier, name: str,
                              version: int, key: str,
                              packed: Optional[str]) -> Optional[bytes]:
        """One external tier's full shard probe: rolling pack / direct
        key / per-version segment, ordered by what pack membership
        (catalog-seeded or scanned) already says about the version so the
        common case pays one get, not two guaranteed miss-probes.

        The direct/segment order ADAPTS per tier: once
        ``_SEG_BIAS_THRESHOLD`` consecutive probes miss the direct key
        and then resolve inside the sealed segment, later probes lead
        with the segment — on a remote store every guaranteed-miss
        direct get is a full metadata round trip, and a sealed stream
        pays it on every shard of every restore.  A direct-key hit at
        any point resets the bias, so streams that publish direct
        copies again (fresh version before its seal) fall back to the
        cheap-first order by themselves."""
        if packed is not None:
            blob = self._pack_entry(tier, name, version, key)
            if blob is None:
                blob = self._tier_get(tier, key)
            if blob is None:
                blob = self._segment_entry(tier, name, version, key)
            return blob
        bias = self._seg_bias.get(tier.info.name, 0)
        if bias >= self._SEG_BIAS_THRESHOLD:
            blob = self._segment_entry(tier, name, version, key)
            if blob is not None:
                return blob
            blob = self._tier_get(tier, key)
            if blob is not None:
                self._seg_bias[tier.info.name] = 0  # direct serves again
                return blob
            return self._pack_entry(tier, name, version, key)
        blob = self._tier_get(tier, key)
        if blob is not None:
            if bias:
                self._seg_bias[tier.info.name] = 0
            return blob
        blob = self._segment_entry(tier, name, version, key)
        if blob is not None:
            self._seg_bias[tier.info.name] = bias + 1
            return blob
        return self._pack_entry(tier, name, version, key)

    def fetch_shard(self, name: str, version: int, rank: int) -> Optional[bytes]:
        key = fmt.shard_key(name, version, rank)
        for tier in self._node_tiers[rank]:
            blob = self._tier_get(tier, key)
            if blob is not None:
                return blob
        with self._lock:
            packed = self._packed.get((name, version))
        for tier in self.external_tiers:
            blob = self._external_shard_probe(tier, name, version, key,
                                              packed)
            if blob is not None:
                return blob
        return None

    def _peer_seal_home(self, skey: str) -> int:
        """Consistent-hash home node for a sealed blob's L2 peer copy.
        Writer (``_do_seal_io``) and every reader derive the same node
        from the key alone — no membership coordination, and the copies
        spread across nodes instead of piling on one."""
        return sum(skey.encode()) % max(self.nranks, 1)

    def _peer_blob_entry(self, name: str, version: int, key: str,
                         packed: Optional[str]) -> Optional[bytes]:
        """Read one shard entry out of a peer node's L2 copy of the sealed
        segment/pack blob (``peer_seal_copies``), through the same
        single-flight cross-reader cache external blobs use.  Only probes
        when the blob key is already known (packed membership or the
        deterministic segment key) — never lists a node tier."""
        skey = packed if packed is not None \
            else fmt.segment_key(name, version)
        home = self._peer_seal_home(skey)
        if not (0 <= home < self.nranks):
            return None
        parse = fmt.PackReader if packed is not None else fmt.SegmentReader
        for tier in self._node_tiers[home]:
            reader, _ = self._cached_blob_reader(tier, skey, parse)
            if reader is None or key not in reader:
                continue
            try:
                return reader.read(key)
            except Exception as e:  # noqa: BLE001 — corrupt entry = miss
                self._diagnose_segment(tier.info.name, skey + "#" + key, e)
        return None

    def shard_sources(self, name: str, version: int, rank: int,
                      *, distance: int = 1) -> list[dict]:
        """Every source that should hold this shard's bytes, one probe
        thunk each: the rank's own node tiers (direct key), the partner
        rank's node tiers (``.partner`` replica, and — with
        ``peer_seal_copies`` — the consistent-hash peer copy of the sealed
        segment/pack blob), then each external tier's pack/direct/segment
        probe.  Returned in nominal cheap-to-costly order; the restore
        scheduler re-ranks by live ``read_cost()`` per fetch, so the list
        order only breaks cost ties."""
        from repro_torch.core.erasure import partner_of

        key = fmt.shard_key(name, version, rank)
        with self._lock:
            packed = self._packed.get((name, version))
        sources: list[dict] = []

        def add(tier, kind, fetch):
            sources.append({"tier": tier, "kind": kind, "fetch": fetch})

        for tier in self._node_tiers[rank]:
            add(tier, "local",
                lambda t=tier: self._tier_get(t, key))
        holder = partner_of(rank, self.nranks, distance)
        if holder != rank:
            pkey = key + ".partner"
            for tier in self._node_tiers[holder]:
                add(tier, "partner",
                    lambda t=tier: self._tier_get(t, pkey))
        if self.peer_seal_copies and self.nranks > 1:
            skey = packed if packed is not None \
                else fmt.segment_key(name, version)
            home = self._peer_seal_home(skey)
            if 0 <= home < self.nranks and self._node_tiers[home]:
                # one logical source: the home node's cached blob copy
                # (tier shown = its fastest tier, where the copy lands)
                add(self._node_tiers[home][0], "peer-seal",
                    lambda: self._peer_blob_entry(name, version, key,
                                                  packed))
        for tier in self.external_tiers:
            add(tier, "external",
                lambda t=tier: self._external_shard_probe(
                    t, name, version, key, packed))
        return sources

    def tier_read_stats(self) -> dict[str, dict]:
        """Per-tier read telemetry snapshot (``StorageTier.read_stats``)
        across the whole fabric.  Node tiers are keyed ``node<r>/<name>``
        (tier names repeat across nodes), external tiers by name."""
        out: dict[str, dict] = {}
        for tier in self.external_tiers:
            stats = getattr(tier, "read_stats", None)
            if callable(stats):
                out[tier.info.name] = stats()
        for r, tiers in enumerate(self._node_tiers):
            for tier in tiers:
                stats = getattr(tier, "read_stats", None)
                if callable(stats):
                    out[f"node{r}/{tier.info.name}"] = stats()
        return out

    def fetch_partner_copy(self, name: str, version: int, rank: int,
                           distance: int) -> Optional[bytes]:
        from repro_torch.core.erasure import partner_of

        holder = partner_of(rank, self.nranks, distance)
        key = fmt.shard_key(name, version, rank) + ".partner"
        for tier in self._node_tiers[holder]:
            blob = self._tier_get(tier, key)
            if blob is not None:
                return blob
        if self.peer_seal_copies and self.nranks > 1:
            with self._lock:
                packed = self._packed.get((name, version))
            return self._peer_blob_entry(
                name, version, fmt.shard_key(name, version, rank), packed)
        return None

    def fetch_parity(self, name: str, version: int, group: int) -> Optional[bytes]:
        from repro_torch.core.erasure import parity_home

        g = min(self.group_size, self.nranks)
        home = parity_home(group, g, self.nranks) if g >= 2 else -1
        key = fmt.parity_key(name, version, group)
        for tier in (self._node_tiers[home]
                     if 0 <= home < self.nranks else []):
            blob = self._tier_get(tier, key)
            if blob is not None:
                return blob
        for tier in self.external_tiers:
            blob = self._tier_get(tier, key)
            if blob is None:
                blob = self._segment_entry(tier, name, version, key)
            if blob is None:
                blob = self._pack_entry(tier, name, version, key)
            if blob is not None:
                return blob
        return None

    def note_shard(self, name, version, level, rank, digest, meta=None):
        """Collective commit: last rank to report publishes the manifest.
        While the version's aggregated batch / rolling pack is open the
        manifest is staged there (it travels in the single seal put);
        otherwise it is written outside the cluster lock — through the
        sealed segment or pack when one exists."""
        pubs = None
        probe = False
        with self._lock:
            k = (name, version, level)
            reg = self._registry.setdefault(k, {})
            reg[rank] = digest
            self._vtimes.setdefault((name, version), time.time())
            if meta:
                self._note_meta_locked(name, version, meta)
            if len(reg) == self.nranks:
                blob = fmt.make_manifest(
                    name, version, self.nranks, level=level,
                    shard_digests=reg, meta=self._meta.get((name, version), {}),
                    parent=self._parents.get((name, version)),
                    group_size=self.group_size)
                key = fmt.manifest_key(name, version) + f".{level}"
                self._cat_note_locked(name, version, level=level)
                mode = self._stage_pubs_locked(name, version, {key: blob})
                if mode != "staged":
                    pubs = {key: blob}
                    # a version this process writes through the direct path
                    # cannot have a segment — skip the per-tier probes; a
                    # retained batch has none yet either
                    probe = mode == "publish" and (
                        bool(self.aggregate)
                        or (name, version) in self._sealed)
        if pubs is not None:
            self._publish_many(name, version, pubs, probe_segments=probe)

    def republish_manifest(self, name, version, rank, digest, meta=None):
        """Post-compaction commit for one rank: replace its digest and
        republish complete manifests.  The version-wide parent link (and
        the manifest meta saying "full") only flips once every rank has
        compacted — until then other ranks' delta shards still walk the
        chain, and GC must keep it alive."""
        with self._lock:
            hydrated = any(n == name and v == version
                           for (n, v, _l) in self._registry)
        # a fresh process (restart-then-compact) has an empty in-memory
        # registry: hydrate this version's digests/parent from the on-disk
        # manifests, else nothing would be republished and the rewritten
        # shard bytes would fail every stale-digest check.  Fetched OUTSIDE
        # the cluster lock — manifests() may scan rolling packs, which
        # memoizes membership under the lock.
        mlist = None if hydrated else self.manifests(name)
        with self._lock:
            if mlist is not None and not any(
                    n == name and v == version
                    for (n, v, _l) in self._registry):
                for m in mlist:
                    if m["version"] != version:
                        continue
                    self._registry[(name, version, m["level"])] = \
                        dict(m["shard_digests"])
                    self._parents.setdefault((name, version), m.get("parent"))
                    self._meta.setdefault((name, version),
                                          m.get("meta") or {})
            done = self._compacted.setdefault((name, version), set())
            done.add(rank)
            fully_compacted = len(done) == self.nranks
            if fully_compacted:
                self._parents[(name, version)] = None
                if meta is not None:
                    self._meta[(name, version)] = dict(meta)
                self._cat_note_locked(name, version, compacted=True)
            parent = self._parents.get((name, version))
            pubs: dict[str, bytes] = {}
            for (n, v, level), reg in self._registry.items():
                if n != name or v != version:
                    continue
                reg[rank] = digest
                if len(reg) == self.nranks:
                    blob = fmt.make_manifest(
                        name, version, self.nranks, level=level,
                        shard_digests=reg,
                        meta=self._meta.get((name, version), {}),
                        parent=parent, group_size=self.group_size)
                    pubs[fmt.manifest_key(name, version) + f".{level}"] = blob
            mode = self._stage_pubs_locked(name, version, pubs) if pubs \
                else "staged"
        if mode != "staged":
            self._publish_many(name, version, pubs,
                               probe_segments=mode == "publish")

    def ranks_compacted(self, name: str, version: int) -> set:
        """Ranks that have folded their shard of ``version`` full (the
        parity refresh waits for its whole erasure group)."""
        with self._lock:
            return set(self._compacted.get((name, version), set()))

    def has_shard_record(self, name: str, version: int, rank: int) -> bool:
        """Did ``rank`` persist ``version`` at ANY level?  (Used by the
        delta module: a parent that never hit storage must not anchor a
        chain.)"""
        with self._lock:
            return any(rank in reg for (n, v, _l), reg in
                       self._registry.items() if n == name and v == version)

    @staticmethod
    def _note_manifest(out: dict, blob):
        if blob:
            try:
                m = fmt.parse_manifest(blob)
            except Exception:  # noqa: BLE001 — unparseable manifest
                return
            out[(m["version"], m["level"])] = m

    def manifests(self, name: str) -> list[dict]:
        """Every readable manifest of the stream, newest first.

        Catalog-first: when a durable stream catalog is available, the
        version set comes from it (one catalog get) and each version's
        manifests resolve through DETERMINISTIC keys — direct manifest
        blobs, the per-version segment, or the recorded pack — so the
        whole discovery costs zero ``keys()`` listings.  When catalogs are
        enabled but no healthy blob exists (deleted, torn, pre-catalog
        data), discovery degrades to the historical key-scan with a logged
        diagnostic."""
        cat = self.load_catalog(name)
        if cat is None and self.catalog_tiers():
            with self._lock:
                pending = bool(self._cat_state.get(name, {}).get("versions"))
            if pending:
                # no blob yet but this process holds unsynced state (the
                # normal async window between a flush and the first
                # maintenance-lane sync): seed the catalog instead of
                # warning through the scan fallback
                self.sync_catalog(name, force=True)
                cat = self.load_catalog(name, refresh=True)
        if cat is not None:
            return self._manifests_from_catalog(name, cat)
        scanned = self._manifests_scan(name)
        if scanned and self.catalog_tiers():
            # only noteworthy when data EXISTS that the catalog doesn't
            # cover — a cold start with nothing on disk is not a fallback
            self._note_catalog_fallback(name, "manifest discovery")
        return scanned

    def _manifests_from_catalog(self, name: str, cat: dict) -> list[dict]:
        out: dict = {}
        with self._lock:
            # union with the in-memory registry: versions this process
            # published whose catalog sync is still pending must not be
            # invisible to its own restart/compaction paths
            versions = set(cat["versions"]) | \
                {v for (n, v, _l) in self._registry if n == name}
            packed = {v: self._packed.get((name, v)) for v in versions}
        for v in sorted(versions, reverse=True):
            rec = cat["versions"].get(v)
            base = fmt.manifest_key(name, v)
            pk = (rec or {}).get("pack") or packed.get(v)
            # the record narrows the probes: direct manifest gets only for
            # levels that ever published (L3 only when it wasn't sealed
            # into a segment/pack — sealed L3 manifests travel inside),
            # and the per-version segment only when one can exist.  A
            # version without a record (in-memory registry only) probes
            # everything.
            if rec is None:
                levels = ("L1", "L2", "L3")
                probe_segment = True
            else:
                sealed_inside = rec.get("sealed") and \
                    rec.get("location") in ("segment", "pack")
                levels = tuple(lv for lv in rec.get("levels", ())
                               if lv != "L3" or not sealed_inside)
                probe_segment = rec.get("location") != "pack" or \
                    not rec.get("sealed")
            for tier in self.external_tiers:
                for level in levels:
                    self._note_manifest(
                        out, self._tier_get(tier, f"{base}.{level}"))
                if probe_segment:
                    reader = self._segment_reader(tier, name, v)
                    if reader is not None:
                        for en in reader.names():
                            if "/manifest" in en:
                                self._note_manifest(
                                    out,
                                    self._segment_entry(tier, name, v, en))
                if not pk:
                    continue
                preader = self._pack_reader(tier, name, pk)
                if preader is None:
                    continue
                for en in preader.entries_for(name, v):
                    if "/manifest" not in en:
                        continue
                    try:
                        self._note_manifest(out, preader.read(en))
                    except Exception as e:  # noqa: BLE001
                        self._diagnose_segment(tier.info.name,
                                               pk + "#" + en, e)
        return [m for _, m in sorted(out.items(), reverse=True)]

    def _manifests_scan(self, name: str) -> list[dict]:
        """Key-scan manifest discovery (the pre-catalog path, and the
        fallback when the catalog is missing or torn)."""
        out: dict = {}

        def note(blob):
            self._note_manifest(out, blob)

        for tier in self.external_tiers:
            for key in tier.keys(f"{name}/"):
                if "/manifest" in key:
                    note(self._tier_get(tier, key))
                elif key.startswith(fmt.pack_prefix(name)):
                    # rolling pack: several delta versions' manifests travel
                    # inside one blob (a torn pack is skipped with a
                    # diagnostic — none of its members are candidates).
                    reader = self._pack_reader(tier, name, key)
                    if reader is None:
                        continue
                    for en in reader.names():
                        if "/manifest" not in en:
                            continue
                        try:
                            note(reader.read(en))
                        except Exception as e:  # noqa: BLE001
                            self._diagnose_segment(tier.info.name,
                                                   key + "#" + en, e)
                elif key.endswith("/segment"):
                    # aggregated version: its manifests travel inside the
                    # segment — resolve them through the cached index (a
                    # torn segment is skipped with a diagnostic, so the
                    # version simply isn't a restart candidate).
                    try:
                        version = int(key[len(name) + 1:].split("/")[0][1:])
                    except ValueError:
                        continue
                    reader = self._segment_reader(tier, name, version)
                    if reader is None:
                        continue
                    for en in reader.names():
                        if "/manifest" in en:
                            note(self._segment_entry(tier, name, version, en))
        return [m for _, m in sorted(out.items(), reverse=True)]

    # -- failure / GC ----------------------------------------------------
    def fail_node(self, rank: int):
        """Simulate fail-stop node loss: volatile + node-local data gone."""
        for tier in self._node_tiers[rank]:
            tier.wipe()

    def gc(self, name: str, keep: int, *, max_age_s: Optional[float] = None,
           now: Optional[float] = None):
        """Drop every artifact of versions beyond the retention policy:
        shards, partner copies, parity blobs and per-level manifests, on
        node-local AND external tiers (prefix delete per version).

        Retention is per-stream and two-dimensional: ``keep`` bounds the
        count (the newest ``keep`` survive; 0 = no count limit), and
        ``max_age_s`` bounds age — a version whose creation time (noted at
        first shard commit, carried durably in the catalog record's
        ``ts``) is older than this many seconds is retired even inside the
        count window.  The newest version always survives whatever its
        age, versions with no known timestamp are never age-retired
        (conservative), and the delta-chain refcount below still pins a
        survivor's whole chain.  ``now`` overrides the wall clock (tests).

        Restart-safe: enumeration is the UNION of the in-memory registry
        and the durable stream catalog (falling back to a manifest key
        scan — with a diagnostic — when catalogs are enabled but no
        healthy blob exists), so a FRESH process retires a previous run's
        versions and orphaned packs without that run's registry.  Retired
        versions leave ``(version, stamp)`` tombstones in the catalog, so
        a concurrent writer's stale RMW can never resurrect them.

        Delta-aware: versions the survivors transitively reference through
        ``parent`` links (their delta chains down to the full base) are
        refcounted live and kept, whatever their age — dropping a base
        would strand every delta above it.

        Pack-aware: a retired version whose L3 entries live in a rolling
        pack shared with survivors triggers a RE-PACK of the survivors
        (the pack key sits outside every version prefix, so the prefix
        delete cannot touch it); a pack whose members all retired is
        deleted whole, and a sweep of the stream's pack keys retires
        orphaned packs whose members are ALL known-dead (dropped now or
        tombstoned earlier) — never packs with members of unknown fate.

        Bookkeeping is dropped under the cluster lock, but the tier I/O
        (prefix deletes, pack rewrites, the catalog RMW) runs OUTSIDE it
        under the same per-version / per-pack rewrite-lock discipline as
        compaction — GC is a maintenance-lane task and must not stall
        every rank's staging behind external deletes."""
        cat_enabled = bool(self.catalog_tiers())
        # NOTE: _gc_swept is only marked after the reconciling scan and
        # orphan-pack sweep actually complete — a sweep that throws (or
        # skips a flaky tier) retries on the next gc
        first_sweep = cat_enabled and name not in self._gc_swept
        cat = self.load_catalog(name, refresh=True) if cat_enabled else None
        if cat_enabled and cat is None:
            with self._lock:
                pending = bool(self._cat_state.get(name, {}).get("versions"))
            if pending:
                # no blob yet but this process holds unsynced state (e.g.
                # the very first sweep raced the very first sync on a
                # parallel maintenance worker): seed the catalog now
                # instead of warning through the scan fallback
                self.sync_catalog(name, force=True)
                cat = self.load_catalog(name, refresh=True)
        cat_versions: dict[int, dict] = {} if cat is None else cat["versions"]
        cat_tombs: dict[int, set] = {} if cat is None else cat["tombstones"]
        scan_manifests: list[dict] = []
        if cat_enabled and cat is None:
            scan_manifests = self._manifests_scan(name)
            if scan_manifests:
                self._note_catalog_fallback(name, "gc enumeration")
        elif first_sweep:
            # one-time migration / stale-recovery merge: a HEALTHY catalog
            # may still be missing versions written before catalogs were
            # enabled (or sealed by a run that crashed before its sync) —
            # the first sweep of each process reconciles the blob against
            # one key scan so such versions are adopted, GC'd when old,
            # and visible to catalog-first restarts, instead of leaking
            # on every tier forever
            scan_manifests = self._manifests_scan(name)
        drops: list[tuple[int, Optional[concurrency.TrackedLock]]] = []
        pack_drops: dict[str, set] = {}
        with self._lock:
            parents: dict[int, Optional[int]] = {}
            scan_levels: dict[int, set] = {}
            for m in scan_manifests:  # oldest applied last wins — any level
                parents.setdefault(m["version"], m.get("parent"))
                scan_levels.setdefault(m["version"], set()).add(m["level"])
            parents.update({v: r.get("parent")
                            for v, r in cat_versions.items()})
            parents.update({v: p for (n, v), p in self._parents.items()
                            if n == name})
            versions = sorted({v for (n, v, _l) in self._registry
                               if n == name}
                              | set(cat_versions) | set(scan_levels),
                              reverse=True)
            live = set(versions[:keep]) if keep else set(versions)
            if max_age_s is not None and versions:
                cutoff = (now if now is not None else time.time()) - max_age_s
                for v in list(live):
                    if v == versions[0]:
                        continue  # the newest survives whatever its age
                    ts = self._vtimes.get((name, v))
                    if ts is None:
                        ts = (cat_versions.get(v) or {}).get("ts")
                    if ts is not None and ts < cutoff:
                        live.discard(v)
            frontier = list(live)
            while frontier:
                p = parents.get(frontier.pop())
                if p is not None and p not in live:
                    live.add(p)
                    frontier.append(p)
            drop = [v for v in versions if v not in live]
            st = None
            adopted = 0
            if cat_enabled:
                st = self._cat_state.setdefault(
                    name, {"versions": {}, "tombstones": {}})
                # migration: live versions discovered only by the scan
                # (pre-catalog data, or a crashed run's unsynced seals)
                # get adopted into the catalog, so the NEXT restart/gc
                # plans from it instead of re-scanning
                for v in live:
                    if v in st["versions"] or v in cat_versions \
                            or v not in scan_levels:
                        continue
                    pk = self._packed.get((name, v))
                    st["versions"][v] = {
                        "kind": "delta" if parents.get(v) is not None
                                else "full",
                        "parent": parents.get(v),
                        "sealed": pk is not None
                        or (name, v) in self._sealed,
                        "location": "pack" if pk else "direct",
                        "pack": pk, "entries": None,
                        "levels": sorted(scan_levels.get(v, ())),
                        "stamp": self._run_stamp}
                    self._cat_dirty.add(name)
                    adopted += 1
            rb = self._rolling.get(name)
            for v in drop:
                if rb is not None and rb.has(v):
                    rb.drop_version(v, fmt.version_prefix(name, v))
                found = self._find_seal_retry_locked(name, v)
                if found is not None:
                    rkey, item = found
                    item["versions"].remove(v)
                    pfx = fmt.version_prefix(name, v)
                    for k in [k for k in item["entries"]
                              if k.startswith(pfx)]:
                        item["entries"].pop(k, None)
                    if not item["versions"]:
                        self._seal_retry.pop(rkey, None)
                pkey = self._packed.pop((name, v), None)
                if pkey is None:
                    pkey = (cat_versions.get(v) or {}).get("pack")
                if pkey is not None:
                    pack_drops.setdefault(pkey, set()).add(v)
                if st is not None:
                    rec = st["versions"].pop(v, None)
                    stamp = (rec or cat_versions.get(v)
                             or {}).get("stamp") or "?"
                    st["tombstones"].setdefault(v, set()).add(stamp)
                    self._cat_dirty.add(name)
                for k in [k for k in self._registry if k[0] == name and k[1] == v]:
                    self._registry.pop(k, None)
                self._meta.pop((name, v), None)
                self._vtimes.pop((name, v), None)
                self._parents.pop((name, v), None)
                self._compacted.pop((name, v), None)
                self._batches.pop((name, v), None)
                self._sealed.pop((name, v), None)
                self._seal_errors.pop((name, v), None)
                skey = fmt.segment_key(name, v)
                with self._seg_lock:
                    for ck in [ck for ck in self._segcache if ck[1] == skey]:
                        self._segcache.pop(ck, None)
                drops.append((v, self._vlocks.pop((name, v), None)))
            if rb is not None and not rb.versions:
                self._rolling.pop(name, None)
        for v, vlock in drops:
            # serialize with any in-flight segment rewrite of this version
            # (its lock is dropped for good afterwards; a rewrite racing
            # PAST this point could at worst resurrect one orphan segment
            # file, never a restart candidate).  No lock ever existed =
            # nothing to serialize with.
            if vlock is not None:
                vlock.acquire()
            try:
                prefix = fmt.version_prefix(name, v)
                for tiers in self._node_tiers:
                    for tier in tiers:
                        for key in tier.keys(prefix):
                            tier.delete(key)
                for tier in self.external_tiers:
                    for key in tier.keys(prefix):
                        tier.delete(key)
            finally:
                if vlock is not None:
                    vlock.release()
        if adopted:
            self._diagnose_catalog(
                None, name,
                f"adopted {adopted} version(s) the durable catalog did "
                f"not cover (pre-catalog data or a crashed run's unsynced "
                f"seals)")
        for pkey, retired in pack_drops.items():
            self._repack_io(name, pkey, retired)
        if cat_enabled and first_sweep:
            # orphaned-pack sweep: a previous run's pack whose members are
            # ALL known-dead (dropped above, or tombstoned by an earlier
            # gc whose pack delete never completed) is deleted whole.
            # Members of unknown fate keep the pack — a stale catalog must
            # never cost live data.  Once per stream per process: THIS
            # process's own retirements always resolve their pack keys via
            # the catalog/_packed and go through the re-pack path above,
            # so repeating the listing every steady-state gc buys nothing.
            dead = set(drop) | set(cat_tombs)
            with self._lock:
                st2 = self._cat_state.get(name) or {}
                dead |= set(st2.get("tombstones", ()))
            # tombstones are version NUMBERS here, but packs only know
            # numbers too — a LATER incarnation legitimately reusing a
            # retired number is live, and a pack holding it must survive
            dead -= live
            swept_ok = True
            for tier in self.external_tiers:
                try:
                    pkeys = tier.keys(fmt.pack_prefix(name))
                except Exception:  # noqa: BLE001 — flaky tier: stay
                    # unswept so the NEXT gc retries the whole sweep
                    swept_ok = False
                    continue
                for pkey in pkeys:
                    if pkey in pack_drops:
                        continue  # already re-packed above
                    reader = self._pack_reader(tier, name, pkey)
                    if reader is None:
                        continue  # torn: diagnosed, membership unknowable
                    members = set(reader.versions)
                    if members and members <= dead:
                        self._repack_io(name, pkey, members)
            if swept_ok:
                self._gc_swept.add(name)
        if cat_enabled:
            # persist tombstones / adoptions now — gc already runs on the
            # maintenance lane (or inline in sync mode, like gc itself)
            self.sync_catalog(name)

    def _repack_io(self, name: str, skey: str, retired: set):
        """Maintenance-lane pack rewrite after GC retired some members:
        survivors are re-packed in place (one put per tier), a fully
        retired pack is deleted."""

        def transform(reader):
            survivors = [v for v in reader.versions if v not in retired]
            if not survivors:
                return None
            prefixes = tuple(fmt.version_prefix(name, v) for v in retired)
            entries = {n: reader.read(n, verify=False)
                       for n in reader.names()
                       if not n.startswith(prefixes)}
            return entries, survivors

        kept = self._pack_rmw(name, skey, transform, drop_torn=True)
        if not kept:
            # the pack is gone from every tier: drop its rewrite lock or
            # _plocks grows by one entry per pack for the cluster lifetime.
            # (A racer that already fetched the old Lock object could at
            # worst rewrite concurrently with a later same-key pack — the
            # orphan-resurrection exposure GC already accepts.)
            with self._plock_guard:
                self._plocks.pop(skey, None)


class VelocClient:
    """Per-rank checkpointing client (paper §2 API).

    Construct from a ``PipelineSpec`` (v2) or a legacy ``VelocConfig``
    (compiled through the shim).  When no ``cluster`` is given, a 1-rank
    cluster is built — from the config's topology in legacy mode, or from
    the default ``TierTopology`` rooted at ``scratch`` in v2 mode.

    Multi-tenant: several clients (different stream names, or the ranks of
    one stream) may share one ``Cluster`` *and* one ``ActiveBackend`` —
    pass ``backend=other_client.backend`` (or a backend you constructed).
    Each client registers its stream's lane policy (weight, rate budget,
    admission marks — the ``lane_*`` / ``admit_*`` spec knobs) on the
    shared backend at construction; workers then serve the streams by
    deficit-weighted round-robin instead of one global queue.  A client
    that was *given* its backend does not own it: ``shutdown()`` drains
    this client's own tasks and leaves the backend running for the other
    tenants — the owner (the client that created it, or whoever built it
    standalone) shuts it down last.
    """

    def __init__(self, cfg: Union[PipelineSpec, VelocConfig],
                 cluster: Optional[Cluster] = None, rank: int = 0, mesh=None,
                 *, scratch: str = "/tmp/veloc",
                 backend: Optional[ActiveBackend] = None):
        if isinstance(cfg, VelocConfig):
            self.cfg: Optional[VelocConfig] = cfg
            self.spec = cfg.to_pipeline_spec()
        elif isinstance(cfg, PipelineSpec):
            self.cfg = None
            self.spec = cfg
        else:
            raise TypeError(
                f"expected PipelineSpec or VelocConfig, got {type(cfg)!r}")
        spec = self.spec
        if cluster is None:
            if self.cfg is not None:
                cluster = Cluster(self.cfg, nranks=1)
            else:
                cluster = Cluster(TierTopology(scratch=scratch), nranks=1,
                                  group_size=spec.erasure_group_size())
        elif cluster.group_size == 0 and spec.erasure_group_size():
            # caller built the cluster without stating a group size but the
            # pipeline erasure-encodes: adopt the pipeline's width so
            # manifests and parity lookups agree with what gets written
            # (every rank shares the cluster and derives the same value).
            cluster.group_size = spec.erasure_group_size()
        if cluster.aggregate is None:
            # same adoption for the aggregated write path: the shared
            # cluster follows the first client's spec (every rank derives
            # the same value from the same spec).
            cluster.aggregate = spec.aggregate
        self.cluster = cluster
        self.rank = rank
        self.mesh = mesh
        self.name = spec.name
        self._protected: dict[str, Any] = {}
        self._open_version: Optional[int] = None
        self._staged: list[fmt.Region] = []
        partner_opts = spec.module_options("partner") or {}
        self._partner_distance = partner_opts.get("distance", 1)
        self.predictor = None
        if spec.phase_predictor == "ema":
            self.predictor = EMAPhasePredictor()
        elif spec.phase_predictor == "gru":
            raise NotImplementedError(
                'phase_predictor="gru" is not ported yet (ROADMAP.md queue '
                "1, item 8)")
        if self.predictor is not None:
            self.cluster.phase_gate = self.predictor.idle_wait
        self.backend = None
        self._owns_backend = False
        if spec.mode == "async":
            if backend is not None:
                self.backend = backend
            else:
                self.backend = ActiveBackend(
                    workers=spec.backend_workers,
                    rate_limiter=self.cluster.rate_limiter,
                    phase_gate=self.cluster.phase_gate,
                    maintenance_interval_s=spec.maintenance_interval_s)
                self._owns_backend = True
            spec.validate_tenant_knobs()
            self.backend.configure_stream(
                self.name, weight=spec.lane_weight,
                rate_bps=spec.lane_rate_bps,
                rate_share=spec.lane_rate_share,
                max_queued=spec.admit_max_queued,
                max_queued_bytes=spec.admit_max_queued_bytes)
            # peer-assisted restore wiring: surface the cluster's per-tier
            # read telemetry through backend.status()["tiers"], and route
            # the cluster's post-seal catalog sync through the coalesced
            # maintenance lane instead of inline external-tier I/O
            self.backend.tier_stats = self.cluster.tier_read_stats
            self.cluster.catalog_sync_soon = self._post_seal_sync_hook
        elif backend is not None:
            raise ValueError(
                "backend= is only meaningful with mode='async' (sync mode "
                "runs the whole pipeline inline)")
        self._compact_lock = concurrency.TrackedLock(
            "client._compact_lock", concurrency.RANK_CLIENT)
        self._compact_pending = False
        self.engine = spec.compile(backend=self.backend)
        self._history: list[dict] = []
        #: (version, level, error) entries for every restore candidate that
        #: was tried and failed during the last ``restart_latest`` call.
        self.restart_diagnostics: list[dict] = []

    # ------------------------------------------------------------------
    # low-level VELOC-style API
    # ------------------------------------------------------------------
    def protect(self, name: str, value: Any):
        """Declare a critical memory region (array or pytree)."""
        self._protected[name] = value

    def unprotect(self, name: str):
        self._protected.pop(name, None)

    def checkpoint_begin(self, version: int):
        assert self._open_version is None, "checkpoint already open"
        self._open_version = version
        self._staged = []

    def checkpoint_mem(self):
        """Stage every protected region (host copy of current values)."""
        assert self._open_version is not None
        for name, value in self._protected.items():
            for r in iter_host_regions(value, rank_prefix=f"{name}/"):
                self._staged.append(r)

    def checkpoint_end(self, *, defensive: bool = True, meta=None
                       ) -> CheckpointFuture:
        assert self._open_version is not None
        version = self._open_version
        self._open_version = None
        regions = list(self._staged)
        self._staged = []
        return self._submit(regions, version, defensive=defensive, meta=meta)

    # ------------------------------------------------------------------
    # high-level pytree API
    # ------------------------------------------------------------------
    def checkpoint(self, state, version: int, *, snap=None, defensive: bool = True,
                   meta=None, device_snapshot: bool = True) -> CheckpointFuture:
        """Checkpoint a (possibly device-resident) tree of tensors.

        Blocking work: the on-device snapshot copy only (or nothing, when the
        caller passes its own ``snap``).  Everything else drains in
        the backend; track it through the returned ``CheckpointFuture``."""
        t0 = time.monotonic()
        if snap is None:
            snap = snapshot_device(state) if device_snapshot else state
        if self.spec.mode == "async":
            regions: Any = lambda: list(iter_host_regions(snap))
        else:
            regions = list(iter_host_regions(snap))
        fut = self._submit(regions, version, defensive=defensive, meta=meta)
        fut.results["app_blocking_s"] = time.monotonic() - t0
        return fut

    def _submit(self, regions, version, *, defensive, meta) -> CheckpointFuture:
        ctx = CheckpointContext(
            name=self.name, version=version, rank=self.rank,
            nranks=self.cluster.nranks, regions=regions,
            meta=dict(meta or {}), cluster=self.cluster, defensive=defensive)
        fut = CheckpointFuture(ctx)
        self.engine.submit(ctx, future=fut)
        # the history row RESOLVES when the pipeline settles: under
        # mode="async" the background stages are still running here, so a
        # snapshot taken now would permanently hold stale/default values.
        row = {"version": version, "skipped": ctx.skipped,
               "blocking_s": ctx.results.get("blocking_s"),
               "status": "pending"}
        self._history.append(row)
        fut.add_done_callback(
            lambda f, row=row, ctx=ctx: self._resolve_history(row, f, ctx))
        # catalog sync BEFORE gc: the first sweep of a brand-new stream
        # should find the catalog already seeded instead of warning its way
        # through the scan fallback (both run on the maintenance lane in
        # submission order)
        self._schedule_catalog_sync(version)
        if self.spec.keep_versions or self.spec.max_age_s is not None:
            self._schedule_gc(version)
        if not ctx.skipped and self.spec.compact_threshold:
            self._maybe_compact(version)
        return fut

    def _resolve_history(self, row: dict, fut: CheckpointFuture,
                         ctx: CheckpointContext):
        row["skipped"] = ctx.skipped
        row["blocking_s"] = ctx.results.get("blocking_s")
        for k in ("shard_bytes", "delta_kind", "l3_tier", "errors"):
            if k in ctx.results:
                row[k] = ctx.results[k]
        if fut.superseded:
            row["status"] = "superseded"
        elif ctx.skipped:
            row["status"] = "skipped"
        elif fut._exc is not None:  # resolved by _finish before callbacks
            row["status"] = "error"
        else:
            row["status"] = "done"

    def _schedule_gc(self, version: int):
        """GC prefix-deletes walk every tier of every retired version —
        external-tier work that has no business on the application thread.
        With an active backend it runs as a coalesced, idle-gated
        maintenance task (at most one pending instance however many
        checkpoints queued it); sync mode keeps the historical inline
        behaviour."""
        # keep=0 means "no count limit" (age-only retention); otherwise
        # keep the newest N plus the version just submitted.
        keep = self.spec.keep_versions + 1 if self.spec.keep_versions else 0
        age = self.spec.max_age_s
        if self.backend is not None:
            self.backend.submit_maintenance(
                f"gc:{self.name}:{self.rank}", version,
                lambda: self.cluster.gc(self.name, keep, max_age_s=age),
                coalesce=True)
        else:
            self.cluster.gc(self.name, keep, max_age_s=age)

    def _schedule_catalog_sync(self, version: int):
        """Persist pending durable-catalog updates for this stream.  Like
        GC, the RMW is external-tier I/O: with an active backend it runs
        as a coalesced, idle-gated maintenance task; sync mode runs it
        inline.  A clean catalog makes this a no-op, so coalesced repeats
        are cheap."""
        if not self.cluster.catalog_tiers():
            return
        if self.backend is not None:
            self.backend.submit_maintenance(
                f"catalog:{self.name}:{self.rank}", version,
                lambda: self.cluster.sync_catalog(self.name), coalesce=True)
        else:
            self.cluster.sync_catalog(self.name)

    def _post_seal_sync_hook(self, name: str, version: int):
        """Cluster ``catalog_sync_soon`` target (async mode only): queue
        the post-seal catalog sync as coalesced maintenance work.  Uses
        the SAME kind as ``_schedule_catalog_sync`` so a seal-triggered
        sync and the per-checkpoint sync collapse into one RMW."""
        self.backend.submit_maintenance(
            f"catalog:{name}:{self.rank}", version,
            lambda: self.cluster.sync_catalog(name), coalesce=True)

    def wait(self, version: Optional[int] = None, timeout: Optional[float] = None
             ) -> bool:
        return self.engine.wait(self.name, self.rank, version, timeout)

    def tick(self, phase: str):
        if self.predictor is not None:
            self.predictor.tick(phase)

    # ------------------------------------------------------------------
    def restart_latest(self, template, shardings=None):
        """Find the newest restorable version and rebuild the pytree.
        Returns (version, state) or (None, None).  Every candidate that was
        tried and failed is recorded in ``self.restart_diagnostics`` as
        {"version", "level", "error"} so operators can see why a version
        was skipped; a total miss additionally folds the cluster's segment
        diagnostics in and logs the whole picture — an operator staring at
        ``(None, None)`` must not have to guess WHY nothing was
        restorable."""
        from repro_torch.core import restart

        self.restart_diagnostics = []
        plan = restart.plan_restore(self.cluster, self.name)
        found = plan.candidates
        for cand in found:
            try:
                regions = restart.load_rank_regions(
                    self.cluster, self.name, cand["version"], self.rank,
                    distance=self._partner_distance, plan=plan)
                state = tree_from_regions(template, regions, shardings)
                return cand["version"], state
            except Exception as e:  # noqa: BLE001 — fall back a level/version
                self.restart_diagnostics.append({
                    "version": cand["version"], "level": cand.get("level"),
                    "error": f"{type(e).__name__}: {e}"})
                continue
        for d in getattr(self.cluster, "segment_diagnostics", []):
            self.restart_diagnostics.append({
                "version": None, "level": "segment",
                "error": f"{d['tier']}:{d['key']}: {d['error']}"})
        _log.warning(
            "restart_latest(%r) rank %d: no restorable version "
            "(%d candidate(s) tried): %s", self.name, self.rank, len(found),
            self.restart_diagnostics or "no manifests found on any tier")
        return None, None

    def compact(self, version: Optional[int] = None) -> int:
        """Fold a delta chain back into a full shard (bounding restart
        latency and freeing chain ancestors for GC).

        Resolves this rank's regions of ``version`` (latest restorable when
        None) through the parent chain, rewrites the shard as a full
        encoding in every tier that holds it (primary and partner copies),
        republishes the manifests with the parent link cleared, and resets
        the pipeline's delta tracker so the next delta chains off the
        compacted base.  Returns the compacted version."""
        from repro_torch.core import restart

        name = self.name
        if version is None:
            found = restart.find_restart(self.cluster, name)
            if not found:
                raise IOError(f"no restorable version of {name!r} to compact")
            version = found[0]["version"]
        blob = restart.fetch_shard_any_level(
            self.cluster, name, version, self.rank,
            distance=self._partner_distance)
        if blob is None:
            raise IOError(f"rank {self.rank} shard unrecoverable for "
                          f"v{version}")
        reader = fmt.ShardReader(blob)
        if not reader.delta_regions():
            return version  # already full
        resolved = restart.load_rank_regions(
            self.cluster, name, version, self.rank,
            distance=self._partner_distance)
        regions = []
        for n in reader.region_names:
            e = reader.entry(n)
            regions.append(fmt.Region(
                n, resolved[n], global_shape=tuple(e["global_shape"]),
                shard_axis=e["shard_axis"], shard_index=e["shard_index"],
                shard_count=e["shard_count"]))
        meta = dict(reader.meta)
        meta["delta"] = {"kind": "full", "compacted": True}
        ser_opts = self.spec.module_options("serialize") or {}
        shard = fmt.serialize_shard(
            regions, meta, encoding=ser_opts.get("encoding", "raw"),
            checksums=ser_opts.get("checksums", True))
        from repro_torch.kernels import ops as kops

        digest = kops.digest(shard)
        key = fmt.shard_key(name, version, self.rank)
        wrote = False
        for tier in (self.cluster.node_tiers(self.rank)
                     + self.cluster.external_tiers):
            if tier.exists(key):
                tier.put(key, shard)
                wrote = True
        # aggregated versions hold the shard inside the external segment:
        # rewrite the entry in place (atomic read-modify-write per tier)
        if self.cluster.rewrite_entries(name, version, {key: shard}):
            wrote = True
        if self.cluster.nranks >= 2:
            from repro_torch.core.erasure import partner_of

            holder = partner_of(self.rank, self.cluster.nranks,
                                self._partner_distance)
            pk = key + ".partner"
            for tier in self.cluster.node_tiers(holder):
                if tier.exists(pk):
                    tier.put(pk, shard)
        if not wrote:  # primary copy was lost everywhere: re-seed L1
            from repro_torch.core.storage import pick_tier

            pick_tier(self.cluster.node_tiers(self.rank)).put(key, shard)
        self.cluster.republish_manifest(name, version, self.rank, digest,
                                        meta=meta)
        try:
            self.engine.module("delta").reset_chain(name, self.rank, version)
        except KeyError:
            pass
        return version

    # ------------------------------------------------------------------
    # background maintenance: auto-compaction + parity refresh
    # ------------------------------------------------------------------
    def _maybe_compact(self, version: int):
        """Auto-compaction trigger (``spec.compact_threshold`` deltas in the
        live chain).  With ``compact_async`` and an active backend the fold
        runs in the maintenance lane — only while the checkpoint lanes are
        idle, so it never fetches a shard that is still in flight and never
        blocks ``checkpoint_end``.  Otherwise it runs inline (after
        draining this version when a backend exists)."""
        try:
            dm = self.engine.module("delta")
        except KeyError:
            return
        thr = self.spec.compact_threshold
        if self.backend is not None and self.spec.compact_async:
            with self._compact_lock:
                if self._compact_pending:
                    return  # one maintenance fold in flight is enough
                self._compact_pending = True
            self.backend.submit_maintenance(
                f"compact:{self.name}:{self.rank}", version,
                lambda: self._compact_task(dm, thr))
            return
        tracker = dm.tracker(self.name, self.rank)
        # async mode reads the tracker one version late (the delta stage of
        # the version just submitted runs in the backend) — the fold then
        # simply triggers on the next checkpoint_end.
        if not tracker.needs_compaction(thr):
            return
        if self.backend is not None:
            self.wait(version)
        self._compact_task(dm, thr)

    def _compact_task(self, dm, threshold: int):
        try:
            tracker = dm.tracker(self.name, self.rank)
            version = tracker.last_version
            if not tracker.needs_compaction(threshold):
                return
            if not self.cluster.has_shard_record(self.name, version,
                                                 self.rank):
                return  # tip never persisted; the chain self-heals instead
            self.compact(version)
            # compaction rewrote primary/partner bytes but the group parity
            # still encodes the pre-compaction deltas (restart skips it via
            # digest checks): re-encode so the version regains full L2
            # protection.  Gated on the whole group having folded — member
            # bytes are final then, and only the group's last compacting
            # rank pays the encode instead of every rank redundantly.
            self.refresh_parity(version, require_full_group=True)
        finally:
            with self._compact_lock:
                self._compact_pending = False

    def refresh_parity(self, version: int, *,
                       require_full_group: bool = False) -> bool:
        """Re-encode this rank's erasure-group parity from the CURRENT
        member shard bytes (e.g. after compaction rewrote them).  Writes to
        wherever the group's parity lives — the parity home's node tier, or
        the external tier (inside the version's segment when aggregated).
        Returns False when the pipeline has no erasure module, a member
        shard is unreachable, or ``require_full_group`` is set and some
        group member has not compacted ``version`` yet (that member's later
        refresh will cover the group)."""
        from repro_torch.core import erasure
        from repro_torch.core.modules import build_parity_payload

        xopts = self.spec.module_options("xor")
        if xopts is None:
            return False
        g = min(xopts.get("group_size", 4), self.cluster.nranks)
        rs = xopts.get("rs_parity", 0)
        if g < 2:
            return False
        gid, _ = erasure.group_of(self.rank, g)
        members = [gid * g + i for i in range(g)
                   if gid * g + i < self.cluster.nranks]
        if require_full_group and not set(members) <= \
                self.cluster.ranks_compacted(self.name, version):
            return False
        shards = [self.cluster.fetch_shard(self.name, version, r)
                  for r in members]
        if any(s is None for s in shards):
            return False
        payload = build_parity_payload(shards, members, rs)
        pkey = fmt.parity_key(self.name, version, gid)
        home = erasure.parity_home(gid, g, self.cluster.nranks)
        if home >= 0:
            tiers = self.cluster.node_tiers(home)
            holders = [t for t in tiers if t.exists(pkey)]
            for tier in holders:
                tier.put(pkey, payload)
            if not holders:
                pick_tier(tiers).put(pkey, payload)
            return True
        if self.cluster.rewrite_entries(self.name, version, {pkey: payload}):
            return True
        pick_tier(self.cluster.external_tiers,
                  need_persistent=True).put(pkey, payload)
        return True

    def shutdown(self):
        if self.backend is not None:
            if self._owns_backend:
                self.backend.shutdown()
            else:
                # shared backend: drain THIS stream's pipeline and
                # maintenance tasks, then leave the backend running for
                # the other tenants (its owner shuts it down).
                for kind in (f"pipe:{self.name}:{self.rank}",
                             f"gc:{self.name}:{self.rank}",
                             f"catalog:{self.name}:{self.rank}",
                             f"compact:{self.name}:{self.rank}"):
                    self.backend.wait(kind, timeout=60)
        try:
            # delta versions waiting in an open rolling pack are L1/L2-only;
            # seal them now so a later fresh process can restore them at L3
            self.cluster.flush_open_packs(self.name)
        except Exception as e:  # noqa: BLE001 — the batch stays retained in
            # cluster._seal_retry; versions remain L1/L2-protected
            _log.warning("final pack flush of %r failed: %s", self.name, e)
        try:
            # final catalog flush: a clean shutdown leaves the durable
            # catalog exactly describing what is restorable where, so the
            # next process plans its restart without any key scan
            self.cluster.sync_catalog(self.name)
        except Exception as e:  # noqa: BLE001 — state stays dirty; the
            # next process falls back to scan discovery with a diagnostic
            _log.warning("final catalog sync of %r failed: %s", self.name, e)


def make_client(cfg: Optional[Union[PipelineSpec, VelocConfig]] = None,
                **kw) -> VelocClient:
    cfg = cfg or VelocConfig(**kw)
    return VelocClient(cfg)
