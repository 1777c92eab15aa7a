"""The VELOC module pipeline (paper §2, "Flexibility through Modular Design"
+ Figure 1).

Every I/O / resilience strategy is an independent ``Module`` with a
priority; a checkpoint request walks the pipeline in priority order and each
module acts or passes based on its own state and the outcome of earlier
modules (recorded in ``ctx.results``).  Modules toggle at runtime via
``enabled`` — the paper's "simple switch" — and custom modules (compression,
integrity, format conversion) slot in by priority.

Built-ins register in the default ``ModuleRegistry`` (repro_torch.core.pipeline)
under short names — "interval", "serialize", "local", "partner", "xor",
"flush", "verify" — so a ``PipelineSpec`` can name them declaratively.
The delta module is not ported yet (``PipelineSpec.compile`` refuses it).
Modules that complete a resilience level carry a ``level`` tag ("L1"/"L2"/
"L3") used by ``CheckpointFuture`` per-level completion events.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.core import erasure, format as fmt
from repro_torch.core.pipeline import register_module
from repro_torch.core.storage import pick_tier
from repro_torch.kernels import ops as kops


@dataclass
class CheckpointContext:
    name: str
    version: int
    rank: int
    nranks: int
    regions: list[fmt.Region]
    meta: dict
    cluster: Any  # repro_torch.core.api.Cluster
    defensive: bool = True  # False for productive/explicit checkpoints
    shard: Optional[bytes] = None
    digest: Optional[str] = None
    results: dict = field(default_factory=dict)
    skipped: bool = False
    t_begin: float = field(default_factory=time.monotonic)
    engine: Any = None  # set by Engine.submit; lets modules query pipeline
    # state of OTHER versions of this stream (e.g. delta orphan check)


class Module:
    name = "module"
    priority = 50
    enabled = True
    level: Optional[str] = None  # resilience level this module completes

    def process(self, ctx: CheckpointContext) -> str:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} prio={self.priority} " \
               f"{'on' if self.enabled else 'off'}>"


@register_module("interval")
class IntervalModule(Module):
    """Skips defensive checkpoints arriving before the optimal interval
    (interval supplied by repro_torch.core.interval — Young/Daly or the ML
    predictor).  Productive/explicit checkpoints always pass."""

    name = "interval"
    priority = 0

    def __init__(self, interval_s: Optional[float] = None, clock=time.monotonic):
        self.interval_s = interval_s
        self._clock = clock
        self._last: Optional[float] = None

    def process(self, ctx):
        if not ctx.defensive or self.interval_s is None:
            return "pass"
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            ctx.skipped = True
            ctx.results["skip_reason"] = "interval"
            return "skip"
        self._last = now
        return "ok"


@register_module("serialize")
class SerializeModule(Module):
    """Regions -> shard bytes (repro_torch.core.format), with the encoding chosen
    by the compression switch ("raw" | "q8" | "zlib")."""

    name = "serialize"
    priority = 10

    def __init__(self, encoding: str = "raw", checksums: bool = True):
        self.encoding = encoding
        self.checksums = checksums

    def process(self, ctx):
        if callable(ctx.regions):
            # async mode: D2H deferred into the backend — the app was only
            # blocked for the on-device snapshot.
            ctx.regions = ctx.regions()
        ctx.shard = fmt.serialize_shard(ctx.regions, ctx.meta,
                                        encoding=self.encoding,
                                        checksums=self.checksums)
        ctx.digest = kops.digest(ctx.shard)
        ctx.results["shard_bytes"] = len(ctx.shard)
        return "ok"


@register_module("local")
class LocalWriteModule(Module):
    """L1: persist the shard to the best node-local tier (pick_tier encodes
    the heterogeneous-storage scheduling)."""

    name = "l1-local"
    priority = 20
    level = "L1"

    def process(self, ctx):
        tiers = ctx.cluster.node_tiers(ctx.rank)
        tier = pick_tier(tiers)
        try:
            tier.put(fmt.shard_key(ctx.name, ctx.version, ctx.rank), ctx.shard)
        except Exception as e:  # noqa: BLE001 — a dead local tier must not
            # take the pipeline down; L2/L3 still run and restart falls back.
            ctx.results["l1_error"] = f"{type(e).__name__}: {e}"
            return "error"
        ctx.results["l1_tier"] = tier.info.name
        ctx.cluster.note_shard(ctx.name, ctx.version, "L1", ctx.rank, ctx.digest,
                               meta=ctx.meta)
        return "ok"


@register_module("partner")
class PartnerModule(Module):
    """L2a: partner replication — push my shard into my partner's node-local
    storage so a lost node's state survives on its neighbour."""

    name = "l2-partner"
    priority = 30
    level = "L2"

    def __init__(self, distance: int = 1):
        self.distance = distance

    def process(self, ctx):
        if ctx.nranks < 2:
            return "pass"
        partner = erasure.partner_of(ctx.rank, ctx.nranks, self.distance)
        try:
            tier = pick_tier(ctx.cluster.node_tiers(partner))
            tier.put(fmt.shard_key(ctx.name, ctx.version, ctx.rank) + ".partner",
                     ctx.shard)
        except Exception as e:  # noqa: BLE001
            ctx.results["l2_partner_error"] = f"{type(e).__name__}: {e}"
            return "error"
        ctx.cluster.note_shard(ctx.name, ctx.version, "L2", ctx.rank, ctx.digest,
                               meta=ctx.meta)
        return "ok"


def build_parity_payload(shards: list[bytes], members: list[int],
                         rs_parity: int = 0) -> bytes:
    """Erasure-group parity payload over the member shards (XOR by default,
    Reed-Solomon when ``rs_parity`` > 0).  Shared by the pipeline's
    XorGroupModule and the post-compaction parity refresh — both must
    produce the identical framing restart's reconstruct path expects."""
    lengths = [len(s) for s in shards]
    if rs_parity > 0:
        parities = erasure.rs_encode(shards, rs_parity)
        return fmt.serialize_shard(
            [fmt.Region(f"parity{j}", np.frombuffer(p, np.uint8))
             for j, p in enumerate(parities)],
            {"members": members, "lengths": lengths, "rs": rs_parity})
    parity = erasure.xor_encode(shards)
    return fmt.serialize_shard(
        [fmt.Region("parity0", np.frombuffer(parity, np.uint8))],
        {"members": members, "lengths": lengths, "rs": 0})


@register_module("xor")
class XorGroupModule(Module):
    """L2b: XOR (or RS) erasure encoding across a group of ranks.  The group
    leader pulls the group's shards (network stand-in: the cluster registry)
    and stores parity in its node-local tier.  rs_parity>0 switches to
    Reed-Solomon with that many parity shards (tolerates >1 failure)."""

    name = "l2-xor"
    priority = 32
    level = "L2"

    def __init__(self, group_size: int = 4, rs_parity: int = 0):
        self.group_size = group_size
        self.rs_parity = rs_parity

    def process(self, ctx):
        g = min(self.group_size, ctx.nranks)
        if g < 2:
            return "pass"
        gid, _gidx = erasure.group_of(ctx.rank, g)
        members = [gid * g + i for i in range(g) if gid * g + i < ctx.nranks]
        # event-driven encode: whichever group member reaches this module
        # LAST (all member shards visible) performs the encode — order-free
        # and idempotent under async racing.
        shards = []
        for r in members:
            blob = ctx.cluster.fetch_shard(ctx.name, ctx.version, r)
            if blob is None:
                ctx.results["xor_status"] = f"group incomplete (rank {r})"
                return "pass"
            shards.append(blob)
        payload = build_parity_payload(shards, members, self.rs_parity)
        # cross-group placement: a node never stores the parity that protects
        # its own shard (erasure.parity_home); single group -> external tier,
        # where it joins the version's aggregated segment when one is open.
        home = erasure.parity_home(gid, g, ctx.nranks)
        pkey = fmt.parity_key(ctx.name, ctx.version, gid)
        try:
            if home < 0:
                if ctx.cluster.aggregate_target() is not None and \
                        ctx.cluster.stage_entry(ctx.name, ctx.version, pkey,
                                                payload):
                    ctx.results["l2_group"] = gid
                    ctx.results["l2_parity_staged"] = True
                    return "ok"
                tier = pick_tier(ctx.cluster.external_tiers,
                                 need_persistent=True)
            else:
                tier = pick_tier(ctx.cluster.node_tiers(home))
            tier.put(pkey, payload)
        except Exception as e:  # noqa: BLE001
            ctx.results["l2_xor_error"] = f"{type(e).__name__}: {e}"
            return "error"
        ctx.results["l2_group"] = gid
        return "ok"


@register_module("flush")
class FlushModule(Module):
    """L3: chunked, rate-limited flush to an external persistent tier
    (parallel file system / DAOS stand-in).  Chunking bounds the
    interference window; the backend's phase gate sits between chunks.

    When the cluster has an aggregating external tier, the shard is staged
    into the version's WriteBatch instead of being put directly: the last
    rank to stage seals every rank's shard + parity + manifests into ONE
    sequential segment write, hiding the per-small-blob put overhead that
    dominates once delta shards shrink.  Note the staged-but-not-yet-sealed
    ranks report L3 "ok" at stage time — durability arrives with the seal,
    whose failure surfaces on the sealing rank; the version's L3 data then
    never becomes externally visible and restart falls back (an L1/L2
    manifest that published before staging began may still advertise the
    version as a node-local-level candidate)."""

    name = "l3-flush"
    priority = 40
    level = "L3"

    def __init__(self, chunk_bytes: int = 4 << 20, seal_retries: int = 0,
                 seal_backoff_base: float = 0.25,
                 seal_backoff_cap: float = 15.0):
        self.chunk_bytes = chunk_bytes
        #: failed segment/pack seals schedule up to this many maintenance-
        #: lane re-seals from the retained batch (needs an active backend)
        self.seal_retries = seal_retries
        #: re-seal N waits base * 2**N seconds (capped) — see
        #: Cluster.schedule_seal_retry
        self.seal_backoff_base = seal_backoff_base
        self.seal_backoff_cap = seal_backoff_cap

    def _schedule_retries(self, ctx, *, failed: bool):
        """Queue maintenance-lane re-seals for every retained failed-seal
        batch of this stream (no-op without a backend or retry budget)."""
        if self.seal_retries <= 0 or ctx.engine is None:
            return
        backend = getattr(ctx.engine, "backend", None)
        if backend is None:
            return
        scheduled = ctx.cluster.schedule_seal_retry(
            backend, ctx.name, self.seal_retries,
            backoff_base=self.seal_backoff_base,
            backoff_cap=self.seal_backoff_cap)
        if failed or scheduled:
            ctx.results["l3_seal_retry_scheduled"] = scheduled

    def _paced_budget(self, ctx, nbytes: int):
        """Charge ``nbytes`` to the flush rate budget in chunk-sized
        acquires with phase-gate sleeps between them — bounding the
        interference window whether the bytes then go out as a direct put
        or as part of a sealed segment.  With a lane budget configured for
        this stream (multi-tenant backends), bytes are charged against the
        stream's private bucket first and the cluster-global bucket second
        — each tenant is bounded by its carve-out AND the shared total."""
        limiters = []
        backend = getattr(ctx.engine, "backend", None) if ctx.engine else None
        if backend is not None:
            lane = backend.lane_limiter(ctx.name)
            if lane is not None:
                limiters.append(lane)
        limiters.append(ctx.cluster.rate_limiter)
        gate = ctx.cluster.phase_gate
        if nbytes <= self.chunk_bytes:
            for lim in limiters:
                lim.acquire(nbytes)
            return
        for off in range(0, nbytes, self.chunk_bytes):
            for lim in limiters:
                lim.acquire(min(self.chunk_bytes, nbytes - off))
            if gate is not None:
                w = gate()
                if w > 0:
                    time.sleep(min(w, 0.5))

    def process(self, ctx):
        target = ctx.cluster.aggregate_target()
        if target is not None:
            self._paced_budget(ctx, len(ctx.shard))
            try:
                sealed = ctx.cluster.stage_l3(
                    ctx.name, ctx.version, ctx.rank, ctx.shard, ctx.digest,
                    meta=ctx.meta)
            except Exception as e:  # noqa: BLE001 — THIS version's seal put
                # failed; the batch is retained, so a bounded maintenance-
                # lane re-seal can still upgrade the version to full L3
                # protection once the tier recovers
                ctx.results["l3_error"] = f"{type(e).__name__}: {e}"
                self._schedule_retries(ctx, failed=True)
                return "error"
            ctx.results["l3_tier"] = target.info.name
            ctx.results["l3_aggregated"] = True
            ctx.results["l3_sealed"] = sealed
            # a chain-boundary pack of EARLIER versions may have failed to
            # seal without touching this version (stage_l3 retains it
            # silently): sweep the stream's retained batches either way
            self._schedule_retries(ctx, failed=False)
            return "ok"
        tier = pick_tier(ctx.cluster.external_tiers,
                         need_persistent=True, need_survives_node=True)
        key = fmt.shard_key(ctx.name, ctx.version, ctx.rank)
        try:
            # chunked put: vendor stores with multipart upload would
            # stream; our tier API is whole-object, so chunks accumulate
            # then publish (still rate-limited per chunk so interference
            # stays bounded).
            self._paced_budget(ctx, len(ctx.shard))
            tier.put(key, ctx.shard)
        except Exception as e:  # noqa: BLE001
            ctx.results["l3_error"] = f"{type(e).__name__}: {e}"
            return "error"
        ctx.results["l3_tier"] = tier.info.name
        ctx.cluster.note_shard(ctx.name, ctx.version, "L3", ctx.rank, ctx.digest,
                               meta=ctx.meta)
        return "ok"


@register_module("verify")
class VerifyModule(Module):
    """Post-write integrity check (reads back from the L1 tier)."""

    name = "verify"
    priority = 45

    def process(self, ctx):
        blob = ctx.cluster.fetch_shard(ctx.name, ctx.version, ctx.rank)
        ok = blob is not None and kops.digest(blob) == ctx.digest
        ctx.results["verified"] = bool(ok)
        return "ok" if ok else "error"
