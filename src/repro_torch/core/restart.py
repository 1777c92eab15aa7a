"""Restart: level probing, integrity verification, shard reconstruction and
elastic re-partitioning.

Priority: newest version first; within a version, L1 local > L2 partner >
L2 parity-reconstruct > L3 external — the cheapest source that passes
checksums wins, mirroring VELOC's restart_test/restart_begin semantics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import erasure
from repro_torch.core import format as fmt

_LEVEL_ORDER = {"L1": 0, "L2": 1, "L3": 2}


def _best_level_candidates(manifests: list[dict]) -> list[dict]:
    byver: dict[int, dict] = {}
    for m in manifests:
        v = m["version"]
        cur = byver.get(v)
        if cur is None or _LEVEL_ORDER.get(m["level"], 9) < \
                _LEVEL_ORDER.get(cur["level"], 9):
            byver[v] = m
    return [byver[v] for v in sorted(byver, reverse=True)]


def find_restart(cluster, name: str) -> list[dict]:
    """Candidate (version, best-level) descending by version.  Discovery is
    catalog-first when the cluster has a durable stream catalog (see
    ``Cluster.manifests``): the version set and pack locations come from
    one catalog blob per tier, costing zero ``keys()`` listings; a missing
    or torn catalog degrades to the key-scan with a diagnostic."""
    return _best_level_candidates(cluster.manifests(name))


class RestorePlan:
    """Everything one restore needs, resolved ONCE up front: candidate
    versions, per-version manifests (shard digests, parent links, erasure
    group), delta chains, and rolling-pack locations — all from a single
    ``cluster.manifests`` pass (catalog-first when the cluster carries a
    durable stream catalog, costing zero key listings).

    The serial restore's hidden cost was re-resolving manifests *twice
    per chain hop* (once for the digest, once inside the parity
    fallback); a plan is built once per restore request and shared across
    every hop — and, for multi-rank or concurrent restores, across
    readers."""

    def __init__(self, name: str, mode: str, candidates: list[dict],
                 manifests: dict[int, dict],
                 parents: dict[int, Optional[int]],
                 packs: dict[int, str], known: set):
        self.name = name
        self.mode = mode              # "catalog" | "scan"
        self.candidates = candidates  # newest-first (version, best level)
        self.manifests = manifests    # version -> best manifest
        self.parents = parents        # version -> parent (None = full)
        self.packs = packs            # version -> rolling-pack key
        self.known = known            # versions with ANY metadata
        self._chains: dict[int, Optional[list[int]]] = {}
        #: per-source demotion state for the multi-source read scheduler:
        #: id(tier) -> multiplicative penalty on ``read_cost`` (miss/error
        #: doubles it, a hit halves it back toward 1) — plan-scoped so one
        #: degraded restore never poisons an unrelated plan, and keyed by
        #: object identity because tier *names* repeat across nodes.
        #: Single-key dict updates are GIL-atomic; shared readers may race
        #: benignly (it only steers a heuristic ranking).
        self.source_penalty: dict[int, float] = {}

    #: penalty clamp: doubling caps out at 64x so a recovered source
    #: re-promotes within ~6 hits instead of never
    _PENALTY_CAP = 64.0

    def penalty(self, tier) -> float:
        return self.source_penalty.get(id(tier), 1.0)

    def note_source(self, tier, ok: bool) -> None:
        """Telemetry feedback from one source probe: a hit halves the
        tier's penalty (toward 1), a miss/error doubles it (capped), so
        ``fetch_shard_any_level``'s ranking demotes sources that keep
        coming up empty and re-promotes them as they recover."""
        p = self.source_penalty.get(id(tier), 1.0)
        self.source_penalty[id(tier)] = \
            max(1.0, p / 2.0) if ok else min(self._PENALTY_CAP, p * 2.0)

    def manifest(self, version: int) -> Optional[dict]:
        return self.manifests.get(int(version))

    def digest(self, version: int, rank: int) -> Optional[str]:
        m = self.manifests.get(int(version))
        return (m or {}).get("shard_digests", {}).get(rank)

    def chain(self, version: int) -> Optional[list[int]]:
        """``[version, parent, ..., full base]`` purely from metadata;
        None when the parent links are cyclic, overlong or dangling (the
        loader then falls back to the per-hop blob walk)."""
        v0 = int(version)
        if v0 in self._chains:
            return self._chains[v0]
        chain: list[int] = []
        v: Optional[int] = v0
        ok = True
        while v is not None:
            if v in chain or len(chain) >= MAX_CHAIN_DEPTH \
                    or v not in self.known:
                ok = False
                break
            chain.append(int(v))
            v = self.parents.get(v)
        out = chain if ok else None
        self._chains[v0] = out
        return out


def plan_restore(cluster, name: str) -> RestorePlan:
    """Build the one-shot ``RestorePlan`` (see class docstring).  Cheap
    enough to build per restore request: one ``cluster.manifests`` call
    (catalog-first) plus pure-metadata walks."""
    loader = getattr(cluster, "load_catalog", None)
    cat = loader(name) if loader is not None else None
    mlist = cluster.manifests(name)
    cands = _best_level_candidates(mlist)
    manifests: dict[int, dict] = {}
    parents: dict[int, Optional[int]] = {}
    for m in mlist:
        manifests.setdefault(m["version"], m)
        if parents.get(m["version"]) is None:
            parents[m["version"]] = m.get("parent")
    packs: dict[int, str] = {}
    if cat is not None:
        for v, rec in cat["versions"].items():
            parents.setdefault(v, rec.get("parent"))
            if rec.get("pack"):
                packs[v] = rec["pack"]
    known = {m["version"] for m in mlist} | set(parents)
    return RestorePlan(name, "catalog" if cat is not None else "scan",
                       cands, manifests, parents, packs, known)


def plan_restart(cluster, name: str) -> dict:
    """Catalog-first restart planner: everything a restore needs to know
    BEFORE fetching a single shard byte.

    Returns ``{"mode", "candidates", "chains", "packs"}``:

      mode        "catalog" when a durable stream catalog drove discovery
                  (O(1) key listings per (tier, stream) — in fact zero),
                  "scan" when discovery fell back to key listings.
      candidates  ``find_restart``'s (version, best-level) manifest list.
      chains      version -> its delta chain ``[v, parent, ..., full
                  base]``, resolved from manifest parent links without
                  touching any shard; a cyclic / overlong / dangling chain
                  maps to None (that candidate will need per-level
                  fallback at load time).
      packs       version -> rolling-pack key, for versions whose L3
                  entries live in a shared pack (loading the plan seeds
                  the cluster's pack-membership index, so subsequent
                  fetches skip the per-(tier, stream) key scan).

    Thin dict view over ``plan_restore`` (the loader-facing object)."""
    plan = plan_restore(cluster, name)
    return {"mode": plan.mode, "candidates": plan.candidates,
            "chains": {c["version"]: plan.chain(c["version"])
                       for c in plan.candidates},
            "packs": plan.packs}


def _manifest_for(cluster, name, version) -> Optional[dict]:
    for m in cluster.manifests(name):
        if m["version"] == version:
            return m
    return None


def _segment_hint(cluster, name: str, version: int) -> str:
    """Per-candidate diagnostic suffix when the version's aggregated
    segment — or a rolling pack of its stream, whose membership is
    unreadable exactly when the pack is torn — was found corrupt: the
    operator should see WHY a version is being skipped, not just that it
    was."""
    marker = f"/v{version:08d}/"
    diags = [d for d in getattr(cluster, "segment_diagnostics", [])
             if marker in d.get("key", "")
             or d.get("key", "").startswith(fmt.pack_prefix(name))]
    if not diags:
        return ""
    return " (segment diagnostics: " + "; ".join(
        f"{d['tier']}:{d['key']}: {d['error']}" for d in diags) + ")"


#: sentinel: "resolve the manifest yourself" (an explicit ``manifest=None``
#: means the caller already knows the version has none)
_UNRESOLVED = object()


def _source_cost(plan: Optional[RestorePlan], src: dict) -> float:
    """Live ranking key for one restore source: the tier's telemetry-based
    ``read_cost`` scaled by the plan's demotion penalty.  Duck-typed tiers
    without telemetry rank at a neutral 1.0 (penalty still applies)."""
    tier = src["tier"]
    cost_fn = getattr(tier, "read_cost", None)
    try:
        cost = float(cost_fn()) if callable(cost_fn) else 1.0
    except Exception:  # noqa: BLE001 — a broken cost probe must not
        cost = 1.0     # abort the restore; rank the source neutrally
    if plan is not None:
        cost *= plan.penalty(tier)
    return cost


#: Plan penalty at which a source stops being hedge material: reached
#: after three consecutive missed walks (1 -> 2 -> 4 -> 8), cleared by
#: one served walk (8 -> 4).  Deliberately based on the plan's per-WALK
#: outcome rather than the tier's raw ``miss_streak``: a multi-key probe
#: (the direct-key miss right before a segment hit) or several readers
#: interleaving can spike the per-get streak on a perfectly healthy
#: tier, and a stalled primary must never be left without a hedge
#: candidate by such a transient.
_HEDGE_TAINT_PENALTY = 8.0


def _tainted(plan: Optional[RestorePlan], tier) -> bool:
    return plan is not None and plan.penalty(tier) >= _HEDGE_TAINT_PENALTY


#: Hedge fan-out bound per hop: a stalled primary may escalate through
#: at most this many candidate legs.  Escalation exists because a
#: not-yet-written-off source can still turn out empty (a fast-serving
#: tier that answers its walks before cheaper sources are ever probed
#: keeps a stale low penalty) — the first leg burns in microseconds on
#: the miss and the next candidate takes over, instead of the caller
#: riding out the primary's full stall.
_HEDGE_MAX_LEGS = 3


def _fetch_ranked(cluster, sources: list[dict], ok,
                  plan: Optional[RestorePlan]) -> Optional[bytes]:
    """Walk every source cheapest-first by live ``read_cost`` x plan
    penalty.  When the cluster's ``restore_hedge_factor`` is on and a
    source's fetch overruns ``factor x its EWMA get latency``, the
    next-ranked sources are launched as escalating hedge legs and the
    first success wins (losses/wins are attributed to the *hedge* tiers'
    counters so exactly-once accounting on the primary stays
    untouched)."""
    sources = sorted(sources, key=lambda s: _source_cost(plan, s))
    factor = float(getattr(cluster, "restore_hedge_factor", 0.0) or 0.0)
    pool = None
    if factor > 0:
        getter = getattr(cluster, "reader_pool", None)
        pool = getter() if callable(getter) else None
    probed_empty: set[int] = set()  # tier ids a completed hedge leg missed
    i = 0
    while i < len(sources):
        src = sources[i]
        i += 1
        if id(src["tier"]) in probed_empty:
            continue
        ewma = getattr(src["tier"], "ewma_get_s", None)
        # Hedging covers a SLOW primary, not an EMPTY one: a source the
        # plan has repeatedly demoted resolves its miss fast by itself,
        # and arming a hedge on its microscopic EWMA budget would just
        # fire into the next source without budget protection of its
        # own.  Probe it plainly and let the ranked walk move on.
        missing = _tainted(plan, src["tier"])
        # Hedge legs must be worth firing: the next-ranked sources the
        # plan has NOT written off, cheapest first.  Hedging into a
        # known-empty tier wastes a leg — it answers "miss" in
        # microseconds while the stalled primary keeps the caller
        # pinned — but a source with a stale low penalty can still turn
        # out empty, so the pool escalates through up to
        # ``_HEDGE_MAX_LEGS`` candidates as legs resolve useless.
        cands = []
        for cand in sources[i:]:
            if id(cand["tier"]) in probed_empty:
                continue
            if not _tainted(plan, cand["tier"]):
                cands.append(cand)
                if len(cands) >= _HEDGE_MAX_LEGS:
                    break
        if plan is not None and len(cands) > 1:
            # For a hedge leg, certainty beats raw cost: a proven-serving
            # source (penalty 1.0) recovers the stall in one fetch, while
            # a cheap-but-unproven one risks burning the leg on a miss.
            # Stable sort keeps cheapest-first within a penalty class.
            cands.sort(key=lambda c: plan.penalty(c["tier"]))
        if pool is not None and cands and ewma and not missing:
            try:
                value, winner, outcomes = pool.hedged(
                    lambda s=src: ok(s["fetch"]()),
                    [lambda n=c: ok(n["fetch"]()) for c in cands],
                    factor * ewma)
            except Exception:  # noqa: BLE001 — a raising source set
                value, winner, outcomes = None, "primary", []  # reads as miss
            for k, st in enumerate(outcomes):
                ctier = cands[k]["tier"]
                if st == "win":
                    ctier.hedge_wins = getattr(ctier, "hedge_wins", 0) + 1
                    if plan is not None:
                        plan.note_source(ctier, True)
                elif st in ("miss", "err"):
                    # a completed hedge leg proved its tier empty too:
                    # demote it and never walk to it again this fetch
                    ctier.hedge_losses = getattr(ctier, "hedge_losses", 0) + 1
                    if plan is not None:
                        plan.note_source(ctier, False)
                    probed_empty.add(id(ctier))
                elif value is not None:
                    # abandoned in-flight leg: the primary won while it
                    # was still fetching — count the wasted get
                    ctier.hedge_losses = getattr(ctier, "hedge_losses", 0) + 1
                # pending leg on a missed primary: leave it re-probable —
                # the walk retries it as a budget-protected primary and
                # the single-flight cache dedups the in-flight get
            if plan is not None and winner == "primary":
                plan.note_source(src["tier"], value is not None)
            if value is not None:
                return value
            continue
        try:
            blob = ok(src["fetch"]())
        except Exception:  # noqa: BLE001 — a raising source reads as a
            blob = None    # miss; the plan penalty demotes it for later hops
        if plan is not None:
            plan.note_source(src["tier"], blob is not None)
        if blob is not None:
            return blob
    return None


def fetch_shard_any_level(cluster, name: str, version: int, rank: int,
                          *, distance: int = 1,
                          expected_digest: Optional[str] = None,
                          manifest=_UNRESOLVED,
                          plan: Optional[RestorePlan] = None
                          ) -> Optional[bytes]:
    """Shard bytes from the cheapest healthy source.  Planned restores
    pass ``manifest`` (possibly None) so the parity fallback never
    re-resolves the stream's manifest list per hop, and ``plan`` so probe
    outcomes feed the adaptive source ranking across hops."""
    from repro_torch.kernels import ops as kops

    def ok(blob):
        if blob is None:
            return None
        if expected_digest and kops.digest(blob) != expected_digest:
            return None
        return blob

    sources_fn = getattr(cluster, "shard_sources", None)
    if callable(sources_fn):
        # adaptive multi-source walk: own node, partner node, peer seal
        # copies and every external tier, ranked by live read_cost
        blob = _fetch_ranked(
            cluster, sources_fn(name, version, rank, distance=distance),
            ok, plan)
        if blob:
            return blob
    else:
        # duck-typed cluster without the multi-source API: legacy order
        # L1 / L3 (fetch_shard walks node tiers then external)
        blob = ok(cluster.fetch_shard(name, version, rank))
        if blob:
            return blob
        # L2a partner copy
        blob = ok(cluster.fetch_partner_copy(name, version, rank, distance))
        if blob:
            return blob
    # L2b parity reconstruct
    m = _manifest_for(cluster, name, version) if manifest is _UNRESOLVED \
        else manifest
    g = (m or {}).get("group_size", 0) or getattr(cluster, "group_size", 0)
    g = min(g, cluster.nranks)
    if g >= 2:
        gid, gidx = erasure.group_of(rank, g)
        payload = cluster.fetch_parity(name, version, gid)
        if payload is not None:
            reader = fmt.ShardReader(payload)
            members = reader.meta["members"]
            lengths = reader.meta["lengths"]
            rs = reader.meta.get("rs", 0)
            survivors = {}
            missing = []
            for j, r in enumerate(members):
                b = cluster.fetch_shard(name, version, r)
                if b is None and r != rank:
                    b = cluster.fetch_partner_copy(name, version, r, distance)
                if b is None:
                    missing.append(j)
                else:
                    survivors[j] = b
            my_j = members.index(rank)
            if my_j not in missing:
                return survivors[my_j]
            if rs > 0:
                parities = {j: reader.read(f"parity{j}") .tobytes()
                            for j in range(rs)}
                rec = erasure.rs_reconstruct(survivors, parities, len(members),
                                             missing, max(lengths))
                return rec[my_j][: lengths[my_j]]
            if len(missing) == 1:
                parity = reader.read("parity0").tobytes()
                return erasure.xor_reconstruct(survivors, parity, len(members),
                                               my_j, lengths[my_j])
    return None


#: Hard ceiling on delta-chain walks: defends against cyclic or corrupted
#: parent links; real chains are bounded by DeltaModule's ``max_chain``.
MAX_CHAIN_DEPTH = 64


def _prefetch_chain(cluster, chain: list[int], rank: int, distance: int,
                    plan: RestorePlan) -> Optional[dict]:
    """Overlapped fetch of every chain hop through the cluster's bounded
    reader pool.  Returns ``{version: (blob, error)}`` or None when no
    pool is available (callers then fetch lazily hop-by-hop, stopping at
    the rank's actual full base).  Errors on *speculative* deep hops are
    harmless — the loader re-raises only for hops it truly needs."""
    getter = getattr(cluster, "reader_pool", None)
    pool = getter() if callable(getter) else None
    if pool is None or len(chain) <= 1:
        return None

    def mk(v):
        def fetch():
            return fetch_shard_any_level(
                cluster, plan.name, v, rank, distance=distance,
                expected_digest=plan.digest(v, rank),
                manifest=plan.manifest(v), plan=plan)
        return fetch

    return dict(zip(chain, pool.run_all([mk(v) for v in chain])))


def _load_rank_walk(cluster, name: str, version: int, rank: int,
                    *, distance: int, _depth: int,
                    plan: Optional[RestorePlan]) -> dict[str, np.ndarray]:
    """The hop-by-hop recursive chain walk: the fallback when metadata
    could not resolve the chain up front (dangling/cyclic parent links, a
    version noted after the plan was built) — each hop's blob supplies
    the next parent pointer."""
    if plan is not None and int(version) in plan.known:
        m = plan.manifest(version)
    else:
        m = _manifest_for(cluster, name, version)
    digest = (m or {}).get("shard_digests", {}).get(rank)
    blob = fetch_shard_any_level(cluster, name, version, rank,
                                 distance=distance, expected_digest=digest,
                                 manifest=m, plan=plan)
    if blob is None:
        raise IOError(f"rank {rank} shard unrecoverable for v{version}"
                      + _segment_hint(cluster, name, version))
    reader = fmt.ShardReader(blob)
    delta_names = set(reader.delta_regions())
    if not delta_names:
        return {n: reader.read(n) for n in reader.region_names}
    if _depth >= MAX_CHAIN_DEPTH:
        raise IOError(f"delta chain exceeds {MAX_CHAIN_DEPTH} links at "
                      f"v{version} (cyclic or corrupt parent metadata)")
    parent = (reader.meta.get("delta") or {}).get("parent")
    if parent is None:
        parent = (m or {}).get("parent")
    if parent is None:
        raise IOError(f"delta shard v{version} has no parent link")
    base = _load_rank_walk(cluster, name, int(parent), rank,
                           distance=distance, _depth=_depth + 1, plan=plan)
    out = {}
    for n in reader.region_names:
        if n in delta_names:
            if n not in base:
                raise IOError(f"delta region {n!r} of v{version} missing "
                              f"from parent v{parent}")
            out[n] = reader.read(n, base=base[n])
        else:
            out[n] = reader.read(n)
    return out


def load_rank_regions(cluster, name: str, version: int, rank: int,
                      *, distance: int = 1,
                      plan: Optional[RestorePlan] = None
                      ) -> dict[str, np.ndarray]:
    """{region_name: array} for one rank, verifying checksums.

    Differential shards are reconstructed by walking ``parent`` links down
    to a full base (each hop fetched from the cheapest healthy level, like
    any other shard), then overlaying each delta's dirty chunks on the way
    back up — per-chunk digests and the full-array digest are verified at
    every overlay, so a corrupt or missing link anywhere in the chain
    raises and the caller falls back to an older version.

    The chain is resolved up front from ``plan`` (built here when not
    passed) — zero per-hop manifest re-resolution — and, when the cluster
    has a reader pool, all hops are fetched CONCURRENTLY while the
    overlay still applies bottom-up.  Metadata the plan could not resolve
    degrades to the per-hop blob walk, never to an error."""
    if plan is None:
        plan = plan_restore(cluster, name)
    chain = plan.chain(version)
    if chain is None:
        return _load_rank_walk(cluster, name, version, rank,
                               distance=distance, _depth=0, plan=plan)
    fetched = _prefetch_chain(cluster, chain, rank, distance, plan)
    hops: list[tuple[int, fmt.ShardReader]] = []  # target-first
    base_found = False
    for v in chain:
        if fetched is not None:
            blob, err = fetched[v]
            if err is not None:
                raise err
        else:
            blob = fetch_shard_any_level(
                cluster, name, v, rank, distance=distance,
                expected_digest=plan.digest(v, rank),
                manifest=plan.manifest(v), plan=plan)
        if blob is None:
            raise IOError(f"rank {rank} shard unrecoverable for v{v}"
                          + _segment_hint(cluster, name, v))
        reader = fmt.ShardReader(blob)
        hops.append((v, reader))
        if not reader.delta_regions():
            base_found = True
            break
    if base_found:
        prev_v, base_reader = hops.pop()
        out = {n: base_reader.read(n) for n in base_reader.region_names}
    else:
        # metadata called the deepest hop the full base but this RANK's
        # blob is still a delta (ranks go full independently; links can
        # be stale) — extend through the blob's own parent pointer.
        deep_v, deep_reader = hops[-1]
        prev_v = (deep_reader.meta.get("delta") or {}).get("parent")
        if prev_v is None:
            prev_v = (plan.manifest(deep_v) or {}).get("parent")
        if prev_v is None:
            raise IOError(f"delta shard v{deep_v} has no parent link")
        out = _load_rank_walk(cluster, name, int(prev_v), rank,
                              distance=distance, _depth=len(hops),
                              plan=plan)
    for v, reader in reversed(hops):
        delta_names = set(reader.delta_regions())
        nxt = {}
        for n in reader.region_names:
            if n in delta_names:
                if n not in out:
                    raise IOError(f"delta region {n!r} of v{v} missing "
                                  f"from parent v{prev_v}")
                nxt[n] = reader.read(n, base=out[n])
            else:
                nxt[n] = reader.read(n)
        out = nxt
        prev_v = v
    return out


def chain_versions(cluster, name: str, version: int, rank: int = 0,
                   *, distance: int = 1,
                   plan: Optional[RestorePlan] = None) -> list[int]:
    """The delta chain of ``version``, newest first, ending at its full
    base — [version] when the shard is already full.

    Resolved from manifest/catalog parent links — zero shard-blob
    downloads on the metadata path; a hop with no metadata at all falls
    back to reading that blob's own parent pointer (the pre-planner
    behaviour, hop by hop)."""
    if plan is None:
        plan = plan_restore(cluster, name)
    out: list[int] = []
    seen: set = set()
    v: Optional[int] = version
    while v is not None:
        if int(v) in seen or len(out) >= MAX_CHAIN_DEPTH:
            raise IOError(f"delta chain exceeds {MAX_CHAIN_DEPTH} links or "
                          f"cycles at v{v} (corrupt parent metadata)")
        v = int(v)
        seen.add(v)
        out.append(v)
        if v in plan.known:
            v = plan.parents.get(v)
            continue
        # no metadata for this hop: the blob itself carries the pointer
        blob = fetch_shard_any_level(cluster, name, v, rank,
                                     distance=distance, manifest=None,
                                     plan=plan)
        if blob is None:
            raise IOError(f"chain walk: v{v} unrecoverable")
        reader = fmt.ShardReader(blob)
        if not reader.delta_regions():
            break
        v = (reader.meta.get("delta") or {}).get("parent")
    return out


def load_all_regions(cluster, name: str, version: int, *, distance: int = 1
                     ) -> dict[int, dict[str, np.ndarray]]:
    """Every rank's regions, sharing ONE plan — and, when the cluster has
    a reader pool, loading ranks concurrently (hop fetches within each
    rank then run inline: the pool's workers are the bound)."""
    plan = plan_restore(cluster, name)
    ranks = list(range(cluster.nranks))
    getter = getattr(cluster, "reader_pool", None)
    pool = getter() if callable(getter) else None
    if pool is None or len(ranks) <= 1:
        return {r: load_rank_regions(cluster, name, version, r,
                                     distance=distance, plan=plan)
                for r in ranks}

    def mk(r):
        def load():
            return load_rank_regions(cluster, name, version, r,
                                     distance=distance, plan=plan)
        return load

    results = pool.run_all([mk(r) for r in ranks])
    out = {}
    for r, (regions, err) in zip(ranks, results):
        if err is not None:
            raise err
        out[r] = regions
    return out


# ---------------------------------------------------------------------------
# elastic re-partitioning
# ---------------------------------------------------------------------------


def _array_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):  # bfloat16 regions read as tensors
        return torch.equal(a, b)
    return np.array_equal(a, b)


def elastic_regions(per_rank: dict[int, dict[str, np.ndarray]],
                    new_nranks: int) -> dict[int, dict[str, np.ndarray]]:
    """Re-slice a checkpoint written by N ranks for M ranks.  Regions whose
    names match across ranks and whose shard metadata marks axis-0 sharding
    are concatenated and re-split; replicated regions are broadcast."""
    old = sorted(per_rank)
    names = list(per_rank[old[0]])
    out = {r: {} for r in range(new_nranks)}
    for n in names:
        arrs = [per_rank[r][n] for r in old]
        same = all(tuple(a.shape) == tuple(arrs[0].shape)
                   and _array_equal(a, arrs[0]) for a in arrs[1:])
        if same:
            for r in range(new_nranks):
                out[r][n] = arrs[0]
            continue
        glob = torch.cat(arrs, dim=0) if isinstance(arrs[0], torch.Tensor) \
            else np.concatenate(arrs, axis=0)
        assert glob.shape[0] % new_nranks == 0, \
            f"region {n}: axis0={glob.shape[0]} not divisible by {new_nranks}"
        piece = glob.shape[0] // new_nranks
        for r in range(new_nranks):
            out[r][n] = glob[r * piece:(r + 1) * piece]
    return out
