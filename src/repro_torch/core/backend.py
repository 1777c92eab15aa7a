"""The VELOC *active backend*: asynchronous pipeline execution with
interference mitigation (paper §2, "Optimized Asynchronous Multi-Level
Strategies").

  - worker threads draining **per-stream lanes**: every checkpoint stream
    (tenant) owns a priority queue of its own, and workers pick the next
    task by deficit-weighted round-robin across lanes — one tenant's
    backlog can no longer head-of-line-block every other tenant the way a
    single global heap did (lower priority value first and FIFO within a
    priority still hold *within* a lane);
  - a token-bucket RateLimiter bounding background bytes/sec so flushes do
    not compete with the application for host bandwidth (the analogue of
    "run background operations at lower OS priority") — plus optional
    per-stream limiters carved from that global budget
    (``configure_stream(rate_bps=...)`` / ``rate_share=...``);
  - admission control: a lane past its high-water mark (queued+running
    tasks, or queued bytes) refuses new submissions with
    ``AdmissionError`` instead of queueing unboundedly — the engine turns
    that into a *skipped* checkpoint with a diagnostic, so a tenant whose
    external tier wedged degrades alone instead of wedging everyone;
  - an optional *phase gate*: a StepPhasePredictor callback that delays
    chunk transfers into predicted idle windows (the paper's
    sequence-model-based scheduling, §2 / ref [6]);
  - newest-version preemption: when checkpoints outpace draining, superseded
    versions of the same task kind are dropped (straggler mitigation — the
    app never blocks on a slow flush);
  - deadlines: a task past its deadline is demoted, not blocking;
  - a *maintenance lane* (``submit_maintenance``): strictly lower priority
    than every checkpoint task — drained only while the checkpoint lanes
    are idle (nothing queued, nothing running) and rate-limited to one task
    start per ``maintenance_interval_s``.  Delta-chain compaction and
    parity refresh run here so restart latency stays bounded without the
    application (or its checkpoints) ever waiting on them.

All lane state (heaps, credits, counters) is guarded by the backend's
single condition ``backend._cv`` (rank ``RANK_BACKEND``); per-stream
rate-limiter buckets use their own ``RANK_GUARD`` locks and are never
acquired while ``_cv`` is held.
"""
from __future__ import annotations

import heapq
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from repro_torch.core import concurrency

#: lane name used when ``submit`` is called without an explicit stream —
#: legacy single-tenant callers all share one lane, which reproduces the
#: historical single-queue behaviour exactly.
DEFAULT_STREAM = "_default"


class RateLimiter:
    """Token bucket in bytes/sec.  acquire() blocks until budget allows."""

    def __init__(self, bytes_per_sec: Optional[float] = None, burst: float = 2.0,
                 clock=time.monotonic, sleep=time.sleep,
                 name: str = "backend.rate_limiter"):
        self.rate = bytes_per_sec
        self.burst = burst
        self._tokens = (bytes_per_sec or 0) * burst
        self._last = clock()
        self._clock, self._sleep = clock, sleep
        self._lock = concurrency.TrackedLock(
            f"{name}._lock", concurrency.RANK_GUARD)

    def acquire(self, nbytes: int):
        if self.rate is None:
            return
        while True:
            with self._lock:
                now = self._clock()
                self._tokens = min(self.rate * self.burst,
                                   self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= nbytes:
                    self._tokens -= nbytes
                    return
                need = (nbytes - self._tokens) / self.rate
            self._sleep(min(need, 0.05))


class ReaderPool:
    """Bounded worker pool for the restore serving path: delta-chain hop
    and per-rank shard fetches overlap instead of walking serially, while
    the worker cap keeps N concurrent readers from turning one restore
    into an unbounded thread storm against the external tier.

    Deliberately separate from ``ActiveBackend``'s checkpoint lanes: reads
    must not queue behind (or preempt) checkpoint flushes, and restore
    often runs in a fresh process that never starts a backend.  Workers
    spawn lazily on first use and are daemons — an idle pool costs
    nothing.

    ``run_all(fns)`` submits every thunk, blocks until all complete, and
    returns ``[(value, error), ...]`` in submission order — per-item
    exceptions are captured, not raised, so a failed *speculative* fetch
    (a chain hop deeper than the rank's actual full base) never aborts
    the whole restore; the caller re-raises only for hops it truly needs.
    Calls from a pool worker run inline (no nested-submit deadlock)."""

    def __init__(self, workers: int = 4, name: str = "reader_pool"):
        self.workers = max(1, int(workers))
        self._cv = concurrency.TrackedCondition(
            f"{name}._cv", concurrency.RANK_READER)
        self._queue: list = []  # FIFO of (job_state, index)
        self._threads: list[threading.Thread] = []
        self._stop = False
        self._tls = threading.local()

    def _ensure_workers_locked(self, pending: int):
        want = min(self.workers, len(self._threads) + pending)
        while len(self._threads) < want:
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"veloc-reader-{len(self._threads)}")
            self._threads.append(t)
            t.start()

    def _worker(self):
        self._tls.in_pool = True
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(1.0)
                if self._stop:
                    return
                job, i = self._queue.pop(0)
            fn = job["fns"][i]
            value, err = None, None
            try:
                value = fn()
            except BaseException as e:  # noqa: BLE001 — deferred to caller
                err = e
            with self._cv:
                job["results"][i] = (value, err)
                job["done"] += 1
                if job["done"] == len(job["fns"]):
                    self._cv.notify_all()

    def run_all(self, fns) -> list[tuple]:
        fns = list(fns)
        if not fns:
            return []
        if getattr(self._tls, "in_pool", False) or self.workers <= 1 \
                or len(fns) == 1:
            out = []
            for fn in fns:
                try:
                    out.append((fn(), None))
                except BaseException as e:  # noqa: BLE001 — deferred
                    out.append((None, e))
            return out
        job = {"fns": fns, "results": [None] * len(fns), "done": 0}
        with self._cv:
            for i in range(len(fns)):
                self._queue.append((job, i))
            self._ensure_workers_locked(len(fns))
            self._cv.notify_all()
            while job["done"] < len(fns):
                self._cv.wait(1.0)
        return job["results"]

    def hedged(self, primary: Callable, hedges, budget_s: float
               ) -> tuple:
        """Hedged read: run ``primary`` concurrently; when it has not
        produced a *useful* (non-None) result within ``budget_s`` seconds,
        launch the first of ``hedges`` (a single callable or a ranked
        list) and take the first useful result.  A launched hedge leg
        that resolves *useless* (miss or error) while the primary is
        still out ESCALATES to the next candidate — a hedge into an
        empty tier answers "miss" in microseconds, and without
        escalation that wasted probe would leave the caller pinned on
        the stalled primary for its full duration.  Returns ``(value,
        winner, outcomes)`` — ``winner`` is ``"primary"`` | ``"hedge"``;
        ``outcomes[k]`` reports launched leg ``k`` as ``"win"`` |
        ``"miss"`` | ``"err"`` | ``"pending"`` so the caller can
        attribute telemetry and demote proven-empty sources (legs never
        launched do not appear).

        The losers are ignored, never cancelled: an abandoned slow leg
        completes harmlessly in the background (its get lands in the
        shared single-flight cache like any other), preserving the
        exactly-once-per-winning-source discipline.  Bookkeeping lives
        under the pool's existing ``RANK_READER`` condition — no new lock
        rank.  Every leg runs on a dedicated daemon thread rather than a
        pool worker, so a fully-loaded pool can never deadlock a hedge
        behind the very fetch it is trying to cover — and, symmetrically,
        a hedge that itself stalls never pins down a primary that
        resolves first.  One asymmetric early-out: when the primary
        resolves to a MISS (None, no error) while hedge legs are still
        in flight, the call returns immediately with those legs marked
        ``"pending"`` instead of blocking on them — the caller's ranked
        walk then re-probes each as a budget-protected primary (the
        in-flight leg's get is deduplicated by the single-flight cache),
        so an empty primary never converts the next source into an
        unprotected synchronous wait."""
        if callable(hedges):
            hedges = [hedges]
        state = {"done": False, "value": None, "err": None}

        def run_leg(fn, st, label):
            def body():
                value, err = None, None
                try:
                    value = fn()
                except BaseException as e:  # noqa: BLE001 — deferred
                    err = e
                with self._cv:
                    st["done"] = True
                    st["value"], st["err"] = value, err
                    self._cv.notify_all()
            t = threading.Thread(target=body, daemon=True, name=label)
            t.start()

        run_leg(primary, state, "veloc-hedge-primary")
        deadline = time.monotonic() + max(0.0, budget_s)
        with self._cv:
            while not state["done"]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            if state["done"]:
                if state["err"] is not None:
                    raise state["err"]
                return state["value"], "primary", []

        def status(hs):
            if not hs["done"]:
                return "pending"
            if hs["value"] is not None:
                return "win"
            return "err" if hs["err"] is not None else "miss"

        hstates: list = []

        def launch_next():
            hs = {"done": False, "value": None, "err": None}
            hstates.append(hs)
            run_leg(hedges[len(hstates) - 1], hs, "veloc-hedge-leg")

        # budget blown: launch the first hedge leg and race
        launch_next()
        with self._cv:
            while True:
                for hs in hstates:
                    if hs["done"] and hs["value"] is not None:
                        return hs["value"], "hedge", [status(h)
                                                     for h in hstates]
                if (hstates[-1]["done"] and not state["done"]
                        and len(hstates) < len(hedges)):
                    launch_next()  # escalate past the useless leg
                    continue
                if state["done"] and state["err"] is None:
                    return (state["value"], "primary",
                            [status(h) for h in hstates])
                if state["done"] and all(h["done"] for h in hstates):
                    # every leg resolved useless — surface an error
                    if state["err"] is not None:
                        raise state["err"]
                    for hs in hstates:
                        if hs["err"] is not None:
                            raise hs["err"]
                    return None, "primary", [status(h) for h in hstates]
                self._cv.wait(1.0)

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)


@dataclass(order=True)
class _Task:
    priority: int
    seq: int
    version: int = field(compare=False)
    kind: str = field(compare=False)
    fn: Callable = field(compare=False)
    deadline: Optional[float] = field(compare=False, default=None)
    on_drop: Optional[Callable] = field(compare=False, default=None)
    #: maintenance lane only: don't start before this monotonic time
    #: (seal-retry exponential backoff); None = eligible immediately
    not_before: Optional[float] = field(compare=False, default=None)
    #: checkpoint lane this task was enqueued on
    stream: str = field(compare=False, default=DEFAULT_STREAM)
    #: caller-declared payload size (admission accounting only)
    nbytes: int = field(compare=False, default=0)
    #: monotonic enqueue time (lane wait-time accounting)
    enq_t: float = field(compare=False, default=0.0)


@dataclass
class LanePolicy:
    """Per-stream scheduling / admission knobs (see ``configure_stream``).

    ``weight``: deficit-round-robin share relative to other lanes (2.0 =
    served twice as often when everyone has work).  ``rate_bps`` /
    ``rate_share``: a private token-bucket budget for this stream's flush
    bytes — explicit bytes/sec, or a fraction carved from the backend's
    global limiter (a share of an unlimited budget stays unlimited).
    ``max_queued`` / ``max_queued_bytes``: admission high-water marks on
    queued+running tasks and queued payload bytes; ``None`` = unlimited."""
    weight: float = 1.0
    rate_bps: Optional[float] = None
    rate_share: Optional[float] = None
    max_queued: Optional[int] = None
    max_queued_bytes: Optional[int] = None


class _Lane:
    """One stream's checkpoint queue + scheduling/admission state.
    Mutated only under ``ActiveBackend._cv``."""

    def __init__(self, name: str, policy: LanePolicy):
        self.name = name
        self.policy = policy
        self.heap: list[_Task] = []
        self.credit = 1.0  # deficit counter: >= 1.0 may dispatch one task
        self.queued_bytes = 0
        self.running = 0
        self.admitted = 0
        self.rejected = 0
        self.dispatched = 0
        self.wait_total_s = 0.0
        self.wait_max_s = 0.0
        self.limiter: Optional[RateLimiter] = None

    def stats(self) -> dict:
        return {"queued": len(self.heap),
                "queued_bytes": self.queued_bytes,
                "running": self.running,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "dispatched": self.dispatched,
                "wait_max_s": self.wait_max_s,
                "wait_total_s": self.wait_total_s,
                "weight": self.policy.weight,
                "rate_bps": None if self.limiter is None
                else self.limiter.rate}


class TaskError(Exception):
    pass


class AdmissionError(RuntimeError):
    """A lane is past its high-water mark; the submission was refused.

    Carries the stream name and a snapshot of the lane counters so the
    caller (the engine) can resolve the checkpoint as *skipped* with a
    useful diagnostic instead of blocking or failing opaquely."""

    def __init__(self, stream: str, detail: str):
        super().__init__(f"stream '{stream}' over admission high-water mark: "
                         f"{detail}")
        self.stream = stream
        self.detail = detail


class ActiveBackend:
    """Multi-lane worker pool for background checkpoint pipeline stages."""

    def __init__(self, workers: int = 1, rate_limiter: Optional[RateLimiter] = None,
                 phase_gate: Optional[Callable[[], float]] = None,
                 maintenance_interval_s: float = 0.0):
        self.rate_limiter = rate_limiter or RateLimiter(None)
        self.phase_gate = phase_gate  # returns seconds to wait before heavy IO
        self._lanes: dict[str, _Lane] = {}
        self._rr: list[str] = []  # lane service order (round-robin cursor)
        self._rr_idx = 0
        self._maint: list[_Task] = []  # maintenance lane (idle-only)
        self._maint_interval = maintenance_interval_s
        self._maint_last: Optional[float] = None  # last maintenance start
        self._seq = 0
        self._cv = concurrency.TrackedCondition(
            "backend._cv", concurrency.RANK_BACKEND)
        self._done: dict[tuple[str, int], str] = {}  # (kind, version) -> status
        self._errors: list[str] = []
        #: exact in-flight tasks; status() reports "running" only for pairs
        #: actually executing (the historical version answered "running" for
        #: ANY pair whenever ANY worker was busy).
        self._running: list[tuple[str, int]] = []
        self._running_ckpt = 0  # checkpoint-lane tasks currently executing
        self._stop = False
        self._draining = False  # shutdown in progress: backoffs collapse
        self._latest: dict[str, int] = {}  # kind -> newest version enqueued
        #: per-tier read-telemetry provider for ``status()["tiers"]`` —
        #: clients point this at ``Cluster.tier_read_stats`` so the
        #: backend snapshot carries the restore-source health alongside
        #: lane and lock stats.  Called OUTSIDE ``_cv`` (pure counter
        #: reads, no lock-order entanglement).
        self.tier_stats: Optional[Callable[[], dict]] = None
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"veloc-backend-{i}")
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    # lanes
    def configure_stream(self, stream: str, *, weight: float = 1.0,
                         rate_bps: Optional[float] = None,
                         rate_share: Optional[float] = None,
                         max_queued: Optional[int] = None,
                         max_queued_bytes: Optional[int] = None) -> None:
        """Create or reconfigure the lane for ``stream``.  Idempotent;
        clients call this at construction so tenants sharing one backend
        each get their declared weight / budget / admission policy.
        Unconfigured streams get an implicit default lane (weight 1.0,
        no private budget, no admission limit) on first submit."""
        if weight <= 0:
            raise ValueError(f"lane weight must be > 0, got {weight}")
        if rate_bps is not None and rate_share is not None:
            raise ValueError("set rate_bps or rate_share, not both")
        if rate_share is not None and not 0 < rate_share <= 1:
            raise ValueError(f"rate_share must be in (0, 1], got {rate_share}")
        pol = LanePolicy(weight=weight, rate_bps=rate_bps,
                         rate_share=rate_share, max_queued=max_queued,
                         max_queued_bytes=max_queued_bytes)
        bps = rate_bps
        if bps is None and rate_share is not None \
                and self.rate_limiter.rate is not None:
            bps = self.rate_limiter.rate * rate_share
        limiter = RateLimiter(bps, name=f"backend.lane.{stream}") \
            if bps is not None else None
        with self._cv:
            lane = self._lane_locked(stream)
            lane.policy = pol
            lane.limiter = limiter

    def _lane_locked(self, stream: str) -> _Lane:
        lane = self._lanes.get(stream)
        if lane is None:
            lane = _Lane(stream, LanePolicy())
            self._lanes[stream] = lane
            self._rr.append(stream)
        return lane

    def lane_limiter(self, stream: str) -> Optional[RateLimiter]:
        """The stream's private token bucket, if one was configured.
        Callers charge this *in addition to* the global ``rate_limiter``
        (per-tenant budget carved from the shared budget)."""
        with self._cv:
            lane = self._lanes.get(stream)
            return lane.limiter if lane is not None else None

    def _queued_ckpt_locked(self) -> bool:
        return any(lane.heap for lane in self._lanes.values())

    def _all_queued_locked(self) -> list[_Task]:
        out: list[_Task] = []
        for lane in self._lanes.values():
            out.extend(lane.heap)
        out.extend(self._maint)
        return out

    # ------------------------------------------------------------------
    def submit(self, kind: str, version: int, fn: Callable, *, priority: int = 50,
               deadline_s: Optional[float] = None, supersede: bool = False,
               on_drop: Optional[Callable] = None,
               stream: Optional[str] = None, nbytes: int = 0):
        """supersede=True drops queued (not running) older versions of kind.
        ``on_drop`` fires if THIS task is later dropped by a superseding
        submit (so completion handles don't hang on preempted versions).

        ``stream`` names the lane (tenant) the task belongs to; omitted,
        everything shares one default lane.  ``nbytes`` is the caller's
        payload-size estimate, counted against the lane's
        ``max_queued_bytes`` high-water mark.  Raises ``AdmissionError``
        (after supersede has freed what it can) when the lane is over its
        configured high-water mark."""
        lane_name = stream or DEFAULT_STREAM
        dropped = []
        with self._cv:
            if self._stop:
                raise RuntimeError("backend stopped")
            lane = self._lane_locked(lane_name)
            if supersede:
                before = len(lane.heap)
                kept = []
                for t in lane.heap:
                    if t.kind == kind and t.version < version:
                        self._done[(t.kind, t.version)] = "superseded"
                        lane.queued_bytes -= t.nbytes
                        if t.on_drop is not None:
                            dropped.append(t.on_drop)
                    else:
                        kept.append(t)
                if len(kept) != before:
                    lane.heap = kept
                    heapq.heapify(lane.heap)
            pol = lane.policy
            depth = len(lane.heap) + lane.running
            if pol.max_queued is not None and depth >= pol.max_queued:
                lane.rejected += 1
                detail = (f"{depth} queued+running >= max_queued="
                          f"{pol.max_queued}")
                self._cv.notify_all()
                raise AdmissionError(lane_name, detail)
            if pol.max_queued_bytes is not None and lane.heap and \
                    lane.queued_bytes + nbytes > pol.max_queued_bytes:
                lane.rejected += 1
                detail = (f"{lane.queued_bytes}+{nbytes} queued bytes > "
                          f"max_queued_bytes={pol.max_queued_bytes}")
                self._cv.notify_all()
                raise AdmissionError(lane_name, detail)
            self._seq += 1
            dl = time.monotonic() + deadline_s if deadline_s else None
            heapq.heappush(lane.heap,
                           _Task(priority, self._seq, version, kind, fn, dl,
                                 on_drop, stream=lane_name, nbytes=nbytes,
                                 enq_t=time.monotonic()))
            lane.queued_bytes += nbytes
            lane.admitted += 1
            self._latest[kind] = max(self._latest.get(kind, -1), version)
            self._cv.notify()
        for cb in dropped:  # outside the lock: callbacks may block/log
            cb()

    def submit_maintenance(self, kind: str, version: int, fn: Callable, *,
                           priority: int = 90, coalesce: bool = False,
                           delay_s: float = 0.0):
        """Queue low-priority background maintenance (delta-chain
        compaction, GC, segment re-seals, ...).  Maintenance never competes
        with checkpoints: a task is only popped while the checkpoint lanes
        are completely idle, and starts are spaced at least
        ``maintenance_interval_s`` apart.

        ``coalesce=True`` deduplicates by task kind: queued (not running)
        older tasks of the same kind are dropped in favour of this one —
        idempotent sweeps like GC need at most one pending instance however
        many checkpoints queued them while the lanes were busy.

        ``delay_s`` defers the task's earliest start (seal-retry
        exponential backoff: an external tier that is down for minutes must
        not be hammered every maintenance window).  Ignored once the
        backend is draining for shutdown — queued work then runs
        immediately instead of holding the process open."""
        with self._cv:
            if self._stop:
                raise RuntimeError("backend stopped")
            if coalesce:
                kept = [t for t in self._maint
                        if not (t.kind == kind and t.version <= version)]
                for t in self._maint:
                    if t.kind == kind and t.version < version:
                        self._done[(t.kind, t.version)] = "superseded"
                if len(kept) != len(self._maint):
                    self._maint = kept
                    heapq.heapify(self._maint)
            self._seq += 1
            nb = time.monotonic() + delay_s \
                if delay_s > 0 and not self._draining else None
            heapq.heappush(self._maint,
                           _Task(priority, self._seq, version, kind, fn,
                                 not_before=nb))
            self._latest[kind] = max(self._latest.get(kind, -1), version)
            self._cv.notify()

    def _pop_ckpt_locked(self) -> Optional[_Task]:
        """Deficit-weighted round-robin across non-empty lanes: a lane
        accrues ``weight`` credit each time the scheduler passes it with
        work queued and spends 1.0 credit per dispatched task, so over time
        lanes are served proportionally to their weights and no lane
        starves.  With all weights at the default 1.0 this degenerates to
        strict round-robin."""
        if not self._queued_ckpt_locked():
            return None
        n = len(self._rr)
        # Two rotations: every non-empty lane accrues its weight at least
        # once, so any lane with weight >= 0.5 reaches a full credit.
        for _ in range(2):
            for off in range(n):
                i = (self._rr_idx + off) % n
                lane = self._lanes[self._rr[i]]
                if not lane.heap:
                    continue
                if lane.credit >= 1.0:
                    lane.credit -= 1.0
                    self._rr_idx = (i + 1) % n
                    return self._lane_pop_locked(lane)
                lane.credit += lane.policy.weight
        # All weights tiny: serve the largest accrued credit outright.
        lane = max((ln for ln in self._lanes.values() if ln.heap),
                   key=lambda ln: ln.credit)
        lane.credit = 0.0
        return self._lane_pop_locked(lane)

    def _lane_pop_locked(self, lane: _Lane) -> _Task:
        task = heapq.heappop(lane.heap)
        lane.queued_bytes -= task.nbytes
        wait = max(0.0, time.monotonic() - task.enq_t)
        lane.wait_total_s += wait
        lane.wait_max_s = max(lane.wait_max_s, wait)
        lane.dispatched += 1
        lane.running += 1
        return task

    def _pop_maintenance_locked(self) -> Optional[_Task]:
        if not self._maint or self._queued_ckpt_locked() or self._running_ckpt:
            return None  # checkpoint lanes not idle
        now = time.monotonic()
        due = [t for t in self._maint
               if t.not_before is None or t.not_before <= now]
        if not due:
            return None  # everything is backing off
        if self._maint_interval > 0 and self._maint_last is not None and \
                now - self._maint_last < self._maint_interval:
            return None  # rate window not open yet
        task = min(due)  # (priority, seq) — heap order among the due
        self._maint.remove(task)
        heapq.heapify(self._maint)
        self._maint_last = time.monotonic()
        return task

    def _idle_wait_locked(self) -> Optional[float]:
        """How long to wait for work: the backoff / rate-window remainder
        when only deferred maintenance is pending, else indefinitely (woken
        by submit / completion / shutdown notifies)."""
        if not self._maint or self._queued_ckpt_locked() or self._running_ckpt:
            return None
        now = time.monotonic()
        due = [t for t in self._maint
               if t.not_before is None or t.not_before <= now]
        if not due:
            return max(0.01, min(t.not_before for t in self._maint) - now)
        if self._maint_interval > 0 and self._maint_last is not None:
            return max(0.01,
                       self._maint_last + self._maint_interval - now)
        return None

    def _worker(self):
        while True:
            with self._cv:
                task = None
                while task is None:
                    task = self._pop_ckpt_locked()
                    if task is not None:
                        is_ckpt = True
                        break
                    task = self._pop_maintenance_locked()
                    if task is not None:
                        is_ckpt = False
                        break
                    if self._stop:
                        return
                    self._cv.wait(self._idle_wait_locked())
                if is_ckpt:
                    self._running_ckpt += 1
                self._running.append((task.kind, task.version))
            status = "done"
            try:
                if task.deadline is not None and time.monotonic() > task.deadline:
                    status = "deadline-miss"
                else:
                    if self.phase_gate is not None:
                        wait = self.phase_gate()
                        if wait > 0:
                            time.sleep(min(wait, 1.0))
                    task.fn()
            except Exception:  # noqa: BLE001 — recorded, surfaced via errors()
                status = "error"
                with self._cv:
                    self._errors.append(
                        f"{task.kind} v{task.version}:\n{traceback.format_exc()}")
            with self._cv:
                self._done[(task.kind, task.version)] = status
                self._running.remove((task.kind, task.version))
                if is_ckpt:
                    self._running_ckpt -= 1
                    lane = self._lanes.get(task.stream)
                    if lane is not None:
                        lane.running -= 1
                self._cv.notify_all()

    # ------------------------------------------------------------------
    def wait(self, kind: Optional[str] = None, version: Optional[int] = None,
             timeout: Optional[float] = None) -> bool:
        """Block until matching tasks drain.  Returns False on timeout."""

        def outstanding():
            pend = [t for t in self._all_queued_locked()
                    if (kind is None or t.kind == kind)
                    and (version is None or t.version == version)]
            if pend:
                return True
            if version is not None and kind is not None:
                if (kind, version) in self._running:
                    return True
                return (kind, version) not in self._done and \
                    version <= self._latest.get(kind, -1)
            if kind is not None:
                return any(k == kind for k, _ in self._running)
            return bool(self._running)

        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while outstanding():
                remaining = None if end is None else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.2)
        return True

    def status(self, kind: Optional[str] = None,
               version: Optional[int] = None) -> Union[str, dict]:
        """With (kind, version): exact task state — "queued" | "running" |
        a terminal status ("done"/"error"/"superseded"/"deadline-miss") |
        "unknown" (never submitted).  In-flight pairs are tracked precisely
        — a busy worker no longer makes every unrelated pair read
        "running".

        With no arguments: a backend-wide snapshot dict — total queue
        depths, in-flight tasks, error count, per-lock contention stats
        (``locks`` is empty unless the runtime checker is enabled), a
        ``lanes`` map with per-stream contention counters: queued
        tasks/bytes, running, admitted/rejected (admission control),
        dispatched, max/total lane wait seconds, weight, and the lane's
        private rate budget if one is configured — and a ``tiers`` map
        with per-tier read telemetry (gets, bytes served, EWMA get
        latency, miss/error streaks, hedge wins/losses) when a cluster
        registered its stats provider (empty otherwise)."""
        if kind is None and version is None:
            with self._cv:
                snap = {"queued": sum(len(ln.heap)
                                      for ln in self._lanes.values()),
                        "maintenance": len(self._maint),
                        "running": list(self._running),
                        "errors": len(self._errors),
                        "lanes": {name: lane.stats()
                                  for name, lane in self._lanes.items()}}
            snap["locks"] = concurrency.lock_stats()
            provider = self.tier_stats
            snap["tiers"] = provider() if provider is not None else {}
            return snap
        if kind is None or version is None:
            raise TypeError("status() takes both kind and version, or neither")
        with self._cv:
            if (kind, version) in self._done:
                return self._done[(kind, version)]
            for t in self._all_queued_locked():
                if t.kind == kind and t.version == version:
                    return "queued"
            if (kind, version) in self._running:
                return "running"
        return "unknown"

    def errors(self) -> list[str]:
        with self._cv:
            return list(self._errors)

    def shutdown(self, wait: bool = True):
        with self._cv:
            # draining must not sit out the maintenance rate window or a
            # seal-retry backoff — run whatever is still queued immediately
            self._maint_interval = 0.0
            self._draining = True
            for t in self._maint:
                t.not_before = None
            self._cv.notify_all()
        if wait:
            self.wait()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
