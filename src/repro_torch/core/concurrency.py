"""Runtime concurrency contract checker: tracked locks + IO-under-lock.

VELOC's "very low overhead" claim rests on checkpoint I/O never blocking
the application thread — yet that bug class has shipped more than once
(tier puts under the cluster lock, a self-deadlock re-acquiring the
cluster lock during pack hydration, catalog RMW ordering).  This module makes those contracts *machine-checked*:

``TrackedLock`` / ``TrackedRLock`` / ``TrackedCondition`` are drop-in
replacements for the ``threading`` primitives.  When the checker is
disabled (the default) they are a single attribute indirection over the
raw primitive — no bookkeeping, no extra allocation per acquire.  When
enabled (``enable()``, the tier-1 autouse fixture, or the
``VELOC_LOCK_CHECK`` env var) every acquisition is checked against the
canonical lock order and recorded in a global lock-order graph:

  rank 10   cluster._cat_locks[name]   per-stream catalog RMW (outermost:
            a catalog RMW must never run, or be awaited,
            under the cluster lock)
  rank 14   module guards (DeltaModule._guard)
  rank 15   DeltaModule per-stream locks (held across cluster queries)
  rank 18   VelocClient._compact_lock
  rank 20   cluster._lock               THE cluster lock; io_forbidden —
            no external-tier I/O may run while it is held
  rank 30   cluster._vlocks[...]        per-version rewrite
  rank 32   cluster._plocks[...]        per-pack rewrite
  rank 40   backend._cv                 ActiveBackend queue condition — ALL
            per-stream lane state (heaps, deficit credits, admission
            counters) lives under this single condition; lanes add no new
            lock
  rank 44   reader_pool._cv             restore-side bounded fetch pool
  rank 46   cluster._seg_lock           shared segment/pack blob cache
            (single-flight condition: loser readers wait here while the
            winner fetches WITHOUT the lock held)
  rank 50   leaf guards (_plock_guard, _cat_guard, RateLimiter — including
            the per-stream lane limiters ``backend.lane.<stream>._lock``;
            limiter buckets are charged sequentially, never nested)
  rank 60   StorageTier._lock           per-tier accounting
  rank 62   KVTier._journal_lock        journal append/compact
  rank 70   CheckpointFuture._lock      callback/level bookkeeping
  rank 80   kernel build + launch-count guards (innermost: a digest can
            run under any lock above, e.g. a KV journal append)

Violations detected (mode "raise" throws, "warn" warns; every violation
is also appended to ``violations()`` so tests catch ones swallowed by
defensive ``except`` blocks downstream):

  - rank inversion: acquiring a lock whose rank is <= any held lock's
    rank (equal ranks on distinct objects are also refused — the codebase
    never nests two same-class locks);
  - cycle in the dynamic lock-order graph (belt and braces over ranks);
  - self-deadlock: re-acquiring a held non-reentrant TrackedLock (the
    republish hydration bug once hung exactly here — with the checker on
    it raises instead);
  - IO-under-lock: ``StorageTier.put/get/delete/keys`` on an *external*
    tier (``info.node_local == False``) while any ``io_forbidden`` lock —
    the cluster lock — is held (the seal-put-under-lock bug).

Per-lock contention / hold-time stats are always collected while enabled
and exported via ``lock_stats()`` (surfaced through ``backend.status()``
and the ``bench_lock_overhead`` benchmark).
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Optional

# -- canonical rank constants (see module docstring) ------------------------
RANK_CATALOG = 10
RANK_MODULE_GUARD = 14
RANK_MODULE = 15
RANK_CLIENT = 18
RANK_CLUSTER = 20
RANK_VERSION = 30
RANK_PACK = 32
RANK_BACKEND = 40
RANK_READER = 44
RANK_READCACHE = 46
RANK_GUARD = 50
RANK_TIER = 60
RANK_JOURNAL = 62
RANK_FUTURE = 70
RANK_KERNEL = 80


class LockDisciplineError(RuntimeError):
    """Base class for every runtime concurrency-contract violation."""


class LockOrderError(LockDisciplineError):
    """An acquisition inverted the canonical lock order (or closed a cycle
    in the dynamic lock-order graph, or re-acquired a held non-reentrant
    lock)."""


class IOUnderLockError(LockDisciplineError):
    """External-tier I/O was issued while an io_forbidden lock (the
    cluster lock) was held."""


class LockStats:
    """Lifetime counters for one named lock (collected while enabled)."""

    __slots__ = ("acquisitions", "contentions", "wait_s", "hold_s",
                 "hold_max_s")

    def __init__(self):
        self.acquisitions = 0
        self.contentions = 0  # acquire() found the lock already held
        self.wait_s = 0.0     # total time blocked in contended acquires
        self.hold_s = 0.0     # total time held
        self.hold_max_s = 0.0

    def as_dict(self) -> dict:
        return {"acquisitions": self.acquisitions,
                "contentions": self.contentions,
                "wait_s": round(self.wait_s, 6),
                "hold_s": round(self.hold_s, 6),
                "hold_max_s": round(self.hold_max_s, 6)}


# -- global checker state ----------------------------------------------------
_ACTIVE = False
_MODE = "raise"       # raise | warn  (lock-order + self-deadlock)
_IO_MODE = "raise"    # raise | warn  (IO-under-lock)
_tls = threading.local()
# the meta lock is a RAW primitive on purpose: it guards the checker's own
# graph/stats and must never itself enter the tracked universe
_meta = threading.Lock()
_edges: dict[str, set[str]] = {}   # lock name -> names acquired while held
_stats: dict[str, LockStats] = {}
_violations: list[str] = []


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def enable(mode: str = "raise", io_mode: Optional[str] = None):
    """Turn the checker on.  ``mode`` governs lock-order violations,
    ``io_mode`` (default: same as ``mode``) governs IO-under-lock."""
    global _ACTIVE, _MODE, _IO_MODE
    if mode not in ("raise", "warn"):
        raise ValueError(f"mode must be 'raise' or 'warn', got {mode!r}")
    _MODE = mode
    _IO_MODE = io_mode if io_mode is not None else mode
    if _IO_MODE not in ("raise", "warn"):
        raise ValueError(f"io_mode must be 'raise' or 'warn', got {_IO_MODE!r}")
    _ACTIVE = True


def disable():
    global _ACTIVE
    _ACTIVE = False


def is_active() -> bool:
    return _ACTIVE


def reset():
    """Clear the order graph, stats and violations (held sets are
    per-thread and drain naturally as locks release)."""
    with _meta:
        _edges.clear()
        _stats.clear()
        del _violations[:]


def violations() -> list[str]:
    with _meta:
        return list(_violations)


def clear_violations():
    with _meta:
        del _violations[:]


def lock_stats() -> dict[str, dict]:
    """Snapshot of per-lock contention/hold-time stats by lock name."""
    with _meta:
        return {name: s.as_dict() for name, s in sorted(_stats.items())}


def _report(msg: str, exc_cls, mode: str):
    with _meta:
        _violations.append(msg)
    if mode == "raise":
        raise exc_cls(msg)
    warnings.warn(msg, stacklevel=3)


def _has_path(src: str, dst: str) -> bool:
    """True when ``dst`` is reachable from ``src`` in the order graph.
    Caller holds ``_meta``."""
    seen = set()
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(_edges.get(node, ()))
    return False


def note_tier_io(tier, op: str):
    """IO-under-lock hook, called by ``StorageTier.put/get/delete/keys``.
    External-tier I/O (node_local=False) while an io_forbidden lock is
    held is the seal-put bug class; node-local tiers are exempt (L1 writes
    under brief bookkeeping locks are the design, not a bug)."""
    if not _ACTIVE:
        return
    info = getattr(tier, "info", None)
    if info is None or info.node_local:
        return
    for entry in _held():
        if entry[0].io_forbidden:
            _report(
                f"IO-under-lock: {op}() on external tier "
                f"{info.name!r} while holding {entry[0].name!r} "
                f"(no external-tier I/O may run under the cluster lock)",
                IOUnderLockError, _IO_MODE)
            return  # one report per call is enough


class TrackedLock:
    """Drop-in ``threading.Lock`` with rank/order/IO-contract checking.

    ``name`` identifies the lock in the order graph and stats; ``rank``
    is its position in the canonical order (lower = acquired earlier /
    outermost); ``io_forbidden=True`` marks locks under which no
    external-tier I/O may run (the cluster lock)."""

    _reentrant = False

    def __init__(self, name: str, rank: int, *, io_forbidden: bool = False):
        self.name = name
        self.rank = rank
        self.io_forbidden = io_forbidden
        self._lock = self._make()

    def _make(self):
        return threading.Lock()

    # -- checking ---------------------------------------------------------
    def _check_order(self, held: list):
        """Rank + graph checks against every lock this thread holds.
        Runs BEFORE blocking on the primitive so a would-be deadlock
        raises instead of hanging."""
        for entry in held:
            other = entry[0]
            if other is self:
                if self._reentrant:
                    return  # depth bump; no new edge
                _report(
                    f"self-deadlock: thread {threading.current_thread().name}"
                    f" re-acquired non-reentrant lock {self.name!r} it "
                    f"already holds", LockOrderError, _MODE)
                return
        for entry in held:
            other = entry[0]
            if other.rank > self.rank or (
                    other.rank == self.rank and other is not self):
                _report(
                    f"lock-order inversion: acquiring {self.name!r} "
                    f"(rank {self.rank}) while holding {other.name!r} "
                    f"(rank {other.rank}); canonical order is "
                    f"catalog -> cluster -> version/pack -> backend -> "
                    f"guards -> tier", LockOrderError, _MODE)
                return
        with _meta:
            for entry in held:
                other = entry[0]
                if other.name == self.name:
                    continue
                if _has_path(self.name, other.name):
                    _report(
                        f"lock-order cycle: {other.name!r} -> {self.name!r} "
                        f"closes a cycle in the observed acquisition graph",
                        LockOrderError, _MODE)
                    return
                _edges.setdefault(other.name, set()).add(self.name)

    def _note_acquired(self, waited_s: float, contended: bool):
        with _meta:
            st = _stats.get(self.name)
            if st is None:
                st = _stats[self.name] = LockStats()
            st.acquisitions += 1
            if contended:
                st.contentions += 1
                st.wait_s += waited_s
        _held().append([self, time.monotonic()])

    def _note_released(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                dur = time.monotonic() - held[i][1]
                del held[i]
                with _meta:
                    st = _stats.get(self.name)
                    if st is not None:
                        st.hold_s += dur
                        if dur > st.hold_max_s:
                            st.hold_max_s = dur
                return

    # -- threading.Lock API ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ACTIVE:
            return self._lock.acquire(blocking, timeout)
        self._check_order(_held())
        contended = not self._lock.acquire(blocking=False)
        waited = 0.0
        if contended:
            if not blocking:
                return False
            t0 = time.monotonic()
            if not self._lock.acquire(True, timeout):
                return False
            waited = time.monotonic() - t0
        self._note_acquired(waited, contended)
        return True

    def release(self):
        if _ACTIVE:
            self._note_released()
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return (f"<{type(self).__name__} {self.name!r} rank={self.rank}"
                f"{' io_forbidden' if self.io_forbidden else ''}>")


class TrackedRLock(TrackedLock):
    """Reentrant variant: same-thread re-acquisition is legal and adds no
    order edge; only the outermost release drops the held entry."""

    _reentrant = True

    def _make(self):
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ACTIVE:
            return self._lock.acquire(blocking, timeout)
        held = _held()
        depth = sum(1 for e in held if e[0] is self)
        if depth:
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                held.append([self, time.monotonic()])
            return ok
        return super().acquire(blocking, timeout)

    def release(self):
        if _ACTIVE:
            held = _held()
            depth = sum(1 for e in held if e[0] is self)
            if depth > 1:
                # inner release: drop the newest entry without hold stats
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] is self:
                        del held[i]
                        break
            else:
                self._note_released()
        self._lock.release()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._lock._is_owned():  # held by US (non-blocking re-acquire
            return True             # would spuriously succeed)
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True


class TrackedCondition:
    """``threading.Condition`` over a TrackedLock.  ``wait()`` drops the
    lock's held entry for the duration (the primitive really does release
    it) and re-registers on wake."""

    def __init__(self, name: str, rank: int, *, io_forbidden: bool = False):
        self._tlock = TrackedLock(name, rank, io_forbidden=io_forbidden)
        self._cond = threading.Condition(self._tlock._lock)

    @property
    def name(self) -> str:
        return self._tlock.name

    @property
    def rank(self) -> int:
        return self._tlock.rank

    def acquire(self, *a, **kw):
        return self._tlock.acquire(*a, **kw)

    def release(self):
        self._tlock.release()

    def __enter__(self):
        self._tlock.acquire()
        return self

    def __exit__(self, *exc):
        self._tlock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not _ACTIVE:
            return self._cond.wait(timeout)
        self._tlock._note_released()
        try:
            return self._cond.wait(timeout)
        finally:
            # the primitive re-acquired the lock on wake; order was already
            # validated at the original acquire — just re-register + count
            self._tlock._note_acquired(0.0, False)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        if not _ACTIVE:
            return self._cond.wait_for(predicate, timeout)
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None
            if end is not None:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


def _env_enable():
    """``VELOC_LOCK_CHECK=1|raise|warn`` turns the checker on at import."""
    val = os.environ.get("VELOC_LOCK_CHECK", "").strip().lower()
    if not val or val in ("0", "off", "false"):
        return
    enable("warn" if val == "warn" else "raise")


_env_enable()
