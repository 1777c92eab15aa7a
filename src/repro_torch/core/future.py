"""Asynchronous checkpoint completion handles.

``VelocClient.checkpoint()`` / ``checkpoint_end()`` return a
``CheckpointFuture``: a first-class handle on the in-flight multi-level
pipeline, replacing the loose ``client.wait()`` + ``ctx.results`` convention.

  - ``done()`` / ``wait(timeout)`` — did the whole pipeline drain?
  - ``result(timeout)`` — block until drained, raise the exception the
    background pipeline hit (previously silently recorded in
    ``backend.errors()``), return the results dict.
  - ``exception(timeout)`` — fetch that exception without raising.
  - ``wait_level("L1"|"L2"|"L3", timeout)`` — per-level completion events:
    resilience levels complete at different times (L1 local write long
    before the rate-limited L3 flush), and callers like GC or lineage
    recording often only need a specific level.

The future proxies ``results`` / ``skipped`` from the underlying
``CheckpointContext`` so existing call sites keep reading the same fields.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core import concurrency


class CheckpointError(RuntimeError):
    """A checkpoint pipeline stage failed."""


class CheckpointFuture:
    """Completion handle for one submitted checkpoint version."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._finished = threading.Event()
        self._exc: Optional[BaseException] = None
        self._superseded = False
        self._lock = concurrency.TrackedLock(
            f"future:{ctx.name}:v{ctx.version}._lock",
            concurrency.RANK_FUTURE)
        self._levels: dict[str, threading.Event] = {}
        self._callbacks: list = []
        self._resolved = False  # _finish ran (callbacks drained)

    # -- wiring (engine / backend side) ---------------------------------
    def _level_done(self, level: str):
        self.level_event(level).set()

    def _finish(self, exc: Optional[BaseException] = None, *,
                superseded: bool = False):
        if superseded and exc is None:
            # the background stages never ran — result() must not read as
            # "persisted"; callers that tolerate preemption check .superseded
            exc = CheckpointError(
                f"checkpoint {self._ctx.name} v{self._ctx.version} "
                f"superseded by a newer version before its background "
                f"stages ran")
        self._exc = exc
        self._superseded = superseded
        if superseded:
            self._ctx.results["superseded"] = True
        # callbacks run BEFORE the completion event: a caller woken by
        # wait()/result() must observe the resolved side effects (e.g. the
        # client's history row), not race them.
        with self._lock:
            self._resolved = True
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad observer must not
                pass           # take down the pipeline worker
        self._finished.set()

    def add_done_callback(self, fn):
        """Run ``fn(future)`` once the pipeline settles — on the finishing
        thread, or immediately when it already has.  Lets callers resolve
        derived records (e.g. the client's checkpoint history) from FINAL
        results instead of a stale submit-time snapshot."""
        with self._lock:
            if not self._resolved:
                self._callbacks.append(fn)
                return
        fn(self)

    # -- inspection ------------------------------------------------------
    @property
    def ctx(self):
        return self._ctx

    @property
    def name(self) -> str:
        return self._ctx.name

    @property
    def version(self) -> int:
        return self._ctx.version

    @property
    def results(self) -> dict:
        return self._ctx.results

    @property
    def skipped(self) -> bool:
        return self._ctx.skipped

    @property
    def superseded(self) -> bool:
        """True when a newer version preempted this one in the backend
        queue before its background stages ran."""
        return self._superseded

    @property
    def module_errors(self) -> list[str]:
        """Names of optional modules that reported an error but did not
        take the pipeline down (e.g. a failed post-write verify)."""
        return list(self._ctx.results.get("errors", []))

    def level_event(self, level: str) -> threading.Event:
        """The completion event for one resilience level ("L1"/"L2"/"L3").
        Created on demand; never set for levels the pipeline doesn't run."""
        with self._lock:
            return self._levels.setdefault(level, threading.Event())

    # -- blocking API ----------------------------------------------------
    def done(self) -> bool:
        return self._finished.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the pipeline drains; False on timeout."""
        return self._finished.wait(timeout)

    def wait_level(self, level: str, timeout: Optional[float] = None) -> bool:
        return self.level_event(level).wait(timeout)

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The exception the pipeline raised, or None.  Raises TimeoutError
        if the pipeline is still running after ``timeout``."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"checkpoint {self.name} v{self.version} still in flight")
        return self._exc

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until drained; raise the pipeline's exception if it had
        one (a ``CheckpointError`` when the version was superseded before
        persisting), else return the results dict."""
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._ctx.results

    def __repr__(self):
        state = "done" if self.done() else "pending"
        if self._exc is not None:
            state = f"error: {self._exc!r}"
        elif self._superseded:
            state = "superseded"
        return f"<CheckpointFuture {self.name} v{self.version} {state}>"
