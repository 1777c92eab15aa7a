"""The VELOC pipeline engine (paper Figure 1).

Runs the module pipeline either synchronously (library mode — the engine is
"linked into the application") or asynchronously (active-backend mode): the
modules up to ``blocking_cut`` priority run inline — VELOC semantics block
the application only until the fastest level holds the checkpoint — and the
remainder is handed to the ActiveBackend worker, newest-version preemption
included.

``submit`` optionally takes a ``CheckpointFuture``; the engine finishes it
when the pipeline drains (or fails), fires its per-level completion events
as level-tagged modules succeed, and marks it superseded when a newer
version preempts it in the backend queue.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.backend import ActiveBackend, AdmissionError
from repro_torch.core.future import CheckpointError, CheckpointFuture
from repro_torch.core.modules import CheckpointContext, Module


def _payload_estimate(ctx: CheckpointContext) -> int:
    """Best-effort payload size for lane admission accounting: the
    serialized shard when the blocking front already produced one, else
    the summed region bytes (0 for deferred/device captures — admission
    then falls back to task-count high-water marks)."""
    if ctx.shard is not None:
        return len(ctx.shard)
    if not isinstance(ctx.regions, (list, tuple)):
        return 0  # deferred D2H thunk: size unknown until it runs
    total = 0
    for r in ctx.regions:
        arr = getattr(r, "array", None)
        total += int(arr.nbytes) if arr is not None else 0
    return total


class Engine:
    def __init__(self, modules: list[Module], backend: Optional[ActiveBackend],
                 *, blocking_cut: int = 25):
        self.modules = sorted(modules, key=lambda m: m.priority)
        self.backend = backend
        self.blocking_cut = blocking_cut

    def module(self, name: str) -> Module:
        for m in self.modules:
            if m.name == name:
                return m
        raise KeyError(name)

    def set_enabled(self, name: str, enabled: bool):
        self.module(name).enabled = enabled

    # ------------------------------------------------------------------
    def _run(self, mods, ctx: CheckpointContext,
             future: Optional[CheckpointFuture] = None):
        for m in mods:
            if not m.enabled:
                continue
            status = m.process(ctx)
            ctx.results[f"{m.name}.status"] = status
            if ctx.skipped:
                break
            if status == "error":
                # record and continue — a failed optional stage (e.g. verify)
                # must not take the pipeline down; level tags tell restart
                # what is trustworthy.
                ctx.results.setdefault("errors", []).append(m.name)
            elif status == "ok" and future is not None and m.level:
                future._level_done(m.level)

    def _nothing_persisted(self, ctx: CheckpointContext
                           ) -> Optional[CheckpointError]:
        """After the pipeline drains: if every level-tagged module that ran
        reported an error (graceful per-tier degradation) and NONE
        succeeded, the checkpoint exists nowhere — the future must not read
        as success."""
        if not ctx.results.get("errors"):
            return None
        level_ok = level_err = False
        for m in self.modules:
            if not m.level:
                continue
            status = ctx.results.get(f"{m.name}.status")
            level_ok = level_ok or status == "ok"
            level_err = level_err or status == "error"
        if level_err and not level_ok:
            return CheckpointError(
                f"checkpoint {ctx.name} v{ctx.version}: every resilience "
                f"level failed ({ctx.results['errors']}); nothing persisted")
        return None

    def submit(self, ctx: CheckpointContext,
               future: Optional[CheckpointFuture] = None) -> CheckpointContext:
        ctx.engine = self
        front = [m for m in self.modules if m.priority <= self.blocking_cut]
        rest = [m for m in self.modules if m.priority > self.blocking_cut]
        try:
            self._run(front, ctx, future)
        except Exception as e:  # noqa: BLE001 — routed into the future,
            if future is not None:   # then re-raised to the caller
                future._finish(e)
            raise
        ctx.results["blocking_s"] = time.monotonic() - ctx.t_begin
        if ctx.skipped:
            if future is not None:
                future._finish()
            return ctx
        if self.backend is None:
            try:
                self._run(rest, ctx, future)
            except Exception as e:  # noqa: BLE001 — routed + re-raised
                if future is not None:
                    future._finish(e)
                raise
            if future is not None:
                future._finish(self._nothing_persisted(ctx))
        else:
            def run_rest():
                try:
                    self._run(rest, ctx, future)
                except Exception as e:  # noqa: BLE001 — routed + re-raised
                    if future is not None:
                        future._finish(e)
                    raise  # the backend records it too (backend.errors())
                else:
                    if future is not None:
                        future._finish(self._nothing_persisted(ctx))

            on_drop = None
            if future is not None:
                on_drop = lambda: future._finish(superseded=True)  # noqa: E731
            try:
                self.backend.submit(
                    f"pipe:{ctx.name}:{ctx.rank}", ctx.version, run_rest,
                    priority=50, supersede=True, on_drop=on_drop,
                    stream=ctx.name, nbytes=_payload_estimate(ctx))
            except AdmissionError as e:
                # The stream's lane is over its high-water mark (e.g. a
                # wedged external tier backing it up).  Resolve as a
                # *skipped* checkpoint with a diagnostic — same contract as
                # the interval module — so this tenant degrades alone
                # instead of queueing unboundedly behind its own backlog.
                ctx.skipped = True
                ctx.results["skip_reason"] = "admission"
                ctx.results["admission"] = str(e)
                if future is not None:
                    future._finish()
        return ctx

    def wait(self, name: str, rank: int, version: Optional[int] = None,
             timeout: Optional[float] = None) -> bool:
        if self.backend is None:
            return True
        return self.backend.wait(f"pipe:{name}:{rank}", version, timeout)
