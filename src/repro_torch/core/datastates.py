"""DataStates-style lineage over checkpoints (paper §3: productive
checkpointing — snapshots that are captured/cloned asynchronously and
navigable as a lineage for branch/explore workflows like guided model
discovery and outlier-ensemble training [2,7])."""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

_LOG_KEY = "datastates/log"


@dataclass
class Snapshot:
    id: int
    version: int            # checkpoint version holding the payload
    branch: str = "main"
    parent: Optional[int] = None
    metrics: dict = field(default_factory=dict)
    tags: list = field(default_factory=list)
    wallclock: float = 0.0


class DataStates:
    """Lineage DAG persisted in the external tier (JSON log)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._snaps: dict[int, Snapshot] = {}
        self._next = 0
        self._load()

    def _tier(self):
        return self.cluster.external_tiers[0]

    def _load(self):
        blob = self._tier().get(_LOG_KEY)
        if blob:
            for line in blob.decode().splitlines():
                s = Snapshot(**json.loads(line))
                self._snaps[s.id] = s
                self._next = max(self._next, s.id + 1)

    def _persist(self):
        blob = "\n".join(json.dumps(asdict(s))
                         for _, s in sorted(self._snaps.items())).encode()
        self._tier().put(_LOG_KEY, blob)

    # ------------------------------------------------------------------
    def record(self, version: int, *, branch: str = "main",
               parent: Optional[int] = None, metrics: Optional[dict] = None,
               tags: Optional[list] = None) -> Snapshot:
        if parent is None and self._snaps:
            same = [s for s in self._snaps.values() if s.branch == branch]
            if same:
                parent = max(same, key=lambda s: s.id).id
        s = Snapshot(id=self._next, version=version, branch=branch,
                     parent=parent, metrics=metrics or {}, tags=tags or [],
                     wallclock=time.time())
        self._snaps[s.id] = s
        self._next += 1
        self._persist()
        return s

    def clone(self, snap_id: int, new_branch: str) -> Snapshot:
        """Branch off an existing snapshot: the clone shares the parent's
        checkpoint payload (zero-copy at the storage level) until the new
        branch checkpoints again."""
        src = self._snaps[snap_id]
        return self.record(src.version, branch=new_branch, parent=src.id,
                           metrics=dict(src.metrics), tags=["clone"])

    def lineage(self, snap_id: int) -> list[Snapshot]:
        out = []
        cur: Optional[int] = snap_id
        while cur is not None:
            s = self._snaps[cur]
            out.append(s)
            cur = s.parent
        return out[::-1]

    def search(self, pred: Callable[[Snapshot], bool]) -> list[Snapshot]:
        return [s for _, s in sorted(self._snaps.items()) if pred(s)]

    def best(self, metric: str, mode: str = "min") -> Optional[Snapshot]:
        cands = [s for s in self._snaps.values() if metric in s.metrics]
        if not cands:
            return None
        key = lambda s: s.metrics[metric]
        return min(cands, key=key) if mode == "min" else max(cands, key=key)

    def branches(self) -> list[str]:
        return sorted({s.branch for s in self._snaps.values()})
