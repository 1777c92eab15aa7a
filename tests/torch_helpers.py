"""Fault-injection tier wrappers for failure-scenario tests of the port
(``repro_torch``): ``tests/helpers.py`` over the port's ``StorageTier``.

``FlakyTier`` fails ``put``/``get`` on demand (raising IOError, like a dead
NVMe or a refused DAOS connection); ``CorruptingTier`` silently flips bytes
on ``get`` (bit rot / torn read) so checksum paths are exercised.  Both
delegate everything else to the wrapped tier, so they drop into a built
``Cluster`` in place of any ``StorageTier``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.core.storage import StorageTier


class WrappedTier(StorageTier):
    """Delegating base: behaves exactly like ``inner``."""

    def __init__(self, inner: StorageTier):
        super().__init__(inner.info)
        self.inner = inner

    def put(self, key, data):
        return self.inner.put(key, data)

    def _get(self, key):
        # route through inner.get() so the wrapped tier's get_calls
        # accounting (and the IO-under-lock hook) still observe reads
        # made through the wrapper; same for _delete/_keys below
        return self.inner.get(key)

    def exists(self, key):
        return self.inner.exists(key)

    def _delete(self, key):
        return self.inner.delete(key)

    def _keys(self, prefix=""):
        return self.inner.keys(prefix)


class FlakyTier(WrappedTier):
    """Fails puts and/or gets for keys matching ``match`` (substring; ""
    matches everything).  ``fail_first`` limits failures to the first N
    matching calls (None = fail forever)."""

    def __init__(self, inner: StorageTier, *, fail_puts: bool = False,
                 fail_gets: bool = False, match: str = "",
                 fail_first: Optional[int] = None):
        super().__init__(inner)
        self.fail_puts = fail_puts
        self.fail_gets = fail_gets
        self.match = match
        self.fail_first = fail_first
        self.failed_puts: list[str] = []
        self.failed_gets: list[str] = []

    def _should_fail(self, key: str, log: list) -> bool:
        if self.match not in key:
            return False
        if self.fail_first is not None and \
                len(self.failed_puts) + len(self.failed_gets) >= self.fail_first:
            return False
        log.append(key)
        return True

    def put(self, key, data):
        if self.fail_puts and self._should_fail(key, self.failed_puts):
            raise IOError(f"injected put failure on {self.info.name}:{key}")
        return self.inner.put(key, data)

    def get(self, key):
        if self.fail_gets and self._should_fail(key, self.failed_gets):
            raise IOError(f"injected get failure on {self.info.name}:{key}")
        return self.inner.get(key)


class CountingTier(WrappedTier):
    """Per-key ``get`` accounting plus a concurrent-get high-water mark.
    The restore-serving tests assert that N concurrent readers cost the
    external tier exactly ONE get per segment/pack blob (shared cache,
    single-flight) and that chain-hop fetches actually overlap.
    ``hold_s`` stretches each get to widen the overlap window."""

    def __init__(self, inner: StorageTier, *, hold_s: float = 0.0):
        super().__init__(inner)
        self.get_counts: dict[str, int] = {}
        self.max_inflight = 0
        self.hold_s = hold_s
        self._inflight = 0
        self._mu = threading.Lock()

    def get(self, key):
        with self._mu:
            self.get_counts[key] = self.get_counts.get(key, 0) + 1
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)
        try:
            if self.hold_s:
                time.sleep(self.hold_s)
            return self.inner.get(key)
        finally:
            with self._mu:
                self._inflight -= 1


class StallingTier(WrappedTier):
    """Blocks ``put`` on an event for keys matching ``match`` — a wedged
    external tier (hung NFS mount, throttled object store) rather than a
    fast-failing one.  ``release()`` un-wedges every blocked and future
    put; ``stalled`` counts puts that hit the wedge."""

    def __init__(self, inner: StorageTier, *, match: str = "",
                 timeout_s: float = 30.0):
        super().__init__(inner)
        self.match = match
        self.timeout_s = timeout_s
        self.stalled: list[str] = []
        self._gate = threading.Event()

    def release(self):
        self._gate.set()

    def put(self, key, data):
        if self.match in key and not self._gate.is_set():
            self.stalled.append(key)
            self._gate.wait(self.timeout_s)
        return self.inner.put(key, data)


class CorruptingTier(WrappedTier):
    """Returns corrupted bytes from ``get`` for keys matching ``match``:
    flips one byte at ``offset`` (from the end when negative).  Storage
    itself is untouched — repeated reads corrupt identically, like real
    bit rot."""

    def __init__(self, inner: StorageTier, *, match: str = "",
                 offset: int = -1,
                 corrupt: Optional[Callable[[bytes], bytes]] = None):
        super().__init__(inner)
        self.match = match
        self.offset = offset
        self.corrupt = corrupt
        self.corrupted_gets: list[str] = []

    def get(self, key):
        blob = self.inner.get(key)
        if blob is None or self.match not in key:
            return blob
        self.corrupted_gets.append(key)
        if self.corrupt is not None:
            return self.corrupt(blob)
        buf = bytearray(blob)
        buf[self.offset] ^= 0xFF
        return bytes(buf)


def wrap_node_tiers(cluster, rank: int, wrapper: Callable[[StorageTier], StorageTier]):
    """Replace every node-local tier of ``rank`` with ``wrapper(tier)``;
    returns the wrappers for inspection."""
    cluster._node_tiers[rank] = [wrapper(t) for t in cluster._node_tiers[rank]]
    return cluster._node_tiers[rank]


def wrap_external_tiers(cluster, wrapper: Callable[[StorageTier], StorageTier]):
    cluster.external_tiers = [wrapper(t) for t in cluster.external_tiers]
    return cluster.external_tiers
