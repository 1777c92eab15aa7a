"""Fault-injection tier wrappers for failure-scenario tests of the port
(``repro_torch``): the part of ``tests/helpers.py`` that the port's tests
use, over the port's ``StorageTier``.

``StallingTier`` blocks ``put`` on demand (a wedged external tier); it
delegates everything else to the wrapped tier, so it drops into a built
``Cluster`` in place of any ``StorageTier``.
"""
from __future__ import annotations

import threading
from typing import Callable

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


def wrap_external_tiers(cluster, wrapper: Callable[[StorageTier], StorageTier]):
    cluster.external_tiers = [wrapper(t) for t in cluster.external_tiers]
    return cluster.external_tiers
