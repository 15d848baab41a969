"""Copy of minio_tpu/cluster/local_locker.py: the port keeps its own, so
that it imports nothing of the JAX package.

In-memory lock table — one per node (cmd/local-locker.go equivalent).

Tracks write/read locks per resource with owner uids and last-refresh
timestamps; locks whose owner stops refreshing go stale and are swept so
a crashed client can't wedge the namespace
(cf. stale-lock force release, internal/dsync/drwmutex.go:256).
"""

from __future__ import annotations

import threading
import time


class LocalLocker:
    def __init__(self, stale_after: float = 30.0):
        self._mu = threading.Lock()
        # resource -> {"writer": uid|None, "readers": {uid: refresh_ts},
        #              "wts": refresh_ts}
        self._table: dict[str, dict] = {}
        self.stale_after = stale_after

    def _entry(self, resource: str) -> dict:
        return self._table.setdefault(
            resource, {"writer": None, "readers": {}, "wts": 0.0})

    def _sweep(self, e: dict) -> None:
        now = time.monotonic()
        if e["writer"] is not None and now - e["wts"] > self.stale_after:
            e["writer"] = None
        e["readers"] = {uid: ts for uid, ts in e["readers"].items()
                        if now - ts < self.stale_after}

    # -- NetLocker surface ---------------------------------------------------

    def lock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._entry(resource)
            self._sweep(e)
            if e["writer"] is not None or e["readers"]:
                return e["writer"] == uid      # re-entrant refresh-as-lock
            e["writer"] = uid
            e["wts"] = time.monotonic()
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._table.get(resource)
            if e is None or e["writer"] != uid:
                return False
            e["writer"] = None
            return True

    def rlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._entry(resource)
            self._sweep(e)
            if e["writer"] is not None:
                return False
            e["readers"][uid] = time.monotonic()
            return True

    def runlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._table.get(resource)
            if e is None or uid not in e["readers"]:
                return False
            del e["readers"][uid]
            return True

    def refresh(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._table.get(resource)
            if e is None:
                return False
            now = time.monotonic()
            if e["writer"] == uid:
                e["wts"] = now
                return True
            if uid in e["readers"]:
                e["readers"][uid] = now
                return True
            return False

    def force_unlock(self, resource: str) -> bool:
        with self._mu:
            self._table.pop(resource, None)
            return True

    def stats(self) -> dict:
        with self._mu:
            return {"resources": len(self._table),
                    "write_locked": sum(1 for e in self._table.values()
                                        if e["writer"] is not None)}
