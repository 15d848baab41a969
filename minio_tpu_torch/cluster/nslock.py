"""Namespace locks: per-(bucket, object) mutual exclusion in one process.

The local form of minio_tpu/cluster/nslock.py (cf. nsLockMap,
cmd/namespace-lock.go:224): `ErasureSet` builds an `NSLockMap` and takes
its write lock around every object mutation (PUT, DELETE, multipart
complete, heal), so a heal cannot publish a version that a concurrent PUT
has replaced.  The distributed form over dsync lockers is not ported:
the port runs one process on one node.

A lock that cannot be taken within its deadline raises `LockLost`, a
StorageError, as the JAX package's dsync does (cluster/dsync.py:26).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from ..storage.errors import StorageError
from .dynamic_timeout import DynamicTimeout


class LockLost(StorageError):
    """Lock acquisition timed out.  A StorageError, so callers that
    classify storage errors (heal workers, quorum reduction) treat it as
    a failed operation, not a crash."""


class _LocalRWLock:
    """Writer-preferring in-process RW lock (internal/lsync analogue)."""

    def __init__(self):
        self._mu = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_write(self, timeout: float) -> bool:
        with self._mu:
            self._writers_waiting += 1
            try:
                ok = self._mu.wait_for(
                    lambda: not self._writer and self._readers == 0,
                    timeout=timeout)
                if not ok:
                    return False
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1
                # Readers wait on writers_waiting == 0; a writer that
                # timed out must wake them or they stall needlessly.
                self._mu.notify_all()

    def release_write(self) -> None:
        with self._mu:
            self._writer = False
            self._mu.notify_all()

    def acquire_read(self, timeout: float) -> bool:
        with self._mu:
            ok = self._mu.wait_for(
                lambda: not self._writer and self._writers_waiting == 0,
                timeout=timeout)
            if not ok:
                return False
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._mu:
            self._readers -= 1
            self._mu.notify_all()


class NSLockMap:
    """In-process RW locks keyed by "bucket/object"."""

    def __init__(self):
        # Adaptive lock deadline (cf. dynamicTimeout at NewNSLock call
        # sites, cmd/dynamic-timeouts.go:36): callers that pass no
        # timeout get one tuned from observed outcomes.
        self.acquire_timeout = DynamicTimeout(default_s=10.0,
                                              minimum_s=1.0,
                                              maximum_s=60.0)
        # resource -> [lock, refcount]; an entry goes at refcount 0, so
        # the map does not grow with every key ever touched.
        self._local: dict[str, list] = {}
        self._mu = threading.Lock()

    def _acquire_entry(self, resource: str) -> _LocalRWLock:
        with self._mu:
            entry = self._local.setdefault(resource, [_LocalRWLock(), 0])
            entry[1] += 1
            return entry[0]

    def _release_entry(self, resource: str) -> None:
        with self._mu:
            entry = self._local.get(resource)
            if entry is not None:
                entry[1] -= 1
                if entry[1] <= 0:
                    del self._local[resource]

    @contextmanager
    def _locked(self, resource: str, write: bool, timeout: float | None):
        adaptive = timeout is None
        if adaptive:
            timeout = self.acquire_timeout.timeout()
        t0 = time.monotonic()
        lk = self._acquire_entry(resource)
        try:
            ok = (lk.acquire_write(timeout) if write
                  else lk.acquire_read(timeout))
            if adaptive:
                if ok:
                    self.acquire_timeout.log_success(time.monotonic() - t0)
                else:
                    self.acquire_timeout.log_timeout()
            if not ok:
                raise LockLost(resource)
            try:
                yield
            finally:
                if write:
                    lk.release_write()
                else:
                    lk.release_read()
        finally:
            self._release_entry(resource)

    def write_locked(self, bucket: str, obj: str,
                     timeout: float | None = None):
        """Exclusive lock on bucket/obj; timeout=None uses the adaptive
        deadline."""
        return self._locked(f"{bucket}/{obj}", True, timeout)

    def read_locked(self, bucket: str, obj: str,
                    timeout: float | None = None):
        """Shared lock on bucket/obj."""
        return self._locked(f"{bucket}/{obj}", False, timeout)
