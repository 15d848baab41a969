"""Namespace locks: per-(bucket, object) mutual exclusion across the
processes of one node, or across the nodes of a cluster.

Counterpart of minio_tpu/cluster/nslock.py (cf. nsLockMap,
cmd/namespace-lock.go:224): `ErasureSet` builds an `NSLockMap` and takes
its write lock around every object mutation (PUT, DELETE, multipart
complete, heal), so a heal cannot publish a version that a concurrent PUT
has replaced.  `NSLockMap(lockers=[...])` is the distributed form: each
lock is a cluster/dsync.DRWMutex over one locker per node (this node's
LocalLocker, the peers' through rpc/lock_rpc.RemoteLocker), as a cluster
node builds it (server/cluster.py); a lock whose refresh lost quorum
while the operation ran raises LockLost after it.  Without lockers it
is the local form below.

The port runs one process or, under MTPU_WORKERS=N, a pool of forked
workers that each open their own drives (server/workers.py).  An
in-process lock alone would let two workers interleave their
read-modify-writes of one key's xl.meta and lose an acknowledged
version (the JAX pool does).  So under each key's in-process RW lock a
write also holds the key's stripe of a fork-shared table
(`StripeTable`): one ops/shm_lock.ShmLock over rows of (holder pid, its
start time, holds).  Reads take no stripe: a publish is a rename, and a
read sees the old xl.meta or the new one.

- A stripe is held by a process, not a thread: two threads of one
  process writing two keys of one stripe both go on (the RW locks keep
  each key exclusive), so a thread that takes two keys of one stripe
  (copy, multipart complete) cannot wait on itself.  Another process
  waits until the stripe's holds drop to 0, up to the write's deadline
  (LockLost).
- A process killed while it holds a stripe leaves a row naming a dead
  pid: a waiter finds it dead (/proc says gone, a zombie, or another
  start time) and takes the stripe.  A process killed inside the table's
  lock leaves nothing half-set that matters: the next locker clears the
  rows of dead holders.
- The table is made before the pool forks (`shared_stripes()`, which
  the supervisor calls; one process makes it on first use).

A lock that cannot be taken within its deadline raises `LockLost`, a
StorageError (cluster/dsync.py, as in the JAX package).
"""

from __future__ import annotations

import mmap
import os
import threading
import time
import zlib
from contextlib import contextmanager

import numpy as np

from ..ops.shm_lock import ShmLock
from .dsync import DRWMutex, LockLost
from .dynamic_timeout import DynamicTimeout

#: stripes of the shared table: a write of one key waits only on writes,
#: in other processes, of keys of its stripe
STRIPES = 1024


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


def _start_ticks(pid: int) -> int | None:
    """The process's start time in clock ticks (field 22 of
    /proc/<pid>/stat), or None when it is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return None
    fields = stat[stat.rindex(b")") + 2:].split()
    if fields[0] in (b"Z", b"X"):
        return None
    return int(fields[19])


_SELF: tuple[int, int] = (0, 0)


def _self_ident() -> tuple[int, int]:
    """(pid, start ticks) of this process, made again after a fork."""
    global _SELF
    pid = os.getpid()
    if _SELF[0] != pid:
        _SELF = (pid, _start_ticks(pid) or 0)
    return _SELF


class StripeTable:
    """Fork-shared stripes of (holder pid, its start ticks, holds) under
    one robust lock; a waiter sleeps on the lock's condition and looks
    at the holder's liveness every 50 ms."""

    def __init__(self, nstripes: int = STRIPES):
        self.nstripes = int(nstripes)
        self._mm = mmap.mmap(-1, self.nstripes * 3 * 8)
        self._rows = np.frombuffer(self._mm, dtype=np.int64).reshape(
            self.nstripes, 3)
        self._lock = ShmLock(on_owner_dead=self._repair_locked)

    def stripe(self, resource: str) -> int:
        return zlib.crc32(resource.encode()) % self.nstripes

    def _repair_locked(self) -> None:
        """A process died inside the table's lock: drop the rows of every
        holder that is gone (a live holder's row stays whole: it changes
        only under this lock, one field at a time, and a row whose pid is
        set names a holder)."""
        for s in np.nonzero(self._rows[:, 0])[0].tolist():
            pid, ticks, _ = (int(v) for v in self._rows[s])
            if _start_ticks(pid) != ticks:
                self._rows[s] = 0

    def acquire(self, resource: str, timeout: float) -> bool:
        s = self.stripe(resource)
        pid, ticks = _self_ident()
        deadline = time.monotonic() + timeout
        rows = self._rows
        if not self._lock.acquire(timeout=timeout):
            return False
        try:
            while True:
                holder = int(rows[s, 0])
                if holder and holder != pid and \
                        _start_ticks(holder) != int(rows[s, 1]):
                    rows[s] = 0             # its holder died holding it
                    holder = 0
                if holder == 0:
                    rows[s, 2] = 0
                    rows[s, 1] = ticks
                    rows[s, 0] = pid
                if holder in (0, pid):
                    rows[s, 2] += 1
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._lock.wait(min(left, 0.05))
        finally:
            self._lock.release()

    def release(self, resource: str) -> None:
        s = self.stripe(resource)
        with self._lock:
            if int(self._rows[s, 0]) != _self_ident()[0]:
                return
            self._rows[s, 2] -= 1
            if self._rows[s, 2] <= 0:
                self._rows[s] = 0
                self._lock.notify_all()


_STRIPES: StripeTable | None = None
_STRIPES_MU = threading.Lock()


def shared_stripes() -> StripeTable:
    """The process tree's stripe table: the pool's supervisor makes it
    before it forks, so every worker locks the same one; a single
    process makes it on first use."""
    global _STRIPES
    with _STRIPES_MU:
        if _STRIPES is None:
            _STRIPES = StripeTable()
        return _STRIPES


class NSLockMap:
    """RW locks keyed by "bucket/object": in-process RW locks, and for a
    write the key's stripe of the fork-shared `StripeTable`; or, with
    `lockers`, dsync mutexes over them."""

    def __init__(self, stripes: StripeTable | None = None,
                 lockers: list | None = None):
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
        self.lockers = lockers
        self.stripes = (None if lockers is not None else
                        stripes if stripes is not None else shared_stripes())

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
    def _dist_locked(self, resource: str, write: bool, timeout: float,
                     adaptive: bool):
        t0 = time.monotonic()
        lost = threading.Event()
        dm = DRWMutex(resource, self.lockers,
                      loss_callback=lambda r: lost.set())
        ok = dm.get_lock(timeout) if write else dm.get_rlock(timeout)
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
            # The lease is sampled before unlock clears the held state:
            # a holder whose refresh never reached quorum within the
            # lease must not acknowledge, even before the loss callback.
            expired = dm.lease_expired()
            dm.unlock()
        if lost.is_set() or expired:
            raise LockLost(f"{resource}: lock lost during operation")

    @contextmanager
    def _locked(self, resource: str, write: bool, timeout: float | None):
        adaptive = timeout is None
        if adaptive:
            timeout = self.acquire_timeout.timeout()
        if self.lockers is not None:
            with self._dist_locked(resource, write, timeout, adaptive):
                yield
            return
        t0 = time.monotonic()
        lk = self._acquire_entry(resource)
        try:
            ok = (lk.acquire_write(timeout) if write
                  else lk.acquire_read(timeout))
            if ok and write:
                # Under the key's own lock, the cross-process stripe,
                # within what is left of the deadline.
                left = max(0.0, timeout - (time.monotonic() - t0))
                if not self.stripes.acquire(resource, left):
                    lk.release_write()
                    ok = False
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
                    self.stripes.release(resource)
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
