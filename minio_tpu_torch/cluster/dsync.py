"""Copy of minio_tpu/cluster/dsync.py: the port keeps its own, so that it
imports nothing of the JAX package.

dsync: quorum-based distributed read-write mutex.

The internal/dsync equivalent (reference internal/dsync/drwmutex.go:64):
a lock is acquired by broadcasting to ALL lockers in the set and winning a
quorum — n/2+1 for writes, n/2 for reads (tolerance math :375); losers
release everything and retry with jitter until the deadline. A held lock
is kept alive by a background refresh loop; losing refresh quorum fires
the loss callback so the owning operation can cancel
(cf. startContinousLockRefresh :221).

Lockers implement the LocalLocker surface; remote ones go through
rpc.lock_rpc.RemoteLocker. Transport failures count as vote-no, exactly
like the reference treats an unreachable lock server.
"""

from __future__ import annotations

import random
import threading
import time
import uuid

from ..storage.errors import StorageError


class LockLost(StorageError):
    """Lock acquisition timed out or quorum was lost mid-operation.
    Subclasses StorageError so handler-level `except StorageError` paths
    map it to a retryable 503 (api_errors.from_storage_error); the local
    namespace lock (cluster/nslock.py) raises it too."""


class DRWMutex:
    def __init__(self, resource: str, lockers: list, *,
                 refresh_interval: float = 10.0,
                 lease_duration: float | None = None,
                 loss_callback=None):
        self.resource = resource
        self.lockers = lockers
        self.refresh_interval = refresh_interval
        # Lease contract (cf. drwmutex.go refresh + local-locker stale
        # sweep): a holder that cannot REACH refresh quorum within
        # lease_duration must consider the lock lost — by then a
        # partitioned majority may have stale-swept its entry and
        # granted the lock to someone else, so acking work under the
        # old grant could conflict.  The default (2.5 intervals) keeps
        # the lease safely under LocalLocker's 30s stale_after at the
        # default 10s refresh: the holder gives up BEFORE the survivors
        # hand out the resource.
        self.lease_duration = (lease_duration
                               if lease_duration is not None
                               else refresh_interval * 2.5)
        self.loss_callback = loss_callback
        self.uid = uuid.uuid4().hex
        self._held: str | None = None          # "w" | "r" | None
        self._mode: str | None = None          # sticky: what we acquired
        self._lease_ok_at = 0.0    # monotonic time of last quorum ack
        self._stop_refresh = threading.Event()
        self._refresh_thread: threading.Thread | None = None

    # -- quorum math (cf. drwmutex.go: write n/2+1, read n/2) ---------------

    @property
    def write_quorum(self) -> int:
        return len(self.lockers) // 2 + 1

    @property
    def read_quorum(self) -> int:
        return max(len(self.lockers) // 2, 1)

    # -- acquire -------------------------------------------------------------

    def _broadcast(self, op: str) -> int:
        votes = 0
        for lk in self.lockers:
            try:
                if getattr(lk, op)(self.resource, self.uid):
                    votes += 1
            except Exception:  # noqa: BLE001 — unreachable locker = no vote
                continue
        return votes

    def _release_all(self, op: str) -> None:
        for lk in self.lockers:
            try:
                getattr(lk, op)(self.resource, self.uid)
            except Exception:  # noqa: BLE001
                continue

    def _acquire(self, op: str, unop: str, quorum: int,
                 timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            votes = self._broadcast(op)
            if votes >= quorum:
                return True
            # Lost the election: release our partial votes so competing
            # acquirers aren't deadlocked on fragments.
            self._release_all(unop)
            if time.monotonic() >= deadline:
                return False
            attempt += 1
            time.sleep(min(0.05 * attempt, 0.5) * (0.5 + random.random()))

    def get_lock(self, timeout: float = 10.0) -> bool:
        if self._acquire("lock", "unlock", self.write_quorum, timeout):
            self._held = self._mode = "w"
            self._lease_ok_at = time.monotonic()
            self._start_refresh()
            return True
        return False

    def get_rlock(self, timeout: float = 10.0) -> bool:
        if self._acquire("rlock", "runlock", self.read_quorum, timeout):
            self._held = self._mode = "r"
            self._lease_ok_at = time.monotonic()
            self._start_refresh()
            return True
        return False

    # -- lease validity ------------------------------------------------------

    def lease_expired(self) -> bool:
        """Whether the holder's lease has run out: no refresh quorum ack
        within lease_duration.  A partitioned holder whose refresh
        rounds hang (black-holed lockers stall each round for the full
        transport timeout) trips this even before the refresh loop
        counts a failed round — the ack gate the operation checks
        BEFORE acknowledging its result."""
        return (self._held is not None
                and time.monotonic() - self._lease_ok_at
                > self.lease_duration)

    def is_held(self) -> bool:
        """Held AND lease-valid — the only state in which an operation
        may ack work done under this lock."""
        return self._held is not None and not self.lease_expired()

    # -- release -------------------------------------------------------------

    def unlock(self) -> None:
        """Release on every locker — even after a refresh-quorum loss
        (minority lockers may still hold our vote; leaving it would wedge
        them until the stale sweep)."""
        self._stop_refresh.set()
        if self._mode == "w":
            self._release_all("unlock")
        elif self._mode == "r":
            self._release_all("runlock")
        self._held = self._mode = None

    # -- refresh loop --------------------------------------------------------

    def _start_refresh(self) -> None:
        self._stop_refresh.clear()
        quorum = self.write_quorum if self._held == "w" else self.read_quorum

        def loop():
            while not self._stop_refresh.wait(self.refresh_interval):
                votes = 0
                for lk in self.lockers:
                    try:
                        if lk.refresh(self.resource, self.uid):
                            votes += 1
                    except Exception:  # noqa: BLE001
                        continue
                if votes >= quorum and not self.lease_expired():
                    # Quorum ack within the lease window: renew.  A
                    # quorum that only arrived AFTER the lease ran out
                    # does NOT resurrect it — the survivors may already
                    # have stale-swept us and granted the lock onward.
                    self._lease_ok_at = time.monotonic()
                    continue
                self._held = None
                if self.loss_callback is not None:
                    self.loss_callback(self.resource)
                return

        self._refresh_thread = threading.Thread(target=loop, daemon=True)
        self._refresh_thread.start()

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "DRWMutex":
        if not self.get_lock():
            raise LockLost(f"could not lock {self.resource}")
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()
