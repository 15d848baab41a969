"""Copy of minio_tpu/ops/ipc_ring.py: the port keeps its own, so that it
imports nothing of the JAX package.

Fixed-record shared-memory ring for cross-process dispatch descriptors.

The shard bytes themselves live in the ShmArena (ops/shm_arena.py);
what crosses the process boundary per work item is one 64-byte
descriptor.  The ring is a bounded MPMC queue over an anonymous shared
mapping created before fork:

  * records are fixed-size (64 B) so producers and consumers never
    frame-parse — slot i is at i * REC;
  * two fork-inherited semaphores carry the item/space counts (blocking
    put/get with timeouts, no busy polling);
  * two locks serialize multi-producer tails and multi-consumer heads
    (the worker pool has N producers on the request ring and one
    consumer; response rings are 1:1).

The descriptor schema is owned by the callers (ops/coalesce.py's
remote front end packs/unpacks with struct); the ring moves opaque
64-byte records.
"""

from __future__ import annotations

import mmap
import multiprocessing

import numpy as np

REC = 64                           # bytes per record
_HDR = 16                          # head u64 + tail u64


class RingClosed(RuntimeError):
    pass


class ShmRing:
    """Bounded MPMC ring of fixed 64-byte records over fork-shared
    anonymous memory.  Create pre-fork; use from any inheriting
    process."""

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._mm = mmap.mmap(-1, _HDR + self.capacity * REC)
        self._idx = np.frombuffer(self._mm, dtype=np.uint64, count=2)
        ctx = multiprocessing.get_context("fork")
        self._items = ctx.Semaphore(0)
        self._space = ctx.Semaphore(self.capacity)
        self._pmu = ctx.Lock()      # producers (tail)
        self._cmu = ctx.Lock()      # consumers (head)

    def put(self, rec: bytes, timeout: float | None = None) -> bool:
        """Append one record; False on timeout (ring full)."""
        if len(rec) > REC:
            raise ValueError(f"record {len(rec)}B > {REC}B")
        if not self._space.acquire(timeout=timeout):
            return False
        rec = rec.ljust(REC, b"\x00")
        with self._pmu:
            tail = int(self._idx[1])
            off = _HDR + (tail % self.capacity) * REC
            self._mm[off:off + REC] = rec
            self._idx[1] = tail + 1
        self._items.release()
        return True

    def get(self, timeout: float | None = None) -> bytes | None:
        """Pop the oldest record; None on timeout (ring empty)."""
        if not self._items.acquire(timeout=timeout):
            return None
        with self._cmu:
            head = int(self._idx[0])
            off = _HDR + (head % self.capacity) * REC
            rec = bytes(self._mm[off:off + REC])
            self._idx[0] = head + 1
        self._space.release()
        return rec

    def drain(self) -> list[bytes]:
        """Non-blocking: pop everything currently queued (a respawned
        worker clears stale responses addressed to its predecessor)."""
        out = []
        while True:
            rec = self.get(timeout=0)
            if rec is None:
                return out
            out.append(rec)

    def depth(self) -> int:
        """Approximate queue depth (lock-free gauge read)."""
        return max(0, int(self._idx[1]) - int(self._idx[0]))
