"""Shared-memory slot arenas.

Counterpart of minio_tpu/ops/shm_arena.py (the port keeps its own, so
that it imports nothing of the JAX package).  One anonymous shared
mapping (``mmap(-1)`` is ``MAP_SHARED | MAP_ANONYMOUS``: inherited by
every forked child, no files, no resource-tracker bookkeeping) is cut
into fixed-size slots; callers exchange only ``(offset, nbytes)``
descriptors and take uint8 views of the same bytes.  In the port the
arena backs the host buffer pool (ops/bpool.py), the hot tier's bodies
(engine/hotcache.py) and the worker pool's dispatch plane
(ops/ipc_dispatch.py).  Creating an arena forks nothing and touches no
CUDA state.

Allocation is a first-fit run of fixed-size slots under one fork-shared
lock.  When the arena is full, ``alloc`` BLOCKS (bounded): a flood of
writers slows down instead of corrupting or deadlocking, and a caller
that cannot get a slot within its budget gets ArenaFull and degrades.
Stats (occupancy, high-water, waits, timeouts) live in the shared
header.

Where the port differs from the JAX arena:

- the lock is ops/shm_lock.ShmLock, which a worker SIGKILLed inside it
  does not leave held.  Every allocation records its run length at its
  first slot, written before its bitmap and cleared before it on free,
  so the next locker after a dead holder rebuilds the bitmap, the
  occupancy and the reference and pending counts from the runs
  (`_repair_locked`): nothing stays half-set;
- an allocation may carry an owner, (worker, tag), written under the
  same lock as the run: a dead worker's allocations are then found in
  the arena itself (`reclaim`), including one it made and died before
  recording anywhere else, and a free that names its owner is a no-op
  once the run has been freed (`free(..., owner=)`), so two parties
  that may each free one run free it exactly once.
"""

from __future__ import annotations

import mmap
import os
import threading
import time

import numpy as np

from .shm_lock import ShmLock

#: shared header: i64[8] = in_use_bytes, high_water_bytes, allocs,
#: frees, waits, timeouts, slot_bytes, nslots
_HDR_SLOTS = 8
_HDR_BYTES = _HDR_SLOTS * 8

#: process-local registry of named arenas (see ShmArena.named): the
#: mapping itself is anonymous, so "named" reuse means "same instance
#: within this process tree" — create before fork and every child
#: inherits the one segment under the same name.
_NAMED: dict[str, "ShmArena"] = {}
_NAMED_MU = threading.Lock()


def default_arena_bytes() -> int:
    try:
        mb = int(os.environ.get("MTPU_SHM_ARENA_MB", "256"))
    except ValueError:
        mb = 256
    return max(8, mb) << 20


class ArenaFull(RuntimeError):
    """alloc() exhausted its wait budget — the caller should degrade
    to local/inline work, not die."""


class ShmArena:
    """Slot arena over one anonymous shared mapping.

    Create BEFORE fork; every inheriting process calls alloc/free/view
    on its inherited copy — all state that matters (header, run table,
    owners, bitmap, slot bytes) lives inside the mapping, and the
    allocator lock is a fork-inherited ShmLock.
    """

    def __init__(self, total_bytes: int | None = None,
                 slot_bytes: int = 1 << 20):
        if total_bytes is None:
            total_bytes = default_arena_bytes()
        self.slot_bytes = int(slot_bytes)
        self.nslots = n = max(1, int(total_bytes) // self.slot_bytes)
        # layout: [header][owner tags i64][run lengths i32]
        #         [owner workers i32][refcounts i32][pending-free i32]
        #         [bitmap u8][slots]
        # Runs, owners, refcounts and pending frees live per RUN HEAD:
        # retain() pins an allocation against free() — an evicting writer
        # (the hot cache) cannot reuse slots a reader is still copying
        # out of; the free is deferred and performed by the last
        # release().
        tag_off = _HDR_BYTES
        run_off = tag_off + n * 8
        wid_off = run_off + n * 4
        ref_off = wid_off + n * 4
        pend_off = ref_off + n * 4
        bm_off = pend_off + n * 4
        # Page-align the data region: slot sizes are powers of two, so
        # every slot start is then page-aligned too — a requirement for
        # O_DIRECT readv into pooled scratch (ops/bpool.py).
        self._data_off = -(-(bm_off + n) // mmap.PAGESIZE) * mmap.PAGESIZE
        self._mm = mmap.mmap(-1, self._data_off + n * self.slot_bytes)

        def arr(dtype, off, count):
            return np.frombuffer(self._mm, dtype=dtype, count=count,
                                 offset=off)
        self._hdr = arr(np.int64, 0, _HDR_SLOTS)
        self._tags = arr(np.int64, tag_off, n)
        self._runs = arr(np.int32, run_off, n)
        self._wids = arr(np.int32, wid_off, n)
        self._refs = arr(np.int32, ref_off, n)
        self._pend = arr(np.int32, pend_off, n)
        self._bitmap = arr(np.uint8, bm_off, n)
        self._hdr[6] = self.slot_bytes
        self._hdr[7] = n
        self._cv = ShmLock(on_owner_dead=self._repair_locked)

    @classmethod
    def named(cls, name: str, total_bytes: int | None = None,
              slot_bytes: int = 1 << 20) -> "ShmArena":
        """One arena per name per process tree: the first caller
        creates the segment, later callers (and, after fork, children
        that inherited the module state) get the SAME instance — so
        independent subsystems can agree on a shared segment without
        passing the object through every constructor."""
        with _NAMED_MU:
            a = _NAMED.get(name)
            if a is None:
                a = cls(total_bytes, slot_bytes)
                _NAMED[name] = a
            return a

    # -- allocation ----------------------------------------------------------

    def _find_run_locked(self, want: int) -> int:
        """First run of `want` free slots, or -1."""
        bm = self._bitmap
        run = 0
        for i in range(self.nslots):
            if bm[i]:
                run = 0
            else:
                run += 1
                if run == want:
                    return i - want + 1
        return -1

    def _first(self, offset: int) -> int:
        return (int(offset) - self._data_off) // self.slot_bytes

    def alloc(self, nbytes: int, timeout: float | None = 5.0,
              owner: tuple[int, int] | None = None) -> int:
        """Reserve `nbytes` of contiguous arena space; returns the byte
        offset (pass it to view()/free()).  Blocks while the arena is
        full, up to `timeout` — then raises ArenaFull (backpressure,
        then degrade; never deadlock).  `owner` = (worker, tag), worker
        > 0, is recorded with the run under the same lock."""
        want = max(1, -(-int(nbytes) // self.slot_bytes))
        if want > self.nslots:
            raise ArenaFull(
                f"request {nbytes}B exceeds arena "
                f"({self.nslots * self.slot_bytes}B)")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            first = self._find_run_locked(want)
            waited = False
            while first < 0:
                waited = True
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    self._hdr[5] += 1       # timeouts
                    raise ArenaFull(
                        f"arena full ({want} slot(s) wanted)")
                self._cv.wait(timeout=(0.25 if left is None
                                       else min(left, 0.25)))
                first = self._find_run_locked(want)
            # The run's record first, its bitmap after: a holder killed
            # in between leaves a run the repair completes.
            w, tag = owner if owner is not None else (0, 0)
            self._tags[first] = tag
            self._wids[first] = w
            self._runs[first] = want
            self._bitmap[first:first + want] = 1
            self._hdr[0] += want * self.slot_bytes
            if self._hdr[0] > self._hdr[1]:
                self._hdr[1] = self._hdr[0]
            self._hdr[2] += 1
            if waited:
                self._hdr[4] += 1
        return self._data_off + first * self.slot_bytes

    def _free_locked(self, first: int) -> None:
        # The record first, the bitmap after: a holder killed in between
        # leaves set bits of no run, which the repair clears.
        want = int(self._runs[first])
        self._runs[first] = 0
        self._wids[first] = 0
        self._tags[first] = 0
        self._pend[first] = 0
        self._bitmap[first:first + want] = 0
        self._hdr[0] -= want * self.slot_bytes
        self._hdr[3] += 1
        self._cv.notify_all()

    def _owned_locked(self, first: int, owner) -> bool:
        if not int(self._runs[first]):
            return False
        return owner is None or \
            (int(self._wids[first]), int(self._tags[first])) == tuple(owner)

    def free(self, offset: int, nbytes: int,
             owner: tuple[int, int] | None = None) -> bool:
        """Release an allocation.  If a reader still holds a retain()
        on it, the free is DEFERRED: the slots stay marked in-use until
        the last release() performs the actual bitmap clear (so the
        reader's view never gets reused under it).  With `owner`, only
        a run that still carries that owner is freed: False when it was
        freed already (and perhaps allocated again)."""
        first = self._first(offset)
        with self._cv:
            if not self._owned_locked(first, owner):
                return False
            if self._refs[first] > 0:
                self._pend[first] = 1
                return True
            self._free_locked(first)
            return True

    def owner_of(self, offset: int) -> tuple[int, int]:
        """(worker, tag) of the run at `offset`; (0, 0) once it is free
        (or for a run made without an owner).  Reads without the lock:
        a tag only changes under it, and a stale read is re-made."""
        first = self._first(offset)
        if not int(self._runs[first]):
            return 0, 0
        return int(self._wids[first]), int(self._tags[first])

    def reclaim(self, worker: int, keep) -> int:
        """Free every run owned by `worker` whose tag `keep(tag)` does
        not claim: a respawned worker frees what its dead predecessor
        allocated and never handed on.  Returns the runs freed."""
        n = 0
        with self._cv:
            for first in np.nonzero(self._wids == worker)[0].tolist():
                if int(self._runs[first]) and \
                        not keep(int(self._tags[first])):
                    self._free_locked(first)
                    n += 1
        return n

    def free_unpinned(self) -> int:
        """Free every run no reader pins and defer the pinned ones: for
        a sole user whose index of the runs was lost (the hot tier after
        a dead holder).  Returns the runs freed."""
        n = 0
        with self._cv:
            for first in np.nonzero(self._runs)[0].tolist():
                if self._refs[first] > 0:
                    self._pend[first] = 1
                else:
                    self._free_locked(first)
                    n += 1
        return n

    def _repair_locked(self) -> None:
        """A holder died inside the lock: rebuild what it may have left
        half-set from the run table — the bitmap (a run's slots, nothing
        else), the occupancy, stray reference and pending counts — and
        finish a deferred free whose last release it did not complete.
        Runs it owned stay allocated: their owner's successor (or the
        tier's own repair) frees them."""
        heads = np.nonzero(self._runs)[0]
        bm = np.zeros(self.nslots, dtype=np.uint8)
        for first in heads.tolist():
            bm[first:first + int(self._runs[first])] = 1
        self._bitmap[:] = bm
        idle = self._runs == 0
        self._refs[idle] = 0
        self._pend[idle] = 0
        self._hdr[0] = int(bm.sum()) * self.slot_bytes
        self._hdr[1] = max(int(self._hdr[1]), int(self._hdr[0]))
        for first in heads.tolist():
            if self._pend[first] and self._refs[first] <= 0:
                self._free_locked(first)
        self._cv.notify_all()

    @property
    def repairs(self) -> int:
        """Times a locker of this arena found its holder dead."""
        return self._cv.repairs

    # -- per-entry refcounts (in-flight reader protection) -------------------

    def retain(self, offset: int) -> None:
        """Pin an allocation against free(): the caller may copy bytes
        out of view() without holding any higher-level lock."""
        first = self._first(offset)
        with self._cv:
            self._refs[first] += 1

    def release(self, offset: int) -> None:
        """Drop a retain(); the last release performs any free() that
        was deferred while the allocation was pinned."""
        first = self._first(offset)
        with self._cv:
            if self._refs[first] > 0:
                self._refs[first] -= 1
            if self._refs[first] == 0 and self._pend[first]:
                self._free_locked(first)

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        """uint8 view of an allocated range — zero-copy in every
        process that inherited the mapping."""
        return np.frombuffer(self._mm, dtype=np.uint8,
                             count=int(nbytes), offset=int(offset))

    def reset(self) -> None:
        """Drop every allocation (supervisor-only: called between
        owner generations when no worker holds a live slot)."""
        with self._cv:
            self._runs[:] = 0
            self._wids[:] = 0
            self._tags[:] = 0
            self._bitmap[:] = 0
            self._refs[:] = 0
            self._pend[:] = 0
            self._hdr[0] = 0
            self._cv.notify_all()

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        h = self._hdr
        return {
            "arena_bytes": self.nslots * self.slot_bytes,
            "in_use_bytes": int(h[0]),
            "high_water_bytes": int(h[1]),
            "allocs": int(h[2]),
            "frees": int(h[3]),
            "alloc_waits": int(h[4]),
            "alloc_timeouts": int(h[5]),
        }
