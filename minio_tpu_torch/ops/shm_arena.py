"""Copy of minio_tpu/ops/shm_arena.py: the port keeps its own, so that it
imports nothing of the JAX package.

Shared-memory slot arenas.  One anonymous shared mapping (``mmap(-1)``
is ``MAP_SHARED | MAP_ANONYMOUS``: inherited by every forked child, no
files, no resource-tracker bookkeeping) is cut into fixed-size slots;
callers exchange only ``(offset, nbytes)`` descriptors and take uint8
views of the same bytes.  In the port the arena backs the host buffer
pool (ops/bpool.py) within one process; named arenas shared with forked
worker processes serve the cross-process front end (ROADMAP Queue A
item 6.1).  Creating an arena forks nothing and touches no CUDA state.

Allocation is a first-fit run of fixed-size slots under one lock (a
``multiprocessing`` lock, so a forked child shares it).  When the arena
is full, ``alloc`` BLOCKS (bounded): a flood of writers slows down
instead of corrupting or deadlocking, and a caller that cannot get a
slot within its budget gets ArenaFull and degrades.  Stats (occupancy,
high-water, waits, timeouts) live in the shared header.
"""

from __future__ import annotations

import mmap
import multiprocessing
import os
import threading
import time

import numpy as np

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
    on its inherited copy — all state that matters (header, bitmap,
    slot bytes) lives inside the mapping, and the allocator lock is a
    fork-inherited ``multiprocessing`` primitive.
    """

    def __init__(self, total_bytes: int | None = None,
                 slot_bytes: int = 1 << 20):
        if total_bytes is None:
            total_bytes = default_arena_bytes()
        self.slot_bytes = int(slot_bytes)
        self.nslots = max(1, int(total_bytes) // self.slot_bytes)
        # layout: [header][bitmap nslots bytes][refcounts int32]
        #         [pending-free int32][slots]
        # Refcounts/pending live per RUN HEAD: retain() pins an
        # allocation against free() — an evicting writer (the hot
        # cache) cannot reuse slots a reader is still copying out of;
        # the free is deferred and performed by the last release().
        self._ref_off = _HDR_BYTES + self.nslots
        self._pend_off = self._ref_off + self.nslots * 4
        # Page-align the data region: slot sizes are powers of two, so
        # every slot start is then page-aligned too — a requirement for
        # O_DIRECT readv into pooled scratch (ops/bpool.py).
        self._data_off = -(-(self._pend_off + self.nslots * 4)
                           // mmap.PAGESIZE) * mmap.PAGESIZE
        self._mm = mmap.mmap(-1, self._data_off
                             + self.nslots * self.slot_bytes)
        self._hdr = np.frombuffer(self._mm, dtype=np.int64,
                                  count=_HDR_SLOTS)
        self._bitmap = np.frombuffer(self._mm, dtype=np.uint8,
                                     count=self.nslots, offset=_HDR_BYTES)
        self._refs = np.frombuffer(self._mm, dtype=np.int32,
                                   count=self.nslots,
                                   offset=self._ref_off)
        self._pend = np.frombuffer(self._mm, dtype=np.int32,
                                   count=self.nslots,
                                   offset=self._pend_off)
        self._hdr[6] = self.slot_bytes
        self._hdr[7] = self.nslots
        ctx = multiprocessing.get_context("fork")
        self._cv = ctx.Condition(ctx.Lock())

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

    def alloc(self, nbytes: int, timeout: float | None = 5.0) -> int:
        """Reserve `nbytes` of contiguous arena space; returns the byte
        offset (pass it to view()/free()).  Blocks while the arena is
        full, up to `timeout` — then raises ArenaFull (backpressure,
        then degrade; never deadlock)."""
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
            self._bitmap[first:first + want] = 1
            self._hdr[0] += want * self.slot_bytes
            if self._hdr[0] > self._hdr[1]:
                self._hdr[1] = self._hdr[0]
            self._hdr[2] += 1
            if waited:
                self._hdr[4] += 1
        return self._data_off + first * self.slot_bytes

    def _free_locked(self, first: int, want: int) -> None:
        self._bitmap[first:first + want] = 0
        self._hdr[0] -= want * self.slot_bytes
        self._hdr[3] += 1
        self._cv.notify_all()

    def free(self, offset: int, nbytes: int) -> None:
        """Release an allocation.  If a reader still holds a retain()
        on it, the free is DEFERRED: the slots stay marked in-use until
        the last release() performs the actual bitmap clear (so the
        reader's view never gets reused under it)."""
        first = (int(offset) - self._data_off) // self.slot_bytes
        want = max(1, -(-int(nbytes) // self.slot_bytes))
        with self._cv:
            if self._refs[first] > 0:
                self._pend[first] = want
                return
            self._free_locked(first, want)

    # -- per-entry refcounts (in-flight reader protection) -------------------

    def retain(self, offset: int) -> None:
        """Pin an allocation against free(): the caller may copy bytes
        out of view() without holding any higher-level lock."""
        first = (int(offset) - self._data_off) // self.slot_bytes
        with self._cv:
            self._refs[first] += 1

    def release(self, offset: int) -> None:
        """Drop a retain(); the last release performs any free() that
        was deferred while the allocation was pinned."""
        first = (int(offset) - self._data_off) // self.slot_bytes
        with self._cv:
            if self._refs[first] > 0:
                self._refs[first] -= 1
            if self._refs[first] == 0 and self._pend[first]:
                want = int(self._pend[first])
                self._pend[first] = 0
                self._free_locked(first, want)

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        """uint8 view of an allocated range — zero-copy in every
        process that inherited the mapping."""
        return np.frombuffer(self._mm, dtype=np.uint8,
                             count=int(nbytes), offset=int(offset))

    def reset(self) -> None:
        """Drop every allocation (supervisor-only: called between
        owner generations when no worker holds a live slot)."""
        with self._cv:
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
