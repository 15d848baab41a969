"""Copy of minio_tpu/ops/bpool.py: the port keeps its own, so that it
imports nothing of the JAX package.

Recycling pool of page-aligned host scratch buffers (internal/bpool
role).  The reference keeps a capped pool of aligned byte slabs
(internal/bpool/bpool.go) so the O_DIRECT read/write path and the
erasure pipeline reuse scratch instead of allocating per request.  Ours
layers leases on a ShmArena (ops/shm_arena.py): one named arena per
process tree holds the slabs, a lease pins a page-aligned uint8 view,
and release returns the run for immediate reuse.  Its users are the
PUT ingest ring (utils/streams.batched_chunks) and the O_DIRECT read
scratch (storage/diskio._direct_read).  This is host memory only: the
coalescer's pinned staging for copies to the card (ops/coalesce.py) is
its own.

Lifetime discipline: leases are explicitly released (context manager
or .release()); a leaked lease is reclaimed by a weakref.finalize
backstop when its view dies, so a raising caller cannot wedge the
arena.  When the arena is momentarily full the pool degrades to a
plain page-aligned anonymous mmap (counted as a fallback); callers
never block on scratch.

Knobs: MTPU_BPOOL=0 kills the pool (every get is a fallback
allocation: the no-pooling oracle); MTPU_BPOOL_MB sizes the arena
(default 32).  `stats()` reports the pool's counters.
"""

from __future__ import annotations

import collections
import mmap
import os
import threading
import weakref

import numpy as np

from .shm_arena import ArenaFull, ShmArena

#: ShmArena slot granularity for scratch runs: O_DIRECT scratch is a
#: few hundred KiB (BULK-sized reads), verify sweeps lease frame
#: batches — 64 KiB slots keep waste low without bloating the bitmap.
_SLOT = 64 << 10

_POOL: "BufferPool | None" = None
_POOL_MU = threading.Lock()


def bpool_enabled() -> bool:
    return os.environ.get("MTPU_BPOOL", "1") != "0"


def bpool_bytes() -> int:
    try:
        mb = int(os.environ.get("MTPU_BPOOL_MB", "32"))
    except ValueError:
        mb = 32
    return max(1, mb) << 20


class Lease:
    """One pinned scratch run: `.view` is a page-aligned uint8 ndarray
    of exactly the requested length.  Release early; finalize is only
    the leak backstop.

    The backstop must never take the arena lock: finalizers run in GC
    context, and cyclic collection can fire while THIS thread already
    holds the arena's condition variable (a non-reentrant fork-shared
    lock).  So `backstop` is a lock-free deque append; the pool drains
    the queue on its next get()."""

    __slots__ = ("view", "_release", "_fin", "__weakref__")

    def __init__(self, view: np.ndarray, release,
                 backstop=None) -> None:
        self.view = view
        self._release = release
        self._fin = (weakref.finalize(self, backstop)
                     if backstop is not None else None)

    def release(self) -> None:
        if self._fin is not None:
            self._fin.detach()
            self._fin = None
        rel, self._release = self._release, None
        if rel is not None:
            rel()
        self.view = None

    def __enter__(self) -> np.ndarray:
        return self.view

    def __exit__(self, *exc) -> None:
        self.release()


class BufferPool:
    """Aligned-scratch lease pool over one ShmArena segment."""

    def __init__(self, total_bytes: int | None = None):
        # An explicit size means the caller wants THAT bound honoured,
        # so it gets a private segment; the default shares one named
        # segment per process tree (ShmArena.named ignores the size of
        # every caller after the first).
        if total_bytes is None:
            self.arena = ShmArena.named("bpool", bpool_bytes(),
                                        slot_bytes=_SLOT)
        else:
            self.arena = ShmArena(total_bytes, slot_bytes=_SLOT)
        self._mu = threading.Lock()
        #: (off, nbytes) runs whose lease died unreleased — freed on
        #: the next get() (see Lease docstring for why not in-place).
        self._leaked: collections.deque = collections.deque()
        self.gets = 0
        self.fallbacks = 0
        self.released = 0
        self.leak_reclaims = 0

    def _drain_leaked(self) -> None:
        dq = self._leaked
        while dq:
            try:
                off, n = dq.popleft()
            except IndexError:
                break
            self.arena.free(off, n)
            with self._mu:
                self.leak_reclaims += 1

    def get(self, nbytes: int) -> Lease:
        """Lease `nbytes` of page-aligned scratch.  Pool off or arena
        momentarily full -> private anonymous mmap (never blocks)."""
        nbytes = int(nbytes)
        self._drain_leaked()
        with self._mu:
            self.gets += 1
        if bpool_enabled() and nbytes <= self.arena.nslots * _SLOT:
            try:
                off = self.arena.alloc(nbytes, timeout=0)
            except ArenaFull:
                pass
            else:
                view = self.arena.view(off, nbytes)

                def _rel(arena=self.arena, off=off, n=nbytes,
                         pool=self):
                    arena.free(off, n)
                    with pool._mu:
                        pool.released += 1

                return Lease(view, _rel,
                             backstop=lambda dq=self._leaked,
                             off=off, n=nbytes: dq.append((off, n)))
        with self._mu:
            self.fallbacks += 1
        if nbytes == 0:
            return Lease(np.empty(0, dtype=np.uint8), None)
        mm = mmap.mmap(-1, nbytes)      # anonymous maps are page-aligned
        view = np.frombuffer(mm, dtype=np.uint8, count=nbytes)
        # the ndarray keeps `mm` alive through its base; nothing to free
        return Lease(view, None)

    def stats(self) -> dict:
        a = self.arena.stats()
        with self._mu:
            return {
                "gets": self.gets,
                "fallbacks": self.fallbacks,
                "released": self.released,
                "leak_reclaims": self.leak_reclaims,
                "pool_bytes": a["arena_bytes"],
                "in_use_bytes": a["in_use_bytes"],
                "high_water_bytes": a["high_water_bytes"],
            }


def default_pool() -> BufferPool:
    """Process-wide pool (created on first use; create before fork to
    share the segment across a worker pool)."""
    global _POOL
    with _POOL_MU:
        if _POOL is None:
            _POOL = BufferPool()
        return _POOL


def stats() -> dict | None:
    """Scrape-side stats: None when no pool was ever created (the
    metrics render must not force the segment into existence)."""
    with _POOL_MU:
        return None if _POOL is None else _POOL.stats()
