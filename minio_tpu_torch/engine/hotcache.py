"""The pool-shared hot-object tier and single-flight GETs.

Counterpart of minio_tpu/engine/hotcache.py (the port keeps its own
copy, so that it imports nothing of the JAX package).  The reference
ships this tier as an ObjectLayer-wrapper disk cache
(cmd/disk-cache.go, cmd/disk-cache-backend.go); this one is held in
RAM and shared by the worker pool: the entry table, the per-bucket
generation slots and the ghost filter live in one anonymous shared
mapping, the bodies in a ShmArena (ops/shm_arena.py), both made before
the fork, so under MTPU_WORKERS=N worker A's fill is worker B's hit.

The contract that makes the cache safe:

* Fills come only from fully verified healthy reads: every segment of
  the object read its k data shards and verified them on the card in
  one round (or was served from the device shard cache, which holds
  only such rows).  Degraded, hedged-spare, breaker-rerouted and
  rebuilt reads return correct bytes but bypass the fill.
* Every entry is stamped with the bucket's generation read before the
  engine read began.  Every mutation (ErasureSet._mark_dirty, after the
  write landed: PUT, overwrite, DELETE, delete markers, multipart
  complete, metadata update, heal, delete_bucket) bumps the shared
  slot, so a stale stamp fails the lookup and the entry is reaped, in
  every process of the pool.  The engine also stamps its FileInfo cache
  with this generation, so a leader never elects through metadata
  older than the generation it fills under.
* Readers copy out, or serve a zero-copy view, under a per-entry arena
  refcount (ShmArena.retain/release): an evicting writer only defers
  the slot's reuse until the last reader is done, so no body is torn.
* Only erasure sets whose drives are all local attach a tier
  (attach_sets): a remote peer's write could not bump this generation
  table.

Eviction is CLOCK over a fixed entry table under one fork-shared lock;
admission is gated by size (MTPU_HOTCACHE_MAX_OBJ, default 4 MiB) and a
two-hit ghost filter (a key must miss twice before it is admitted, so a
one-pass scan does not flush the hot set).  The ghost table is two-way
where the reference's is direct-mapped: there, two keys that share a
ghost slot replace each other's ghost on every miss and are never
admitted.  MTPU_HOTCACHE=0 turns the
tier off (the byte-identical oracle); MTPU_HOTCACHE_MB (default 64)
sizes the data segment.

SingleFlight deduplicates cold GETs within a process: concurrent GETs
of one (set, bucket, object, version) elect a leader that does the one
engine read; followers wait for its result and slice it (ranged GETs
too), so a herd on a cold key costs one read.

The module imports the standard library, numpy and ops.shm_arena only,
never torch: the pool's supervisor (server/workers.py) builds the tier
before it forks and loads no torch (ops/ipc_knobs.py).
"""

from __future__ import annotations

import collections
import hashlib
import os
import pickle
import threading
import weakref

import numpy as np

from ..ops.shm_arena import ArenaFull, ShmArena
from ..ops.shm_lock import ShmLock

#: header int64 slots: 0 hits, 1 misses, 2 fills, 3 evictions,
#: 4 bypassed, 5 stale_gen, 6 invalidations, 7 clock_hand,
#: 8 collisions, 9 ghost_defers, 10 meta_hits
_HDR = 16
#: hashed per-bucket generation slots (over-invalidation on a slot
#: collision is safe: it only forces a re-read)
_GEN_SLOTS = 512
#: ghost table of key hashes (two-hit admission filter), two-way: a key
#: may sit in either of two slots, so two hot keys that share one slot do
#: not keep replacing each other's ghost (the reference's table is
#: direct-mapped, and such a pair is never admitted)
_GHOST_SLOTS = 4096
#: entry fields: 0 used, 1 keyhash, 2 gen, 3 off, 4 total,
#: 5 clockbit, 6 hits, 7 body_len
_EFIELDS = 8

#: blob layout inside the arena:
#: [u32 klen][u32 filen][key utf8][fi pickle][body]
_BLOB_HDR = 8


def hot_enabled() -> bool:
    return os.environ.get("MTPU_HOTCACHE", "1") != "0"


def hot_bytes() -> int:
    try:
        mb = int(os.environ.get("MTPU_HOTCACHE_MB", "64"))
    except ValueError:
        mb = 64
    return max(8, mb) << 20


def hot_max_obj() -> int:
    try:
        return max(1, int(os.environ.get("MTPU_HOTCACHE_MAX_OBJ",
                                         str(4 << 20))))
    except ValueError:
        return 4 << 20


def _key_bytes(bucket: str, obj: str, version_id: str) -> bytes:
    return f"{bucket}\x00{obj}\x00{version_id}".encode()


def _key_hash(key: bytes) -> int:
    d = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(d, "little", signed=True)


def _bucket_slot(bucket: str) -> int:
    d = hashlib.blake2b(bucket.encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") % _GEN_SLOTS


class _Flight:
    """One in-flight leader read; followers wait on the event."""

    __slots__ = ("ev", "result")

    def __init__(self):
        self.ev = threading.Event()
        self.result = None          # (fi, body) | None (leader failed)

    def resolve(self, result) -> None:
        self.result = result
        self.ev.set()

    def wait(self, timeout: float = 30.0):
        if not self.ev.wait(timeout):
            return None             # wedged leader: caller reads direct
        return self.result


class SingleFlight:
    """Per-process GET deduplication keyed by (bucket, obj, version).

    begin() returns (flight, leader); exactly one caller per key gets
    leader=True and MUST resolve + end() the flight (followers fall
    back to a direct read when the leader resolves None or fails)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._flights: dict[tuple, _Flight] = {}

    def begin(self, key: tuple) -> tuple[_Flight, bool]:
        with self._mu:
            f = self._flights.get(key)
            if f is not None:
                return f, False
            f = _Flight()
            self._flights[key] = f
            return f, True

    def end(self, key: tuple) -> None:
        with self._mu:
            f = self._flights.pop(key, None)
            if f is not None and not f.ev.is_set():
                f.resolve(None)     # never leave followers hanging


class HotObjectCache:
    """The shared hot tier: entry table + generation table + ghost
    filter in one anonymous shared mapping, bodies in a ShmArena.

    Create BEFORE fork (WorkerPlane does); every worker operates on
    its inherited copy — all state that matters lives in the two
    mappings and the fork-shared lock.
    """

    def __init__(self, total_bytes: int | None = None,
                 max_obj: int | None = None,
                 n_entries: int | None = None):
        import mmap
        total_bytes = int(total_bytes or hot_bytes())
        self.max_obj = int(max_obj or hot_max_obj())
        # 64 KiB slots: small hot objects waste little; a 1 MiB object
        # is a 17-slot run (first-fit over a few thousand slots).
        self.arena = ShmArena(total_bytes, slot_bytes=64 << 10)
        if n_entries is None:
            n_entries = min(4096, max(64, self.arena.nslots))
        self.n_entries = int(n_entries)
        words = _HDR + _GEN_SLOTS + _GHOST_SLOTS \
            + self.n_entries * _EFIELDS
        self._mm = mmap.mmap(-1, words * 8)
        a = np.frombuffer(self._mm, dtype=np.int64)
        self._hdr = a[:_HDR]
        self._gens = a[_HDR:_HDR + _GEN_SLOTS]
        self._ghost = a[_HDR + _GEN_SLOTS:
                        _HDR + _GEN_SLOTS + _GHOST_SLOTS]
        self._ent = a[_HDR + _GEN_SLOTS + _GHOST_SLOTS:].reshape(
            self.n_entries, _EFIELDS)
        # Recursive (fill reaches note_bypass under it) and robust: a
        # worker killed inside it leaves no other worker blocked at its
        # lookup (ops/shm_lock.py), and the next locker drops the index
        # first (_repair_locked).
        self._mu = ShmLock(recursive=True, on_owner_dead=self._repair_locked)
        self.flights = SingleFlight()
        #: arena offsets whose zero-copy view died (weakref.finalize)
        #: — released on the next cache operation, NOT in the GC
        #: callback: release() takes the arena's non-reentrant
        #: fork-shared lock, and cyclic GC can run while this thread
        #: already holds it.  deque append/popleft are atomic.
        self._dead_views: collections.deque = collections.deque()
        #: optional per-process observer — pool workers point this at
        #: their SharedState slab slot (hit/miss per worker).
        self.on_lookup = None

    #: the tier object itself is only built when enabled, but tests
    #: flip MTPU_HOTCACHE at runtime — honor the kill switch per call.
    @property
    def enabled(self) -> bool:
        return hot_enabled()

    # -- generations ---------------------------------------------------------

    def generation(self, bucket: str) -> int:
        # No lock: one aligned int64 load from the shared mapping (every
        # election stamps its FileInfo-cache entry with it, in every
        # worker).  Bumps stay under the lock; a read older than a bump
        # only forces a miss.
        return int(self._gens[_bucket_slot(bucket)])

    def note_mutation(self, bucket: str) -> None:
        """One atomic generation bump invalidates every cached entry
        of the bucket — wired into ErasureSet._mark_dirty, so each
        PUT/DELETE/heal/decom write-path already reaches it."""
        with self._mu:
            self._gens[_bucket_slot(bucket)] += 1
            self._hdr[6] += 1

    def _repair_locked(self) -> None:
        """A worker died holding the lock, perhaps halfway through an
        entry or a fill: every entry is suspect.  The tier is a cache,
        so it drops its whole index, and the bodies go back to the
        arena (runs a live reader pins are freed by its last release).
        Nothing the dead worker was filling can be served: its entry
        never went in, or is dropped here."""
        self._ent[:, 0] = 0
        self.arena.free_unpinned()

    # -- lookup --------------------------------------------------------------

    def _find_locked(self, h: int) -> list[int]:
        m = (self._ent[:, 0] == 1) & (self._ent[:, 1] == h)
        return np.nonzero(m)[0].tolist()

    def _remove_locked(self, idx: int) -> None:
        off, total = int(self._ent[idx, 3]), int(self._ent[idx, 4])
        self._ent[idx, 0] = 0
        self.arena.free(off, total)     # deferred while readers hold it

    def _pin_locked(self, bucket: str, h: int) -> tuple[int, int] | None:
        """Find a fresh entry for key hash h, retain its arena run, and
        return (off, total) — or None (miss).  Stale entries are reaped
        in passing."""
        for idx in self._find_locked(h):
            if int(self._ent[idx, 2]) != \
                    int(self._gens[_bucket_slot(bucket)]):
                self._hdr[5] += 1       # stale generation
                self._remove_locked(idx)
                continue
            off, total = int(self._ent[idx, 3]), int(self._ent[idx, 4])
            self.arena.retain(off)
            self._ent[idx, 5] = 1       # CLOCK reference bit
            self._ent[idx, 6] += 1
            return off, total
        return None

    def _parse(self, off: int, total: int, key: bytes,
               want_body: bool):
        """Copy + parse a pinned blob; returns (fi, body|None) or None
        on a key-hash collision."""
        try:
            head = bytes(self.arena.view(off, _BLOB_HDR))
            klen = int.from_bytes(head[:4], "little")
            filen = int.from_bytes(head[4:8], "little")
            meta_end = _BLOB_HDR + klen + filen
            raw = bytes(self.arena.view(
                off, total if want_body else meta_end))
            if raw[_BLOB_HDR:_BLOB_HDR + klen] != key:
                return None             # 64-bit hash collision
            fi = pickle.loads(raw[_BLOB_HDR + klen:meta_end])
            return fi, (raw[meta_end:] if want_body else None)
        finally:
            self.arena.release(off)

    def lookup(self, bucket: str, obj: str, version_id: str):
        """Full hit: (fi, body bytes) or None.  The returned FileInfo
        is a fresh unpickle — callers may mutate it freely."""
        self.drain_released_views()
        key = _key_bytes(bucket, obj, version_id)
        h = _key_hash(key)
        with self._mu:
            pinned = self._pin_locked(bucket, h)
            if pinned is None:
                self._hdr[1] += 1
            else:
                self._hdr[0] += 1
        if pinned is not None:
            got = self._parse(*pinned, key, want_body=True)
            if got is not None:
                if self.on_lookup is not None:
                    self.on_lookup(True)
                return got
            with self._mu:              # collision: a miss after all
                self._hdr[0] -= 1
                self._hdr[1] += 1
                self._hdr[8] += 1
        if self.on_lookup is not None:
            self.on_lookup(False)
        return None

    def drain_released_views(self) -> None:
        """Release the arena pins of dead lookup_view results (queued
        by their finalizers); called at the top of every cache
        operation and exposed for tests that assert pin counts."""
        dq = self._dead_views
        while dq:
            try:
                off = dq.popleft()
            except IndexError:
                break
            self.arena.release(off)

    def lookup_view(self, bucket: str, obj: str, version_id: str):
        """Zero-copy full hit: (fi, body) with the body a uint8 ndarray
        view STRAIGHT OVER the arena run — no bytes() copy, no slice
        copy (the MTPU_ZEROCOPY serve path; lookup() is the copying
        oracle).

        The run stays retained until the view's base array dies
        (weakref.finalize queues the release), so the caller can hand
        the view — or any slice of it, slices keep the base alive — to
        sendmsg and simply drop it.  Eviction while pinned only DEFERS
        the arena free (ShmArena pending-free), so the bytes under the
        view can never be reused mid-send: torn bodies stay impossible.
        """
        self.drain_released_views()
        key = _key_bytes(bucket, obj, version_id)
        h = _key_hash(key)
        with self._mu:
            pinned = self._pin_locked(bucket, h)
            if pinned is None:
                self._hdr[1] += 1
            else:
                self._hdr[0] += 1
        if pinned is not None:
            off, total = pinned
            base = self.arena.view(off, total)
            try:
                klen = int.from_bytes(base[:4].tobytes(), "little")
                filen = int.from_bytes(base[4:8].tobytes(), "little")
                meta_end = _BLOB_HDR + klen + filen
                if base[_BLOB_HDR:_BLOB_HDR + klen].tobytes() != key:
                    raise KeyError      # 64-bit hash collision
                fi = pickle.loads(
                    base[_BLOB_HDR + klen:meta_end].tobytes())
            except Exception:  # noqa: BLE001 — collision/corrupt blob
                self.arena.release(off)
                with self._mu:          # a miss after all
                    self._hdr[0] -= 1
                    self._hdr[1] += 1
                    self._hdr[8] += 1
                if self.on_lookup is not None:
                    self.on_lookup(False)
                return None
            weakref.finalize(
                base, self._dead_views.append, off)
            if self.on_lookup is not None:
                self.on_lookup(True)
            return fi, base[meta_end:]
        if self.on_lookup is not None:
            self.on_lookup(False)
        return None

    def holds(self, bucket: str, obj: str, version_id: str) -> bool:
        """Whether a fresh entry for the key is resident, without
        counting, pinning or reaping: sendfile_plan asks this before its
        election, so a tier hit never pays for one.  A key-hash
        collision reads as held (the read then takes the normal path)."""
        h = _key_hash(_key_bytes(bucket, obj, version_id))
        gen = self.generation(bucket)
        with self._mu:
            return any(int(self._ent[idx, 2]) == gen
                       for idx in self._find_locked(h))

    def lookup_meta(self, bucket: str, obj: str, version_id: str):
        """Metadata-only hit (HEAD / conditional-GET precheck): the
        FileInfo without copying the body.  Counted separately so HEAD
        traffic does not skew the body hit ratio."""
        key = _key_bytes(bucket, obj, version_id)
        h = _key_hash(key)
        with self._mu:
            pinned = self._pin_locked(bucket, h)
            if pinned is None:
                return None
            self._hdr[10] += 1
        got = self._parse(*pinned, key, want_body=False)
        return None if got is None else got[0]

    # -- fill / eviction -----------------------------------------------------

    def note_bypass(self) -> None:
        with self._mu:
            self._hdr[4] += 1

    def _evict_one_locked(self) -> bool:
        """One CLOCK sweep step chain: clear reference bits until an
        unreferenced entry falls out; False when the table is empty."""
        n = self.n_entries
        hand = int(self._hdr[7])
        for _ in range(2 * n):
            idx = hand % n
            hand += 1
            if not self._ent[idx, 0]:
                continue
            if self._ent[idx, 5]:
                self._ent[idx, 5] = 0
                continue
            self._remove_locked(idx)
            self._hdr[3] += 1
            self._hdr[7] = hand
            return True
        self._hdr[7] = hand
        return False

    def fill(self, bucket: str, obj: str, version_id: str, fi,
             body: bytes, gen: int) -> bool:
        """Admit one verified read.  `gen` is the bucket generation
        captured BEFORE the engine read started — if a write raced the
        read, the stamp mismatches and the fill is dropped (a cached
        entry may never outlive the bytes it was read from)."""
        self.drain_released_views()
        blen = len(body)
        if blen == 0 or blen > self.max_obj:
            self.note_bypass()
            return False
        key = _key_bytes(bucket, obj, version_id)
        h = _key_hash(key)
        try:
            fi_raw = pickle.dumps(fi, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 — unpicklable fi: skip fill
            self.note_bypass()
            return False
        total = _BLOB_HDR + len(key) + len(fi_raw) + blen
        with self._mu:
            if int(self._gens[_bucket_slot(bucket)]) != int(gen):
                self._hdr[5] += 1
                return False
            # Two-hit ghost filter: first miss plants the key hash,
            # second admits (scans touch each key once — never admitted).
            gi = h % _GHOST_SLOTS
            gj = (h // _GHOST_SLOTS) % _GHOST_SLOTS
            if int(self._ghost[gi]) != h and int(self._ghost[gj]) != h:
                # Plant in a free slot of the two, else in the first.
                if int(self._ghost[gi]) and not int(self._ghost[gj]):
                    gi = gj
                self._ghost[gi] = h
                self._hdr[9] += 1
                return False
            if any(int(self._ent[i, 2])
                   == int(self._gens[_bucket_slot(bucket)])
                   for i in self._find_locked(h)):
                return False            # another worker beat us to it
            # Entry slot: first free, else CLOCK-evict one.
            free = np.nonzero(self._ent[:, 0] == 0)[0]
            if free.size == 0:
                if not self._evict_one_locked():
                    self.note_bypass()
                    return False
                free = np.nonzero(self._ent[:, 0] == 0)[0]
            idx = int(free[0])
            # Arena space: evict until the run fits (bounded by the
            # table size; pinned runs free lazily so give up rather
            # than spin).
            off = None
            for _ in range(self.n_entries + 1):
                try:
                    off = self.arena.alloc(total, timeout=0)
                    break
                except ArenaFull:
                    if not self._evict_one_locked():
                        break
            if off is None:
                self._hdr[4] += 1
                return False
            view = self.arena.view(off, total)
            view[:4] = np.frombuffer(
                len(key).to_bytes(4, "little"), dtype=np.uint8)
            view[4:8] = np.frombuffer(
                len(fi_raw).to_bytes(4, "little"), dtype=np.uint8)
            view[_BLOB_HDR:_BLOB_HDR + len(key)] = np.frombuffer(
                key, dtype=np.uint8)
            view[_BLOB_HDR + len(key):_BLOB_HDR + len(key)
                 + len(fi_raw)] = np.frombuffer(fi_raw, dtype=np.uint8)
            view[_BLOB_HDR + len(key) + len(fi_raw):] = np.frombuffer(
                body, dtype=np.uint8)
            self._ent[idx] = (1, h, gen, off, total, 1, 0, blen)
            self._hdr[2] += 1
            return True

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            h = self._hdr
            entries = int(np.count_nonzero(self._ent[:, 0]))
            cached_bytes = int(self._ent[self._ent[:, 0] == 1, 7].sum())
            hits, misses = int(h[0]), int(h[1])
        a = self.arena.stats()
        total = hits + misses
        return {
            "hits": hits, "misses": misses,
            "meta_hits": int(h[10]),
            "hit_ratio": (hits / total) if total else 0.0,
            "fills": int(h[2]), "evictions": int(h[3]),
            "bypassed": int(h[4]), "stale_gen": int(h[5]),
            "invalidations": int(h[6]), "collisions": int(h[8]),
            "ghost_defers": int(h[9]),
            "entries": entries, "cached_bytes": cached_bytes,
            "segment_bytes": a["arena_bytes"],
            "in_use_bytes": a["in_use_bytes"],
            "max_obj_bytes": self.max_obj,
        }


# -- attachment ---------------------------------------------------------------

def _all_local(es) -> bool:
    """A tier can only trust its generation table when every mutation
    in the deployment runs through THIS process tree's _mark_dirty —
    i.e. every drive is local (HealthWrappedDrive is isinstance-
    transparent).  Offline slots (None) are fine."""
    from ..storage.drive import LocalDrive
    return all(d is None or isinstance(d, LocalDrive)
               for d in es.drives)


def attach_sets(sets, tier: HotObjectCache) -> int:
    """Attach `tier` to every all-local ErasureSet of one ErasureSets
    stack; returns how many sets attached."""
    n = 0
    for es in getattr(sets, "sets", [sets]):
        if _all_local(es):
            es.hot_tier = tier
            n += 1
    return n


def attach_pools(pools, tier: HotObjectCache | None = None):
    """Build (unless given the pre-fork one) and attach the hot tier
    across every pool; remembers it as pools.hot_tier for the server's
    metrics.  Returns the tier, or None when disabled or nothing
    attached."""
    if not hot_enabled():
        return None
    if tier is None:
        tier = HotObjectCache()
    n = 0
    for p in pools.pools:
        n += attach_sets(p, tier)
    if n == 0:
        return None
    pools.hot_tier = tier
    return tier


def maybe_tier() -> HotObjectCache | None:
    """Pre-fork constructor used by WorkerPlane: the segment must
    exist before the first fork so every worker inherits ONE cache."""
    return HotObjectCache() if hot_enabled() else None
