"""Device shard cache and the host-to-device byte ledger (torch).

Counterpart of minio_tpu/ops/devcache.py, without its observe/ hooks.

The cache keeps the verified (nb, K, S) data rows of healthy GETs, keyed
by `(owner, bucket, object, part, data_dir, b0, b1, algo)`, so a re-read
of a resident range (a GET, a ranged GET, heal's rebuild of a part) reads
no shard and copies nothing to the card again: a GET serves the verified
host copy, and heal runs its rebuild against the rows' tensor on the card
(`device_array`, placed once on first use).

Fill discipline: only a fully verified healthy read fills (no degraded
read, no rebuild, nothing that tripped a digest mismatch), and the
(owner, bucket) generation is taken before the shard reads, so a write
that races the read rejects the fill instead of being masked by it.
`ErasureSet._mark_dirty` bumps the generation on every mutation.  Owner
tokens are per ErasureSet instance and the cache is per process, so a
reopened set or a restarted process starts cold.

The ledger counts every host-to-device placement of shard bytes
(`devices.put`, the coalescer lanes' staged copies, `device_array`) per
card, so a run can read the bytes that crossed per byte served: about 1
on first touch, 0 on a hit.  On the CPU (device="cpu", the tests) the
same placements are counted, though no copy is made.

Env (read per call):

- MTPU_DEVCACHE=0 turns the cache off: the byte-identical direct-read
  oracle;
- MTPU_DEVCACHE_MB caps the resident payload bytes (default 64);
- MTPU_H2D_PIPELINE=0 turns off the lanes' pinned, double-buffered
  staging (ops/coalesce.py): the serial-copy oracle.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np


def enabled() -> bool:
    return os.environ.get("MTPU_DEVCACHE", "1") != "0"


def cache_bytes() -> int:
    try:
        mb = int(os.environ.get("MTPU_DEVCACHE_MB", "64"))
    except ValueError:
        mb = 64
    return max(1, mb) << 20


def h2d_pipeline_enabled() -> bool:
    return os.environ.get("MTPU_H2D_PIPELINE", "1") != "0"


# -- host-to-device ledger ----------------------------------------------------

_H2D_MU = threading.Lock()
_H2D_BYTES = 0
_H2D_DISPATCHES = 0
_H2D_LANES: dict[int, dict] = {}


def card_index(device) -> int:
    """The ledger's and the lanes' index of a device: the CUDA ordinal,
    0 for the CPU."""
    return int(getattr(device, "index", None) or 0)


def note_h2d(nbytes: int, device: int | None = None) -> None:
    """Record one host-to-device placement of `nbytes` bytes on card
    `device`.  Called by every placement site and by nothing else."""
    global _H2D_BYTES, _H2D_DISPATCHES
    with _H2D_MU:
        _H2D_BYTES += int(nbytes)
        _H2D_DISPATCHES += 1
        if device is not None:
            lane = _H2D_LANES.setdefault(
                int(device), {"h2d_bytes": 0, "h2d_dispatches": 0})
            lane["h2d_bytes"] += int(nbytes)
            lane["h2d_dispatches"] += 1


def h2d_stats() -> dict:
    with _H2D_MU:
        return {
            "h2d_bytes": _H2D_BYTES,
            "h2d_dispatches": _H2D_DISPATCHES,
            "lanes": {d: dict(v) for d, v in sorted(_H2D_LANES.items())},
        }


def reset_h2d() -> None:
    global _H2D_BYTES, _H2D_DISPATCHES
    with _H2D_MU:
        _H2D_BYTES = 0
        _H2D_DISPATCHES = 0
        _H2D_LANES.clear()


# -- owner tokens -------------------------------------------------------------

_OWNER_MU = threading.Lock()
_NEXT_OWNER = 0


def next_owner() -> int:
    """A fresh per-process token, one per ErasureSet instance: a reopened
    set never sees what an earlier instance filled."""
    global _NEXT_OWNER
    with _OWNER_MU:
        _NEXT_OWNER += 1
        return _NEXT_OWNER


class Entry:
    """One resident range: the verified data rows (nb, K, S) of blocks
    [b0, b1) of a part (`host`, read-only), the tail block's rows
    (1, K, tail) when the range covers it, and `dev`, the rows' tensor on
    `device`, placed on first use by `device_array`."""

    __slots__ = ("key", "gen", "host", "tail", "dev", "device", "nbytes")

    def __init__(self, key, gen, host, tail, dev, device, nbytes):
        self.key = key
        self.gen = gen
        self.host = host
        self.tail = tail
        self.dev = dev
        self.device = device
        self.nbytes = nbytes


class DeviceShardCache:
    """LRU of verified shard batches, capped by payload bytes
    (MTPU_DEVCACHE_MB).  `note_mutation` bumps the (owner, bucket)
    generation; an entry filled under an older one is dropped when next
    looked up."""

    def __init__(self):
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, Entry]" = OrderedDict()
        self._gen: dict[tuple, int] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.invalidations = 0
        self.stale_drops = 0
        self.rejects = 0

    # -- generations ---------------------------------------------------------

    def current_gen(self, owner: int, bucket: str) -> int:
        with self._mu:
            return self._gen.get((owner, bucket), 0)

    def note_mutation(self, owner: int, bucket: str) -> None:
        with self._mu:
            self._gen[(owner, bucket)] = \
                self._gen.get((owner, bucket), 0) + 1
            self.invalidations += 1

    # -- fill / lookup -------------------------------------------------------

    def fill(self, key: tuple, gen0: int, host: np.ndarray,
             tail: np.ndarray | None = None, dev=None,
             device=None) -> bool:
        """Admit one verified range.  `gen0` is the (owner, bucket)
        generation taken before the shard reads; a mutation since then
        rejects the fill.  The arrays become read-only: hits hand out
        views of them.  Returns whether the entry was admitted."""
        owner, bucket = key[0], key[1]
        nbytes = int(host.nbytes) + (int(tail.nbytes) if tail is not None
                                     else 0)
        cap = cache_bytes()
        with self._mu:
            if self._gen.get((owner, bucket), 0) != gen0:
                self.stale_drops += 1
                return False
            if nbytes > cap:
                self.rejects += 1
                return False
            host.flags.writeable = False
            if tail is not None:
                tail.flags.writeable = False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = Entry(key, gen0, host, tail, dev, device,
                                       nbytes)
            self._bytes += nbytes
            self.fills += 1
            while self._bytes > cap and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1
        return True

    def _valid(self, e: Entry) -> bool:
        return self._gen.get((e.key[0], e.key[1]), 0) == e.gen

    def lookup(self, key: tuple) -> Entry | None:
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            if not self._valid(e):
                del self._entries[key]
                self._bytes -= e.nbytes
                self.stale_drops += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def lookup_range(self, owner: int, bucket: str, obj: str,
                     part: int, data_dir: str, algo: str,
                     lo: int, hi: int) -> tuple[Entry, int] | None:
        """An entry covering blocks [lo, hi) of the part, and the block
        offset of `lo` inside it."""
        with self._mu:
            for key in list(self._entries):
                if key[:5] != (owner, bucket, obj, part, data_dir) \
                        or key[7] != algo:
                    continue
                e = self._entries[key]
                if not self._valid(e):
                    del self._entries[key]
                    self._bytes -= e.nbytes
                    self.stale_drops += 1
                    continue
                b0, b1 = key[5], key[6]
                if b0 <= lo and hi <= b1:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return e, lo - b0
            self.misses += 1
            return None

    # -- device residency ----------------------------------------------------

    def device_array(self, e: Entry):
        """The entry's rows as a tensor on its device, placed (and
        counted, once) on first use.  It is made on the caller's current
        stream; a consumer on another stream must wait for that stream
        and `record_stream` the tensor."""
        dev = e.dev
        if dev is not None:
            return dev
        from . import devices
        placed = devices.put(e.host, e.device)
        e.dev = placed
        return placed

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": (self.hits / total) if total else 0.0,
                "fills": self.fills,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "stale_drops": self.stale_drops,
                "rejects": self.rejects,
                "entries": len(self._entries),
                "resident_bytes": self._bytes,
                "capacity_bytes": cache_bytes(),
            }

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bytes = 0


# -- process singleton -------------------------------------------------------

_CACHE: DeviceShardCache | None = None
_CACHE_MU = threading.Lock()


def get() -> DeviceShardCache:
    global _CACHE
    c = _CACHE
    if c is None:
        with _CACHE_MU:
            if _CACHE is None:
                _CACHE = DeviceShardCache()
            c = _CACHE
    return c


def stats() -> dict | None:
    """The cache's stats; None when no cache was ever created."""
    with _CACHE_MU:
        return None if _CACHE is None else _CACHE.stats()


def reset() -> None:
    """Drop the singleton (fresh generations, zero counters) and the
    ledger."""
    global _CACHE
    with _CACHE_MU:
        _CACHE = None
    reset_h2d()


def _reset_after_fork() -> None:
    # A forked child cannot use its parent's CUDA tensors: it starts with
    # an empty cache and refills from its own verified reads.
    global _CACHE
    _CACHE = None
    reset_h2d()


os.register_at_fork(after_in_child=_reset_after_fork)
