"""Data usage, the scanner's output, and the dirty-bucket tracker.

Counterpart of minio_tpu/background/usage.py (cmd/data-usage-cache.go
and cmd/data-update-tracker.go:59): per-bucket object, version and byte
counts with bytes per top-level prefix, merged across sets and pools,
persisted as msgpack under each drive's system volume
(`usage/usage.msgpack`) and readable without a scan; and the tracker of
buckets written since the last cycle (`dirty-buckets.json`), so that a
cycle rescans those and carries the others forward.  Both files are the
JAX package's, byte for byte in their fields: each package reads the
other's.

In a worker pool only worker 0 scans, while every worker takes writes:
`SharedMarks`, a table of counters in memory shared by the pool's
processes (built before the fork, like the hot tier's segment), carries
a mark made in any worker to worker 0's next cycle.  A bucket maps to a
slot by CRC-32, so two buckets can share one: a false mark costs one
rescan, and no mark is ever lost.

Imports neither torch nor the engine: the pool's supervisor builds the
shared table before it forks.
"""

from __future__ import annotations

import json
import mmap
import threading
import time
import zlib

import numpy as np

from ..storage.drive import SYS_VOL
from ..storage.errors import StorageError
from ..utils import msgpackx

USAGE_PATH = "usage/usage.msgpack"


class BucketUsage:
    __slots__ = ("objects", "versions", "bytes", "prefixes")

    def __init__(self):
        self.objects = 0
        self.versions = 0
        self.bytes = 0
        self.prefixes: dict[str, int] = {}     # top-level prefix -> bytes

    def to_obj(self) -> dict:
        return {"o": self.objects, "v": self.versions, "b": self.bytes,
                "p": self.prefixes}

    @classmethod
    def from_obj(cls, d: dict) -> "BucketUsage":
        u = cls()
        u.objects = d.get("o", 0)
        u.versions = d.get("v", 0)
        u.bytes = d.get("b", 0)
        u.prefixes = dict(d.get("p", {}))
        return u


class DataUsage:
    def __init__(self):
        self.buckets: dict[str, BucketUsage] = {}
        self.scanned_at = 0.0
        self.cycle = 0

    def account(self, bucket: str, name: str, size: int,
                versions: int = 1) -> None:
        u = self.buckets.setdefault(bucket, BucketUsage())
        u.objects += 1
        u.versions += versions
        u.bytes += size
        top = name.split("/", 1)[0] + ("/" if "/" in name else "")
        u.prefixes[top] = u.prefixes.get(top, 0) + size

    def total_bytes(self) -> int:
        return sum(u.bytes for u in self.buckets.values())

    def to_bytes(self) -> bytes:
        return msgpackx.packb({
            "at": self.scanned_at, "cycle": self.cycle,
            "buckets": {b: u.to_obj() for b, u in self.buckets.items()}})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DataUsage":
        d = msgpackx.unpackb(raw)
        u = cls()
        u.scanned_at = d.get("at", 0.0)
        u.cycle = d.get("cycle", 0)
        u.buckets = {b: BucketUsage.from_obj(v)
                     for b, v in d.get("buckets", {}).items()}
        return u

    # -- persistence on a set's drives ---------------------------------------

    def persist(self, es) -> None:
        raw = self.to_bytes()
        es._map_drives(lambda d: d.write_all(SYS_VOL, USAGE_PATH, raw))

    @classmethod
    def load(cls, es) -> "DataUsage | None":
        for d in es.drives:
            if d is None:
                continue
            try:
                return cls.from_bytes(d.read_all(SYS_VOL, USAGE_PATH))
            except StorageError:
                continue
        return None


class SharedMarks:
    """Mark counters in an anonymous shared mapping: made before a fork,
    bumped by every process, read by the scanning one.  A slot's counter
    only grows; lost increments under a race still change it."""

    def __init__(self, slots: int = 4096):
        self.slots = int(slots)
        self._mm = mmap.mmap(-1, self.slots * 8)
        self._a = np.frombuffer(self._mm, dtype=np.int64)

    def _slot(self, bucket: str) -> int:
        return zlib.crc32(bucket.encode()) % self.slots

    def bump(self, bucket: str) -> None:
        self._a[self._slot(bucket)] += 1

    def read(self, bucket: str) -> int:
        return int(self._a[self._slot(bucket)])


class DirtyTracker:
    """Which buckets changed since the last scan cycle: the scanner skips
    the others the way the reference's bloom filter lets it.

    Persisted (save/load) so a restart keeps pending marks, as the
    reference's dataUpdateTracker does: marks stay in memory, the
    scanner saves each cycle and takes the union at its start, and a
    bound tracker also saves shortly after a mark (debounced)."""

    _global = None
    PERSIST_PATH = "dirty-buckets.json"

    SAVE_INTERVAL = 5.0      # debounce of mark-triggered saves

    def __init__(self):
        self._mu = threading.Lock()
        self._dirty: set[str] = set()
        self._stamp: dict[str, float] = {}
        self._es = None                 # persistence target (bind())
        self._last_save = 0.0
        self._save_timer: threading.Timer | None = None
        # The pool's fork-shared marks and, in the scanning process, the
        # counter each bucket had at the last snapshot.
        self._shared: SharedMarks | None = None
        self._seen: dict[str, int] = {}

    @classmethod
    def shared(cls) -> "DirtyTracker":
        if cls._global is None:
            cls._global = cls()
        return cls._global

    def attach_shared(self, marks: SharedMarks | None) -> None:
        """Mark into (and, when scanning, read from) the pool's table."""
        self._shared = marks
        self._seen = {}

    def bind(self, es) -> None:
        """Save to this set's drives shortly after a mark; without it a
        mark made between cycles would persist only at the end of the
        cycle that consumed it.  None unbinds."""
        self._es = es

    def mark(self, bucket: str) -> None:
        with self._mu:
            self._dirty.add(bucket)
            self._stamp[bucket] = time.time()
        if self._shared is not None:
            self._shared.bump(bucket)
        self._maybe_persist()

    def _maybe_persist(self) -> None:
        if self._es is None:
            return
        now = time.time()
        with self._mu:
            due = now - self._last_save >= self.SAVE_INTERVAL
            if due:
                self._last_save = now
            elif self._save_timer is None:
                # A trailing save, so the last mark of a burst lands.
                delay = self.SAVE_INTERVAL - (now - self._last_save)
                t = threading.Timer(max(delay, 0.05), self._timer_save)
                t.daemon = True
                self._save_timer = t
                t.start()
        if due:
            # Off the request path: mark() runs in PUT handlers, and the
            # drive fan-out must not add to a request's latency.
            threading.Thread(target=self._safe_save, daemon=True).start()

    def _safe_save(self) -> None:
        es = self._es
        if es is not None:
            try:
                self.save(es)
            except Exception:  # noqa: BLE001 — persistence is advisory
                pass

    def _timer_save(self) -> None:
        with self._mu:
            self._save_timer = None
            self._last_save = time.time()
        self._safe_save()

    def snapshot_and_clear(self, buckets=()) -> set[str]:
        """The buckets marked since the last snapshot: this process's
        marks, and of `buckets`, those whose shared counter moved (a
        bucket seen for the first time counts as clean: the scanner's
        first cycle scans everything)."""
        with self._mu:
            out = set(self._dirty)
            self._dirty.clear()
            if self._shared is not None:
                for b in buckets:
                    v = self._shared.read(b)
                    if b in self._seen and self._seen[b] != v:
                        out.add(b)
                    self._seen[b] = v
            return out

    def is_dirty(self, bucket: str) -> bool:
        with self._mu:
            return bucket in self._dirty

    # -- persistence -----------------------------------------------------------

    def save(self, es) -> None:
        """The pending set on every live drive's system volume (any copy
        restores it)."""
        with self._mu:
            blob = json.dumps({"dirty": sorted(self._dirty),
                               "stamp": self._stamp}).encode()
        es._map_drives(lambda d: d.write_all(SYS_VOL, self.PERSIST_PATH,
                                             blob))

    def load(self, es) -> None:
        """The union of every readable drive's copy: a drive that was
        offline at a save holds an older file and must not hide newer
        marks."""
        for d in es.drives:
            if d is None:
                continue
            try:
                obj = json.loads(d.read_all(SYS_VOL, self.PERSIST_PATH))
            except (StorageError, ValueError):
                continue
            with self._mu:
                self._dirty.update(obj.get("dirty", []))
                for k, v in obj.get("stamp", {}).items():
                    self._stamp.setdefault(k, v)
