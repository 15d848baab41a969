"""Programmable fault-injection drive (counterpart of
minio_tpu/storage/naughty.py; cf. naughtyDisk,
cmd/naughty-disk_test.go:31).

A LocalDrive whose methods can be programmed to fail on their Nth call,
on every call, or from a given call onward, or to be slow.  Quorum-edge
tests sweep write and read failures across erasure geometries with it
and assert the exact error the API surfaces.

It subclasses LocalDrive, so engine paths gated on
isinstance(d, LocalDrive) stay active: the faults hit the code a real
flaky disk would.

The batched metadata calls (`write_metadata_many`, `read_version_many`,
ops/metalanes.py) are intercepted as calls of their own, and each of
their items also counts as one call of the single-op method it stands
for (`write_metadata`, `read_version`): a fault or a delay programmed
there hits the matching item of a batch, which fails alone, as its
solo call would.
"""

from __future__ import annotations

import threading
import time

from .drive import LocalDrive
from .errors import ErrDiskNotFound

#: Methods the engine calls on the per-drive contract.
INTERCEPTED = (
    "make_volume", "stat_volume", "delete_volume", "list_volumes",
    "write_all", "read_all", "delete", "append_file", "create_file",
    "read_file", "read_file_view", "rename_file", "rename_data",
    "read_version", "write_metadata", "update_metadata",
    "delete_version", "file_size",
    "list_dir", "list_raw", "verify_file", "disk_info",
    "write_file_batches", "open_read_fd",
    "write_metadata_many", "read_version_many",
)

#: batched call -> (the single-op method each item stands for, the
#: item's result when it fails)
BATCHED = {
    "write_metadata_many": ("write_metadata", lambda e: e),
    "read_version_many": ("read_version", lambda e: (None, e)),
}


class NaughtyDrive(LocalDrive):
    """LocalDrive with a per-method fault program.

    program entries (set via the helpers):
      fail(method, on_call=N, exc=...)   fail that method's Nth call
      fail_from(method, call=N, exc=...) fail from the Nth call onward
      fail_always(method, exc=...)       every call
      offline(exc=...)                   EVERY intercepted method fails
      slow(method, delay_s, ...)         delay (don't fail) calls: the
                                         tail-latency fault class the
                                         hedged-read path exists for
    Counters in .calls[method] record invocations (failed ones too; a
    batch's items count under their single-op method).
    """

    def __init__(self, root: str, create: bool = True):
        super().__init__(root, create=create)
        self._mu_naughty = threading.Lock()
        self.calls: dict[str, int] = {}
        self._on_call: dict[tuple[str, int], Exception] = {}
        self._from_call: dict[str, tuple[int, Exception]] = {}
        self._always: dict[str, Exception] = {}
        self._slow_on: dict[tuple[str, int], float] = {}
        self._slow_from: dict[str, tuple[int, float]] = {}
        self._offline_exc: Exception | None = None
        for name in INTERCEPTED:
            real = getattr(self, name, None)
            if real is None:
                continue
            # an instance attribute shadows the class method
            wrap = self._wrap_many if name in BATCHED else self._wrap
            setattr(self, name, wrap(name, real))

    def _draw(self, name: str) -> tuple[Exception | None, float]:
        """Count one call of `name`; its programmed fault and delay.
        The caller holds the lock."""
        n = self.calls.get(name, 0) + 1
        self.calls[name] = n
        exc = self._on_call.pop((name, n), None)
        if exc is None and self._offline_exc is not None:
            exc = self._offline_exc
        if exc is None and name in self._always:
            exc = self._always[name]
        if exc is None and name in self._from_call:
            start, e = self._from_call[name]
            if n >= start:
                exc = e
        delay = self._slow_on.pop((name, n), 0.0)
        if name in self._slow_from:
            start, d = self._slow_from[name]
            if n >= start:
                delay = max(delay, d)
        return exc, delay

    def _wrap(self, name, real):
        def naughty(*a, **kw):
            with self._mu_naughty:
                exc, delay = self._draw(name)
            if delay > 0.0:
                time.sleep(delay)   # outside the lock: slowness must not
                                    # serialize the drive's other methods
            if exc is not None:
                raise exc
            return real(*a, **kw)
        return naughty

    def _wrap_many(self, name, real):
        single, failed = BATCHED[name]

        def naughty_many(items):
            items = list(items)
            with self._mu_naughty:
                exc, delay = self._draw(name)
                per_item = [self._draw(single) for _ in items]
            delay = max([delay] + [d for _, d in per_item])
            if delay > 0.0:
                time.sleep(delay)
            if exc is not None:
                raise exc
            keep = [i for i, (e, _) in enumerate(per_item) if e is None]
            got = real([items[i] for i in keep]) if keep else []
            out = [failed(e) if e is not None else None
                   for e, _ in per_item]
            for i, r in zip(keep, got):
                out[i] = r
            return out
        return naughty_many

    # -- programming ---------------------------------------------------------

    def fail(self, method: str, on_call: int = 1,
             exc: Exception | None = None) -> "NaughtyDrive":
        self._on_call[(method, self.calls.get(method, 0) + on_call)] = \
            exc or ErrDiskNotFound("injected")
        return self

    def fail_from(self, method: str, call: int = 1,
                  exc: Exception | None = None) -> "NaughtyDrive":
        self._from_call[method] = (self.calls.get(method, 0) + call,
                                   exc or ErrDiskNotFound("injected"))
        return self

    def fail_always(self, method: str,
                    exc: Exception | None = None) -> "NaughtyDrive":
        self._always[method] = exc or ErrDiskNotFound("injected")
        return self

    def offline(self, exc: Exception | None = None) -> "NaughtyDrive":
        self._offline_exc = exc or ErrDiskNotFound("injected offline")
        return self

    def slow(self, method: str, delay_s: float, on_call: int | None = None,
             from_call: int | None = None) -> "NaughtyDrive":
        """Delay `method` by delay_s: on its Nth next call (on_call), from
        the Nth call onward (from_call), or every call (neither given)."""
        if on_call is not None:
            self._slow_on[(method, self.calls.get(method, 0) + on_call)] = \
                delay_s
        else:
            start = self.calls.get(method, 0) + (from_call or 1)
            self._slow_from[method] = (start, delay_s)
        return self

    def heal_thyself(self) -> "NaughtyDrive":
        """Clear the whole fault program (the drive 'recovers')."""
        with self._mu_naughty:
            self._on_call.clear()
            self._from_call.clear()
            self._always.clear()
            self._slow_on.clear()
            self._slow_from.clear()
            self._offline_exc = None
        return self
