"""Counterpart of minio_tpu/storage/oscounters.py: the same counts,
times and spans, with `timed` a small slotted object in place of a
generator context manager (the drive layer pays it on every call).

Per-OS-call counters/timings for the storage layer.

The cmd/os-instrumented.go role: every syscall class the drive layer
issues is counted and timed, so `disk_info()`/admin metrics can show
where drive time goes (complements the per-API EWMAs in
storage/health_wrap.py, the xlStorageDiskIDCheck role)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from ..observe import span as _span

_perf = time.perf_counter
_current = _span._current

class Counters:
    """One instance per drive, so per-drive numbers actually attribute
    to the drive (a process-wide singleton would report identical
    aggregates under every drive and overcount N x when summed).

    `drive` labels the owning drive; inside a traced request every
    timed op doubles as a per-drive I/O span ("drive.read" etc.) —
    the dt is already measured here, so the span costs one contextvar
    read when tracing is off."""

    def __init__(self, drive: str = ""):
        self._mu = threading.Lock()
        self._counts: dict[str, int] = defaultdict(int)
        self._seconds: dict[str, float] = defaultdict(float)
        self._drive = drive

    def timed(self, op: str) -> "_Timed":
        """`with counters.timed("read"): ...` counts and times the block
        (a small object, not a generator: every drive call pays it)."""
        return _Timed(self, op)

    def snapshot(self) -> dict:
        with self._mu:
            return {op: {"count": self._counts[op],
                         "total_ms": round(self._seconds[op] * 1e3, 3)}
                    for op in sorted(self._counts)}

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()
            self._seconds.clear()


class _Timed:
    """One timed drive call: counted and timed on exit, and recorded as
    a "drive.<op>" span only inside a traced request."""

    __slots__ = ("_c", "_op", "_t0")

    def __init__(self, counters: Counters, op: str):
        self._c = counters
        self._op = op

    def __enter__(self) -> None:
        self._t0 = _perf()

    def __exit__(self, *exc) -> bool:
        dt = _perf() - self._t0
        c, op = self._c, self._op
        with c._mu:
            c._counts[op] += 1
            c._seconds[op] += dt
        if _current.get() is not None:
            _span.record("drive." + op, dt, drive=c._drive)
        return False
