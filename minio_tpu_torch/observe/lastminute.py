"""The port's copy of minio_tpu/observe/lastminute.py.

Sliding last-minute SLO windows (the cmd/last-minute.go analogue).

Per-API ring of one-second slots, each holding count/error/latency-sum/
byte totals plus a small latency histogram.  The writer is the request
thread of THIS process and every mutation is a handful of CPython
int/float ops on lists the ring owns — no lock is taken on the request
path (the reference keeps lastMinuteLatency equally lock-free and merges
at scrape).  The scrape-side reader only sums slots; a read racing a
slot reset can at worst move one sample between adjacent windows, it can
never corrupt a total.  In the pre-fork pool each worker keeps its own
window (single-writer discipline, like the worker pool's shared slab) and the
scrape that lands on a worker reports that worker's slice.

Exported at scrape time as the mtpu_api_last_minute_{p50,p99,count,
errors} gauge families (see MetricsRegistry._sync_last_minute).
"""

from __future__ import annotations

import os
import time

#: Latency bucket upper bounds in milliseconds (last one catches all).
BOUNDS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
             float("inf"))

#: Window length env knob (seconds of history one scrape reports).
WINDOW_ENV = "MTPU_SLO_WINDOW_S"
DEFAULT_WINDOW_S = 60


class _ApiRing:
    """One API's ring: parallel per-slot arrays indexed by
    epoch-second % window, each slot stamped with the second it holds
    so stale laps self-invalidate without a sweeper."""

    __slots__ = ("secs", "count", "errors", "sheds", "sum_ms",
                 "nbytes", "buckets")

    def __init__(self, window: int):
        self.secs = [0] * window
        self.count = [0] * window
        self.errors = [0] * window
        self.sheds = [0] * window
        self.sum_ms = [0.0] * window
        self.nbytes = [0] * window
        self.buckets = [[0] * len(BOUNDS_MS) for _ in range(window)]


class ApiWindow:
    """Per-API sliding window of the last `window_s` seconds."""

    def __init__(self, window_s: int | None = None, clock=time.time):
        if window_s is None:
            window_s = int(os.environ.get(WINDOW_ENV, "") or
                           DEFAULT_WINDOW_S)
        self.window = max(1, int(window_s))
        self.clock = clock
        self.apis: dict[str, _ApiRing] = {}

    def observe(self, api: str, duration_s: float,
                error: bool = False, nbytes: int = 0,
                shed: bool = False) -> None:
        ring = self.apis.get(api)
        if ring is None:
            # setdefault so two racing first-observers share one ring.
            ring = self.apis.setdefault(api, _ApiRing(self.window))
        now = int(self.clock())
        i = now % self.window
        if ring.secs[i] != now:
            # Lap: this slot holds a second older than the window.
            ring.secs[i] = now
            ring.count[i] = 0
            ring.errors[i] = 0
            ring.sheds[i] = 0
            ring.sum_ms[i] = 0.0
            ring.nbytes[i] = 0
            ring.buckets[i] = [0] * len(BOUNDS_MS)
        ms = duration_s * 1e3
        ring.count[i] += 1
        if error:
            ring.errors[i] += 1
        if shed:
            # Admission sheds are their own class, NOT errors: a 503
            # SlowDown is the overload plane working as designed and
            # must not eat the API's error budget.
            ring.sheds[i] += 1
        ring.sum_ms[i] += ms
        ring.nbytes[i] += nbytes
        b = ring.buckets[i]
        for j, bound in enumerate(BOUNDS_MS):
            if ms <= bound:
                b[j] += 1
                break

    def snapshot(self) -> dict[str, dict]:
        """Merge live slots into per-API {count, errors, bytes, avg_ms,
        p50_ms, p99_ms} — pure reads of already-maintained counters."""
        now = int(self.clock())
        lo = now - self.window
        out: dict[str, dict] = {}
        for api, ring in list(self.apis.items()):
            count = errors = sheds = nbytes = 0
            sum_ms = 0.0
            agg = [0] * len(BOUNDS_MS)
            for i in range(self.window):
                sec = ring.secs[i]
                if lo < sec <= now:
                    count += ring.count[i]
                    errors += ring.errors[i]
                    sheds += ring.sheds[i]
                    sum_ms += ring.sum_ms[i]
                    nbytes += ring.nbytes[i]
                    slot = ring.buckets[i]
                    for j in range(len(BOUNDS_MS)):
                        agg[j] += slot[j]
            out[api] = {
                "count": count,
                "errors": errors,
                "sheds": sheds,
                "bytes": nbytes,
                "avg_ms": (sum_ms / count) if count else 0.0,
                "p50_ms": percentile(agg, count, 0.50),
                "p99_ms": percentile(agg, count, 0.99),
            }
        return out


def percentile(buckets: list[int], count: int, q: float) -> float:
    """Bucket-upper-bound percentile (the resolution the ring keeps)."""
    if count <= 0:
        return 0.0
    target = count * q
    cum = 0
    for j, bound in enumerate(BOUNDS_MS):
        cum += buckets[j]
        if cum >= target:
            return bound if bound != float("inf") else BOUNDS_MS[-2]
    return BOUNDS_MS[-2]
