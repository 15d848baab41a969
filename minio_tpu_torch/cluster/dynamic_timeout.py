"""Copy of minio_tpu/cluster/dynamic_timeout.py: the port keeps its own, so that
it imports nothing of the JAX package.

Dynamic timeouts: deadlines that adapt to observed latencies.

The cmd/dynamic-timeouts.go:36 equivalent: lock/op deadlines start at a
default and adjust from a sliding window of observed outcomes — many
timeouts push the deadline up (x1.25 steps), consistently fast
successes pull it back down (towards the observed p-high), bounded by
[minimum, maximum]. Used by callers that wrap lock acquisition or slow
drive ops.
"""

from __future__ import annotations

import threading


class DynamicTimeout:
    WINDOW = 64
    GROW = 1.25
    # Separate grow/shrink thresholds with a neutral dead band between
    # them (the reference uses >=33% grow / <10% shrink): without the
    # band, a workload whose tail sits near the deadline oscillates —
    # shrink snaps onto the fast majority, the next window times out the
    # tail, grow crawls back, repeat.
    GROW_TRIGGER = 0.33        # >=33% timeouts => grow
    SHRINK_TRIGGER = 0.05      # <5% timeouts => consider gradual shrink

    def __init__(self, default_s: float, minimum_s: float,
                 maximum_s: float | None = None):
        self.minimum = minimum_s
        self.maximum = maximum_s or default_s * 16
        self._timeout = max(min(default_s, self.maximum), self.minimum)
        self._mu = threading.Lock()
        self._entries: list[tuple[bool, float]] = []   # (timed_out, took_s)

    def timeout(self) -> float:
        with self._mu:
            return self._timeout

    def log_success(self, took_s: float) -> None:
        self._log(False, took_s)

    def log_timeout(self) -> None:
        self._log(True, 0.0)

    def _log(self, timed_out: bool, took_s: float) -> None:
        with self._mu:
            self._entries.append((timed_out, took_s))
            if len(self._entries) < self.WINDOW:
                return
            n_timeout = sum(1 for t, _ in self._entries if t)
            frac = n_timeout / len(self._entries)
            if frac >= self.GROW_TRIGGER:
                self._timeout = min(self._timeout * self.GROW,
                                    self.maximum)
            elif frac < self.SHRINK_TRIGGER:
                # Gradual shrink toward the p95 of successes (with 2x
                # headroom), at most one GROW step per window so a
                # mistake costs one window, not a cliff.
                succ = sorted(took for t, took in self._entries if not t)
                if succ:
                    p_high = succ[max(int(len(succ) * 0.95) - 1, 0)]
                    candidate = max(p_high * 2.0, self.minimum,
                                    self._timeout / self.GROW)
                    if candidate < self._timeout:
                        self._timeout = candidate
            # frac in [SHRINK_TRIGGER, GROW_TRIGGER): neutral band, hold.
            self._entries.clear()
