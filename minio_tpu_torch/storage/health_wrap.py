"""Drive health wrapper (counterpart of minio_tpu/storage/health_wrap.py): per-API latency EWMAs + an active circuit breaker.

The xlStorageDiskIDCheck equivalent (/root/reference/cmd/xl-storage-disk-
id-check.go:68): every StorageAPI call on the wrapped drive is timed into
an exponentially-weighted moving average and counted, giving the
scanner/metrics/admin layers a live per-drive, per-API health picture
without touching the drive implementation. Wraps LocalDrive or
RemoteDrive alike (anything with the drive method surface).

On top of the passive stats sits the breaker state machine the reference
runs per disk (checkHealth + monitorDiskWritable):

    OK --consecutive errors / latency breaches--> SUSPECT
    SUSPECT --more consecutive errors--> OFFLINE   (background prober)
    SUSPECT --one clean call--> OK
    OFFLINE --probe succeeds--> OK

While OFFLINE every storage call fails fast with ErrDiskNotFound (the
circuit is open): reads go straight to parity spares, writes miss the
drive and land in the MRF queue, and nothing waits multi-second I/O
timeouts on hardware already known dead.  A daemon prober re-checks the
raw drive on a jittered interval and closes the circuit when it answers;
`close()` stops it (the boot's drain calls it).  The module's `stats()`
counts the state transitions (the JAX package records them into
DATA_PATH).

Env knobs (read per call so tests flip them without rebuilding):
  MTPU_BREAKER=0              disable (passive-stats-only oracle mode)
  MTPU_BREAKER_ERRS           consecutive errors -> SUSPECT  (default 3)
  MTPU_BREAKER_OFFLINE_ERRS   consecutive errors -> OFFLINE  (default 8)
  MTPU_BREAKER_SLOW_MS        per-call latency breach bound  (default 2000)
  MTPU_BREAKER_SLOW_CALLS     consecutive breaches -> SUSPECT (default 5)
  MTPU_BREAKER_PROBE_S        base probe interval, jittered  (default 1.0)

The batched metadata calls (`write_metadata_many`, `read_version_many`,
ops/metalanes.py) return an error per item instead of raising; each
failed item counts against the drive as a failed solo call would, and
the call's whole time is judged once for slowness (every item waited
that long).
"""

from __future__ import annotations

import os
import random
import threading
import time

_STATS_MU = threading.Lock()
_TRANSITIONS = {"ok": 0, "suspect": 0, "offline": 0}


def stats() -> dict:
    """Breaker transitions into each state, over every wrapped drive of
    the process."""
    with _STATS_MU:
        return {"transitions": dict(_TRANSITIONS)}


#: the batched drive calls, which return their items' errors instead of
#: raising: how to read them from the result
_ITEM_ERRORS = {
    "write_metadata_many": lambda res: list(res),
    "read_version_many": lambda res: [e for _, e in res],
}


class APIStats:
    __slots__ = ("calls", "errors", "ewma_ms", "last_ms")

    def __init__(self):
        self.calls = 0
        self.errors = 0
        self.ewma_ms = 0.0
        self.last_ms = 0.0


def breaker_enabled() -> bool:
    return os.environ.get("MTPU_BREAKER", "1") != "0"


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def drive_available(d) -> bool:
    """Whether the engine should fan READ work out to this drive: not a
    hole in the stripe, not breaker-OFFLINE, and (for remote drives) not
    known-dead by the RPC health checker.  Writes still attempt every
    drive — a miss there is what feeds the MRF queue."""
    if d is None:
        return False
    hs = getattr(d, "health_state", None)
    if hs is not None and hs() == "offline":
        return False
    online = getattr(d, "is_online", None)
    if online is not None:
        try:
            return bool(online())
        except Exception:  # noqa: BLE001 — health probe must not throw
            return True
    return True


class HealthWrappedDrive:
    """Transparent instrumentation proxy + circuit breaker for a drive."""

    EWMA_ALPHA = 0.2
    MAX_TRANSITIONS = 64
    _INTERNAL = ("_drive", "_stats", "_mu", "_timed_cache", "_state",
                 "_consec_errs", "_consec_slow", "_transitions",
                 "_prober", "_probe_seq", "_last_fault", "_probe_stop")

    def __init__(self, drive):
        object.__setattr__(self, "_drive", drive)
        object.__setattr__(self, "_stats", {})
        object.__setattr__(self, "_mu", threading.Lock())
        object.__setattr__(self, "_timed_cache", {})
        object.__setattr__(self, "_state", "ok")
        object.__setattr__(self, "_consec_errs", 0)
        object.__setattr__(self, "_consec_slow", 0)
        object.__setattr__(self, "_transitions", [])
        object.__setattr__(self, "_prober", None)
        object.__setattr__(self, "_probe_seq", 0)
        object.__setattr__(self, "_last_fault", "")
        object.__setattr__(self, "_probe_stop", threading.Event())

    # identity/attribute passthrough ----------------------------------------

    @property
    def __class__(self):  # noqa: D105
        # isinstance-transparency: the engine's fast-path gates
        # (serial local fan-out, mmap read_file_view) key on
        # isinstance(d, LocalDrive) and must see through the proxy.
        return type(self._drive)

    def __setattr__(self, name, value):
        # Attribute writes (e.g. format bootstrap assigning disk_id) must
        # reach the REAL drive, or reads-via-methods and reads-via-attr
        # silently diverge.
        if name in self._INTERNAL:
            object.__setattr__(self, name, value)
        else:
            setattr(self._drive, name, value)

    @staticmethod
    def _benign(e: Exception) -> bool:
        """Expected control-flow errors must not count against drive
        health (the reference excludes not-found classes the same way)."""
        from .errors import (ErrFileNotFound, ErrFileVersionNotFound,
                             ErrObjectNotFound, ErrPathNotFound,
                             ErrVersionNotFound, ErrVolumeExists,
                             ErrVolumeNotFound)
        return isinstance(e, (ErrFileNotFound, ErrFileVersionNotFound,
                              ErrObjectNotFound, ErrPathNotFound,
                              ErrVersionNotFound, ErrVolumeExists,
                              ErrVolumeNotFound))

    def __getattr__(self, name):
        cached = self._timed_cache.get(name)
        if cached is not None:
            return cached
        attr = getattr(self._drive, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def timed(*args, **kwargs):
            if self._state == "offline" and breaker_enabled():
                # Open circuit: fail fast, never touch dead hardware.
                # The failure is NOT recorded into the stats — the
                # breaker must not count its own rejections as fresh
                # drive errors.
                from .errors import ErrDiskNotFound
                raise ErrDiskNotFound(
                    f"{getattr(self._drive, 'root', '?')}: circuit open "
                    f"({self._last_fault})")
            t0 = time.perf_counter()
            err: Exception | None = None
            outcomes: list = []
            try:
                res = attr(*args, **kwargs)
                if name in _ITEM_ERRORS:
                    outcomes = _ITEM_ERRORS[name](res)
                return res
            except Exception as e:
                err = e
                raise
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                if not outcomes:
                    outcomes = [err]
                faults = [e if e is not None and not self._benign(e)
                          else None for e in outcomes]
                with self._mu:
                    st = self._stats.setdefault(name, APIStats())
                    st.calls += 1
                    st.errors += sum(1 for f in faults if f is not None)
                    st.last_ms = ms
                    st.ewma_ms = (ms if st.calls == 1 else
                                  self.EWMA_ALPHA * ms
                                  + (1 - self.EWMA_ALPHA) * st.ewma_ms)
                # A batched call's failed items count as the failed
                # single calls they stand for: a drive that fails every
                # laned publish trips the breaker as one failing every
                # solo publish does.  Its clean items count once, at the
                # call's full time, so a stalled drive breaches the slow
                # bound whatever the batch's size.
                for fault in faults:
                    if fault is not None:
                        self._breaker_record(name, ms, fault)
                if any(f is None for f in faults):
                    self._breaker_record(name, ms, None)
        timed.__name__ = name
        self._timed_cache[name] = timed
        return timed

    # breaker ----------------------------------------------------------------

    def _breaker_record(self, api: str, ms: float,
                        fault: Exception | None) -> None:
        if not breaker_enabled():
            return
        slow = ms > _env_num("MTPU_BREAKER_SLOW_MS", 2000.0)
        start_probe = False
        with self._mu:
            if fault is not None:
                self._consec_errs += 1
                self._consec_slow = 0
                self._last_fault = f"{api}: {type(fault).__name__}"
            elif slow:
                self._consec_slow += 1
                self._consec_errs = 0
                self._last_fault = f"{api}: {ms:.0f} ms"
            else:
                # One clean, fast call closes a half-open circuit.
                self._consec_errs = 0
                self._consec_slow = 0
                if self._state == "suspect":
                    self._transition("ok", "clean call")
                return
            if self._state == "ok" and (
                    self._consec_errs
                    >= _env_num("MTPU_BREAKER_ERRS", 3)
                    or self._consec_slow
                    >= _env_num("MTPU_BREAKER_SLOW_CALLS", 5)):
                self._transition("suspect", self._last_fault)
            if self._state == "suspect" and self._consec_errs \
                    >= _env_num("MTPU_BREAKER_OFFLINE_ERRS", 8):
                self._transition("offline", self._last_fault)
                start_probe = True
        if start_probe:
            self._start_prober()

    def _transition(self, to: str, reason: str) -> None:
        """State change under self._mu (caller holds it)."""
        frm = self._state
        if frm == to:
            return
        object.__setattr__(self, "_state", to)
        self._transitions.append(
            {"t": time.time(), "from": frm, "to": to, "reason": reason})
        del self._transitions[:-self.MAX_TRANSITIONS]
        with _STATS_MU:
            _TRANSITIONS[to] += 1

    def _probe_ok(self) -> bool:
        """One direct probe of the RAW drive (bypasses the open
        circuit): cheap statvfs-level call, any answer closes it."""
        try:
            self._drive.disk_info()
            return True
        except Exception:  # noqa: BLE001 — still dead
            return False

    def probe_now(self) -> bool:
        """Synchronous probe (tests/admin): closes the circuit on
        success.  Returns whether the drive answered."""
        ok = self._probe_ok()
        if ok:
            with self._mu:
                self._consec_errs = 0
                self._consec_slow = 0
                if self._state != "ok":
                    self._transition("ok", "probe ok")
        return ok

    def _start_prober(self) -> None:
        with self._mu:
            if self._probe_stop.is_set() or (
                    self._prober is not None and self._prober.is_alive()):
                return
            self._probe_seq += 1
            seq = self._probe_seq

            def loop():
                rng = random.Random(id(self) ^ seq)
                while self._state == "offline" and seq == self._probe_seq:
                    base = _env_num("MTPU_BREAKER_PROBE_S", 1.0)
                    # Jittered interval: a whole stripe probing dead
                    # drives must not do so in lockstep.
                    if self._probe_stop.wait(base * (0.5 + rng.random())):
                        return
                    if self.probe_now():
                        return

            t = threading.Thread(target=loop, daemon=True,
                                 name="mtpu-drive-probe")
            object.__setattr__(self, "_prober", t)
            t.start()

    def close(self) -> None:
        """Stop the prober (the drain path): its wait ends at once and
        no new one starts."""
        self._probe_stop.set()
        t = self._prober
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    # stats surface ----------------------------------------------------------

    def health_state(self) -> str:
        """"ok" | "suspect" | "offline" (always "ok" when the breaker
        oracle flag MTPU_BREAKER=0 is set)."""
        return self._state if breaker_enabled() else "ok"

    def health_info(self) -> dict:
        with self._mu:
            return {"state": self.health_state(),
                    "consecutive_errors": self._consec_errs,
                    "consecutive_slow": self._consec_slow,
                    "last_fault": self._last_fault,
                    "transitions": list(self._transitions)}

    def api_stats(self) -> dict[str, dict]:
        with self._mu:
            return {name: {"calls": st.calls, "errors": st.errors,
                           "ewma_ms": round(st.ewma_ms, 3),
                           "last_ms": round(st.last_ms, 3)}
                    for name, st in self._stats.items()}

    def total_errors(self) -> int:
        with self._mu:
            return sum(st.errors for st in self._stats.values())

    def slowest_apis(self, n: int = 5) -> list[tuple[str, float]]:
        with self._mu:
            items = sorted(((name, st.ewma_ms)
                            for name, st in self._stats.items()),
                           key=lambda t: -t[1])
        return items[:n]


def wrap_drives(drives: list) -> list:
    """Wrap every non-None drive in a set with health instrumentation."""
    return [None if d is None else HealthWrappedDrive(d) for d in drives]
