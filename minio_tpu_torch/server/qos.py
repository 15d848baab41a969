"""The overload plane: admission control, per-tenant QoS, background yield.

The port of minio_tpu/server/qos.py (the port keeps its own code, so that
it imports nothing of the JAX package).  The reference bounds foreground
concurrency with a requests-max semaphore and a deadline queue
(cmd/handler-api.go maxClients): a request that cannot get a slot within
its deadline is shed with 503 SlowDown + Retry-After — bounded memory
under any offered load, never an OOM from buffered sockets.  This module
is that plane plus the two siblings the reference spreads across
cmd/bucket-quota.go and the bandwidth monitor:

  * **Admission control** — `QoSPlane.acquire/release` around every
    S3 request (health, admin and metrics stay exempt, as at the drain
    gate).  `MTPU_REQUESTS_MAX` slots (auto-sized from worker count
    when unset), `MTPU_REQUESTS_DEADLINE_MS` of bounded queueing, and
    a hard queue cap (`MTPU_QOS_QUEUE`) past which sheds are instant.
  * **Tenant classes** — access keys map to premium/standard/
    best-effort (`MTPU_QOS_TENANTS`).  Admission runs a priority
    ladder: best-effort may only take a slot while occupancy is below
    its rung, so under saturation best-effort sheds first and premium
    p99 stays bounded.  Per-class token buckets (`MTPU_QOS_CLASSES`,
    req/s + bytes/s) and per-bucket bandwidth budgets (the `bandwidth`
    field of the bucket quota config) throttle on top.
  * **Pressure signal** — an EMA of admission occupancy, exported to
    the background planes: `scale_workers` shrinks batch concurrency
    and `bg_pause` sleeps between items, so background work stops
    competing with foreground GET/PUT under load and recovers when
    pressure clears.  Heal, the scanner, decommission and replication
    take them, and the ILM transition workers `scale_workers("ilm")`
    (bucket/tier.run_transitions).

Fork-shared by construction: all mutable state lives in one anonymous
``mmap(-1)`` guarded by a fork-inherited lock, created BEFORE the worker
pool forks (server/workers.py), so ``MTPU_WORKERS=N`` enforces ONE global
cap and one global pressure signal, not N local ones.

Where the port differs from the JAX plane:

- the lock is ops/shm_lock.ShmLock (robust, with a futex condition): a
  worker SIGKILLed inside it does not freeze admission for the pool;
- occupancy (in flight and waiting) is kept per worker row as well as
  in the pool totals, which are the rows' sums.  A worker killed while
  it holds slots or waits for one leaves its row behind; the supervisor
  clears that row when it reaps the worker (`clear_row`), before the
  respawn serves, and the next locker after a holder that died inside
  the lock recomputes the totals from the rows.  The JAX plane keeps
  only pool-wide counters, so every such death leaks its slots for the
  pool's life (and keeps the pressure EMA up).

``MTPU_QOS=0`` is the kill switch: acquire/throttle/yield all become
no-ops and responses are byte-identical to the QoS build on unsheded
traffic (admission adds no headers, no body bytes — only 503s differ,
and those only exist under saturation).
"""

from __future__ import annotations

import math
import mmap
import os
import threading
import time
import zlib

from ..ops.shm_lock import ShmLock


#: Admission knobs.
MAX_ENV = "MTPU_REQUESTS_MAX"
DEADLINE_ENV = "MTPU_REQUESTS_DEADLINE_MS"
QUEUE_ENV = "MTPU_QOS_QUEUE"
#: Tenant/class knobs.
TENANTS_ENV = "MTPU_QOS_TENANTS"       # ak=class,ak2=class
CLASSES_ENV = "MTPU_QOS_CLASSES"       # class=rps:bytes_per_s,...
LADDER_ENV = "MTPU_QOS_LADDER"         # premium,standard,best-effort fracs
#: Background-yield knobs.
BG_SLEEP_ENV = "MTPU_QOS_BG_SLEEP_MS"
DEFAULT_DEADLINE_MS = 1000.0
DEFAULT_BG_SLEEP_MS = 50.0

CLASSES = ("premium", "standard", "best-effort")
DEFAULT_CLASS = "standard"
#: Occupancy fraction of the slot budget each class may fill: under
#: saturation best-effort stops being admitted at 50%, standard at
#: 90%, premium rides to the cap — the priority ladder that keeps
#: premium p99 bounded while best-effort sheds.
DEFAULT_LADDER = (1.0, 0.9, 0.5)

#: Shared header slots (i64).  Single-writer-per-transition under the
#: plane lock; readers are lock-free (a torn read moves one sample, it
#: cannot corrupt a counter).  The totals _H_INFLIGHT and _H_WAITING are
#: the sums of the per-worker rows that follow the token-bucket table.
_H_INFLIGHT = 0
_H_WAITING = 1
_H_ADMITTED = 2
_H_SHED = 3
_H_WAIT_US = 4
_H_PRESSURE_MILLI = 5
_H_PRESSURE_STAMP_US = 6
_H_BG_YIELDS = 7
_H_TENANT_THROTTLED = 8
_H_BUCKET_THROTTLED = 9
_H_ADMITTED_CLASS = 10      # +0 premium, +1 standard, +2 best-effort
_H_SHED_CLASS = 13
_H_SHED_DEADLINE = 16
_H_SHED_QUEUE = 17
_H_FORCED_MILLI = 18        # test hook: >=0 overrides pressure()
_HDR = 24

#: Token-bucket slot table: hash-addressed open probing, 6 i64 per
#: slot: key_hash, rps_tokens_milli, rps_stamp_us, bw_tokens_bytes,
#: bw_stamp_us, reserved.  128 slots cover any sane tenant count; a
#: full table degrades to "not limited" (never to blocking).
_TB_SLOTS = 128
_TB_STRIDE = 6
#: per-worker occupancy row: in flight, waiting
_ROW_INFLIGHT = 0
_ROW_WAITING = 1
_ROW_STRIDE = 2

_EMA_ALPHA = 0.3
_PRESSURE_HALF_LIFE_S = 2.0
#: Below this pressure the background planes run at full width.
BG_THRESHOLD = 0.1


def qos_enabled() -> bool:
    """MTPU_QOS=0 is the byte-identical oracle (read per call, like
    every other MTPU_* kill switch)."""
    return os.environ.get("MTPU_QOS", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_requests_max(nworkers: int = 0) -> int:
    """Auto-size the slot budget from worker count when MTPU_REQUESTS_MAX
    is unset: enough concurrency that admission is invisible on a
    healthy box, small enough that a flood queues instead of OOMing."""
    raw = os.environ.get(MAX_ENV, "")
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    cpu = os.cpu_count() or 4
    return 32 * cpu * max(1, int(nworkers))


#: (raw env string, parsed result) — the parse is re-run only when the
#: env var actually changes, keeping the per-request cost to one dict
#: lookup on the hot path.
_classes_memo: tuple[str, dict] = ("\x00", {})
_tenants_memo: tuple[str, dict] = ("\x00", {})


def classes_config() -> dict[str, tuple[float, float]]:
    """class -> (req/s, bytes/s); 0 = unlimited (the default, so the
    oracle stays byte-identical until someone configures rates)."""
    global _classes_memo
    raw = os.environ.get(CLASSES_ENV, "")
    if raw == _classes_memo[0]:
        return _classes_memo[1]
    out = {c: (0.0, 0.0) for c in CLASSES}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, spec = part.partition("=")
        name = name.strip()
        if name not in out:
            continue
        rps, _, bw = spec.partition(":")
        try:
            out[name] = (max(0.0, float(rps or 0)),
                         max(0.0, float(bw or 0)))
        except ValueError:
            continue
    _classes_memo = (raw, out)
    return out


def tenant_class(access_key: str) -> str:
    """Resolve an access key to its tenant class (MTPU_QOS_TENANTS=
    "ak=premium,ak2=best-effort"); unknown keys are standard."""
    global _tenants_memo
    raw = os.environ.get(TENANTS_ENV, "")
    if raw != _tenants_memo[0]:
        m = {}
        for part in raw.split(","):
            name, _, klass = part.strip().partition("=")
            if name and klass in CLASSES:
                m[name] = klass
        _tenants_memo = (raw, m)
    if access_key:
        return _tenants_memo[1].get(access_key, DEFAULT_CLASS)
    return DEFAULT_CLASS


def _ladder() -> tuple[float, float, float]:
    raw = os.environ.get(LADDER_ENV, "")
    if raw:
        try:
            vals = tuple(float(v) for v in raw.split(","))
            if len(vals) == 3 and all(0.0 < v <= 1.0 for v in vals):
                return vals  # type: ignore[return-value]
        except ValueError:
            pass
    return DEFAULT_LADDER


def _key_hash(key: str) -> int:
    # crc32 folded to a nonzero i63: zero marks an empty bucket slot.
    h = zlib.crc32(key.encode()) & 0x7FFFFFFF
    return h or 1


class QoSPlane:
    """Fork-shared admission semaphore + deadline queue + token-bucket
    table + pressure EMA + per-worker occupancy rows.  Create before fork
    (WorkerPlane does); every inherited copy mutates the SAME mapping
    under the SAME fork-inherited lock.  A process counts its occupancy
    in row 0 until `bind_row(worker)` names its own."""

    def __init__(self, nworkers: int = 0,
                 max_slots: int | None = None,
                 deadline_ms: float | None = None,
                 queue_max: int | None = None):
        if max_slots is None:
            max_slots = default_requests_max(nworkers)
        self.max_slots = max(1, int(max_slots))
        if deadline_ms is None:
            deadline_ms = _env_float(DEADLINE_ENV, DEFAULT_DEADLINE_MS)
        self.deadline_s = max(0.0, deadline_ms) / 1e3
        if queue_max is None:
            raw = os.environ.get(QUEUE_ENV, "")
            try:
                queue_max = int(raw) if raw != "" else 4 * self.max_slots
            except ValueError:
                queue_max = 4 * self.max_slots
        self.queue_max = max(0, int(queue_max))
        self.ladder = dict(zip(CLASSES, _ladder()))
        #: Per-class slot limits, precomputed: the acquire fast path
        #: is two dict/list lookups + three slab increments.
        self._limits = [max(1, math.ceil(f * self.max_slots))
                        for f in (*self.ladder.values(), 1.0)]
        self._class_idx = {c: i for i, c in enumerate(CLASSES)}
        self.nrows = max(1, int(nworkers))
        self._rows_off = _HDR + _TB_SLOTS * _TB_STRIDE
        nbytes = (self._rows_off + self.nrows * _ROW_STRIDE) * 8
        self._mm = mmap.mmap(-1, nbytes)
        # memoryview.cast, not np.frombuffer: scalar loads/stores on a
        # cast memoryview return plain ints several times faster than
        # numpy 0-d indexing, and this slab is ONLY ever touched one
        # scalar at a time on the request hot path.
        self._a = memoryview(self._mm).cast("q")
        self._a[_H_FORCED_MILLI] = -1
        self._cv = ShmLock(on_owner_dead=self._repair_locked)
        #: this process's occupancy row (process-local: set after fork)
        self._row = self._rows_off
        #: Per-plane background yield tallies (process-local; the
        #: shared slab keeps the pool-wide total).
        self.bg_yields: dict[str, int] = {}
        self._bg_mu = threading.Lock()

    # -- per-worker rows -----------------------------------------------------

    def _row_off(self, worker: int) -> int:
        return self._rows_off + (int(worker) % self.nrows) * _ROW_STRIDE

    def bind_row(self, worker: int) -> None:
        """Count this process's occupancy in `worker`'s row (a pool
        worker calls it after its fork)."""
        self._row = self._row_off(worker)

    def _occupy(self, field: int, delta: int) -> None:
        """Move one occupancy count (under the lock): the process's row
        and the pool total together."""
        self._a[self._row + field] += delta
        self._a[_H_INFLIGHT if field == _ROW_INFLIGHT else _H_WAITING] \
            += delta

    def row(self, worker: int) -> tuple[int, int]:
        """(in flight, waiting) counted in `worker`'s row."""
        off = self._row_off(worker)
        return (int(self._a[off + _ROW_INFLIGHT]),
                int(self._a[off + _ROW_WAITING]))

    def clear_row(self, worker: int) -> tuple[int, int]:
        """Give back what a dead worker held or waited for: its row goes
        to 0 and leaves the totals, and waiters look again.  The
        supervisor calls it when it reaps the worker, before the respawn
        serves.  Returns the (in flight, waiting) cleared."""
        off = self._row_off(worker)
        a = self._a
        with self._cv:
            held = (int(a[off + _ROW_INFLIGHT]), int(a[off + _ROW_WAITING]))
            a[off + _ROW_INFLIGHT] = 0
            a[off + _ROW_WAITING] = 0
            self._recount_locked()
            self._cv.notify_all()
        return held

    def _recount_locked(self) -> None:
        rows = self._rows_off
        a = self._a
        a[_H_INFLIGHT] = sum(int(a[rows + r * _ROW_STRIDE + _ROW_INFLIGHT])
                             for r in range(self.nrows))
        a[_H_WAITING] = sum(int(a[rows + r * _ROW_STRIDE + _ROW_WAITING])
                            for r in range(self.nrows))

    def _repair_locked(self) -> None:
        """A process died inside the lock, perhaps between a row and its
        total: the totals are the rows' sums again."""
        self._recount_locked()
        self._cv.notify_all()

    # -- admission -----------------------------------------------------------

    def _class_limit(self, klass: str) -> int:
        return self._limits[self._class_idx.get(klass, 1)]

    def _update_pressure_locked(self, force: bool = False) -> None:
        a = self._a
        now_us = int(time.time() * 1e6)
        # Sample at most every 50 ms unless forced: the EMA feeds a
        # 2 s-half-life background-yield signal, so per-request
        # resampling buys nothing but hot-path float work.
        if not force and now_us - a[_H_PRESSURE_STAMP_US] < 50_000:
            return
        raw = min(1.0, (a[_H_INFLIGHT] + a[_H_WAITING])
                  / float(self.max_slots + max(1, self.queue_max)))
        prev = a[_H_PRESSURE_MILLI] / 1e3
        dt = max(0.0, (now_us - a[_H_PRESSURE_STAMP_US]) / 1e6)
        # Stale EMA decays toward the fresh sample before blending, so
        # one ancient spike cannot dominate a quiet plane.
        prev *= 0.5 ** (dt / _PRESSURE_HALF_LIFE_S)
        ema = prev + _EMA_ALPHA * (raw - prev)
        a[_H_PRESSURE_MILLI] = int(ema * 1e3)
        a[_H_PRESSURE_STAMP_US] = now_us

    def acquire(self, klass: str = DEFAULT_CLASS) -> tuple[str, float]:
        """Take one admission slot.  Returns (verdict, queue_wait_s):
        verdict "ok" (slot held — caller MUST release()), or
        "shed-queue" / "shed-deadline" (no slot; shed with 503
        SlowDown).  Never blocks past the deadline, never queues past
        the queue cap — bounded memory at any offered load."""
        ci = self._class_idx.get(klass, 1)
        limit = self._limits[ci]
        a = self._a
        with self._cv:
            if a[_H_INFLIGHT] < limit:
                self._occupy(_ROW_INFLIGHT, 1)
                a[_H_ADMITTED] += 1
                a[_H_ADMITTED_CLASS + ci] += 1
                self._update_pressure_locked()
                return "ok", 0.0
            if a[_H_WAITING] >= self.queue_max \
                    or self.deadline_s <= 0:
                a[_H_SHED] += 1
                a[_H_SHED_CLASS + ci] += 1
                a[_H_SHED_QUEUE] += 1
                self._update_pressure_locked(force=True)
                return "shed-queue", 0.0
            t0 = time.monotonic()
            deadline = t0 + self.deadline_s
            self._occupy(_ROW_WAITING, 1)
            self._update_pressure_locked(force=True)
            try:
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        a[_H_SHED] += 1
                        a[_H_SHED_CLASS + ci] += 1
                        a[_H_SHED_DEADLINE] += 1
                        return "shed-deadline", time.monotonic() - t0
                    self._cv.wait(left)
                    if int(a[_H_INFLIGHT]) < limit:
                        wait = time.monotonic() - t0
                        self._occupy(_ROW_INFLIGHT, 1)
                        a[_H_ADMITTED] += 1
                        a[_H_ADMITTED_CLASS + ci] += 1
                        a[_H_WAIT_US] += int(wait * 1e6)
                        return "ok", wait
            finally:
                self._occupy(_ROW_WAITING, -1)
                self._update_pressure_locked(force=True)

    def release(self) -> None:
        a = self._a
        with self._cv:
            self._occupy(_ROW_INFLIGHT, -1)
            # No pressure resample here: occupancy falling is exactly
            # what the read-side wall decay models, and the next
            # acquire resamples anyway.
            # notify_all, not notify: waiters hold different class
            # rungs — the head waiter may be barred while a premium
            # one further back is admissible.  Skipped entirely on the
            # (overwhelmingly common) uncontended release.
            if a[_H_WAITING]:
                self._cv.notify_all()

    # -- token buckets (tenant req/s + bytes/s, bucket bytes/s) --------------

    def _tb_slot(self, key: str) -> int | None:
        """Find-or-claim the bucket slot for `key` (linear probe from
        the key hash).  Returns the array offset of the slot, or None
        when the table is full (degrade to unlimited, never block)."""
        h = _key_hash(key)
        for i in range(_TB_SLOTS):
            off = _HDR + ((h + i) % _TB_SLOTS) * _TB_STRIDE
            cur = int(self._a[off])
            if cur == h:
                return off
            if cur == 0:
                self._a[off] = h
                return off
        return None

    def _bucket_take(self, off: int, tokens_idx: int, stamp_idx: int,
                     rate: float, burst: float, need: float,
                     scale: float) -> bool:
        """Shared-slab token bucket: refill by elapsed wall time, then
        spend.  `scale` maps the float token unit onto the i64 slot.
        A bucket may go negative by one burst (post-paid bandwidth
        charges); admission requires a positive balance."""
        now_us = int(time.time() * 1e6)
        a = self._a
        last = int(a[off + stamp_idx])
        if last == 0:
            a[off + tokens_idx] = int(burst * scale)
            a[off + stamp_idx] = now_us
        else:
            dt = max(0.0, (now_us - last) / 1e6)
            refill = int(rate * dt * scale)
            # Stamp advances only when whole tokens landed, so slow
            # rates accumulate fractional refill instead of losing it
            # to integer truncation on every busy-poll.
            if refill > 0:
                a[off + tokens_idx] = min(
                    int(burst * scale),
                    int(a[off + tokens_idx]) + refill)
                a[off + stamp_idx] = now_us
        have = int(a[off + tokens_idx])
        need_i = int(need * scale)
        if need_i > 0:
            if have < need_i:
                return False
            a[off + tokens_idx] = have - need_i
            return True
        # need == 0: admission probe — a post-paid bucket admits while
        # its balance is positive and refuses while it repays debt.
        return have > 0

    def tenant_admit(self, access_key: str, klass: str) -> bool:
        """One request against the tenant's req/s bucket.  Unlimited
        classes (rate 0 — the default) short-circuit True."""
        rps, _ = classes_config().get(klass, (0.0, 0.0))
        if rps <= 0 or not access_key:
            return True
        with self._cv:
            off = self._tb_slot("t:" + access_key)
            if off is None:
                return True
            ok = self._bucket_take(off, 1, 2, rps, max(1.0, rps), 1.0,
                                   1e3)
            if not ok:
                self._a[_H_TENANT_THROTTLED] += 1
            return ok

    def tenant_bw_ok(self, access_key: str, klass: str) -> bool:
        """Positive-balance check on the tenant's bytes/s bucket
        (bytes are charged post-response, so the bucket runs a debt of
        at most one burst)."""
        _, bw = classes_config().get(klass, (0.0, 0.0))
        if bw <= 0 or not access_key:
            return True
        with self._cv:
            off = self._tb_slot("t:" + access_key)
            if off is None:
                return True
            ok = self._bucket_take(off, 3, 4, bw, bw, 0.0, 1.0)
            if not ok:
                self._a[_H_TENANT_THROTTLED] += 1
            return ok

    def charge_tenant_bw(self, access_key: str, klass: str,
                         nbytes: int) -> None:
        _, bw = classes_config().get(klass, (0.0, 0.0))
        if bw <= 0 or not access_key or nbytes <= 0:
            return
        with self._cv:
            off = self._tb_slot("t:" + access_key)
            if off is not None:
                self._a[off + 3] = int(self._a[off + 3]) - int(nbytes)
                now_us = int(time.time() * 1e6)
                if int(self._a[off + 4]) == 0:
                    self._a[off + 4] = now_us

    def bucket_bw_ok(self, bucket: str, rate: float) -> bool:
        """Per-BUCKET bandwidth budget (the `bandwidth` field of the
        quota config, cmd/bucket-quota.go enforcement + the bandwidth
        monitor's accounting)."""
        if rate <= 0 or not bucket:
            return True
        with self._cv:
            off = self._tb_slot("b:" + bucket)
            if off is None:
                return True
            ok = self._bucket_take(off, 3, 4, rate, rate, 0.0, 1.0)
            if not ok:
                self._a[_H_BUCKET_THROTTLED] += 1
            return ok

    def charge_bucket_bw(self, bucket: str, rate: float,
                         nbytes: int) -> None:
        if rate <= 0 or not bucket or nbytes <= 0:
            return
        with self._cv:
            off = self._tb_slot("b:" + bucket)
            if off is not None:
                self._a[off + 3] = int(self._a[off + 3]) - int(nbytes)
                now_us = int(time.time() * 1e6)
                if int(self._a[off + 4]) == 0:
                    self._a[off + 4] = now_us

    # -- pressure + background yield -----------------------------------------

    def pressure(self) -> float:
        """Admission occupancy EMA in [0, 1], decayed by wall time so
        a quiet plane reads 0 even when no request refreshes it."""
        forced = int(self._a[_H_FORCED_MILLI])
        if forced >= 0:
            return forced / 1e3
        ema = int(self._a[_H_PRESSURE_MILLI]) / 1e3
        dt = max(0.0, time.time()
                 - int(self._a[_H_PRESSURE_STAMP_US]) / 1e6)
        return ema * 0.5 ** (dt / _PRESSURE_HALF_LIFE_S)

    def _force_pressure(self, v: float | None) -> None:
        """Test hook: pin pressure() to `v` (None restores the live
        EMA).  Shared-slab, so forked workers see the pin too."""
        self._a[_H_FORCED_MILLI] = (-1 if v is None
                                    else int(max(0.0, v) * 1e3))

    def scale_workers(self, n: int, plane: str = "") -> int:
        """Effective background batch concurrency under pressure: full
        width below the threshold, shrinking to 1 as the admission
        plane saturates.  Every shrink counts as a yield."""
        n = max(1, int(n))
        p = self.pressure()
        if p <= BG_THRESHOLD or n == 1:
            return n
        eff = max(1, int(math.floor(n * (1.0 - p))))
        if eff < n:
            self._note_bg_yield(plane)
        return eff

    def bg_pause(self, plane: str = "") -> float:
        """Sleep between background batch items proportionally to
        pressure; returns the seconds slept (0 under the threshold —
        the healthy-path overhead is one float compare)."""
        p = self.pressure()
        if p <= BG_THRESHOLD:
            return 0.0
        sleep_s = p * _env_float(BG_SLEEP_ENV, DEFAULT_BG_SLEEP_MS) / 1e3
        if sleep_s > 0:
            self._note_bg_yield(plane)
            time.sleep(sleep_s)
        return sleep_s

    def _note_bg_yield(self, plane: str) -> None:
        self._a[_H_BG_YIELDS] += 1
        if plane:
            with self._bg_mu:
                self.bg_yields[plane] = self.bg_yields.get(plane, 0) + 1

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        a = self._a
        per_class = {c: {"admitted": int(a[_H_ADMITTED_CLASS + i]),
                         "shed": int(a[_H_SHED_CLASS + i])}
                     for i, c in enumerate(CLASSES)}
        return {
            "enabled": qos_enabled(),
            "max_slots": self.max_slots,
            "queue_max": self.queue_max,
            "deadline_ms": round(self.deadline_s * 1e3, 1),
            "inflight": int(a[_H_INFLIGHT]),
            "waiting": int(a[_H_WAITING]),
            "admitted": int(a[_H_ADMITTED]),
            "shed": int(a[_H_SHED]),
            "shed_deadline": int(a[_H_SHED_DEADLINE]),
            "shed_queue": int(a[_H_SHED_QUEUE]),
            "queue_wait_seconds": int(a[_H_WAIT_US]) / 1e6,
            "pressure": round(self.pressure(), 4),
            "bg_yields": int(a[_H_BG_YIELDS]),
            "bg_yields_by_plane": dict(self.bg_yields),
            "tenant_throttled": int(a[_H_TENANT_THROTTLED]),
            "bucket_throttled": int(a[_H_BUCKET_THROTTLED]),
            "classes": per_class,
        }

    def worker_rows(self) -> list[tuple[int, int]]:
        """(in flight, waiting) of every worker row."""
        return [self.row(r) for r in range(self.nrows)]


# -- process-global plane ----------------------------------------------------

_PLANE: QoSPlane | None = None
_PLANE_MU = threading.Lock()


def get_plane(nworkers: int = 0) -> QoSPlane:
    """The process-tree singleton.  WorkerPlane calls this BEFORE the
    first fork (the mapping must exist pre-fork, like the hot-cache
    segment); single-process servers create it lazily on first use.
    Children inherit the module global along with the mapping."""
    global _PLANE
    with _PLANE_MU:
        if _PLANE is None:
            _PLANE = QoSPlane(nworkers=nworkers)
        return _PLANE


def reset_for_tests() -> None:
    """Drop the singleton so the next get_plane() re-reads env knobs —
    test-only (a live server holds its own reference)."""
    global _PLANE
    with _PLANE_MU:
        _PLANE = None


def maybe_plane() -> QoSPlane | None:
    """The singleton if QoS is on, else None (the oracle's fast path:
    one env read, zero shared-memory touches)."""
    if not qos_enabled():
        return None
    return get_plane()


# -- background-plane facade -------------------------------------------------
# The five background planes call these module functions instead of
# holding a plane reference: one import, no constructor threading, and
# the MTPU_QOS=0 oracle short-circuits before touching shared memory.

def scale_workers(n: int, plane: str = "") -> int:
    p = maybe_plane()
    return n if p is None else p.scale_workers(n, plane)


def bg_pause(plane: str = "") -> float:
    p = maybe_plane()
    return 0.0 if p is None else p.bg_pause(plane)


def pressure() -> float:
    p = maybe_plane()
    return 0.0 if p is None else p.pressure()


def peek_access_key(headers) -> str:
    """Extract the UNVERIFIED access key from the Authorization header
    (AWS4-HMAC-SHA256 Credential=AK/scope, ...) or presigned query —
    admission-class routing only.  Signature verification still
    happens in _authenticate; a forged premium key buys a forged
    request nothing but an admission slot it then fails auth in."""
    auth = (headers.get("Authorization", "")
            or headers.get("authorization", "") or "")
    i = auth.find("Credential=")
    if i >= 0:
        frag = auth[i + len("Credential="):]
        return frag.split("/", 1)[0].strip()
    return ""
