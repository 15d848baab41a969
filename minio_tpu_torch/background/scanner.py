"""Data scanner: a perpetual crawl that accounts usage and starts heals.

Counterpart of minio_tpu/background/scanner.py (cmd/data-scanner.go:49,
96).  Each cycle walks the namespace (each set's quorum-merged listing),
builds the usage tree (background/usage.py) and heals objects whose
stripe looks unhealthy (a live drive without the object's xl.meta).
Every `deep_every`-th cycle is deep: each object is healed with
`deep=True`, which reads every shard's frames on every live drive and
verifies their digests on the card (engine/heal.py), so silent
corruption on an idle server is found and repaired with no client read.
Buckets written since the last cycle (the dirty tracker, which every set
of every pool marks) are scanned every cycle, the others every
`full_scan_every`-th; in between their numbers are carried forward.
The loop waits at least MTPU_SCANNER_INTERVAL seconds between cycles and
ten times the last cycle's length (at most a tenth of the time busy).

Knobs (the JAX package's, with its defaults): MTPU_SCANNER (1; 0 starts
no scanner at boot), MTPU_SCANNER_INTERVAL (60 s), MTPU_SCANNER_DEEP_EVERY
(16).  The crawl yields to foreground pressure (server/qos.bg_pause).

`attach_config` is where the server binds its bucket configuration and
its tier manager (bucket/tier.py): with them bound, each cycle first
runs every bucket's lifecycle (bucket/lifecycle.py, the JAX
`_apply_lifecycle`): the expiry pass when its rules can expire anything,
freeing the tier copy of an expired transitioned version, and the
transitions (tier.run_transitions) when its rules can transition; then
the bucket's tier upkeep (`_ilm_maintenance`: temporary restores whose
window passed lose their hot copy).  `stats.lifecycle` sums the expiry
passes' counts (the tier manager's `stats()` counts the moves).  Each
cycle ends with one drain of the tier journal: failed remote deletes
and the partial copies of failed transitions are retried on the
scanner's cadence.
"""

from __future__ import annotations

import os
import threading
import time

from ..bucket.lifecycle import Lifecycle, apply_lifecycle
from ..bucket.tier import run_transitions
from ..storage.errors import ErrDiskNotFound, StorageError
from .usage import DataUsage, DirtyTracker


class ScanStats:
    def __init__(self):
        self.cycles = 0
        self.deep_cycles = 0
        self.objects_scanned = 0
        self.objects_verified = 0
        self.heals_triggered = 0
        self.corruption_found = 0
        self.last_cycle_s = 0.0
        # The expiry passes' counts, summed (bucket/lifecycle.py).
        self.lifecycle = {"expired": 0, "expired_noncurrent": 0,
                          "transitioned": 0, "skipped_locked": 0}


class DataScanner:
    def __init__(self, pools, *, heal_fn=None,
                 full_scan_every: int = 16,
                 deep_every: int | None = None,
                 object_sleep: float = 0.0,
                 dirty: DirtyTracker | None = None):
        self.pools = pools
        # (bucket, obj, version_id) -> None; the default is the engine's
        # heal on the object's set in every pool.
        self.heal_fn = heal_fn if heal_fn is not None else self._heal
        self.full_scan_every = full_scan_every
        if deep_every is None:
            deep_every = int(os.environ.get("MTPU_SCANNER_DEEP_EVERY",
                                            "16"))
        self.deep_every = max(1, deep_every)
        self.object_sleep = object_sleep
        self.dirty = dirty or DirtyTracker.shared()
        self.stats = ScanStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_usage: DataUsage | None = None
        # The bucket configuration and the tier manager (attach_config),
        # whose lifecycle and tier upkeep a cycle applies.
        self.meta = None
        self.tier_mgr = None
        # A restart keeps the marks saved before it (the union of every
        # drive's copy), and marks between cycles are saved shortly
        # after they are made.
        es = self._first_es()
        if es is not None:
            try:
                self.dirty.load(es)
            except Exception:  # noqa: BLE001 — scanning must still run
                pass
            self.dirty.bind(es)

    def _first_es(self):
        try:
            return self.pools.pools[0].sets[0]
        except (AttributeError, IndexError):
            return None

    def _heal(self, bucket: str, obj: str, version_id: str) -> None:
        """The default heal: the engine's object heal on the object's
        set of every pool."""
        from ..engine import heal as H
        for pool in self.pools.pools:
            try:
                H.heal_object(pool.set_for(obj), bucket, obj, version_id)
            except StorageError:
                continue

    def _object_needs_heal(self, es, bucket: str, name: str) -> bool:
        """Does a LIVE drive lack the object's xl.meta?  Offline drives
        do not count: nothing can be healed onto them, and counting
        them would heal every object.  The shards' check is heal's."""
        res = es._map_drives(lambda d: d.read_version(bucket, name))
        missing = sum(1 for _, e in res
                      if e is not None and not isinstance(e, ErrDiskNotFound))
        live = sum(1 for d in es.drives if d is not None)
        return 0 < missing < live

    def attach_config(self, meta, tier_mgr=None) -> "DataScanner":
        """Bind the bucket-config store (bucket/metadata.py) whose
        lifecycle configs each cycle applies, and the tier manager that
        moves and frees tiered versions; the server calls this when it
        binds the object layer."""
        self.meta = meta
        self.tier_mgr = tier_mgr
        return self

    def _apply_lifecycle(self, bucket: str) -> None:
        if self.meta is None:
            return
        try:
            raw = self.meta.get(bucket, "lifecycle")
        except Exception:  # noqa: BLE001 — config store hiccup
            return
        if raw is None:
            return
        try:
            lc = Lifecycle.parse(raw)
            # Only rules that can fire cost a pass: each pass is a whole
            # listing of the bucket on top of the crawl's own.
            if any(r.expire_days or r.expire_date or r.noncurrent_days
                   for r in lc.rules):
                got = apply_lifecycle(self.pools, bucket, lc,
                                      tier_mgr=self.tier_mgr)
                for k, v in got.items():
                    self.stats.lifecycle[k] += v
            if self.tier_mgr is not None and any(
                    r.transition_tier and r.transition_days
                    for r in lc.rules):
                run_transitions(self.pools, bucket, lc, self.tier_mgr)
        except Exception:  # noqa: BLE001 — ILM must not kill the scan
            pass

    def _ilm_maintenance(self, bucket: str) -> None:
        """The bucket's tier upkeep: temporary restores whose window
        passed lose their hot copy (the x-amz-restore expiry)."""
        if self.tier_mgr is None:
            return
        try:
            self.tier_mgr.expire_restores(bucket)
        except Exception:  # noqa: BLE001 — ILM must not kill the scan
            pass

    # -- one cycle -------------------------------------------------------------

    def scan_cycle(self, deep: bool = False) -> DataUsage:
        from ..engine import heal as H
        from ..server import qos as _qos
        t0 = time.time()
        self.stats.cycles += 1
        if deep:
            self.stats.deep_cycles += 1
        cycle = self.stats.cycles
        buckets = self.pools.list_buckets()
        dirty = self.dirty.snapshot_and_clear(buckets)
        usage = DataUsage()
        usage.cycle = cycle

        for bucket in buckets:
            self._apply_lifecycle(bucket)
            self._ilm_maintenance(bucket)
            full = (bucket in dirty or deep
                    or cycle % self.full_scan_every == 1)
            if not full and self._last_usage is not None \
                    and bucket in self._last_usage.buckets:
                # Clean: the last cycle's numbers stand.
                usage.buckets[bucket] = self._last_usage.buckets[bucket]
                continue
            for pool in self.pools.pools:
                for es in pool.sets:
                    if bucket in dirty:
                        # Another process may have written it: its
                        # listing cache here knows nothing of that.
                        es.metacache.bump(bucket)
                    try:
                        infos = es.list_objects(bucket, max_keys=1000000)
                    except StorageError:
                        continue
                    for fi in infos:
                        self.stats.objects_scanned += 1
                        usage.account(bucket, fi.name, fi.size)
                        if deep:
                            # Every shard's frames verified on the card
                            # and repaired in place (healObject's deep
                            # mode, cmd/erasure-healing.go:244).
                            self.stats.objects_verified += 1
                            try:
                                results = H.heal_object(
                                    es, bucket, fi.name, deep=True)
                                if any(r.healed_drives for r in results):
                                    self.stats.corruption_found += 1
                                    self.stats.heals_triggered += 1
                            except StorageError:
                                pass
                        elif self.heal_fn is not None and \
                                self._object_needs_heal(es, bucket, fi.name):
                            self.stats.heals_triggered += 1
                            try:
                                self.heal_fn(bucket, fi.name, "")
                            except StorageError:
                                pass
                        if self.object_sleep:
                            time.sleep(self.object_sleep)
                        _qos.bg_pause("scanner")

        # One tier-journal drain a cycle: the journal converges to zero
        # without a loop of its own.
        if self.tier_mgr is not None:
            try:
                self.tier_mgr.drain_journal()
            except Exception:  # noqa: BLE001 — ILM must not kill the scan
                pass

        usage.scanned_at = time.time()
        self.stats.last_cycle_s = usage.scanned_at - t0
        self._last_usage = usage
        # On every set: it survives restarts, and the admin API reads it
        # without a scan.
        for pool in self.pools.pools:
            for es in pool.sets:
                try:
                    usage.persist(es)
                except StorageError:
                    continue
        # The cycle consumed the marks: save the (usually empty) pending
        # set so a restart resumes from here.
        es = self._first_es()
        if es is not None:
            try:
                self.dirty.save(es)
            except Exception:  # noqa: BLE001
                pass
        return usage

    def latest_usage(self) -> DataUsage | None:
        if self._last_usage is not None:
            return self._last_usage
        return load_usage(self.pools)

    # -- the perpetual loop ----------------------------------------------------

    def start(self, interval: float | None = None) -> "DataScanner":
        """Normal cycles at an adaptive cadence, every `deep_every`-th
        one deep (the perpetual runDataScanner loop,
        cmd/data-scanner.go:96)."""
        if interval is None:
            interval = float(os.environ.get("MTPU_SCANNER_INTERVAL", "60"))

        def loop():
            wait = interval
            while not self._stop.wait(wait):
                deep = (self.stats.cycles + 1) % self.deep_every == 0
                try:
                    self.scan_cycle(deep=deep)
                except Exception:  # noqa: BLE001 — the scanner survives
                    pass
                # At most a tenth of the time busy: a 30 s cycle earns a
                # 300 s pause, an instant one the configured interval.
                wait = max(interval, self.stats.last_cycle_s * 10)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-scanner")
        self._thread.start()
        return self

    def stop(self, timeout: float | None = 30.0) -> None:
        """End the loop, waiting up to `timeout` for a running cycle, and
        stop saving marks to this scanner's drives."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        if self.dirty._es is self._first_es():
            self.dirty.bind(None)


def load_usage(pools) -> DataUsage | None:
    """The last usage a scanner persisted, from the first set that has
    one (what a process without the scanner reads)."""
    for pool in pools.pools:
        for es in pool.sets:
            u = DataUsage.load(es)
            if u is not None:
                return u
    return None


class PersistedUsage:
    """The usage view of a process that runs no scanner (a pool worker
    other than 0): the scanning process's last persisted cycle, read
    from the drives at most once a second."""

    TTL = 1.0

    def __init__(self, pools):
        self.pools = pools
        self._mu = threading.Lock()
        self._at = 0.0
        self._usage: DataUsage | None = None

    def latest_usage(self) -> DataUsage | None:
        with self._mu:
            now = time.monotonic()
            if now - self._at > self.TTL:
                self._usage = load_usage(self.pools)
                self._at = now
            return self._usage


def scanner_from_env(pools) -> DataScanner | None:
    """The boot's scanner, started, unless MTPU_SCANNER=0."""
    if os.environ.get("MTPU_SCANNER", "1") == "0":
        return None
    return DataScanner(pools).start()
