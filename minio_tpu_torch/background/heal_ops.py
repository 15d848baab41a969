"""Heal sequences with live status (cf. allHealState and healSequence,
cmd/admin-heal-ops.go:90,396).

Counterpart of minio_tpu/background/heal_ops.py.  A sequence walks a
scope (the whole deployment, one bucket, or a prefix of one): format heal
once per set first, then for each bucket and pool `heal_bucket` and
`heal_bucket_objects` on every set, through
`heal.sweep_sets_device_parallel` (sets on different cards at once).
`status()` is live while it runs and `stop()` ends it after the heals in
flight.  Its heals yield to foreground pressure as every heal does
(engine/heal.py `_heal_workers`, `bg_pause`).
"""

from __future__ import annotations

import threading
import time
import uuid

from ..engine import heal as H
from ..storage.errors import StorageError


class HealSequence:
    def __init__(self, pools, bucket: str = "", prefix: str = "",
                 deep: bool = False, remove_dangling: bool = True):
        self.id = uuid.uuid4().hex
        self.pools = pools
        self.bucket = bucket
        self.prefix = prefix
        self.deep = deep
        self.remove_dangling = remove_dangling
        self.state = "pending"      # pending|running|done|failed|stopped
        self.started = 0.0
        self.finished = 0.0
        self.items_scanned = 0
        self.items_healed = 0
        self.failures: list[str] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- execution -------------------------------------------------------------

    def _on_object(self, bucket):
        mu = threading.Lock()

        def observe(name, results, err):
            with mu:
                self.items_scanned += 1
                if err is not None:
                    self.failures.append(f"{bucket}/{name}: {err}")
                elif any(r.healed_drives for r in results):
                    self.items_healed += 1
        return observe

    def run(self) -> "HealSequence":
        self.state = "running"
        self.started = time.time()
        try:
            # Format heal needs no bucket: once per set, before any
            # bucket or object (it restores the system volume every
            # write stages through).
            for pool in self.pools.pools:
                for es in pool.sets:
                    try:
                        H.heal_format(es)
                    except StorageError:
                        pass
            buckets = ([self.bucket] if self.bucket
                       else self.pools.list_buckets())
            for bucket in buckets:
                for pool in self.pools.pools:
                    # Each set's job runs on its card's thread; the
                    # observer locks, so outcomes stream back live.
                    def job(es, _bucket=bucket):
                        try:
                            H.heal_bucket(es, _bucket)
                        except StorageError:
                            pass
                        try:
                            H.heal_bucket_objects(
                                es, _bucket, prefix=self.prefix,
                                deep=self.deep,
                                remove_dangling=self.remove_dangling,
                                stop=self._stop,
                                on_object=self._on_object(_bucket))
                        except StorageError:
                            pass

                    H.sweep_sets_device_parallel(pool.sets, job,
                                                 stop=self._stop)
                    if self._stop.is_set():
                        self.state = "stopped"
                        return self
            self.state = "done"
        except Exception as e:  # noqa: BLE001 — reported in status()
            self.state = "failed"
            self.failures.append(str(e))
        finally:
            self.finished = time.time()
        return self

    def start(self) -> "HealSequence":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> "HealSequence":
        """Block until a started sequence has ended (or `timeout`)."""
        if self._thread is not None:
            self._thread.join(timeout)
        return self

    def stop(self) -> None:
        self._stop.set()

    def status(self) -> dict:
        return {"id": self.id, "state": self.state,
                "bucket": self.bucket, "prefix": self.prefix,
                "scanned": self.items_scanned,
                "healed": self.items_healed,
                "failures": list(self.failures[-20:]),
                "started": self.started, "finished": self.finished}


class HealState:
    """Registry of sequences (the allHealState role): one running
    sequence per scope."""

    def __init__(self, pools):
        self.pools = pools
        self._mu = threading.Lock()
        self._seqs: dict[str, HealSequence] = {}

    def launch(self, bucket: str = "", prefix: str = "",
               deep: bool = False) -> HealSequence:
        scope = f"{bucket}/{prefix}"
        with self._mu:
            existing = self._seqs.get(scope)
            if existing is not None and existing.state == "running":
                return existing
            seq = HealSequence(self.pools, bucket, prefix, deep)
            self._seqs[scope] = seq
        return seq.start()

    def get(self, seq_id: str) -> HealSequence | None:
        with self._mu:
            for s in self._seqs.values():
                if s.id == seq_id:
                    return s
        return None

    def statuses(self) -> list[dict]:
        with self._mu:
            return [s.status() for s in self._seqs.values()]
