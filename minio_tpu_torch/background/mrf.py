"""MRF, the "most recently failed" heal queue (counterpart of
minio_tpu/background/mrf.py).

The cmd/mrf.go:52 equivalent: writes that succeeded with quorum but
failed on SOME drives enqueue the object here; a background worker heals
the stripe back to full width (immediately-retried with backoff rather
than waiting for the scanner's next pass). The engine enqueues from its
put path; drive reconnects implicitly resolve on the next retry.

Persistence: with a `journal_path` the queue survives process death the
same way the reference's healMRFDir does — every enqueue appends one
JSONL record (flushed + fsynced: an acked-but-degraded write must not
lose its pending heal to a kill -9), heals/drops append completion
records, and the file is compacted into a checkpoint record (atomic
tmp + rename) when the tail grows or on stop().  Boot replays the
journal: pending entries re-enter the queue exactly once (completed
keys cancel their enqueues) and the healed/dropped/retries counters
carry over.

A heal runs through the pool's `heal_object`, so on the port it runs on
the card.  `attach_mrf` counts the entries its queues replayed in the
module's `stats()`, which the metrics registry (observe/metrics.py)
renders as mtpu_mrf_journal_replayed_total.

Env knobs:
  MTPU_MRF_FSYNC       1 (default) fsync each enqueue append, 0 flush only
  MTPU_MRF_CKPT_EVERY  tail records between auto-checkpoints (256)
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import OrderedDict

_STATS_MU = threading.Lock()
_STATS = {"replayed": 0}


def stats() -> dict:
    """Entries replayed from journals at boot, over the process."""
    with _STATS_MU:
        return dict(_STATS)


class MRFQueue:
    def __init__(self, heal_fn, *, max_items: int = 10000,
                 retry_interval: float = 1.0, max_attempts: int = 8,
                 max_interval: float = 60.0, jitter: float = 0.25,
                 seed: int | None = None,
                 journal_path: str | None = None):
        self.heal_fn = heal_fn          # (bucket, obj, version_id) -> None
        self.max_items = max_items
        self.retry_interval = retry_interval
        self.max_attempts = max_attempts
        # Exponential backoff is capped (a drive that stays dead for
        # minutes shouldn't push retries out to hours) and jittered so
        # entries enqueued together — one failed PUT burst — don't
        # hammer the recovering drive in lockstep on every round.
        self.max_interval = max_interval
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        # key -> {"bucket","obj","vid","attempts","next_try"}
        self._q: OrderedDict[str, dict] = OrderedDict()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self.healed = 0
        self.dropped = 0
        self.retries = 0
        self.replayed = 0
        self.journal_path = journal_path
        self._jf = None
        self._j_tail = 0                # records since last checkpoint
        self._j_fsync = os.environ.get("MTPU_MRF_FSYNC", "1") != "0"
        self._j_every = int(os.environ.get("MTPU_MRF_CKPT_EVERY", "256"))
        if journal_path:
            self._replay_journal()
            self.checkpoint()           # compact the boot state

    # -- journal -------------------------------------------------------------

    def _replay_journal(self) -> None:
        """Rebuild queue + counters from the journal.  A torn trailing
        line (the append a kill interrupted) parses as garbage and is
        ignored; everything before it is intact because records are
        written with a single flushed write each."""
        try:
            with open(self.journal_path, "r", encoding="utf-8") as f:
                raw = f.read()
        except (FileNotFoundError, OSError):
            return
        pending: OrderedDict[str, dict] = OrderedDict()
        for line in raw.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            op = rec.get("op")
            if op == "ckpt":
                pending = OrderedDict()
                for e in rec.get("pending", ()):
                    key = f"{e['b']}/{e['o']}@{e['vid']}"
                    pending[key] = {"bucket": e["b"], "obj": e["o"],
                                    "vid": e["vid"],
                                    "attempts": int(e.get("attempts", 0))}
                self.healed = int(rec.get("healed", 0))
                self.dropped = int(rec.get("dropped", 0))
                self.retries = int(rec.get("retries", 0))
            elif op == "enq":
                key = f"{rec['b']}/{rec['o']}@{rec['vid']}"
                pending[key] = {"bucket": rec["b"], "obj": rec["o"],
                                "vid": rec["vid"], "attempts": 0}
            elif op == "done":
                if pending.pop(rec.get("k"), None) is not None:
                    self.healed += 1
            elif op == "drop":
                if pending.pop(rec.get("k"), None) is not None:
                    self.dropped += 1
        now = time.monotonic()
        for key, it in pending.items():
            it["next_try"] = now        # retry immediately after boot
            self._q[key] = it
        self.replayed = len(pending)

    def _append_locked(self, rec: dict, durable: bool = False) -> None:
        if not self.journal_path:
            return
        try:
            if self._jf is None:
                self._jf = open(self.journal_path, "a", encoding="utf-8")
            self._jf.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._jf.flush()
            if durable and self._j_fsync:
                os.fsync(self._jf.fileno())
            self._j_tail += 1
        except OSError:
            return                      # journal loss degrades to memory-only
        if self._j_tail >= self._j_every:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        if not self.journal_path:
            return
        rec = {"op": "ckpt", "healed": self.healed, "dropped": self.dropped,
               "retries": self.retries,
               "pending": [{"b": it["bucket"], "o": it["obj"],
                            "vid": it["vid"], "attempts": it["attempts"]}
                           for it in self._q.values()]}
        tmp = self.journal_path + ".tmp"
        try:
            if self._jf is not None:
                self._jf.close()
                self._jf = None
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.journal_path)
            self._j_tail = 0
        except OSError:
            pass

    def checkpoint(self) -> None:
        """Compact the journal to one ckpt record (drain/stop path)."""
        with self._mu:
            self._checkpoint_locked()

    # -- queue ---------------------------------------------------------------

    def _backoff(self, attempts: int) -> float:
        base = min(self.max_interval, self.retry_interval * (2 ** attempts))
        return base * (1.0 + self.jitter * self._rng.random())

    def enqueue(self, bucket: str, obj: str, version_id: str = "") -> None:
        key = f"{bucket}/{obj}@{version_id}"
        with self._mu:
            if key not in self._q and len(self._q) >= self.max_items:
                shed_key, _ = self._q.popitem(last=False)  # shed oldest
                self.dropped += 1
                self._append_locked({"op": "drop", "k": shed_key})
            self._q[key] = {"bucket": bucket, "obj": obj,
                            "vid": version_id, "attempts": 0,
                            "next_try": time.monotonic()}
            self._append_locked({"op": "enq", "b": bucket, "o": obj,
                                 "vid": version_id}, durable=True)
        self._wake.set()

    def pending(self) -> int:
        with self._mu:
            return len(self._q)

    def stats(self) -> dict:
        """Backlog depth + lifetime counters — the healthinfo MRF row
        (and already what /metrics exports per queue)."""
        with self._mu:
            return {"pending": len(self._q), "healed": self.healed,
                    "dropped": self.dropped, "retries": self.retries,
                    "replayed": self.replayed}

    def drain_once(self) -> int:
        """Try every due entry once; returns how many healed."""
        now = time.monotonic()
        with self._mu:
            due = [(k, dict(v)) for k, v in self._q.items()
                   if v["next_try"] <= now]
        healed = 0
        for key, item in due:
            try:
                self.heal_fn(item["bucket"], item["obj"], item["vid"])
            except Exception:  # noqa: BLE001 — retry with backoff
                with self._mu:
                    self.retries += 1
                    if key in self._q:
                        it = self._q[key]
                        it["attempts"] += 1
                        if it["attempts"] >= self.max_attempts:
                            del self._q[key]
                            self.dropped += 1
                            self._append_locked({"op": "drop", "k": key})
                        else:
                            it["next_try"] = now + \
                                self._backoff(it["attempts"])
                continue
            with self._mu:
                if self._q.pop(key, None) is not None:
                    self._append_locked({"op": "done", "k": key})
            self.healed += 1
            healed += 1
        return healed

    def start(self) -> "MRFQueue":
        def loop():
            while not self._stop.is_set():
                self._wake.wait(timeout=self.retry_interval)
                self._wake.clear()
                if self._stop.is_set():
                    return
                self.drain_once()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-mrf")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30.0)        # a heal in flight finishes first
        if self.journal_path:
            self.checkpoint()
            with self._mu:
                if self._jf is not None:
                    try:
                        self._jf.close()
                    except OSError:
                        pass
                    self._jf = None


def _journal_name() -> str:
    """Journal filename for THIS process.  The pre-fork worker pool
    (server/workers.py) runs N servers over the same drives; a JSONL
    journal is single-writer (interleaved appends tear records), so
    each worker owns `mrf-journal.w<ID>.jsonl`.  Single-process mode
    keeps the legacy name."""
    wid = os.environ.get("MTPU_WORKER_ID", "")
    if wid:
        return f"mrf-journal.w{wid}.jsonl"
    return "mrf-journal.jsonl"


def _pool_journal_path(pool) -> str | None:
    """Journal home: the first local drive of the pool's first set —
    under its reserved system namespace, next to tmp/ and multipart/.
    A cluster node's remote drives (rpc/storage_rpc.RemoteDrive, whose
    root names a URL) are skipped: the journal is this node's file."""
    from ..storage.drive import SYS_VOL, LocalDrive
    for es in getattr(pool, "sets", [pool]):
        for d in getattr(es, "drives", []):
            root = getattr(d, "root", None)
            if isinstance(d, LocalDrive) and root:
                return os.path.join(root, SYS_VOL, _journal_name())
    return None


def adopt_orphan_journals(journal_path: str) -> int:
    """Fold sibling journals whose writer is gone into `journal_path`
    so their pending heals are not stranded.  Called by the recovery
    owner (worker 0, or single-process mode) BEFORE its MRFQueue
    replays.  A journal is an orphan when it belongs to a worker id
    beyond the current pool width (pool shrank), or when this process
    is the legacy single writer and per-worker journals remain from a
    previous MTPU_WORKERS>0 run (and vice versa).  Each orphan is
    reduced to its NET pending set first (its own ckpt/enq/done/drop
    algebra), then appended as plain enq records — raw concatenation
    would let an orphan's ckpt record wipe the adopter's entries at
    replay."""
    home = os.path.dirname(journal_path)
    me = os.path.basename(journal_path)
    try:
        names = sorted(os.listdir(home))
    except OSError:
        return 0
    adopted = 0
    width = int(os.environ.get("MTPU_WORKERS_TOTAL", "0") or 0)
    for name in names:
        if name == me or not name.startswith("mrf-journal"):
            continue
        if not name.endswith(".jsonl"):
            continue
        if width:
            # Pool mode: live siblings are w0..w{width-1}; adopt the
            # legacy journal and out-of-range worker journals only.
            m = name.removeprefix("mrf-journal.").removesuffix(".jsonl")
            if m.startswith("w"):
                try:
                    if int(m[1:]) < width:
                        continue            # a live sibling owns it
                except ValueError:
                    pass
        path = os.path.join(home, name)
        try:
            with open(path, "r", encoding="utf-8") as src:
                pending = _net_pending(src.read())
            with open(journal_path, "a", encoding="utf-8") as dst:
                for it in pending.values():
                    dst.write(json.dumps(
                        {"op": "enq", "b": it["bucket"], "o": it["obj"],
                         "vid": it["vid"]},
                        separators=(",", ":")) + "\n")
                dst.flush()
                os.fsync(dst.fileno())
            os.unlink(path)
            adopted += 1
        except OSError:
            continue
    return adopted


def _net_pending(raw: str) -> "OrderedDict[str, dict]":
    """The enq/done/drop/ckpt algebra of _replay_journal, standalone —
    what a journal's writer still owed when it last wrote."""
    pending: OrderedDict[str, dict] = OrderedDict()
    for line in raw.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        op = rec.get("op")
        if op == "ckpt":
            pending = OrderedDict()
            for e in rec.get("pending", ()):
                key = f"{e['b']}/{e['o']}@{e['vid']}"
                pending[key] = {"bucket": e["b"], "obj": e["o"],
                                "vid": e["vid"]}
        elif op == "enq":
            key = f"{rec['b']}/{rec['o']}@{rec['vid']}"
            pending[key] = {"bucket": rec["b"], "obj": rec["o"],
                            "vid": rec["vid"]}
        elif op in ("done", "drop"):
            pending.pop(rec.get("k"), None)
    return pending


def attach_mrf(pools, journal: bool = True, **kw) -> list[MRFQueue]:
    """Server-boot wiring: one started MRFQueue per ErasureSets pool,
    healing through the pool's own heal_object (routes to the right
    set), attached to every set so the engine's partial-write paths
    find `es.mrf`.  Returns the queues (callers keep them for stop()).

    With `journal` (the boot default) each queue persists to the pool's
    first local drive so pending heals survive restarts; pools with no
    local drive stay memory-only."""
    queues = []
    for pool in getattr(pools, "pools", [pools]):
        def heal(bucket, obj, vid, _p=pool):
            _p.heal_object(bucket, obj, vid)
        jp = _pool_journal_path(pool) if journal else None
        if jp and os.environ.get("MTPU_WORKER_ID", "0") in ("", "0"):
            # The recovery owner folds journals stranded by a previous
            # run's (different) process topology into its own before
            # replay — pending heals never orphan across mode changes.
            adopt_orphan_journals(jp)
        q = MRFQueue(heal, journal_path=jp, **kw).start()
        if q.replayed:
            with _STATS_MU:
                _STATS["replayed"] += q.replayed
        for es in getattr(pool, "sets", [pool]):
            es.mrf = q
        queues.append(q)
    return queues
