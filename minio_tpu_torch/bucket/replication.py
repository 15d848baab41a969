"""Bucket replication: a journaled worker pool that mirrors every write
to a remote target.

The port's copy of minio_tpu/bucket/replication.py (the
cmd/bucket-replication.go:825,1280 role).  A bucket's replication config
(rule filters and a target bucket) makes each eligible write a task; the
pool's workers copy the task's version (or the delete marker) to the
target and stamp x-amz-replication-status on the SOURCE object (PENDING,
then COMPLETED or FAILED) as the reference does.  The copy lands under
the source's version id and mod time, so a replayed copy replaces
rather than duplicates.  A copy carries the version's plaintext: the
server's reader (`read_source`, set by server/handlers.py) reverses the
object transforms, and an SSE-S3 version asks the target to seal it
again under the target's own KMS.  An SSE-C version cannot be copied
(its key is the client's, never stored): it is stamped FAILED and
counted `unreplicable`.  A GET of an object missing locally may PROXY to
the target while the bucket resyncs (`proxy_get`), and `start_resync`
replays a whole bucket through a persisted, resumable state machine.
Targets are pools-style objects (put_object, delete_object, get_object):
a remote S3 server through `target_client`, or another in-process
ServerPools in tests.  On the card a copy is the source's verified GET
(mxh256 or hh256 digests, GF on a degraded read) and the target's PUT
(GF encode and digests).

Durability (the MRF journal's discipline): every accepted task appends
one fsynced JSONL intent (`enq`) to the process's journal BEFORE it is
runnable, completions append `done`, and the tail compacts into one
atomic `ckpt` record (tmp + rename) every MTPU_REPL_CKPT_EVERY records,
at boot and on stop().  Boot replays the journal exactly once: a kill -9
between the ack and the copy loses nothing.  A torn trailing line is
ignored.  Each worker of the pre-fork pool owns
`repl-journal.w<ID>.jsonl` (one writer per file); worker 0, and a lone
process, fold the journals no live process owns into their own
(`adopt_orphan_journals`).

The journal's home is the first local drive of the first pool that is
not draining (the JAX package's is the first pool's, whose drives a
drain takes away).  A drain started while the pool runs moves the home:
the backlog is checkpointed into the new home before the old journal
goes, and the resync states move with it.  Adoption looks on every
pool's first drive, so a journal left where the home used to be is
still adopted.

Fault tolerance: a failed copy retries with capped exponential backoff
and never leaves the journal (a partitioned target is lag, not loss);
consecutive failures against one target open a per-target breaker that
defers its tasks until a probe succeeds.  The workers yield to
foreground pressure (server/qos.py: `bg_pause`, and `scale_workers`
parks the higher-numbered ones).

The JAX package's MTPU_REPL_JOURNAL=0 mode (an in-memory queue, one
attempt) is not ported: without a local drive the journal's algebra
runs in memory alone.

Env knobs (the JAX package's, with its defaults):
  MTPU_REPL_FSYNC           1: fsync each intent append
  MTPU_REPL_CKPT_EVERY      tail records between checkpoints (256)
  MTPU_REPL_WORKERS         worker threads (2)
  MTPU_REPL_RETRY_INTERVAL  base retry backoff seconds (0.25)
  MTPU_REPL_MAX_INTERVAL    backoff cap seconds (30)
  MTPU_REPL_BREAKER_FAILS   consecutive failures that open a breaker (3)
  MTPU_REPL_BREAKER_MAX     breaker probe-interval cap seconds (15)
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import xml.etree.ElementTree as ET
from collections import OrderedDict

from ..crypto import sse as _sse
from ..storage.drive import SYS_VOL
from ..storage.errors import (ErrBucketNotFound, ErrObjectNotFound,
                              ErrVersionNotFound, StorageError)
from ..utils import compress as _cz
from ..utils.crashpoints import crash_point

STATUS_KEY = "x-amz-replication-status"
RESYNC_DIR = "replication"
#: Replica-fidelity headers (a PUT that keeps the source's version id and
#: mod time): the server strips them, like the REPLICA marker, from any
#: principal without s3:ReplicateObject.
REPL_VID_HEADER = "x-mtpu-repl-version-id"
REPL_MTIME_HEADER = "x-mtpu-repl-mtime"

_JOURNAL_PREFIX, _JOURNAL_SUFFIX = "repl-journal", ".jsonl"

_SSE_ALGO, _H_SSE = _sse.META_ALGO, _sse.H_SSE
#: The metadata of the object transforms: a replica carries the
#: plaintext, so none of it goes with the copy.
TRANSFORM_KEYS = frozenset((
    _sse.META_ALGO, _sse.META_SEALED_KEY, _sse.META_KMS_KEY_ID,
    _sse.META_KEY_MD5, _sse.META_SSEC_IV, _sse.META_ACTUAL_SIZE,
    _cz.META_COMPRESSION, _cz.META_ACTUAL_SIZE,
    "x-mtpu-internal-client-size"))     # server/handlers.py's


class ErrReplicationTargetDown(StorageError):
    """A configured target could not be reached: a proxied GET answers
    503 ReplicationRemoteConnectionError, not a 404 that would say the
    object does not exist."""


class ErrUnreplicable(StorageError):
    """A version no retry can copy: an SSE-C version (its key is the
    client's), or a sealed one for a target that cannot seal."""


class ErrReplicaDenied(StorageError):
    """The target refused a proxied GET (403): AccessDenied."""


def _is_not_found(e: Exception) -> bool:
    """The target answered 'no such key' (in process or over the
    wire), as opposed to down, refused or a 5xx."""
    if isinstance(e, (ErrObjectNotFound, ErrVersionNotFound,
                      ErrBucketNotFound)):
        return True
    status = getattr(e, "status", None)
    code = getattr(e, "code", "")
    return status == 404 or code in ("NoSuchKey", "NoSuchBucket",
                                     "NoSuchVersion")


class ReplicationRule:
    def __init__(self, prefix: str, target_bucket: str,
                 delete_marker_replication: bool = True):
        self.prefix = prefix
        self.target_bucket = target_bucket
        self.delete_marker_replication = delete_marker_replication


def parse_replication_config(xml_bytes: bytes) -> list[ReplicationRule]:
    root = ET.fromstring(xml_bytes)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    rules = []
    for r in root.iter("Rule"):
        if (r.findtext("Status") or "Enabled") != "Enabled":
            continue
        prefix = r.findtext("Filter/Prefix") or r.findtext("Prefix") or ""
        dest = r.findtext("Destination/Bucket") or ""
        dest = dest.removeprefix("arn:aws:s3:::")
        dm = (r.findtext("DeleteMarkerReplication/Status")
              or "Enabled") == "Enabled"
        rules.append(ReplicationRule(prefix, dest, dm))
    return rules


def _journal_name() -> str:
    """This process's journal: one writer per file, so each worker of
    the pre-fork pool owns `repl-journal.w<ID>.jsonl`."""
    wid = os.environ.get("MTPU_WORKER_ID", "")
    if wid:
        return f"{_JOURNAL_PREFIX}.w{wid}{_JOURNAL_SUFFIX}"
    return _JOURNAL_PREFIX + _JOURNAL_SUFFIX


def _pool_sets(pool):
    return getattr(pool, "sets", [pool])


def _first_root(pool) -> str | None:
    for es in _pool_sets(pool):
        for d in getattr(es, "drives", []):
            root = getattr(d, "root", None)
            if d is not None and root:
                return root
    return None


def _home_pool(source_pools):
    """The first pool that is not draining (a drain's drives go once it
    completes); the first pool when every one is."""
    pools = getattr(source_pools, "pools", [source_pools])
    draining = getattr(source_pools, "draining", set())
    for i, p in enumerate(pools):
        if i not in draining:
            return p
    return pools[0]


def _first_drives(pool) -> list:
    for es in _pool_sets(pool):
        return [d for d in es.drives if d is not None]
    return []


def _pool_journal_path(source_pools, home=None) -> str | None:
    """The journal's home: the first local drive of the home pool, under
    its system volume."""
    root = _first_root(home if home is not None
                       else _home_pool(source_pools))
    if root is None:
        return None
    return os.path.join(root, SYS_VOL, _journal_name())


def _journal_dirs(source_pools) -> list[str]:
    """Every pool's first local drive's system volume: where a journal
    of this deployment may have been left."""
    out = []
    for p in getattr(source_pools, "pools", [source_pools]):
        root = _first_root(p)
        if root is not None:
            d = os.path.join(root, SYS_VOL)
            if d not in out:
                out.append(d)
    return out


def _task_key(op: str, bucket: str, tb: str, key: str,
              vid: str = "") -> str:
    """A task's identity.  A named version is a task of its own, so a
    version superseded before its copy runs still reaches the target
    (the JAX key has no version: a newer enqueue replaces the pending
    one, and the copy takes whatever is latest when it runs).  Without
    a version (an unversioned overwrite, a resync's key) the latest
    state wins."""
    base = f"{op}|{bucket}|{tb}|{key}"
    return f"{base}|{vid}" if vid else base


def _key_of(t: dict) -> str:
    return _task_key(t["t"], t["b"], t["tb"], t["k"], t.get("vid", ""))


def _task_of(rec: dict) -> dict:
    return {"t": rec["t"], "b": rec["b"], "k": rec["k"], "tb": rec["tb"],
            "vid": rec.get("vid", ""), "dm": int(rec.get("dm", 0)),
            "ts": rec.get("ts", 0.0), "seq": int(rec.get("seq", 0))}


def _fold(raw: str) -> tuple["OrderedDict[str, dict]", dict | None, int]:
    """The enq/done/ckpt algebra of a journal: (what its writer still
    owed, its last checkpoint record, the highest sequence seen).  A done
    of an OLDER generation does not cancel a newer enq of the same key
    that raced the completion; a torn line is skipped."""
    pending: OrderedDict[str, dict] = OrderedDict()
    ckpt, seq = None, 0
    for line in raw.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue                     # torn trailing line: ignored
        op = rec.get("op")
        if op == "ckpt":
            ckpt = rec
            pending = OrderedDict()
            for e in rec.get("pending", ()):
                pending[_key_of(e)] = dict(e)
            seq = max(seq, int(rec.get("seq", 0)))
        elif op == "enq":
            pending[_key_of(rec)] = _task_of(rec)
            seq = max(seq, int(rec.get("seq", 0)))
        elif op == "done":
            it = pending.get(rec.get("k"))
            if it is not None and int(it.get("seq", 0)) <= \
                    int(rec.get("seq", 1 << 62)):
                pending.pop(rec.get("k"), None)
    return pending, ckpt, seq


def _net_pending(raw: str) -> "OrderedDict[str, dict]":
    """What a journal's writer still owed when it last wrote."""
    return _fold(raw)[0]


class ReplicationPool:
    """Worker pool draining replication tasks from a crash-replayable
    journal (cf. ReplicationPool, cmd/bucket-replication.go:1280)."""

    def __init__(self, source_pools, workers: int | None = None):
        self.source = source_pools
        self._rules: dict[str, list[ReplicationRule]] = {}
        self._targets: dict[tuple, object] = {}   # (bucket, tb) -> client
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.completed = 0
        self.failed = 0
        self.bytes_replicated = 0
        self.retries = 0
        self.dropped = 0
        self.replayed = 0
        self.adopted = 0
        self.proxied_reads = 0
        self.unreplicable = 0
        # (bucket, key, version id) -> (fi, plaintext): the server's
        # reader, which reverses the object transforms; None copies the
        # stored bytes of versions that have none.
        self.read_source = None
        self._stats_mu = threading.Lock()
        self._resync_mu = threading.Lock()
        self._resync_threads: dict[str, threading.Thread] = {}

        if workers is None:
            workers = int(os.environ.get("MTPU_REPL_WORKERS", "2") or 2)
        self._home = _home_pool(source_pools)
        self._jpath = _pool_journal_path(source_pools, self._home)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._pending: OrderedDict[str, dict] = OrderedDict()
        self._inflight: dict[str, dict] = {}
        self._seq = 0
        self._tombstones: set[str] = set()
        self._breakers: dict[tuple, dict] = {}
        self._rng = random.Random()
        self._jf = None
        self._j_tail = 0
        self._j_fsync = os.environ.get("MTPU_REPL_FSYNC", "1") != "0"
        self._j_every = int(os.environ.get("MTPU_REPL_CKPT_EVERY",
                                           "256") or 256)
        self.retry_interval = float(os.environ.get(
            "MTPU_REPL_RETRY_INTERVAL", "0.25") or 0.25)
        self.max_interval = float(os.environ.get(
            "MTPU_REPL_MAX_INTERVAL", "30") or 30)
        self.breaker_fails = int(os.environ.get(
            "MTPU_REPL_BREAKER_FAILS", "3") or 3)
        self.breaker_max = float(os.environ.get(
            "MTPU_REPL_BREAKER_MAX", "15") or 15)

        if self._jpath is not None:
            self.adopted = adopt_orphan_journals(
                self._jpath, _journal_dirs(source_pools),
                orphans=os.environ.get("MTPU_WORKER_ID", "0") in ("", "0"))
            self._replay_journal()
            self.checkpoint()            # compact the boot state
        for i in range(workers):
            t = threading.Thread(target=self._worker, args=(i, workers),
                                 daemon=True, name=f"mtpu-repl-{i}")
            t.start()
            self._threads.append(t)

    # -- wiring --------------------------------------------------------------

    def configure(self, bucket: str, rules: list[ReplicationRule],
                  target) -> None:
        """One target for every rule of the bucket.  The server wires
        through configure_rules; this is the JAX package's name, kept
        for the differential tests that drive both packages alike."""
        self.configure_rules(bucket, [(r, target) for r in rules])

    def configure_rules(self, bucket: str, pairs) -> None:
        """Pairs of (rule, target client).  Replaces the bucket's whole
        wiring: clients built from rotated-out credentials must not
        linger.  Keyed by (source bucket, target bucket): two sources
        with same-named targets on different endpoints stay apart.
        The swap never leaves the bucket unwired: a rewire (another
        worker's config write) drops none of its tasks."""
        rules = [r for r, _ in pairs]
        stale = ({r.target_bucket for r in self._rules.get(bucket, [])}
                 - {r.target_bucket for r in rules})
        for r, t in pairs:
            self._targets[(bucket, r.target_bucket)] = t
        self._rules[bucket] = rules
        for tb in stale:
            self._targets.pop((bucket, tb), None)
        self._tombstones.discard(bucket)
        with self._cv:
            self._cv.notify_all()        # replayed tasks may now run

    def unconfigure(self, bucket: str) -> None:
        """Drop a bucket's wiring (target deregistered, config removed):
        replication stops now, and the workers drop its journaled tasks
        (the tombstone says 'unwired on purpose', as opposed to 'not
        wired yet' at boot, which keeps the replayed backlog)."""
        rules = self._rules.pop(bucket, [])
        for r in rules:
            self._targets.pop((bucket, r.target_bucket), None)
        if rules:
            self._tombstones.add(bucket)
            with self._cv:
                self._cv.notify_all()

    # -- journal -------------------------------------------------------------

    def _rehome_locked(self) -> None:
        """Follow the home off a pool that began to drain after this pool
        was built (a live decommission).  The whole backlog is
        checkpointed, fsynced, into the new home before the old journal
        is unlinked, and each bucket's resync state is moved, so a reboot
        without the drained pool still replays every acknowledged
        write's intent and resumes every resync."""
        home = _home_pool(self.source)
        if home is self._home:
            return
        old_home, self._home = self._home, home
        path = _pool_journal_path(self.source, home)
        if path is not None and self._jpath is not None \
                and path != self._jpath:
            old, self._jpath = self._jpath, path
            try:
                # A journal of this process's name already there (its
                # predecessor's, written while that pool was the home).
                with open(path, "r", encoding="utf-8") as f:
                    owed = _net_pending(f.read())
            except OSError:
                owed = {}
            now = time.monotonic()
            for tk, it in owed.items():
                if tk not in self._pending and tk not in self._inflight:
                    it["attempts"], it["next_try"] = 0, now
                    self._pending[tk] = it
            if not self._checkpoint_locked():
                # The next look tries again.
                self._home, self._jpath = old_home, old
                return
            try:
                os.unlink(old)
            except OSError:
                pass
        self._move_resync(old_home)

    def _move_resync(self, old_home) -> None:
        """Carry each bucket's resync state from the old home's first
        set to the new home's."""
        try:
            buckets = self.source.list_buckets()
        except StorageError:
            return
        for bucket in buckets:
            path = self._resync_path(bucket)
            got = None
            for d in _first_drives(old_home):
                try:
                    got = d.read_all(SYS_VOL, path)
                    break
                except StorageError:
                    continue
            if got is None:
                continue
            for d in self._first_drives():
                try:
                    d.write_all(SYS_VOL, path, got)
                except StorageError:
                    continue
            for d in _first_drives(old_home):
                try:
                    d.delete(SYS_VOL, path)
                except StorageError:
                    continue

    def _append_locked(self, rec: dict, durable: bool = False) -> None:
        self._rehome_locked()
        if self._jpath is None:
            return
        try:
            if self._jf is None:
                self._jf = open(self._jpath, "a", encoding="utf-8")
            self._jf.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._jf.flush()
            if durable and self._j_fsync:
                os.fsync(self._jf.fileno())
            self._j_tail += 1
        except OSError:
            return                      # journal loss degrades to memory
        if self._j_tail >= self._j_every:
            self._checkpoint_locked()

    def _fsync_locked(self) -> None:
        if self._jf is not None and self._j_fsync:
            try:
                os.fsync(self._jf.fileno())
            except OSError:
                pass

    def _checkpoint_locked(self) -> bool:
        self._rehome_locked()
        if self._jpath is None:
            return False
        pend = list(self._pending.values()) + list(self._inflight.values())
        rec = {"op": "ckpt", "seq": self._seq,
               "completed": self.completed, "failed": self.failed,
               "retries": self.retries, "dropped": self.dropped,
               "bytes": self.bytes_replicated,
               "proxied": self.proxied_reads,
               "pending": [{"t": t["t"], "b": t["b"], "k": t["k"],
                            "tb": t["tb"], "vid": t.get("vid", ""),
                            "dm": int(t.get("dm", 0)),
                            "ts": t.get("ts", 0.0),
                            "seq": t.get("seq", 0)} for t in pend]}
        tmp = self._jpath + ".tmp"
        try:
            if self._jf is not None:
                self._jf.close()
                self._jf = None
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._jpath)
            self._j_tail = 0
        except OSError:
            return False
        return True

    def checkpoint(self) -> None:
        """Compact the journal to one ckpt record (boot, drain, stop)."""
        with self._cv:
            self._checkpoint_locked()

    def _replay_journal(self) -> None:
        """Rebuild the backlog and the lifetime counters from the
        journal: every record before a torn last line is intact (one
        flushed write each)."""
        try:
            with open(self._jpath, "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return
        pending, ckpt, seq = _fold(raw)
        if ckpt is not None:
            self.completed = int(ckpt.get("completed", 0))
            self.failed = int(ckpt.get("failed", 0))
            self.retries = int(ckpt.get("retries", 0))
            self.dropped = int(ckpt.get("dropped", 0))
            self.bytes_replicated = int(ckpt.get("bytes", 0))
            self.proxied_reads = int(ckpt.get("proxied", 0))
        self._seq = max(self._seq, seq)
        now = time.monotonic()
        for tk, it in pending.items():
            it["attempts"] = 0
            it["next_try"] = now         # retry at once after boot
            self._pending[tk] = it
        self.replayed = len(pending)

    # -- enqueue hooks (after a successful PUT or DELETE) --------------------

    def _match_rule(self, bucket: str, key: str,
                    need_dm: bool = False) -> ReplicationRule | None:
        for r in self._rules.get(bucket, []):
            if key.startswith(r.prefix):
                if need_dm and not r.delete_marker_replication:
                    return None
                return r
        return None

    def _new_task(self, op: str, bucket: str, key: str, tb: str,
                  vid: str = "", dm: bool = False) -> dict:
        self._seq += 1
        return {"t": op, "b": bucket, "k": key, "tb": tb, "vid": vid,
                "dm": int(dm), "ts": time.time(), "seq": self._seq,
                "attempts": 0, "next_try": time.monotonic()}

    @staticmethod
    def _enq_record(task: dict) -> dict:
        return {"op": "enq", **{k: task[k] for k in
                                ("t", "b", "k", "tb", "vid", "dm", "ts",
                                 "seq")}}

    def _enqueue(self, op: str, bucket: str, key: str, tb: str,
                 vid: str = "", dm: bool = False) -> None:
        """Journal the intent (fsynced) BEFORE it is runnable: an acked
        write whose intent reached the journal survives any kill."""
        with self._cv:
            task = self._new_task(op, bucket, key, tb, vid, dm)
            self._append_locked(self._enq_record(task), durable=True)
            crash_point("repl.enqueue")
            self._pending[_key_of(task)] = task
            self._cv.notify()

    def _enqueue_page(self, bucket: str, keys: list[str]) -> int:
        """A resync page: every key's intent journaled with ONE fsync,
        then runnable.  The caller checkpoints its resync state only
        after this returns, so a counted key is a journaled key (a kill
        between the two replays the page; same-key intents replace)."""
        n = 0
        with self._cv:
            staged = []
            for key in keys:
                r = self._match_rule(bucket, key)
                if r is None:
                    continue
                task = self._new_task("put", bucket, key, r.target_bucket)
                self._append_locked(self._enq_record(task))
                staged.append(task)
                n += 1
            self._fsync_locked()
            for task in staged:
                crash_point("repl.enqueue")
                self._pending[_key_of(task)] = task
            self._cv.notify_all()
        return n

    def on_put(self, bucket: str, key: str, version_id: str = "") -> bool:
        r = self._match_rule(bucket, key)
        if r is None:
            return False
        self._enqueue("put", bucket, key, r.target_bucket, vid=version_id)
        return True

    def on_delete(self, bucket: str, key: str, version_id: str = "",
                  delete_marker: bool = False) -> bool:
        r = self._match_rule(bucket, key, need_dm=True)
        if r is None:
            return False
        self._enqueue("delete", bucket, key, r.target_bucket,
                      vid=version_id, dm=delete_marker)
        return True

    def on_metadata(self, bucket: str, key: str,
                    version_id: str = "") -> bool:
        """Re-replicate after a metadata change (tags, retention, legal
        hold; cf. replicateMetadata)."""
        r = self._match_rule(bucket, key)
        if r is None:
            return False
        self._enqueue("meta", bucket, key, r.target_bucket, vid=version_id)
        return True

    # -- GET proxy (proxyGetToReplicationTarget) -----------------------------

    def proxy_get(self, bucket: str, key: str,
                  headers: dict | None = None) -> tuple[dict, bytes]:
        """(metadata, bytes) of `key` from the bucket's target: serves a
        GET whose local copy has not landed yet.  A remote target
        answers with the plaintext (its server reverses its own
        transforms; `headers`, the client's SSE-C key, go with the
        request); an in-process target with its stored bytes and
        metadata, which the caller reverses.  Raises
        ErrObjectNotFound when no target has it, ErrReplicationTargetDown
        when a target that might have it could not be reached."""
        down: Exception | None = None
        for r in self._rules.get(bucket, []):
            if not key.startswith(r.prefix):
                continue
            target = self._targets.get((bucket, r.target_bucket))
            if target is None:
                continue
            try:
                if isinstance(target, _RemoteTarget):
                    got = target.get_object(r.target_bucket, key,
                                            headers=headers)
                else:
                    got = target.get_object(r.target_bucket, key)
            except Exception as e:  # noqa: BLE001 — classified below
                if _is_not_found(e):
                    continue             # absent there too: next rule
                if getattr(e, "status", None) == 403:
                    # Reached, and it refused: an SSE-C replica asked
                    # for without its key, not a target that is down.
                    raise ErrReplicaDenied(str(e)) from None
                down = e                 # unreachable: other rules first
                continue
            with self._stats_mu:
                self.proxied_reads += 1
            # In-process pools return (fi, data); S3 clients bytes.
            if isinstance(got, tuple):
                fi, data = got
                return dict(fi.metadata), bytes(data)
            return {}, bytes(got)
        if down is not None:
            raise ErrReplicationTargetDown(
                f"replication target for {bucket}/{key} unreachable: "
                f"{type(down).__name__}: {down}")
        raise ErrObjectNotFound(f"{bucket}/{key} (and no replication "
                                "target holds it)")

    # -- resumable resync ----------------------------------------------------

    def _resync_path(self, bucket: str) -> str:
        return f"{RESYNC_DIR}/resync-{bucket}.json"

    def _first_drives(self):
        """The drives that hold the resync state: the home pool's first
        set (not a draining pool's)."""
        return _first_drives(self._home)

    def _save_resync(self, bucket: str, state: dict) -> None:
        payload = json.dumps(state).encode()
        for d in self._first_drives():
            try:
                d.write_all(SYS_VOL, self._resync_path(bucket), payload)
            except StorageError:
                continue

    def resync_status(self, bucket: str) -> dict | None:
        for d in self._first_drives():
            try:
                return json.loads(
                    d.read_all(SYS_VOL, self._resync_path(bucket)))
            except StorageError:
                continue
            except ValueError:
                return None
        return None

    def start_resync(self, bucket: str) -> dict:
        """Begin, or RESUME, replaying the bucket to its target.  The
        state (last enqueued key, counts) is saved after every page, and
        a page's intents are fsynced to the journal before the state
        counts them, so a restart resumes from the marker and no counted
        key is lost."""
        with self._resync_mu:
            t = self._resync_threads.get(bucket)
            if t is not None and t.is_alive():
                return self.resync_status(bucket) or {"status": "running"}
            state = self.resync_status(bucket)
            if state is None or state.get("status") == "done":
                state = {"bucket": bucket, "status": "running",
                         "started": time.time(), "last_key": "",
                         "queued": 0}
            else:
                state["status"] = "running"
            self._save_resync(bucket, state)

            def run():
                marker = state["last_key"]
                while True:
                    if self._stop.is_set():
                        # Stopped mid-resync: the state stays "running"
                        # so the next start_resync resumes from last_key.
                        self._save_resync(bucket, state)
                        return
                    try:
                        page = self.source.list_objects(
                            bucket, marker=marker, max_keys=1000)
                    except StorageError:
                        state["status"] = "failed"
                        self._save_resync(bucket, state)
                        return
                    if not page:
                        break
                    state["queued"] += self._enqueue_page(
                        bucket, [fi.name for fi in page])
                    marker = page[-1].name
                    state["last_key"] = marker
                    self._save_resync(bucket, state)
                state["status"] = "done"
                state["finished"] = time.time()
                self._save_resync(bucket, state)

            th = threading.Thread(target=run, daemon=True,
                                  name=f"mtpu-resync-{bucket}")
            self._resync_threads[bucket] = th
            th.start()
            return dict(state)

    # -- copy primitives -----------------------------------------------------

    def _set_source_status(self, bucket: str, key: str, status: str,
                           vid: str = "") -> None:
        """Stamp x-amz-replication-status on the SOURCE version (the
        latest when `vid` is empty)."""
        try:
            fi = self.source.head_object(bucket, key, vid)
            if fi.metadata.get(STATUS_KEY) == status:
                return
            fi.metadata[STATUS_KEY] = status
            self.source.update_object_metadata(bucket, key, fi)
        except StorageError:
            pass

    def _read_stored(self, bucket: str, key: str, vid: str) -> tuple:
        """(fi, bytes) of a version without a reader: its stored bytes,
        which are its plaintext only when no transform was applied."""
        fi, data = self.source.get_object(bucket, key, version_id=vid)
        if any(k in fi.metadata for k in TRANSFORM_KEYS):
            raise ErrUnreplicable(f"{bucket}/{key} is sealed or "
                                  "compressed and no reader reverses it")
        return fi, data

    def _replicate_put(self, bucket: str, key: str, tb: str, target,
                       vid: str = "") -> None:
        """Copy the task's version (the latest when it names none): its
        plaintext, which an SSE-S3 version asks the target to seal."""
        self._set_source_status(bucket, key, "PENDING", vid)
        if self.read_source is not None:
            fi, data = self.read_source(bucket, key, vid)
        else:
            fi, data = self._read_stored(bucket, key, vid)
        meta = {k: v for k, v in fi.metadata.items()
                if k != STATUS_KEY and k not in TRANSFORM_KEYS}
        meta[STATUS_KEY] = "REPLICA"
        if fi.metadata.get(_SSE_ALGO) == "SSE-S3":
            if not isinstance(target, _RemoteTarget):
                # Only a server seals a replica again; an in-process
                # target would keep the plaintext.
                raise ErrUnreplicable(f"{bucket}/{key} is sealed and "
                                      "the target cannot seal it again")
            meta[_H_SSE] = "AES256"
        kw = {}
        # The replica keeps the source's version id and mod time (the
        # drain mover's rule): a replayed copy replaces, and the target's
        # history matches id for id.
        if fi.version_id:
            kw["version_id"] = fi.version_id
        if fi.mod_time_ns:
            kw["mod_time_ns"] = fi.mod_time_ns
        target.put_object(tb, key, data, metadata=meta, **kw)
        crash_point("repl.post_copy")
        with self._stats_mu:
            self.bytes_replicated += len(data)
        crash_point("repl.status")
        self._set_source_status(bucket, key, "COMPLETED", vid)

    def _replicate_delete(self, bucket: str, key: str, tb: str, target,
                          delete_marker: bool = False) -> None:
        try:
            if delete_marker:
                # The source wrote a delete MARKER: so does the target
                # (cf. replicateDelete), not a hard delete of its latest.
                target.delete_object(tb, key, "", True)
            else:
                target.delete_object(tb, key)
            crash_point("repl.post_copy")
        except StorageError:
            pass                                  # already absent: fine

    # -- the workers ---------------------------------------------------------

    def _backoff(self, attempts: int) -> float:
        base = min(self.max_interval,
                   self.retry_interval * (2 ** min(attempts, 20)))
        return base * (1.0 + 0.25 * self._rng.random())

    def _next_task(self) -> dict | None:
        """Move the earliest due task into the in-flight set; wait until
        one is due or the pool stops."""
        with self._cv:
            while not self._stop.is_set():
                # A drain may have begun: an idle pool's journal moves
                # off the draining pool too.
                self._rehome_locked()
                now = time.monotonic()
                best_key, wait = None, 0.2
                for tk, t in self._pending.items():
                    dt = t["next_try"] - now
                    if dt <= 0:
                        best_key = tk
                        break
                    wait = min(wait, dt)
                if best_key is not None:
                    task = self._pending.pop(best_key)
                    self._inflight[best_key] = task
                    return task
                self._cv.wait(timeout=wait)
        return None

    def _finish(self, task: dict, *, done: bool,
                dropped: bool = False) -> None:
        """Retire an in-flight task: journal its completion (a NEWER
        enqueue of the same key that raced it stays in the backlog)."""
        tk = _key_of(task)
        with self._cv:
            self._inflight.pop(tk, None)
            if done or dropped:
                self._append_locked({"op": "done", "k": tk,
                                     "seq": task["seq"]})
            self._cv.notify()

    def _requeue(self, task: dict, next_try: float) -> None:
        """Put a failed or deferred task back, unless a newer enqueue of
        the same key already replaced it (the latest state wins)."""
        tk = _key_of(task)
        with self._cv:
            self._inflight.pop(tk, None)
            if tk not in self._pending:
                task["next_try"] = next_try
                self._pending[tk] = task
            self._cv.notify()

    def _worker(self, idx: int, nworkers: int) -> None:
        from ..server import qos as _qos
        while not self._stop.is_set():
            # Under foreground pressure the higher-numbered workers park
            # (worker 0 always runs) and the rest pace themselves.
            if idx >= _qos.scale_workers(nworkers, "replication"):
                self._stop.wait(0.2)
                continue
            task = self._next_task()
            if task is None:
                return
            _qos.bg_pause("replication")
            self._run_task(task)

    def _run_task(self, task: dict) -> None:
        bucket, key, tb = task["b"], task["k"], task["tb"]
        if bucket in self._tombstones:
            # Unwired on purpose: its journaled backlog drops with it.
            with self._stats_mu:
                self.dropped += 1
            self._finish(task, done=False, dropped=True)
            return
        bk = (bucket, tb)
        br = self._breakers.get(bk)
        now = time.monotonic()
        if br is not None and br["open_until"] > now:
            # Breaker open: defer without spending an attempt, so a dead
            # target is lag and never a retry hot loop.
            self._requeue(task, br["open_until"]
                          + 0.05 * self._rng.random())
            return
        target = self._targets.get((bucket, tb))
        if target is None:
            # Not wired yet (boot replays before the server wires the
            # persisted configs): wait, do not drop.
            self._requeue(task, now + 0.5)
            return
        try:
            crash_point("repl.pre_copy")
            if task["t"] == "delete":
                self._replicate_delete(bucket, key, tb, target,
                                       delete_marker=bool(task.get("dm")))
            else:                      # "put" and "meta" both copy
                self._replicate_put(bucket, key, tb, target,
                                    task.get("vid", ""))
        except (ErrObjectNotFound, ErrVersionNotFound):
            # The source version went before the copy ran (deleted or
            # superseded): nothing is left to replicate.
            with self._stats_mu:
                self.dropped += 1
            self._finish(task, done=False, dropped=True)
            return
        except ErrUnreplicable:
            # No retry can copy it (an SSE-C version): FAILED, not lag.
            with self._stats_mu:
                self.unreplicable += 1
            self._set_source_status(bucket, key, "FAILED",
                                    task.get("vid", ""))
            self._finish(task, done=False, dropped=True)
            return
        except Exception:  # noqa: BLE001 — retry with backoff
            with self._stats_mu:
                if task["attempts"] == 0:
                    self.failed += 1
                else:
                    self.retries += 1
            if task["attempts"] == 0 and task["t"] != "delete":
                self._set_source_status(bucket, key, "FAILED",
                                        task.get("vid", ""))
            br = self._breakers.setdefault(
                bk, {"fails": 0, "open_until": 0.0, "opened": 0,
                     "probes": 0})
            br["fails"] += 1
            if br["fails"] >= self.breaker_fails:
                if br["open_until"] == 0.0:
                    br["opened"] += 1
                hold = min(self.breaker_max, 0.5 * (2 ** (
                    br["fails"] - self.breaker_fails)))
                br["open_until"] = time.monotonic() + hold
            task["attempts"] += 1
            self._requeue(task, time.monotonic()
                          + self._backoff(task["attempts"]))
            return
        if br is not None:
            if br["open_until"]:
                br["probes"] += 1       # the probe that closed it
            br["fails"] = 0
            br["open_until"] = 0.0
        with self._stats_mu:
            self.completed += 1
        self._finish(task, done=True)

    # -- stats and lifecycle -------------------------------------------------

    def stats(self) -> dict:
        """Replication counters (cf. cmd/bucket-replication-stats.go)."""
        with self._cv:
            backlog = (list(self._pending.values())
                       + list(self._inflight.values()))
            now = time.time()
            lag: dict[str, float] = {}
            for t in backlog:
                age = max(0.0, now - float(t.get("ts") or now))
                lag[t["tb"]] = max(lag.get(t["tb"], 0.0), age)
            mono = time.monotonic()
            breakers = {f"{b}->{tb}": max(0.0, br["open_until"] - mono)
                        for (b, tb), br in self._breakers.items()
                        if br["open_until"] > mono}
            trips = {f"{b}->{tb}": {"opened": br["opened"],
                                    "probes": br["probes"]}
                     for (b, tb), br in self._breakers.items()}
            queued = len(backlog)
        return {"completed": self.completed, "failed": self.failed,
                "bytesReplicated": self.bytes_replicated,
                "queued": queued, "retries": self.retries,
                "dropped": self.dropped, "replayed": self.replayed,
                "adopted": self.adopted,
                "proxiedReads": self.proxied_reads,
                "unreplicable": self.unreplicable,
                "journalPending": queued,
                "lagSeconds": {k: round(v, 3) for k, v in lag.items()},
                "breakersOpen": {k: round(v, 3)
                                 for k, v in breakers.items()},
                "breakerTrips": trips}

    def wait_idle(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._pending and not self._inflight:
                    return True
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        with self._cv:
            self._checkpoint_locked()
            if self._jf is not None:
                try:
                    self._jf.close()
                except OSError:
                    pass
                self._jf = None


def _orphan(name: str, width: int) -> bool:
    """Is a sibling journal's writer gone?  With a pool of `width`
    workers, worker ids below it are live siblings; every other name
    (ids beyond it, the one-process name) is an orphan."""
    if not (name.startswith(_JOURNAL_PREFIX)
            and name.endswith(_JOURNAL_SUFFIX)):
        return False
    if width:
        m = name[len(_JOURNAL_PREFIX):-len(_JOURNAL_SUFFIX)].lstrip(".")
        if m.startswith("w"):
            try:
                if int(m[1:]) < width:
                    return False
            except ValueError:
                pass
    return True


def adopt_orphan_journals(journal_path: str,
                          dirs: list[str] | None = None,
                          orphans: bool = True) -> int:
    """Fold the journals no live process owns into `journal_path`: each
    reduced to its NET pending set, appended as plain enq records (so its
    ckpt cannot wipe the adopter's entries), fsynced, then unlinked.
    `dirs` are the other places a journal of the deployment may sit (the
    home follows the drains): there a journal of this process's own name
    is its predecessor's, adopted always.  `orphans` (worker 0, a lone
    process) also adopts every journal whose writer is gone (`_orphan`)."""
    home = os.path.dirname(journal_path)
    me = os.path.basename(journal_path)
    width = int(os.environ.get("MTPU_WORKERS_TOTAL", "0") or 0)
    adopted = 0
    for d in [home] + [x for x in (dirs or []) if x != home]:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            path = os.path.join(d, name)
            if path == journal_path:
                continue
            if not ((orphans and _orphan(name, width))
                    or (d != home and name == me)):
                continue
            try:
                with open(path, "r", encoding="utf-8") as src:
                    pending = _net_pending(src.read())
                with open(journal_path, "a", encoding="utf-8") as dst:
                    for it in pending.values():
                        dst.write(json.dumps(
                            {"op": "enq", **_task_of(it)},
                            separators=(",", ":")) + "\n")
                    dst.flush()
                    os.fsync(dst.fileno())
                os.unlink(path)
                adopted += 1
            except OSError:
                continue
    return adopted


# ---------------------------------------------------------------------------
# remote-target registry and the server's wiring (cmd/bucket-targets.go)
# ---------------------------------------------------------------------------

def parse_targets(raw: bytes | None) -> list[dict]:
    """bucket-targets.json -> [{arn, endpoint, accessKey, secretKey,
    targetBucket}]."""
    if not raw:
        return []
    try:
        out = json.loads(raw)
        return out if isinstance(out, list) else []
    except ValueError:
        return []


class _RemoteTarget:
    """A registered remote target, as the pool calls it (pools-style
    methods over the port's signed S3 client)."""

    def __init__(self, cli, bucket: str):
        self.cli = cli
        self.bucket = bucket

    def put_object(self, bucket, key, data, *, metadata=None, **kw):
        headers = {}
        for k, v in (metadata or {}).items():
            if (k.startswith("x-amz-meta-") or k == "content-type"
                    or k == STATUS_KEY or k == _H_SSE):
                # The status marks the copy REPLICA on the remote: GET
                # and HEAD report it, and the remote's own replication
                # skips it (the loop guard).
                headers[k] = v
        if kw.get("version_id"):
            headers[REPL_VID_HEADER] = kw["version_id"]
        if kw.get("mod_time_ns"):
            headers[REPL_MTIME_HEADER] = str(kw["mod_time_ns"])
        self.cli.put_object(bucket, key, bytes(data),
                            headers=headers or None)

    def get_object(self, bucket, key, headers=None):
        _, _, data = self.cli._check(*self.cli.request(
            "GET", f"/{bucket}/{key}", headers=dict(headers or {})))
        return data

    def delete_object(self, bucket, key, version_id="", versioned=False):
        # REPLICA-marked, so an active-active peer does not send it back;
        # the remote bucket's versioning decides marker or hard delete,
        # as for a client's DELETE.
        st, _, body = self.cli.request(
            "DELETE", f"/{bucket}/{key}", headers={STATUS_KEY: "REPLICA"})
        if st not in (200, 204):
            from ..server.client import S3ClientError
            raise S3ClientError(st, "DeleteFailed",
                                body[:200].decode("utf-8", "replace"))


def target_client(entry: dict) -> _RemoteTarget:
    """The client of one registered remote target (the TargetClient of
    cmd/bucket-targets.go:388): replication rides the signed S3 wire."""
    from ..server.client import S3Client
    cli = S3Client(entry["endpoint"], entry["accessKey"],
                   entry["secretKey"])
    return _RemoteTarget(cli, entry.get("targetBucket", ""))


def wire_bucket(pool: ReplicationPool, meta, bucket: str) -> bool:
    """(Re)wire one bucket from its PERSISTED config and registered
    targets: when the config lands and at every boot.  False when either
    half is missing; ValueError when a rule names an unregistered target
    bucket (replicating there would misdirect data)."""
    raw_cfg = meta.get(bucket, "replication")
    if not raw_cfg:
        return False
    targets = parse_targets(meta.get(bucket, "replication_targets"))
    if not targets:
        return False
    rules = parse_replication_config(raw_cfg)
    by_bucket = {t.get("targetBucket", ""): t for t in targets}
    clients: dict[str, _RemoteTarget] = {}

    def client_for(entry: dict) -> _RemoteTarget:
        key = entry.get("arn") or entry.get("targetBucket", "")
        if key not in clients:
            clients[key] = target_client(entry)
        return clients[key]

    unmatched = [r.target_bucket for r in rules
                 if r.target_bucket not in by_bucket]
    if unmatched:
        raise ValueError(
            f"replication rules reference unregistered target "
            f"bucket(s) {unmatched}; register them with "
            f"admin bucket-remote first")
    pool.configure_rules(bucket, [(r, client_for(by_bucket[r.target_bucket]))
                                  for r in rules])
    return True
