"""Crash-resumable pool decommission: drain a pool into the others.

Counterpart of minio_tpu/background/decom.py (the reference's
decommission, cmd/erasure-server-pool-decom.go).  The admin marks a pool
draining (`ServerPools.set_draining`): new writes leave it at once,
reads keep serving from it, and a mover walks the pool's namespace
(the buckets and the system volume's objects, META_PREFIXES),
PUTting every version and every pending multipart upload again through
the normal write path into the other pools.  Each version's bytes are
read (verified, rebuilt where a shard is missing) and written (encoded
and framed) on the card, as a GET and a PUT are.

Exactly once, per version: the destination copy is VERIFIED (the same
bytes under the same version id and mod time, or, for the null version
alone, superseded by a newer client write) BEFORE the source version is
deleted, and only then a durable `moved` record is appended.  Every step
is idempotent, so a kill -9 at any of the four crash points
(`decom.pre_verify`, `decom.post_copy`, `decom.pre_delete`,
`decom.checkpoint`, utils/crashpoints.py) resumes to the same end: a
version that died mid-copy is copied again under its own id, one that
died between verify and delete is found on the destination and reaped,
one that died before its record is gone from the source on the next
walk.  The resume re-walks the pool; the journal carries the drain's
state, its progress and the multipart relocation map (old upload id ->
new), on which clients' upload ids depend across restarts.

Journal: fsynced JSONL at `<the first pool but the drained one's first
local drive>/.mtpu.sys/decom-journal.p<idx>.jsonl`, never on the drained
pool, whose drives are about to go.  The JAX package's records

    {"op": "state", "pool": i, "state": "draining"|...}
    {"op": "moved", "k": "bucket/obj@vid", "bytes": n}
    {"op": "mp", "old": "<i.uid>", "new": "<j.uid>", "b": ..., "o": ...}
    {"op": "ckpt", ...}              # compaction (tmp + fsync + replace)

and, which the JAX replay skips, the port's progress records: "walk"
(the pass's object count), "obj" (an object done), "part" (a relocated
part's bytes), a time "t" on each state record and the progress fields
of "ckpt".  Each package reads the other's journal.

One mover per pool across a worker pool's processes: the owner runs the
movers (one process alone, or worker 0, the recovery owner;
server/workers.py).  Another worker records an admin
request in the journal (`request`) and bumps the shared topology
generation, and the owner folds the journal into its movers
(`reconcile`).  A respawned worker 0 resumes the drains from their
journals (`resume_decommissions`), so a drain outlives the process that
ran it, and every worker answers status from the journal
(`journal_status`), so every worker reads the same.  The JAX package
runs the mover in whichever worker answered the POST.

Env knobs:
  MTPU_DECOM_FSYNC     1 (default) fsync each durable append, 0 flush only
  MTPU_DECOM_WORKERS   parallel mover lanes (default 1)
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..storage.drive import SYS_VOL, XL_META_FILE
from ..storage.errors import (ErrBucketNotFound, ErrErasureReadQuorum,
                              ErrObjectNotFound, ErrVersionNotFound,
                              StorageError)
from ..storage.xlmeta import XLMeta
from ..utils.crashpoints import crash_point

_NOT_HERE = (ErrObjectNotFound, ErrVersionNotFound, ErrBucketNotFound)

#: a drain in these states holds its pool out of placement and has (or
#: gets) a mover; `failed` parks until an admin resume
ACTIVE_STATES = ("draining", "paused")

_PREFIX, _SUFFIX = "decom-journal.p", ".jsonl"

#: The system volume's prefixes that hold objects of the object layer:
#: every bucket's configs (bucket/metadata.py), IAM and the server config
#: (iam/iam.py, config/config.py).  A drain moves them as it moves a
#: bucket's versions, or a reboot without the drained pool would lose
#: them (the JAX mover walks the buckets alone).  The rest of the volume
#: is each drive's own (journals, pool-topology.json, the metacache,
#: tmp and multipart staging) and stays.
META_PREFIXES = ("buckets/", "config/")


def journal_name(pool_idx: int) -> str:
    return f"{_PREFIX}{pool_idx}{_SUFFIX}"


def _pool_first_root(pool) -> str | None:
    for es in getattr(pool, "sets", [pool]):
        for d in getattr(es, "drives", []):
            root = getattr(d, "root", None)
            if d is not None and root:
                return root
    return None


def default_journal_path(pools, pool_idx: int) -> str | None:
    """The first local drive of the first pool that is not the drained
    one (its drives go once the drain completes); else the drained
    pool's own."""
    for i, p in enumerate(pools.pools):
        if i == pool_idx:
            continue
        root = _pool_first_root(p)
        if root:
            return os.path.join(root, SYS_VOL, journal_name(pool_idx))
    root = _pool_first_root(pools.pools[pool_idx])
    return (os.path.join(root, SYS_VOL, journal_name(pool_idx))
            if root else None)


def _fold(path: str) -> dict:
    """A journal's records folded to the drain's net state and progress;
    a torn last line (a kill mid-append) is skipped."""
    out = {"state": "draining", "moved": 0, "bytes": 0, "mp": {},
           "error": None, "objects": 0, "objects_total": 0,
           "started_at": None, "session_t0": None, "session_bytes": 0,
           "session_objects": 0}
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except (ValueError, TypeError):
            continue                      # torn tail
        op = rec.get("op")
        if op == "ckpt":
            out["state"] = rec.get("state", out["state"])
            out["moved"] = int(rec.get("moved", 0))
            out["bytes"] = int(rec.get("bytes", 0))
            out["mp"] = dict(rec.get("mp", {}))
            out["error"] = rec.get("error")
            out["objects"] = int(rec.get("objects", 0))
            out["objects_total"] = int(rec.get("objects_total", 0))
            out["started_at"] = rec.get("started_at", out["started_at"])
        elif op == "state":
            st = rec.get("state", out["state"])
            out["state"] = st
            out["error"] = rec.get("error")
            t = rec.get("t")
            if t is not None and out["started_at"] is None:
                out["started_at"] = t
            if st == "draining":
                out["session_t0"] = t
                out["session_bytes"] = out["session_objects"] = 0
        elif op == "moved":
            out["moved"] += 1
            out["bytes"] += int(rec.get("bytes", 0))
            out["session_bytes"] += int(rec.get("bytes", 0))
        elif op == "part":
            out["bytes"] += int(rec.get("bytes", 0))
            out["session_bytes"] += int(rec.get("bytes", 0))
        elif op == "mp":
            out["mp"][rec["old"]] = rec["new"]
        elif op == "walk":
            out["objects_total"] = int(rec.get("total", 0))
        elif op == "obj":
            out["objects"] += 1
            out["session_objects"] += 1
    return out


def replay_journal(path: str) -> dict:
    """A journal's net state: {"state", "moved", "bytes", "mp"}, the JAX
    package's fold."""
    f = _fold(path)
    return {k: f[k] for k in ("state", "moved", "bytes", "mp")}


def find_journals(pools) -> dict[int, str]:
    """pool idx -> journal path, searched on every pool's first drive
    (the journal's home depends on the state being recovered)."""
    found: dict[int, str] = {}
    for p in pools.pools:
        root = _pool_first_root(p)
        if not root:
            continue
        sysdir = os.path.join(root, SYS_VOL)
        try:
            names = os.listdir(sysdir)
        except OSError:
            continue
        for name in sorted(names):
            if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
                continue
            try:
                idx = int(name[len(_PREFIX):-len(_SUFFIX)])
            except ValueError:
                continue
            found.setdefault(idx, os.path.join(sysdir, name))
    return found


def active_drains(pools) -> set[int]:
    """The pools whose drain journal holds a drain in ACTIVE_STATES."""
    return {idx for idx, path in find_journals(pools).items()
            if idx < len(pools.pools)
            and _fold(path)["state"] in ACTIVE_STATES}


def journal_status(pool_idx: int, path: str) -> dict:
    """A drain's admin status, from its journal alone: what every worker
    of a pool answers, whichever runs the mover."""
    f = _fold(path)
    remaining = max(0, f["objects_total"] - f["objects"])
    elapsed = (time.time() - f["session_t0"]
               if f["state"] == "draining" and f["session_t0"] else 0.0)
    rate = f["session_bytes"] / elapsed if elapsed > 0.5 else 0.0
    done_rate = (f["session_objects"] / elapsed
                 if elapsed > 0.5 and f["session_objects"] else 0.0)
    eta = remaining / done_rate if done_rate else None
    return {
        "pool": pool_idx,
        "state": f["state"],
        "error": f["error"],
        "objects_total": f["objects_total"],
        "objects_moved": f["objects"],
        "objects_remaining": remaining,
        "versions_moved": f["moved"],
        "uploads_relocated": len(f["mp"]),
        "bytes_moved": f["bytes"],
        "bytes_per_sec": round(rate, 1),
        "eta_seconds": round(eta, 1) if eta is not None else None,
        "started_at": f["started_at"],
    }


def pool_status(pools, pool_idx: int) -> dict | None:
    """The drain status of one pool, None when it has no journal."""
    path = find_journals(pools).get(pool_idx)
    if path is None:
        d = pools.decommissions.get(pool_idx)
        return d.status() if d is not None else None
    return journal_status(pool_idx, path)


def _append_record(path: str, rec: dict, fsync: bool = True) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        f.flush()
        if fsync:
            os.fsync(f.fileno())


class Decommissioner:
    """One pool's drain: the mover thread, its journal, the admin
    controls."""

    def __init__(self, pools, pool_idx: int, *,
                 journal_path: str | None = None,
                 fsync: bool | None = None,
                 workers: int | None = None):
        if not 0 <= pool_idx < len(pools.pools):
            raise ValueError(f"no pool {pool_idx}")
        self.pools = pools
        self.pool_idx = pool_idx
        self.journal_path = (journal_path
                             or default_journal_path(pools, pool_idx))
        self._j_fsync = (os.environ.get("MTPU_DECOM_FSYNC", "1") != "0"
                         if fsync is None else fsync)
        if workers is None:
            try:
                workers = int(os.environ.get("MTPU_DECOM_WORKERS", "1"))
            except ValueError:
                workers = 1
        self.workers = max(1, workers)

        self._mu = threading.Lock()
        self._jf = None
        self.state = "draining"
        self.error: str | None = None
        self.versions_moved = 0
        self.bytes_moved = 0
        self.uploads_moved = 0
        self.objects_total = 0
        self.objects_done = 0
        self._session_bytes = 0
        self._session_t0: float | None = None
        self.started_at = time.time()
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._cancel = threading.Event()
        self._thread: threading.Thread | None = None

        if self.journal_path:
            prior = _fold(self.journal_path)
            self.state = prior["state"]
            self.error = prior["error"]
            self.versions_moved = prior["moved"]
            self.bytes_moved = prior["bytes"]
            self.uploads_moved = len(prior["mp"])
            self.objects_done = prior["objects"]
            if prior["started_at"]:
                self.started_at = prior["started_at"]
            # Relocated upload ids keep resolving after a restart.
            self.pools.upload_relocations.update(prior["mp"])
            if self.state == "paused":
                self._unpaused.clear()

    # -- journal -------------------------------------------------------------

    def _append(self, rec: dict, durable: bool = True) -> None:
        if not self.journal_path:
            return
        if rec.get("op") == "state":
            rec["t"] = time.time()
        with self._mu:
            try:
                if self._jf is None:
                    os.makedirs(os.path.dirname(self.journal_path),
                                exist_ok=True)
                    self._jf = open(self.journal_path, "a",
                                    encoding="utf-8")
                self._jf.write(json.dumps(rec, separators=(",", ":"))
                               + "\n")
                self._jf.flush()
                if durable and self._j_fsync:
                    os.fsync(self._jf.fileno())
            except OSError:
                # A lost journal leaves progress in memory only: the
                # resume walk derives correctness from the namespace.
                self._jf = None

    def _state(self, state: str, **extra) -> None:
        self._append({"op": "state", "pool": self.pool_idx,
                      "state": state, **extra})

    def checkpoint(self) -> None:
        """Compact the journal to one ckpt record."""
        if not self.journal_path:
            return
        with self._mu:
            rec = {"op": "ckpt", "pool": self.pool_idx,
                   "state": self.state, "moved": self.versions_moved,
                   "bytes": self.bytes_moved,
                   "mp": {k: v for k, v
                          in self.pools.upload_relocations.items()
                          if k.startswith(f"{self.pool_idx}.")},
                   "error": self.error, "objects": self.objects_done,
                   "objects_total": self.objects_total,
                   "started_at": self.started_at}
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
            except OSError:
                pass

    # -- controls ------------------------------------------------------------

    def start(self) -> "Decommissioner":
        """Mark the pool draining and launch the mover (parked at its
        gate when the journal left the drain paused)."""
        self.pools.set_draining(self.pool_idx, True)
        self.pools.decommissions[self.pool_idx] = self
        if self.state not in ACTIVE_STATES:
            self.state = "draining"
            self.error = None
        self._state(self.state)
        self._thread = threading.Thread(target=self._run,
                                        name=f"decom-p{self.pool_idx}",
                                        daemon=True)
        self._thread.start()
        return self

    def run_sync(self) -> None:
        """The drain in the caller's thread (tests, harnesses)."""
        self.pools.set_draining(self.pool_idx, True)
        self.pools.decommissions[self.pool_idx] = self
        self._state(self.state)
        self._run()

    def pause(self) -> None:
        if self.state == "draining":
            self.state = "paused"
            self._unpaused.clear()
            self._state("paused")

    def resume(self) -> None:
        if self.state in ("paused", "failed"):
            # A failed drain may sit without its draining flag (a boot
            # found a parked journal): assert it, or the mover would
            # copy objects back onto the source.
            self.pools.set_draining(self.pool_idx, True)
            self.pools.decommissions[self.pool_idx] = self
            self.state = "draining"
            self.error = None
            self._state("draining")
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=f"decom-p{self.pool_idx}",
                    daemon=True)
                self._thread.start()
            self._unpaused.set()

    def cancel(self) -> None:
        """Stop the drain and make the pool placement-eligible again.
        Versions already moved stay moved (valid copies, their sources
        deleted); relocated uploads keep their mapping."""
        self._cancel.set()
        self._unpaused.set()
        self.join(timeout=30)
        self.state = "cancelled"
        self._state("cancelled")
        self.checkpoint()
        self.pools.set_draining(self.pool_idx, False)

    def join(self, timeout: float | None = None) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        """From the journal, as every worker answers it (in memory only
        where the drain has no journal)."""
        if self.journal_path and os.path.exists(self.journal_path):
            return journal_status(self.pool_idx, self.journal_path)
        with self._mu:
            remaining = max(0, self.objects_total - self.objects_done)
            elapsed = (time.monotonic() - self._session_t0
                       if self._session_t0 else 0.0)
            rate = self._session_bytes / elapsed if elapsed > 0.5 else 0.0
            done_rate = (self.objects_done / elapsed
                         if elapsed > 0.5 and self.objects_done else 0.0)
            eta = remaining / done_rate if done_rate else None
            return {
                "pool": self.pool_idx, "state": self.state,
                "error": self.error,
                "objects_total": self.objects_total,
                "objects_moved": self.objects_done,
                "objects_remaining": remaining,
                "versions_moved": self.versions_moved,
                "uploads_relocated": self.uploads_moved,
                "bytes_moved": self.bytes_moved,
                "bytes_per_sec": round(rate, 1),
                "eta_seconds": round(eta, 1) if eta is not None else None,
                "started_at": self.started_at,
            }

    # -- the mover -----------------------------------------------------------

    def _src(self):
        return self.pools.pools[self.pool_idx]

    def _gate(self) -> bool:
        """Block while paused; False when the drain should stop.  Every
        mover passes here between versions, so it is also the drain's
        yield to foreground pressure (server/qos.py)."""
        while not self._unpaused.wait(0.2):
            if self._cancel.is_set():
                return False
        if self._cancel.is_set():
            return False
        from ..server import qos as _qos
        _qos.bg_pause("decom")
        return True

    def _run(self) -> None:
        try:
            self._session_bytes = 0
            self._session_t0 = time.monotonic()
            # Pending uploads first: their ids are client-held and
            # pool-sticky, so new parts must land on the destination
            # before the walk churns.
            self._relocate_uploads()
            # Walk, move, walk again until the pool is empty: a PUT that
            # raced the draining flag can publish behind the walk.
            for _ in range(8):
                if not self._gate():
                    return
                names = self._names()
                with self._mu:
                    self.objects_total = self.objects_done + len(names)
                self._append({"op": "walk", "total": self.objects_total},
                             durable=False)
                if not names:
                    break
                self._move_all(names)
                if self._cancel.is_set():
                    return
            else:
                raise StorageError(
                    f"pool {self.pool_idx} namespace not converging")
            if self._names():
                raise StorageError(
                    f"pool {self.pool_idx} not empty after drain")
            self.state = "complete"
            self._state("complete")
            self.checkpoint()
        except Exception as e:          # noqa: BLE001 - park, do not die
            if self._cancel.is_set():
                return
            self.state = "failed"
            self.error = f"{type(e).__name__}: {e}"
            self._state("failed", error=self.error)

    def _names(self) -> list[tuple[str, str]]:
        """Every object of the pool: each bucket's, then the system
        volume's objects (META_PREFIXES), which `list_buckets` does not
        name."""
        src = self._src()
        out: list[tuple[str, str]] = []
        walks = [(b, "") for b in src.list_buckets()]
        walks += [(SYS_VOL, p) for p in META_PREFIXES]
        for b, prefix in walks:
            seen: set[str] = set()
            for es in src.sets:
                try:
                    seen.update(es.list_object_names(b, prefix))
                except StorageError:
                    continue
            out.extend((b, o) for o in sorted(seen))
        return out

    def _move_all(self, names: list[tuple[str, str]]) -> None:
        # Re-read each pass: mover lanes shrink while the admission
        # plane is under pressure and come back once it clears.
        from ..server import qos as _qos
        workers = _qos.scale_workers(self.workers, "decom")
        if workers > 1:
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix=f"decom-p{self.pool_idx}") as ex:
                list(ex.map(self._move_one, names))
        else:
            for bo in names:
                self._move_one(bo)

    def _move_one(self, bo: tuple[str, str]) -> None:
        if not self._gate():
            return
        bucket, obj = bo
        try:
            versions = self._src().list_object_versions(bucket, obj)
        except _NOT_HERE:
            versions = []
        except ErrErasureReadQuorum:
            self._finish_reap(bucket, obj)
            versions = []
        # Oldest first: each PUT keeps the source's mod time and version
        # id, so the history's order survives the move.
        for fi in reversed(versions):
            if not self._gate():
                return
            self._move_version(bucket, obj, fi)
        with self._mu:
            self.objects_done += 1
        self._append({"op": "obj"}, durable=False)

    def _move_version(self, bucket: str, obj: str, fi) -> None:
        src = self._src()
        vid = fi.version_id
        crash_point("decom.pre_verify")
        if fi.deleted:
            # A delete marker moves only as the live tip (intermediate
            # markers carry no data and would mint new ids); then the
            # source's marker is reaped.
            if fi.is_latest and not self._dest_newer(bucket, obj,
                                                     fi.mod_time_ns):
                try:
                    self.pools.delete_object(bucket, obj, versioned=True)
                except _NOT_HERE:
                    pass
            crash_point("decom.post_copy")
            crash_point("decom.pre_delete")
            self._reap_source(bucket, obj, vid)
            self._record_moved(bucket, obj, vid, 0)
            return
        try:
            src_fi, data = src.get_object(bucket, obj, version_id=vid)
        except _NOT_HERE:
            return                      # raced away (a client delete)
        # The version whole, as the JAX mover holds it: the peak is two
        # copies of the largest version (this and the verify's read).
        data = bytes(data)
        meta = dict(src_fi.metadata)
        if not self._dest_has(bucket, obj, src_fi, data):
            # The normal write path, whose placement skips the draining
            # pool; the version id and time are kept, so the copy IS the
            # version (the engine never lets an older time replace a
            # newer write of the same slot), and so is its parity, as
            # MinIO's decommission keeps an object's storage class (the
            # JAX mover writes the destination set's default parity).
            self.pools.put_object(bucket, obj, data, metadata=meta,
                                  versioned=bool(vid),
                                  version_id=vid if vid else None,
                                  mod_time_ns=src_fi.mod_time_ns,
                                  parity=src_fi.erasure.parity_blocks)
        crash_point("decom.post_copy")
        if not self._dest_has(bucket, obj, src_fi, data):
            raise StorageError(
                f"decom verify failed for {bucket}/{obj}@{vid!r}")
        crash_point("decom.pre_delete")
        self._reap_source(bucket, obj, vid)
        self._record_moved(bucket, obj, vid, len(data))

    def _reap_source(self, bucket: str, obj: str, vid: str) -> None:
        try:
            self._src().delete_object(bucket, obj, version_id=vid,
                                      versioned=False)
        except _NOT_HERE:
            pass                        # reaped before a resume

    def _finish_reap(self, bucket: str, obj: str) -> None:
        """A version history below read quorum on the source: what is
        left of a reap the mover's death cut short (the reap begins only
        once the destination's copy is verified, and a kill between its
        drives leaves the version on the others).  Each drive's remnant
        goes once the destination holds that version, by id and mod time;
        a remnant without such a copy is not the mover's to remove, and
        the drain fails on it as before."""
        es = self._src().set_for(obj)
        copies = {(v.version_id, v.mod_time_ns)
                  for _, _, vers in self._dest_versions(bucket, obj)
                  for v in vers if not v.deleted}
        remnants = []
        for d in es.drives:
            if d is None:
                continue
            try:
                raw = d.read_all(bucket, f"{obj}/{XL_META_FILE}")
            except StorageError:
                continue
            for v in XLMeta.from_bytes(raw).list_versions(bucket, obj):
                if not v.deleted and \
                        (v.version_id, v.mod_time_ns) not in copies:
                    raise ErrErasureReadQuorum(
                        f"{bucket}/{obj}: a version below read quorum "
                        f"with no copy on another pool")
                remnants.append((d, v.version_id))
        for d, vid in remnants:
            try:
                d.delete_version(bucket, obj, vid)
            except StorageError:
                continue

    def _record_moved(self, bucket: str, obj: str, vid: str,
                      nbytes: int) -> None:
        crash_point("decom.checkpoint")
        with self._mu:
            self.versions_moved += 1
            self.bytes_moved += nbytes
            self._session_bytes += nbytes
        self._append({"op": "moved", "k": f"{bucket}/{obj}@{vid}",
                      "bytes": nbytes})

    # -- the destination's copy ------------------------------------------------

    def _dest_versions(self, bucket: str, obj: str):
        for i, p in enumerate(self.pools.pools):
            if i == self.pool_idx:
                continue
            try:
                yield i, p, p.list_object_versions(bucket, obj)
            except StorageError:
                continue

    def _dest_newer(self, bucket: str, obj: str, mod_ns: int) -> bool:
        return any(v.mod_time_ns > mod_ns
                   for _, _, vers in self._dest_versions(bucket, obj)
                   for v in vers)

    def _dest_has(self, bucket: str, obj: str, src_fi, data: bytes) -> bool:
        """True when deleting the source version is safe: a destination
        copy of the same version id and time reads back byte for byte,
        or, for the null version alone (last write wins there), a newer
        client write superseded it during the drain.  A versioned id is
        never superseded: history moves whole under any overwrite."""
        vid = src_fi.version_id
        etag = src_fi.metadata.get("etag", "")
        superseded = False
        for _, p, vers in self._dest_versions(bucket, obj):
            for v in vers:
                if vid == "" and v.mod_time_ns > src_fi.mod_time_ns:
                    superseded = True
                if v.version_id != vid or v.deleted:
                    continue
                if v.mod_time_ns != src_fi.mod_time_ns:
                    continue
                if etag and v.metadata.get("etag", "") != etag:
                    continue
                if v.size != src_fi.size:
                    continue
                try:
                    _, dbytes = p.get_object(bucket, obj, version_id=vid)
                except StorageError:
                    continue
                if bytes(dbytes) == data:
                    return True
        return superseded

    # -- pending multipart uploads -------------------------------------------

    def _relocate_uploads(self) -> None:
        src = self._src()
        for bucket in src.list_buckets():
            for u in src.list_multipart_uploads(bucket):
                if not self._gate():
                    return
                self._relocate_upload(bucket, u["object"], u["upload_id"])

    def _relocate_upload(self, bucket: str, obj: str, uid: str) -> None:
        old_full = f"{self.pool_idx}.{uid}"
        src = self._src()
        new_full = self.pools.upload_relocations.get(old_full)
        if new_full is None:
            meta = src.upload_metadata(bucket, obj, uid)
            new_full = self.pools.new_multipart_upload(bucket, obj,
                                                       metadata=meta)
            # The mapping is durable before any part is copied: a resume
            # copies again into the SAME destination upload (a part
            # re-put replaces the part).
            self.pools.upload_relocations[old_full] = new_full
            self._append({"op": "mp", "old": old_full, "new": new_full,
                          "b": bucket, "o": obj})
            with self._mu:
                self.uploads_moved += 1
        didx, new_uid = self.pools._split_upload_id(new_full)
        dest = self.pools.pools[didx]
        for p in src.list_parts(bucket, obj, uid):
            data = src.read_part_bytes(bucket, obj, uid, p.number)
            dest.put_object_part(bucket, obj, new_uid, p.number, data)
            with self._mu:
                self._session_bytes += len(data)
                self.bytes_moved += len(data)
            self._append({"op": "part", "bytes": len(data)},
                         durable=False)
        try:
            src.abort_multipart_upload(bucket, obj, uid)
        except StorageError:
            pass


def resume_decommissions(pools, *, autostart: bool = True
                         ) -> list[Decommissioner]:
    """The boot's recovery (the owner's alone): find the drain journals,
    reload the relocation maps, mark draining pools again and start the
    interrupted movers again: the kill -9 resume."""
    out: list[Decommissioner] = []
    for idx, path in sorted(find_journals(pools).items()):
        if idx >= len(pools.pools):
            continue
        d = Decommissioner(pools, idx, journal_path=path)
        pools.decommissions[idx] = d
        if d.state in ACTIVE_STATES:
            try:
                pools.set_draining(idx, True)
            except ValueError:
                d.state = "failed"
                d.error = "cannot resume: last placement-eligible pool"
                out.append(d)
                continue
            if autostart:
                d.start()           # a paused drain parks at its gate
        elif d.state == "complete":
            # Drained and empty: nothing may land on a pool that is
            # about to be unplugged.
            pools.draining.add(idx)
        out.append(d)
    return out


def request(pools, idx: int, action: str) -> dict | None:
    """A worker that runs no mover records an admin action in the drain's
    journal, for the owner's `reconcile`; its own placement follows at
    once.  Returns the status, or None when `action` needs a drain and
    the pool has none.  Raises ValueError on a bad pool, on draining the
    last placement pool, or on an unknown action."""
    if not 0 <= idx < len(pools.pools):
        raise ValueError(f"no pool {idx}")
    path = find_journals(pools).get(idx)
    state = _fold(path)["state"] if path else None
    if action == "start":
        if state in ACTIVE_STATES:
            return journal_status(idx, path)
        pools.set_draining(idx, True)
        path = path or default_journal_path(pools, idx)
        new = "draining"
    elif path is None:
        return None
    elif action not in ("pause", "resume", "cancel"):
        raise ValueError(f"unknown action {action!r}")
    elif action == "pause":
        new = "paused" if state == "draining" else None
    elif action == "resume":
        new = "draining" if state in ("paused", "failed") else None
        if new:
            pools.set_draining(idx, True)
    else:
        new = "cancelled"
        pools.set_draining(idx, False)
    if new:
        _append_record(path, {"op": "state", "pool": idx, "state": new,
                              "t": time.time()},
                       os.environ.get("MTPU_DECOM_FSYNC", "1") != "0")
    return journal_status(idx, path)


def reconcile(pools) -> list[str]:
    """The owner folds every drain journal into its movers: a drain some
    worker requested starts here, a pause, resume or cancel recorded
    there reaches the mover.  Returns what it did, one line each."""
    done = []
    for idx, path in sorted(find_journals(pools).items()):
        if idx >= len(pools.pools):
            continue
        want = _fold(path)["state"]
        d = pools.decommissions.get(idx)
        alive = d is not None and d.alive()
        if want in ACTIVE_STATES and not alive:
            d = Decommissioner(pools, idx, journal_path=path)
            try:
                d.start()
            except ValueError as e:
                done.append(f"pool {idx}: not started: {e}")
                continue
            done.append(f"pool {idx}: mover started ({d.state})")
        elif not alive:
            continue
        elif want == "paused" and d.state == "draining":
            d.pause()
            done.append(f"pool {idx}: paused")
        elif want == "draining" and d.state == "paused":
            d.resume()
            done.append(f"pool {idx}: resumed")
        elif want == "cancelled" and d.state != "cancelled":
            d.cancel()
            done.append(f"pool {idx}: cancelled")
    return done
