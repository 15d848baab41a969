"""Listing metacache: streamed quorum-merged walks with persisted,
resumable continuations.

Counterpart of minio_tpu/engine/metacache.py, whole, with the same
persisted bytes (cf. cmd/metacache-set.go listPath and
cmd/metacache-stream.go):

- the walk is a generator: each asked drive serves bounded pages
  (`LocalDrive.walk_page`, which prunes subtrees before the resume
  marker), a k-way merge elects each name by quorum, and entries flow
  out in lexical order, in O(asked drives x page) memory;
- results persist as zlib-compressed msgpack segments of about
  SEG_ENTRIES names under the system volume, with an index keyed by
  (bucket, prefix); a later page whose marker lands in persisted
  territory is served from the segment, across calls and restarts, and
  the live walk resumes where persistence stopped;
- MTPU_LIST_ASK sets how many drives a listing asks ("strict" = all, or
  a count; default a majority; the askDisks role,
  cmd/metacache-set.go:92);
- every mutation of a bucket bumps its generation (`bump`, from
  `ErasureSet._mark_dirty`), which drops its caches; CACHE_TTL bounds
  what another process's writes can leave stale.

Host work only: no device call is made here.
"""

from __future__ import annotations

import hashlib
import heapq
import os
import threading
import time
import zlib

from ..storage.drive import SYS_VOL
from ..storage.errors import StorageError
from ..storage.xlmeta import FileInfo, XLMeta
from ..utils import msgpackx
from . import quorum as Q

CACHE_TTL = 30.0            # seconds a cache stays valid without writes
CACHE_DIR = "metacache"
SEG_ENTRIES = 2000          # entries per persisted segment
WALK_PAGE = 1000            # per-drive page size


def _ask_count(n_online: int) -> int:
    """How many drives a listing asks (cf. askDisks,
    cmd/metacache-set.go:92): default majority; MTPU_LIST_ASK a count
    or "strict" (all)."""
    v = os.environ.get("MTPU_LIST_ASK", "")
    if v == "strict":
        return n_online
    if v.isdigit() and int(v) > 0:
        return min(int(v), n_online)
    return max(1, n_online // 2 + 1)


class Metacache:
    def __init__(self, es):
        self.es = es
        self._mu = threading.Lock()
        self._gen: dict[str, int] = {}          # bucket -> generation
        # (bucket, prefix, gen) -> state dict:
        #   {"at": ts, "segs": [[last_name, seq], ...],
        #    "done": bool, "last": str, "next_seq": int}
        self._idx: dict[tuple, dict] = {}
        self._seg_cache: tuple | None = None    # (path, entries) LRU-1
        self._persisted_paths: dict[str, set] = {}
        self.walks = 0                          # streams opened
        self.streamed_entries = 0               # entries pulled live

    # -- invalidation --------------------------------------------------------

    def bump(self, bucket: str) -> None:
        with self._mu:
            self._gen[bucket] = self._gen.get(bucket, 0) + 1
            for key in [k for k in self._idx if k[0] == bucket]:
                del self._idx[key]
            self._seg_cache = None
            paths = self._persisted_paths.pop(bucket, set())
        # Drop persisted caches for this bucket too; other nodes fall
        # back to the TTL bound (the reference's metacache life window).
        for path in paths:
            def rm(d, p=path):
                d.delete(SYS_VOL, p, recursive=True)
            try:
                self.es._map_drives(rm)
            except StorageError:
                pass

    def _generation(self, bucket: str) -> int:
        with self._mu:
            return self._gen.get(bucket, 0)

    # -- streamed walk + quorum merge (metacache-set.go listPath) ------------

    def _stream(self, bucket: str, prefix: str, after: str = "",
                info: dict | None = None):
        """Quorum-agreed FileInfo generator in lexical name order.

        Every asked drive serves bounded pages; a k-way merge groups
        per name; a name needs metadata agreement among the asked
        drives' LIVE copies (find_file_info_in_quorum with the quorum
        shrinking as drives fail mid-walk, like the old ok_drives
        accounting) to be listed. If EVERY asked drive fails the
        stream raises — a truncated walk must never read as a
        complete listing. Pass `info` to learn post-hoc whether any
        drive failed (callers then skip caching the result)."""
        self.walks += 1
        online = [d for d in self.es.drives if d is not None]
        if not online:
            raise StorageError("listing failed: no drives online")
        asked = online[:_ask_count(len(online))]
        if info is None:
            info = {}
        info["failed"] = 0
        info["asked"] = len(asked)

        def pages(d):
            cursor = after
            while True:
                try:
                    entries, eof = d.walk_page(bucket, prefix,
                                               after=cursor,
                                               limit=WALK_PAGE)
                except StorageError:
                    info["failed"] += 1
                    return
                yield from entries
                if eof or not entries:
                    return
                cursor = entries[-1][0]

        merged = heapq.merge(*(pages(d) for d in asked),
                             key=lambda e: e[0])
        cur_name, cur_raws = None, []

        def resolve(name, raws):
            fis = []
            for raw in raws:
                try:
                    fis.append(XLMeta.from_bytes(raw).latest(bucket,
                                                             name))
                except StorageError:
                    continue
            alive = max(1, info["asked"] - info["failed"])
            try:
                fi = Q.find_file_info_in_quorum(fis, max(1, alive // 2))
            except StorageError:
                return None
            return None if fi.deleted else fi

        for name, raw in merged:
            if name == cur_name:
                cur_raws.append(raw)
                continue
            if cur_name is not None:
                fi = resolve(cur_name, cur_raws)
                if fi is not None:
                    self.streamed_entries += 1
                    yield fi
            cur_name, cur_raws = name, [raw]
        if cur_name is not None:
            fi = resolve(cur_name, cur_raws)
            if fi is not None:
                self.streamed_entries += 1
                yield fi
        if info["failed"] >= info["asked"]:
            raise StorageError(
                f"listing failed on all {info['asked']} asked drives")

    # -- persisted segments (metacache-stream.go persistence) ----------------

    def _base_path(self, bucket: str, prefix: str) -> str:
        h = hashlib.sha256(
            f"{bucket}\x00{prefix}".encode()).hexdigest()[:24]
        return f"{CACHE_DIR}/{h}"

    def _write_sys(self, bucket: str, path: str, payload: bytes) -> None:
        with self._mu:
            self._persisted_paths.setdefault(bucket, set()).add(path)

        def put(d):
            d.write_all(SYS_VOL, path, payload)
        try:
            self.es._map_drives(put)
        except StorageError:
            pass

    def _read_sys(self, path: str) -> bytes | None:
        for d in self.es.drives:
            if d is None:
                continue
            try:
                return d.read_all(SYS_VOL, path)
            except StorageError:
                continue
        return None

    @staticmethod
    def _pack_entries(entries: list) -> bytes:
        return zlib.compress(msgpackx.packb(
            [{"n": fi.name, "s": fi.size, "mt": fi.mod_time_ns,
              "v": fi.version_id, "m": dict(fi.metadata)}
             for fi in entries]), 1)

    @staticmethod
    def _unpack_entries(bucket: str, payload: bytes) -> list:
        return [FileInfo(volume=bucket, name=e["n"], size=e["s"],
                         mod_time_ns=e["mt"], version_id=e["v"],
                         metadata=e["m"])
                for e in msgpackx.unpackb(zlib.decompress(payload))]

    def _persist_segment(self, bucket, prefix, state, entries) -> None:
        # seq is MONOTONIC per cache (never reused after a lost-segment
        # truncation) so a replacement segment gets a fresh path and a
        # seq every reader's rescan cursor is guaranteed to be below.
        seq = state["next_seq"]
        state["next_seq"] = seq + 1
        path = f"{self._base_path(bucket, prefix)}/{seq}.seg"
        self._write_sys(bucket, path, self._pack_entries(entries))
        # Seed the LRU so the caller's rescan serves these entries
        # from memory instead of re-reading + decompressing what we
        # hold right now — and so a persist that failed on every drive
        # (ENOSPC) still makes forward progress in-process instead of
        # looping through the lost-segment path.
        with self._mu:
            self._seg_cache = (path, list(entries))
        state["segs"].append([entries[-1].name, seq])
        state["last"] = entries[-1].name
        self._persist_index(bucket, prefix, state)

    def _persist_index(self, bucket, prefix, state) -> None:
        path = f"{self._base_path(bucket, prefix)}/index"
        self._write_sys(bucket, path, msgpackx.packb(state))

    def _load_segment(self, bucket, prefix, seq) -> list | None:
        path = f"{self._base_path(bucket, prefix)}/{seq}.seg"
        with self._mu:
            if self._seg_cache and self._seg_cache[0] == path:
                return self._seg_cache[1]
        payload = self._read_sys(path)
        if payload is None:
            return None
        try:
            entries = self._unpack_entries(bucket, payload)
        except Exception:  # noqa: BLE001 — corrupt cache = miss
            return None
        with self._mu:
            self._seg_cache = (path, entries)
        return entries

    def _state_for(self, bucket: str, prefix: str, gen: int) -> dict:
        key = (bucket, prefix, gen)
        with self._mu:
            st = self._idx.get(key)
        if st is not None and time.time() - st["at"] <= CACHE_TTL:
            return st
        # A restart (or another caller's cache): adopt the persisted
        # index when fresh.
        raw = self._read_sys(f"{self._base_path(bucket, prefix)}/index")
        st = None
        if raw is not None:
            try:
                cand = msgpackx.unpackb(raw)
                if time.time() - cand.get("at", 0) <= CACHE_TTL:
                    st = cand
            except Exception:  # noqa: BLE001
                st = None
        if st is None:
            st = {"at": time.time(), "segs": [], "done": False,
                  "last": "", "next_seq": 0}
        st.setdefault("next_seq",
                      max((s[1] for s in st["segs"]), default=-1) + 1)
        with self._mu:
            self._idx[key] = st
        return st

    # -- public API ----------------------------------------------------------

    def list(self, bucket: str, prefix: str = "", marker: str = "",
             max_keys: int = 10000) -> list:
        """One page of the cached, quorum-merged listing.

        Serves from persisted segments where the marker lands in
        already-walked territory; otherwise extends the walk from
        exactly where it stopped, persisting new segments as they
        fill. Never materializes more than (page + one segment)."""
        from itertools import islice
        gen = self._generation(bucket)
        state = self._state_for(bucket, prefix, gen)
        with self._mu:
            lock = self._idx.setdefault(
                (bucket, prefix, gen, "extend-lock"), threading.Lock())
        out: list = []
        seen_seq = -1
        while True:
            # serve any segments not yet scanned, in order
            for last, seq in list(state["segs"]):
                if seq <= seen_seq:
                    continue
                if len(out) >= max_keys:
                    break
                seen_seq = seq
                if last <= marker:
                    continue
                seg = self._load_segment(bucket, prefix, seq)
                if seg is None:
                    # lost segment (drive churn): drop it and every
                    # later one, resume the live walk from the last
                    # intact segment (the replacement re-persists
                    # under a fresh, higher seq — see _persist_segment)
                    with lock:
                        state["segs"] = [s for s in state["segs"]
                                         if s[1] < seq]
                        state["last"] = (state["segs"][-1][0]
                                         if state["segs"] else "")
                        state["done"] = False
                    break
                out.extend(fi for fi in seg if fi.name > marker)
            if len(out) >= max_keys or state["done"]:
                return out[:max_keys]
            # extend the walk by one segment (serialized; a racing
            # caller's extension shows up as new segments on rescan)
            with lock:
                if state["done"] or (state["segs"]
                                     and state["segs"][-1][1] > seen_seq):
                    continue                      # rescan new segments
                info: dict = {}
                stream = self._stream(bucket, prefix,
                                      after=state["last"], info=info)
                pending = list(islice(stream, SEG_ENTRIES))
                if info["failed"]:
                    # Degraded walk: serve the FULL requested page
                    # live (keep draining the same stream up to
                    # max_keys) but cache NOTHING — a truncated
                    # listing must not persist as authoritative (nor
                    # mark the cache done).
                    for fi in pending:
                        if fi.name > marker:
                            out.append(fi)
                    # A mid-drain all-drives failure PROPAGATES: a
                    # short page reads as "listing complete" to every
                    # pagination client (IsTruncated=false) — silent
                    # truncation loses data downstream, a 5xx does not.
                    for fi in stream:
                        if fi.name > marker:
                            out.append(fi)
                        if len(out) > max_keys:
                            break
                    return out[:max_keys]
                if len(pending) < SEG_ENTRIES:
                    state["done"] = True
                if pending:
                    self._persist_segment(bucket, prefix, state,
                                          pending)
                else:
                    self._persist_index(bucket, prefix, state)
