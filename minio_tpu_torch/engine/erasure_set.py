"""One erasure set on the GPU: quorum CRUD over a stripe of N local drives.

Counterpart of minio_tpu/engine/erasure_set.py, cut to the object API a
server stands on: buckets (`make_bucket`, `delete_bucket`, listing),
`put_object`, `get_object` and its streaming form `get_object_iter`
(whole and ranged, healthy and degraded, single- and multi-part),
`head_object`, `update_object_metadata`,
`delete_object` (a version, or a delete marker when versioned), and the
listings (`list_objects` through engine/metacache.py, `list_object_names`,
`list_object_versions`); engine/heal.py, engine/multipart.py and
engine/sets.py build on it.  The on-disk state is
the JAX package's, byte for byte, so either package reads what the other
wrote.

- A PUT cuts the body into 1 MiB blocks and encodes up to BATCH_BLOCKS
  of them per device batch (ops/fused.encode_and_hash): parity and the
  bitrot digest of every shard-block in one pass over one device copy of
  the data.  The ragged tail block is one more batch, at its own shard
  size.  Batch i is dispatched before batch i-1 is framed and written.
  The host only frames [digest | shard] onto the drives and publishes
  with rename_data.  Objects <= 128 KiB are framed inline into each
  drive's xl.meta.
- A GET reads the k data shards of each segment and verifies their
  digests on the device: the healthy path does no GF(2^8) work, since
  the data shards of a systematic code are the plaintext.  A missing
  drive, a failed read or a digest mismatch drops that row and reads a
  parity spare; the missing data rows are then rebuilt in the same
  device call that verifies the survivors (ops/fused.verify_and_transform).
- Every device batch goes through the cross-request coalescer
  (ops/coalesce.py, MTPU_COALESCE): an encode under ("enc", k, m, algo,
  S), a healthy verify under ("digest", algo, S) (on the CPU only while
  the lane is hot, as the reference does off the device), a degraded
  verify + rebuild under ("vt", k, m, sources, targets, algo, S).
  Concurrent requests' items pack into one launch; a failed handle is
  recomputed by the direct call.  MTPU_COALESCE=0 is the direct oracle.
- A fully verified healthy read fills the device shard cache
  (ops/devcache.py, MTPU_DEVCACHE) with its rows, the generation taken
  before the shard reads; a later read of a resident range is served
  from the verified copy with no shard read and no copy to the card.
  Every mutation (`_mark_dirty`) invalidates the bucket's entries.
- The digest is each part's recorded bitrot algorithm
  (`fi.erasure.bitrot_algo(part)`): mxh256, or HighwayHash256S as MinIO
  writes it, both on the device; sha256 (written) and blake2b512 (read)
  have no device program and take ops/fused.py's host route, hashlib,
  while their encode, rebuild and heal stay on the device.  New objects
  take MTPU_BITROT_ALGO.
- Legacy objects, an `xl.json` per drive (storage/xlmeta_v1.py, the
  format-v1 layout of older MinIO servers): unframed shard files with
  one whole-file digest per drive, 10 MiB blocks.  They are read whole
  (`_read_v1_object`): each drive's shard is trusted only when its own
  xl.json's digest verifies (HighwayHash on the device,
  storage/bitrot_io.verify_whole_file), and missing data rows are
  rebuilt on the device from k trusted shards.  They never enter the
  hot tier or a sendfile plan, and `list_object_versions` lists them.

The host side of a PUT: the ETag's MD5 runs off the request thread
(utils/streams.PipelinedMD5, streams piece by piece on a process-wide
pool of 4), a
streamed body arrives through the pooled ingest ring and each drive's
staged shards land by one vectored write (`write_file_batches`) while
zero-copy is on (MTPU_ZEROCOPY; =0 is the copying oracle).  Drives may
be health-wrapped (storage/health_wrap.py): a breaker-offline drive
counts as offline for the parity upgrade (recorded as
`x-mtpu-internal-erasure-upgraded`) and is skipped by the read fan-out;
writes still go to it, and a write that missed drives but met quorum is
queued for MRF heal (`self.mrf`, background/mrf.py).  The GET path
elects metadata through a FileInfo cache (a HEAD writes through it, so
HEAD + GET elect once), prefetches one segment in `get_object` as in
`get_object_iter`, and hedges its shard reads (MTPU_HEDGE,
MTPU_HEDGE_MS; =0 waits for every shard): stragglers past an adaptive
delay (the set's DynamicTimeout) are covered by parity spares, whose
rows are then rebuilt on the device.  `stats()` counts elections and
hedges.

The GET side of the serving spine: with a hot tier attached
(`hot_tier`, engine/hotcache.py, MTPU_HOTCACHE) a GET is served from the
pool-shared RAM tier when its entry is fresh, and a cold GET of a
cacheable object (streaming layout, 1 B to MTPU_HOTCACHE_MAX_OBJ) runs
single-flight: one leader reads the whole object and fills the tier
when every segment verified its k data shards in one round on the
device, its followers slice the leader's result.  A hit launches
nothing.  `get_object_iter` serves a hit as a view of the tier's shared
arena while zero-copy is on.  With a tier attached, the FileInfo cache
is stamped with the tier's shared generation as well as this set's, so
a write through another worker process invalidates it at once.
`sendfile_plan` plans a whole healthy GET of a k=1 object as verified
file runs that the server sends with os.sendfile (ops/zerocopy.py): the
shard's frames are verified on the device through the fd the sends use.

The device is explicit: `device=None` is the CUDA card
`set_index % n_devices()`, `device="cpu"` runs the plain versions on the
host, and without CUDA the constructor raises.

PUT, DELETE and a metadata update hold the object's namespace write
lock (cluster/nslock.py), as multipart completion and heal do.  Every
mutation calls `_mark_dirty`, which bumps the bucket's metacache
generation, so no listing is served from a cache taken before it.

The metadata plane (ops/metalanes.py, MTPU_METABATCH; =0 is the
single-op oracle): once concurrent inline PUTs are in flight, each
drive's publishes go through its write lane, where three or more queued
share one journal fsync and one drive sync (`_put_inline_lanes`);
concurrent metadata reads go through the read
lanes, and while reads are hot an election first reads the K+1 drives
that hold the key's shards 0..K (`_read_version_fanout`, MTPU_META_TRIM)
and stands on them only when they agree on an inline version at quorum.
The positions it did not read are listed in the election's
`Metas.unread`, and nothing takes them for missing drives.

Left out (it has a byte-identical off switch in the JAX package, so
the bytes do not depend on it): the multi-device mesh codec.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import queue as _queuemod
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..cluster.dynamic_timeout import DynamicTimeout
from ..cluster.nslock import NSLockMap
from ..observe import span as ospan
from ..observe.metrics import DATA_PATH
from ..ops import coalesce, devcache, devices, fused, metalanes
from ..ops import zerocopy as zc
from ..parallel import pipeline
from ..storage import bitrot_io, xlmeta_v1
from ..storage.drive import SMALL_FILE_THRESHOLD, SYS_VOL, TMP_DIR, LocalDrive
from ..storage.errors import (ErrBucketExists, ErrBucketNotFound,
                              ErrDiskNotFound, ErrErasureReadQuorum,
                              ErrErasureWriteQuorum, ErrFileCorrupt,
                              ErrFileNotFound, ErrFileVersionNotFound,
                              ErrObjectNotFound, ErrVersionNotFound,
                              ErrVolumeExists, ErrVolumeNotFound,
                              StorageError)
from ..storage.health_wrap import drive_available
from ..storage.xlmeta import (ErasureInfo, FileInfo, ObjectPartInfo, XLMeta,
                              new_uuid, normalize_version_id)
from ..utils import streams
from . import quorum as Q
from .metacache import Metacache

BLOCK_SIZE = 1 << 20          # blockSizeV2, cmd/object-api-common.go:40
BATCH_BLOCKS = 32             # 1 MiB blocks per device call (32 MiB data)
#: A one-core host gains nothing from fanning work out to threads (the
#: JAX package's ErasureSet._SERIAL_FANOUT); heal runs one object at a
#: time there.
SERIAL_FANOUT = (os.cpu_count() or 2) == 1
#: Seconds a positive bucket-existence answer serves the PUT pre-check.
_BUCKET_CACHE_TTL = 2.0
#: Rows a coalesced batch is padded to a multiple of.  The reference pads
#: to BATCH_BLOCKS to bound its jit shapes; the port's kernels take any
#: batch, so padding would only add work (ROADMAP Queue C).
PAD_ROWS = 1


_STATS_MU = threading.Lock()
_STATS = {"meta_read_requests": 0, "hedged_reads": 0, "hedge_fired": 0,
          "hedge_spares": 0, "hedge_wins": 0}


def stats() -> dict:
    """The engine's counters over every set of the process: metadata
    elections (`_read_metadata` calls) and hedged shard gathers, with
    the timer firings, the spares they launched and the spares that
    won.  The metrics registry (observe/metrics.py) renders them as its
    mtpu_meta_read_requests_total, mtpu_hedged_reads_total and
    mtpu_hedge_* families."""
    with _STATS_MU:
        return dict(_STATS)


def _count(**kw) -> None:
    with _STATS_MU:
        for key, n in kw.items():
            _STATS[key] += n


def _hedge_enabled() -> bool:
    """Hedged shard reads (MTPU_HEDGE, default on): when a stripe
    read's stragglers outlive an adaptive delay, parity spares are read
    and the first k distinct shards to answer win.  MTPU_HEDGE=0 is the
    wait-for-your-shard oracle (read per call)."""
    return os.environ.get("MTPU_HEDGE", "1") != "0"


def _hedge_fixed_ms() -> float | None:
    """MTPU_HEDGE_MS pins the hedge delay; unset, the set's
    DynamicTimeout adapts it from observed reads."""
    v = os.environ.get("MTPU_HEDGE_MS", "")
    try:
        return float(v) if v else None
    except ValueError:
        return None


def _now_ns() -> int:
    return time.time_ns()


class Metas(list):
    """An election's metadata by drive position.  `unread` holds the
    positions a trimmed read did not read: a None there is neither a
    missing drive nor a missing metadata copy."""

    unread: frozenset = frozenset()


class ErasureSet:
    """Object CRUD on one stripe of `n` drives (an entry may be None when
    a drive is offline)."""

    def __init__(self, drives: list[LocalDrive | None],
                 default_parity: int | None = None, set_index: int = 0,
                 device=None, nslock: NSLockMap | None = None):
        self.drives = list(drives)
        self.n = len(self.drives)
        if self.n < 2:
            raise ValueError("an erasure set needs >= 2 drives")
        self.default_parity = (self.n // 2 if default_parity is None
                               else default_parity)
        self.set_index = set_index
        self.device = devices.resolve(device, set_index)
        self.pool = ThreadPoolExecutor(max_workers=max(self.n, 4))
        # Read-ahead and write stages of heal's pipeline; never the
        # drive fan-out pool, which those stages submit to.
        self._iter_pool = ThreadPoolExecutor(max_workers=8)
        # Object mutations hold the object's write lock (cf. NSLock at
        # cmd/erasure-object.go:930); one process, so in-process locks.
        self.nslock = NSLockMap() if nslock is None else nslock
        self._bucket_cache: dict[str, float] = {}
        # An MRF queue (background/mrf.py) takes the objects a write
        # left short of full width; None until the boot attaches one.
        self.mrf = None
        # The data scanner's dirty-bucket tracker (background/usage.py),
        # which ServerPools wires into every set of every pool.
        self._dirty_tracker = None
        # Parsed-quorum FileInfo cache of the GET path: (bucket
        # generation, stamp, fi, metas) per (bucket, object, version);
        # every mutation bumps the bucket's generation (_mark_dirty)
        # and a short TTL bounds what another process's write leaves
        # stale.
        self._fi_cache: dict[tuple, tuple] = {}
        self._fi_gen: dict[str, int] = {}
        # Hedged reads: the hedge delay adapts like a lock deadline, and
        # per-position read EWMAs tell a one-core host when fanning out
        # is worth the thread hops (a known-slow drive).
        self._hedge_dyn = DynamicTimeout(0.05, 0.002, 2.0)
        self._read_ewma_ms = [0.0] * self.n
        self.metacache = Metacache(self)
        # Device shard cache identity: a fresh token per instance, so a
        # reopened set never sees what an earlier one filled.
        self._devcache_owner = devcache.next_owner()
        # The hot-object tier (engine/hotcache.attach_sets), None until
        # the boot attaches one.
        self.hot_tier = None
        # The parity the K+1 read trim assumes (_read_version_fanout):
        # the set's default, or the parity the server writes its
        # STANDARD storage class with (server/handlers.py sets it).
        self.trim_parity = self.default_parity

    #: FileInfo cache: the TTL of the bucket-existence cache; the size
    #: cap only matters for pathological key churn.
    _FI_CACHE_TTL = 2.0
    _FI_CACHE_MAX = 512

    def _mark_dirty(self, bucket: str) -> None:
        """A mutation of `bucket`: its cached FileInfos, listings and
        shard batches are stale.  Recorded with the cache off too, so
        turning it on again cannot bring back entries from before the
        write.  The dirty tracker, where one is wired, marks the bucket
        for the scanner's next cycle."""
        if self._dirty_tracker is not None:
            self._dirty_tracker.mark(bucket)
        self._fi_gen[bucket] = self._fi_gen.get(bucket, 0) + 1
        self.metacache.bump(bucket)
        if self.hot_tier is not None:
            self.hot_tier.note_mutation(bucket)
        devcache.get().note_mutation(self._devcache_owner, bucket)

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        self._iter_pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fan-out ---------------------------------------------------------------

    def _map_positions(self, fn, positions=None) -> list:
        """fn(pos, drive) on every drive position in parallel; returns
        (result, error) per position.  An offline drive is
        ErrDiskNotFound."""
        positions = range(self.n) if positions is None else positions

        def call(pos):
            d = self.drives[pos]
            if d is None:
                return None, ErrDiskNotFound("offline")
            try:
                return fn(pos, d), None
            except Exception as e:  # noqa: BLE001 — quorum classifies
                return None, e

        # wrap_ctx: per-drive spans born in pool threads still attach to
        # the traced request (a no-op when untraced).
        return list(self.pool.map(ospan.wrap_ctx(call), positions))

    def _map_drives(self, fn) -> list:
        """fn(drive) on every drive in parallel; (result, error) per
        position."""
        return self._map_positions(lambda pos, d: fn(d))

    def _live_quorum(self) -> int:
        return max(1, sum(1 for d in self.drives if d is not None) // 2)

    # -- buckets ---------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        errs = [e for _, e in self._map_positions(
            lambda pos, d: d.make_volume(bucket))]
        if errs and all(isinstance(e, ErrVolumeExists) for e in errs):
            raise ErrBucketExists(bucket)
        # Partial existence is the heal case: treat as success.
        errs = [None if isinstance(e, ErrVolumeExists) else e for e in errs]
        err = Q.reduce_write_quorum_errs(errs, self.n // 2 + 1)
        if err is not None:
            raise err

    def list_buckets(self) -> list[str]:
        """Buckets that at least a live quorum of drives holds."""
        counts: dict[str, int] = {}
        for vols, e in self._map_drives(lambda d: d.list_volumes()):
            if e is None:
                for v in vols:
                    counts[v] = counts.get(v, 0) + 1
        quorum = self._live_quorum()
        return sorted(v for v, c in counts.items() if c >= quorum)

    def bucket_exists(self, bucket: str, cached: bool = False) -> bool:
        """Whether a live quorum of drives holds the bucket.  `cached`
        serves the PUT pre-check from a recent positive answer (the
        write itself still fails on a drive without the volume); other
        callers always stat."""
        now = time.monotonic()
        if cached:
            hit = self._bucket_cache.get(bucket)
            if hit is not None and now - hit < _BUCKET_CACHE_TTL:
                return True
        res = self._map_positions(lambda pos, d: d.stat_volume(bucket))
        exists = sum(1 for _, e in res if e is None) >= self._live_quorum()
        if exists:
            self._bucket_cache[bucket] = now
        else:
            self._bucket_cache.pop(bucket, None)
        return exists

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        """Remove the bucket from every drive: an empty one, or with
        `force` whatever it holds (cf. DeleteBucket,
        cmd/erasure-bucket.go)."""
        self._bucket_cache.pop(bucket, None)
        errs = [e for _, e in self._map_drives(
            lambda d: d.delete_volume(bucket, force=force))]
        if errs and all(isinstance(e, ErrVolumeNotFound) for e in errs):
            raise ErrBucketNotFound(bucket)
        errs = [None if isinstance(e, ErrVolumeNotFound) else e for e in errs]
        err = Q.reduce_write_quorum_errs(errs, self.n // 2 + 1)
        if err is not None:
            raise err
        self._mark_dirty(bucket)

    # -- put -------------------------------------------------------------------

    def clamp_parity(self, parity: int | None) -> int:
        if parity is None:
            return self.default_parity
        return max(0, min(int(parity), self.n // 2))

    def put_object(self, bucket: str, obj: str, data, *,
                   metadata: dict | None = None, versioned: bool = False,
                   parity: int | None = None, version_id: str | None = None,
                   mod_time_ns: int | None = None) -> FileInfo:
        """Erasure-code and store one object (single part).

        `data` is bytes or a reader (.read(n)); a reader streams in
        O(BATCH_BLOCKS x BLOCK_SIZE) memory.  `version_id`/`mod_time_ns`
        override the generated identity (and a preserved timestamp never
        replaces a newer version).
        """
        with ospan.span("engine.bucket_check"):
            if not self.bucket_exists(bucket, cached=True):
                raise ErrBucketNotFound(bucket)
        with self.nslock.write_locked(bucket, obj):
            fi = self._put_object_locked(
                bucket, obj, data, metadata=metadata, versioned=versioned,
                parity=parity, version_id=version_id,
                mod_time_ns=mod_time_ns)
        self._mark_dirty(bucket)
        return fi

    def _put_object_locked(self, bucket, obj, data, *, metadata, versioned,
                           parity, version_id, mod_time_ns) -> FileInfo:
        parity = self.clamp_parity(parity)
        # Offline drives become parity, so the write keeps full
        # reconstruction capability (cf. erasure-object.go:766-800).
        # Breaker-offline drives count too: their writes fail fast, so
        # the stripe needs the same extra parity as a physical hole.
        offline = sum(1 for d in self.drives if not drive_available(d))
        upgraded = bool(offline) and parity < self.n // 2
        if upgraded:
            parity = min(parity + offline, self.n // 2)
        k = self.n - parity
        write_quorum = k + (1 if k == parity else 0)

        stream = None
        if streams.is_reader(data):
            # Peek enough to decide inline vs streaming.
            stream, head = data, bytearray()
            while len(head) <= SMALL_FILE_THRESHOLD:
                piece = stream.read(SMALL_FILE_THRESHOLD + 1 - len(head))
                if not piece:
                    break
                head += piece
            data = bytes(head)
            if len(data) <= SMALL_FILE_THRESHOLD:
                stream = None

        distribution = Q.hash_order(f"{bucket}/{obj}", self.n)
        meta = dict(metadata or {})
        # A bytes body's ETag digest runs on the MD5 workers while the
        # body is encoded and written (streams.PipelinedMD5); a stream
        # feeds them chunk by chunk in stage_stream.
        md5 = None
        if stream is None and "etag" not in meta:
            md5 = streams.PipelinedMD5()
            md5.feed(data)
        elif stream is not None:
            md5 = streams.PipelinedMD5()
        if upgraded:
            meta["x-mtpu-internal-erasure-upgraded"] = f"{offline}-offline"
        if version_id is None:
            version_id = new_uuid() if versioned else ""
        mod_time = (mod_time_ns if mod_time_ns is not None
                    else _now_ns())
        try:
            return self._put_body(bucket, obj, data, stream, md5, meta, k,
                                  parity, write_quorum, distribution,
                                  version_id, mod_time, mod_time_ns)
        finally:
            if md5 is not None:
                md5.close()

    def _put_body(self, bucket, obj, data, stream, md5, meta, k, parity,
                  write_quorum, distribution, version_id, mod_time,
                  mod_time_ns) -> FileInfo:
        if mod_time_ns is not None:
            try:
                cur = self._read_metadata(bucket, obj, version_id)[0]
                if cur.mod_time_ns >= mod_time:
                    return cur
            except StorageError:
                pass

        algo = bitrot_io.write_algo()
        checksums = [{"part": 1, "algo": algo, "hash": b""}]
        size = {"n": len(data)}        # a stream's is counted as it goes

        def fi_for(pos: int, data_dir: str, inline: bytes | None):
            ec = ErasureInfo(data_blocks=k, parity_blocks=parity,
                             block_size=BLOCK_SIZE,
                             index=distribution[pos],
                             distribution=distribution, checksums=checksums)
            n = size["n"]
            return FileInfo(volume=bucket, name=obj, version_id=version_id,
                            data_dir=data_dir, mod_time_ns=mod_time,
                            size=n, metadata=meta,
                            parts=[ObjectPartInfo(1, n, n)], erasure=ec,
                            inline_data=inline)

        if stream is None and len(data) <= SMALL_FILE_THRESHOLD:
            shards = [bytearray() for _ in range(self.n)]
            with ospan.span("engine.encode"):
                for framed in self._encode_chunks(
                        streams.batched_chunks(data, None,
                                               BATCH_BLOCKS * BLOCK_SIZE),
                        k, parity, algo):
                    for i, f in enumerate(framed):
                        shards[i] += memoryview(f)
            if md5 is not None:
                with ospan.span("engine.etag"):
                    meta.setdefault("etag", md5.hexdigest())
            per_drive = Q.unshuffle_to_drives([bytes(s) for s in shards],
                                              distribution)
            return self._put_inline(bucket, obj, fi_for, per_drive,
                                    write_quorum, version_id)

        data_dir = new_uuid()
        tmp_dir = f"{TMP_DIR}/put-{uuid.uuid4().hex}"
        part = f"{tmp_dir}/part.1"
        failed = [d is None for d in self.drives]
        errs = None
        try:
            size["n"] = self.stage_stream(
                data, stream, md5 if stream is not None else None, k, parity,
                algo, distribution, part, failed, write_quorum)
            if md5 is not None:
                with ospan.span("engine.etag"):
                    meta.setdefault("etag", md5.hexdigest())
            with ospan.span("engine.publish"):
                res = self._map_positions(
                    lambda pos, d: self._publish(
                        pos, d, failed, tmp_dir,
                        fi_for(pos, data_dir, None), bucket, obj))
            errs = [e for _, e in res]
            err = Q.reduce_write_quorum_errs(errs, write_quorum)
            if err is not None:
                self._undo_publish(bucket, obj, version_id, errs)
                raise err
        finally:
            # Publish renamed the winners' staging away: only a failed
            # drive (or every drive, when the PUT failed before its
            # publish) may still hold its own.
            todo = (None if errs is None else
                    [pos for pos in range(self.n)
                     if failed[pos] or errs[pos] is not None])
            if todo is None or todo:
                self._map_positions(lambda pos, d: self._rm_tmp(d, tmp_dir),
                                    todo)
        fi = fi_for(0, data_dir, None)
        if self.mrf is not None and (any(failed) or any(errs)):
            self.mrf.enqueue(bucket, obj, fi.version_id)
        return fi

    def _put_inline(self, bucket, obj, fi_for, per_drive, write_quorum,
                    version_id) -> FileInfo:
        """Publish a small object: each drive's framed shard lives in
        its xl.meta.  A lone request takes the single-op fan-out (one
        fsynced write_metadata per drive); once the in-flight count or a
        busy lane shows concurrency (or MTPU_METABATCH_SOLO), each
        publish goes through its drive's write lane, whose batch-mates
        (three or more) share one journal fsync and one drive sync."""
        mb = None
        use_lanes = False
        if metalanes.enabled():
            mb = metalanes.get()
            mb.note_put(1)
            use_lanes = mb.put_hot() or metalanes.solo_forced()
        try:
            with ospan.span("engine.write"):
                if use_lanes:
                    res = self._put_inline_lanes(bucket, obj, fi_for,
                                                 per_drive, mb)
                else:
                    res = self._map_positions(
                        lambda pos, d: d.write_metadata(
                            bucket, obj, fi_for(pos, "", per_drive[pos])))
        finally:
            if mb is not None:
                mb.note_put(-1)
        errs = [e for _, e in res]
        err = Q.reduce_write_quorum_errs(errs, write_quorum)
        if err is not None:
            self._undo_publish(bucket, obj, version_id, errs)
            raise err
        fi = fi_for(0, "", None)
        if self.mrf is not None and any(errs):
            # Partial success: MRF heals the stripe back to full width
            # (cf. the enqueue at cmd/erasure-object.go:1403).
            self.mrf.enqueue(bucket, obj, fi.version_id)
        return fi

    def _put_inline_lanes(self, bucket, obj, fi_for, per_drive, mb) -> list:
        """One xl.meta publish per position through its drive's write
        lane; the handles collected into `_map_positions`' (result,
        error) shape.  The lanes own their dispatchers, so this never
        waits on the set's fan-out pool."""
        handles: list = []
        for pos, d in enumerate(self.drives):
            if d is None:
                handles.append(ErrDiskNotFound("offline"))
                continue
            try:
                handles.append(mb.submit_write(
                    d, bucket, obj, fi_for(pos, "", per_drive[pos])))
            except Exception as e:  # noqa: BLE001 — quorum classifies
                handles.append(e)
        return [_handle_result(h) for h in handles]

    def stage_stream(self, head, stream, md5, k: int, m: int, algo: str,
                     distribution: list[int], path: str, failed: list[bool],
                     write_quorum: int, on_batch=None) -> int:
        """Encode a body (`head`, then the rest of `stream` when it is a
        reader) batch by batch on the device and append each drive's
        framed shards to `path` in its system volume; returns the body's
        length.  `md5` (a streams.PipelinedMD5, or None when the caller
        fed the body itself) takes every chunk: its worker digests
        chunk i while chunk i is encoded and written.  A drive whose
        append fails is marked in `failed`; fewer than `write_quorum`
        left raises ErrErasureWriteQuorum.

        With zero-copy on (ops/zerocopy.py) each drive's append is
        `write_file_batches` (one open + pwritev): a bytes body of at
        most one batch is encoded whole and staged in one call per
        drive, a stream in one call per batch.  MTPU_ZEROCOPY=0, or a
        drive without the call, keeps the append_file loop.

        Tracing: the encode and the writes run under engine.encode and
        engine.stage (a body of one batch) or engine.write (a batch of a
        longer one) spans; with `on_batch(nbytes, encode_s, write_s)`
        (multipart's parts) each batch's measured times go to it
        instead."""
        total = 0

        def chunks():
            nonlocal total
            for chunk, is_last in streams.batched_chunks(
                    head, stream, BATCH_BLOCKS * BLOCK_SIZE):
                if md5 is not None:
                    md5.update(chunk)
                total += len(chunk)
                yield chunk, is_last

        vectored = zc.zerocopy_enabled()

        def write_all(batches: list) -> None:
            todo = [p for p in range(self.n) if not failed[p]]

            def stage(pos, d):
                wfb = (getattr(d, "write_file_batches", None)
                       if vectored else None)
                if wfb is not None:
                    wfb(SYS_VOL, path, [b[pos] for b in batches])
                    return
                for b in batches:
                    d.append_file(SYS_VOL, path, b[pos])

            for pos, (_, e) in zip(todo, self._map_positions(stage, todo)):
                if e is not None:
                    failed[pos] = True
            if failed.count(False) < write_quorum:
                raise ErrErasureWriteQuorum(
                    f"{failed.count(False)} < {write_quorum}")

        encoded = (Q.unshuffle_to_drives(framed, distribution)
                   for framed in self._encode_chunks(chunks(), k, m, algo))
        def write(batches: list) -> None:
            if vectored:
                write_all(batches)
            else:
                for per_drive in batches:
                    write_all([per_drive])

        whole = stream is None and len(head) <= BATCH_BLOCKS * BLOCK_SIZE
        if on_batch is not None:
            seen = 0
            it = iter(encoded)
            while True:
                t0 = time.perf_counter()
                got = list(it) if whole else [next(it, None)]
                if not got or got[-1] is None:
                    break
                t1 = time.perf_counter()
                write(got)
                on_batch(total - seen, t1 - t0, time.perf_counter() - t1)
                seen = total
            return total
        if whole:
            # One encode dispatch covers the body: encode, then stage
            # every drive's shards in one fan-out (a stage span, as the
            # JAX package's one-dispatch fast path has).
            with ospan.span("engine.encode"):
                batches = list(encoded)
            with ospan.span("engine.stage"):
                write(batches)
        else:
            for per_drive in ospan.timed_iter(encoded, "engine.encode"):
                with ospan.span("engine.write"):
                    write_all([per_drive])
        return total

    @staticmethod
    def _publish(pos, d, failed, tmp_dir, fi, bucket, obj) -> None:
        if failed[pos]:
            raise ErrDiskNotFound("staging failed")
        d.rename_data(SYS_VOL, tmp_dir, fi, bucket, obj)

    @staticmethod
    def _rm_tmp(d, tmp_dir) -> None:
        try:
            d.delete(SYS_VOL, tmp_dir, recursive=True)
        except ErrFileNotFound:
            pass

    def _undo_publish(self, bucket, obj, version_id, errs) -> None:
        """Roll back drives that published when the write missed quorum,
        so a rejected PUT never becomes readable."""
        def undo(pos, d):
            if errs[pos] is None:
                d.delete_version(bucket, obj, version_id)
        self._map_positions(undo)

    def _direct_encode(self, blocks: np.ndarray, k: int, m: int, algo: str):
        """The encode of one (nb, K, S) batch without the coalescer:
        (parity, digests) as tensors on the device.  Also the recompute of
        a failed coalesced handle: this request's bytes on this request's
        launches."""
        return fused.encode_and_hash(blocks, k, m, algo=algo,
                                     device=self.device)

    def _encode_chunks(self, chunks, k: int, m: int, algo: str):
        """Yield lists of k+m framed shard pieces (shard order), one per
        device batch, for an iterator of (chunk, is_last) pairs, every
        chunk a multiple of BLOCK_SIZE but the last.  Full blocks go in
        batches of up to BATCH_BLOCKS, the ragged tail block in one more
        at its own shard size.  Batch i is dispatched before batch i-1 is
        framed and yielded, so the caller's writes of i-1 overlap the
        device's work on i.  A chunk may be a view of a recycled buffer
        (the pooled ingest ring): it stays valid for the next pull, and
        the last chunk's batch is resolved before the iterator ends.

        With the coalescer on, each batch is submitted under ("enc", k,
        m, algo, S), where concurrent requests' batches pack into one
        launch; a handle that fails is recomputed by `_direct_encode`."""
        co = coalesce.get() if coalesce.enabled() else None
        shard_size = -(-BLOCK_SIZE // k)

        def dispatch(blocks):
            if co is None:
                return blocks, self._direct_encode(blocks, k, m, algo)
            return blocks, co.submit(
                ("enc", k, m, algo, blocks.shape[2]), blocks,
                enc_kernel(k, m, algo, self.device), weight=blocks.shape[0],
                device=self.device)

        def frame(p):
            blocks, h = p
            if isinstance(h, coalesce.Handle):
                try:
                    parity, digests = h.result()
                    h.release()
                except Exception:  # noqa: BLE001 — direct recompute
                    coalesce.record_co_fallback()
                    parity, digests = self._direct_encode(blocks, k, m,
                                                          algo)
            else:
                parity, digests = h
            return bitrot_io.frame_shard_views(blocks, _host(parity),
                                               _host(digests), algo)

        pending = None
        for chunk, is_last in chunks:
            buf = np.frombuffer(chunk, dtype=np.uint8)
            n_full = buf.size // BLOCK_SIZE
            tail = buf[n_full * BLOCK_SIZE:]
            if tail.size and not is_last:
                raise ValueError("non-final chunk not BLOCK_SIZE aligned")
            batches = []
            for start in range(0, n_full, BATCH_BLOCKS):
                nb = min(BATCH_BLOCKS, n_full - start)
                blocks = buf[start * BLOCK_SIZE:(start + nb) * BLOCK_SIZE]
                if BLOCK_SIZE % k:
                    # Each block zero-pads to k*shard_size (split padding
                    # rule, cf. erasure-coding.go:81).
                    padded = np.zeros((nb, k * shard_size), dtype=np.uint8)
                    padded[:, :BLOCK_SIZE] = blocks.reshape(nb, BLOCK_SIZE)
                    blocks = padded
                batches.append(blocks.reshape(nb, k, shard_size))
            if tail.size:
                tail_shard = -(-tail.size // k)
                block = np.zeros(k * tail_shard, dtype=np.uint8)
                block[:tail.size] = tail
                batches.append(block.reshape(1, k, tail_shard))
            for blocks in batches:
                nxt = dispatch(blocks)
                if pending is not None:
                    yield frame(pending)
                pending = nxt
            if is_last and pending is not None:
                # The last chunk's buffer goes back to the ingest ring
                # when `chunks` ends: resolve its batch, which reads it,
                # before pulling again (as the reference does at
                # is_last).
                yield frame(pending)
                pending = None
        if pending is not None:
            yield frame(pending)

    # -- get -------------------------------------------------------------------

    def get_object(self, bucket: str, obj: str, offset: int = 0,
                   length: int = -1, version_id: str = ""
                   ) -> tuple[FileInfo, bytes]:
        """Read [offset, offset+length) of an object, verifying bitrot on
        the device and rebuilding up to `parity` missing or corrupt
        shards (cf. getObjectWithFileInfo, cmd/erasure-object.go:221).

        With a hot tier attached the read is served from the tier when
        its entry is fresh; a cold read of a cacheable object runs
        single-flight and fills the tier when fully verified."""
        tier = self.hot_tier
        if tier is not None and tier.enabled:
            got = self._get_object_hot(bucket, obj, offset, length,
                                       version_id)
            if got is not None:
                return got
        return self._get_object_direct(bucket, obj, offset, length,
                                       version_id)

    def _get_object_direct(self, bucket: str, obj: str, offset: int = 0,
                           length: int = -1, version_id: str = "",
                           report: dict | None = None
                           ) -> tuple[FileInfo, bytes]:
        """The engine read, without the tier.  `report` collects what
        decides a tier fill: "segs", the segments read; "fast", those
        whose k data shards verified in one round (or came from the
        device shard cache); "taint", any degraded read or rebuild.  A
        fill needs fast == segs and no taint."""
        fi, metas, offset, length = self._plan_read(bucket, obj, offset,
                                                    length, version_id)
        if length == 0:
            return fi, b""
        if fi.inline_data is not None or (fi.parts and not fi.data_dir):
            return fi, self._read_inline(fi, metas, offset, length)
        if xlmeta_v1.is_v1(fi):
            return fi, self._read_v1_object(bucket, obj, fi)[
                offset:offset + length]
        # The zeroed destination is real time at tens of MiB (page
        # faults): priced as its own stage.
        with ospan.span("engine.alloc"):
            out = bytearray(length)
        mv = memoryview(out)
        segs = self._plan_segments(fi, offset, length)
        offs = [0]
        for _, _, ln in segs[:-1]:
            offs.append(offs[-1] + ln)
        if report is not None:
            report["segs"] = len(segs)
            if self._degraded(metas):
                report["taint"] = True

        def read_seg(i):
            pn, off, ln = segs[i]
            with ospan.span("engine.read_part"):
                mv[offs[i]:offs[i] + ln] = self._read_part(
                    bucket, obj, fi, pn, off, ln, report)

        # Segment i+1's reads and device call run while segment i is
        # copied into place, under get_object_iter's gate.
        for _ in pipeline.prefetch_map(read_seg, range(len(segs)),
                                       self._prefetch_pool(metas), depth=1):
            pass
        return fi, out

    # -- hot tier --------------------------------------------------------------

    @staticmethod
    def _hot_range(fi, body, offset: int, length: int):
        """Slice a cached or leader's whole body with _plan_read's range
        checks, so a hit raises the errors a direct read would."""
        size = fi.size
        if offset < 0 or offset > size:
            raise StorageError(f"offset {offset} outside object of size "
                               f"{size}")
        if length < 0:
            length = size - offset
        if offset + length > size:
            raise StorageError(f"range [{offset}, {offset + length}) "
                               f"outside object of size {size}")
        if offset == 0 and length == len(body):
            return body
        return body[offset:offset + length]

    def _hot_cacheable(self, fi) -> bool:
        """Only streaming-layout objects within the size gate enter the
        tier: an inline object is one cheap metadata read already, a
        zero-byte one has no payload, and a legacy (xl.json) one is read
        whole on its own path."""
        if fi.deleted or fi.size <= 0 or fi.size > self.hot_tier.max_obj:
            return False
        if fi.inline_data is not None or (fi.parts and not fi.data_dir):
            return False
        return not xlmeta_v1.is_v1(fi)

    def _get_object_hot(self, bucket: str, obj: str, offset: int,
                        length: int, version_id: str,
                        skip_lookup: bool = False):
        """A GET through the tier: a hit, else a single-flight engine
        read with a verified fill.  Returns (fi, body), or None, which
        tells the caller to read directly (not cacheable, or the leader
        failed)."""
        tier = self.hot_tier
        if not skip_lookup:
            got = tier.lookup(bucket, obj, version_id)
            if got is not None:
                fi, body = got
                return fi, self._hot_range(fi, body, offset, length)
        key = (id(self), bucket, obj, version_id)
        flight, leader = tier.flights.begin(key)
        if not leader:
            res = flight.wait()
            if res is None:
                return None
            fi, body = res
            return fi, self._hot_range(fi, body, offset, length)
        ok = False
        try:
            # A leader elected after an earlier flight filled the entry
            # (its lookup missed just before that flight ended) serves
            # the fill instead of reading again.
            if tier.lookup_meta(bucket, obj, version_id) is not None:
                got = tier.lookup(bucket, obj, version_id)
                if got is not None:
                    flight.resolve(got)
                    ok = True
                    fi, body = got
                    return fi, self._hot_range(fi, body, offset, length)
            # The generation before the read: a write that lands while
            # it runs bumps it, and the fill is dropped.  The FileInfo
            # cache is stamped with it too (_fi_generation), so the
            # election below is no older than gen0.
            gen0 = tier.generation(bucket)
            fi, _, _, _ = self._plan_read(bucket, obj, 0, -1, version_id)
            if not self._hot_cacheable(fi):
                tier.note_bypass()
                return None
            report: dict = {}
            fi, data = self._get_object_direct(bucket, obj, 0, -1,
                                               version_id, report=report)
            body = bytes(data)
            if report.get("segs") and not report.get("taint") \
                    and report.get("fast", 0) == report["segs"]:
                tier.fill(bucket, obj, version_id, fi, body, gen0)
            else:
                tier.note_bypass()
            flight.resolve((fi, body))
            ok = True
            return fi, self._hot_range(fi, body, offset, length)
        finally:
            if not ok:
                flight.resolve(None)
            tier.flights.end(key)

    def _hot_iter(self, bucket: str, obj: str, offset: int, length: int,
                  version_id: str):
        """get_object_iter's tier branch: (fi, chunks) of a hit or of a
        single-flight read of a cacheable object, else None.  While
        zero-copy is on a hit is one view of the tier's shared arena
        (its pin is released once the view dies)."""
        tier = self.hot_tier
        if zc.zerocopy_enabled():
            got = tier.lookup_view(bucket, obj, version_id)
            if got is not None:
                fi, body = got
                chunk = self._hot_range(fi, body, offset, length)
                zc.record("hot_views", len(chunk))
                return fi, iter((chunk,)) if len(chunk) else iter(())
        else:
            got = tier.lookup(bucket, obj, version_id)
            if got is not None:
                fi, body = got
                chunk = self._hot_range(fi, memoryview(body), offset,
                                        length)
                return fi, iter((chunk,)) if len(chunk) else iter(())
        # A cold cacheable object: the single-flight whole read (the
        # miss was counted above).  Its memory is bounded by the
        # admission size, MTPU_HOTCACHE_MAX_OBJ.
        try:
            peek, _, _, _ = self._plan_read(bucket, obj, 0, -1, version_id)
        except StorageError:
            return None
        if not self._hot_cacheable(peek):
            tier.note_bypass()
            return None
        got = self._get_object_hot(bucket, obj, offset, length, version_id,
                                   skip_lookup=True)
        if got is None:
            return None
        fi, body = got
        return fi, iter((body,)) if len(body) else iter(())

    def sendfile_plan(self, bucket: str, obj: str, offset: int = 0,
                      length: int = -1, version_id: str = ""):
        """A kernel-send plan of a whole healthy GET, or None.

        In the k=1 layout each part's one data shard is the plaintext
        between bitrot frames, so the body can leave by os.sendfile of
        its data runs without entering the process.  Returns (fi,
        [zerocopy.FilePlan per part]) whose fds' frames were verified on
        the device (heal's frame batches) through the fds the sends
        use, or None when a gate fails and the caller reads normally:
        zero-copy off; not the whole object; not k=1; inline; legacy
        (xl.json: unframed shards); a drive or
        a metadata copy missing; the data shard's drive not a healthy
        local one; the object cacheable while the hot tier is on (the
        tier owns the small hot set); or a shard file's size or frames
        that fail the verify.  A key the tier holds is declined before
        the election, so a hit never pays for one."""
        if not zc.zerocopy_enabled():
            return None
        tier = self.hot_tier
        if tier is not None and tier.enabled \
                and tier.holds(bucket, obj, version_id):
            return None
        try:
            fi, metas, offset, length = self._plan_read(
                bucket, obj, offset, length, version_id)
        except StorageError:
            return None          # the normal read raises the real error
        if offset != 0 or length != fi.size or fi.size <= 0:
            return None
        if fi.erasure.data_blocks != 1:
            return None
        if fi.inline_data is not None or not fi.parts or not fi.data_dir:
            return None
        if xlmeta_v1.is_v1(fi):
            return None
        if tier is not None and tier.enabled and self._hot_cacheable(fi):
            return None
        if self._degraded(metas):
            return None
        order = Q.shuffle_by_distribution(list(range(self.n)),
                                          fi.erasure.distribution)
        d = self.drives[order[0]]
        if not isinstance(d, LocalDrive) or not drive_available(d):
            return None
        from .heal import _verify_frames
        ec = fi.erasure
        plans: list[zc.FilePlan] = []
        try:
            for part in fi.parts:
                algo = ec.bitrot_algo(part.number)
                hs = bitrot_io.digest_size(algo)
                frame = hs + ec.shard_size
                fd = d.open_read_fd(
                    bucket, f"{obj}/{fi.data_dir}/part.{part.number}")
                # The plan owns the fd from here (closed on any bail).
                full, tail = divmod(part.size, ec.shard_size)
                runs = [(b * frame + hs, ec.shard_size) for b in range(full)]
                if tail:
                    runs.append((full * frame + hs, tail))
                plans.append(zc.FilePlan(fd, runs, part.size))
                want = bitrot_io.bitrot_shard_file_size(
                    part.size, ec.shard_size, algo)
                if os.fstat(fd).st_size != want:
                    raise ErrFileCorrupt("sendfile plan size mismatch")
                # The verify copies every page to the card once: map
                # them in one call (MAP_POPULATE), not one fault a page
                # inside the copy.
                mm = mmap.mmap(fd, want, prot=mmap.PROT_READ,
                               flags=mmap.MAP_SHARED
                               | getattr(mmap, "MAP_POPULATE", 0))
                view = memoryview(mm)
                _verify_frames(self, lambda lo, ln: view[lo:lo + ln],
                               part.size, ec, algo)
        except (StorageError, OSError, ValueError):
            for p in plans:
                p.close()
            return None
        return fi, plans

    def get_object_iter(self, bucket: str, obj: str, offset: int = 0,
                        length: int = -1, version_id: str = ""):
        """Streaming read: (fi, iterator of verified, decoded chunks), each
        at most one device batch (BATCH_BLOCKS blocks), so memory is
        O(batch), never O(object) (the GetObjectReader role,
        cmd/object-api-utils.go:392-528).  The metadata election and the
        range check run before it returns; a read that fails later
        raises from the iterator.

        Segment i+1's drive reads and device call run while segment i
        drains to the caller.  On a one-core host a healthy read from
        local drives has nothing to overlap, so its segments run inline;
        a degraded one still prefetches, its rebuild overlapping the
        next segment's shard reads.

        With a hot tier attached, a hit or a cold read of a cacheable
        object goes through the tier (`_hot_iter`)."""
        tier = self.hot_tier
        if tier is not None and tier.enabled:
            got = self._hot_iter(bucket, obj, offset, length, version_id)
            if got is not None:
                return got
        fi, metas, offset, length = self._plan_read(bucket, obj, offset,
                                                    length, version_id)
        if length == 0:
            return fi, iter(())
        if fi.inline_data is not None or (fi.parts and not fi.data_dir):
            return fi, iter((self._read_inline(fi, metas, offset, length),))
        if xlmeta_v1.is_v1(fi):
            return fi, iter((self._read_v1_object(bucket, obj, fi)[
                offset:offset + length],))
        def read_seg(seg):
            with ospan.span("engine.read_part"):
                return self._read_part(bucket, obj, fi, *seg)

        return fi, pipeline.prefetch_map(
            read_seg, self._plan_segments(fi, offset, length),
            self._prefetch_pool(metas), depth=1)

    def _degraded(self, metas) -> bool:
        """A read with a drive offline or a drive's metadata missing (a
        position a trimmed election did not read is neither)."""
        return (any(d is None for d in self.drives)
                or any(m is None for pos, m in enumerate(metas)
                       if pos not in metas.unread))

    def _prefetch_pool(self, metas):
        """The pool of a read's one-segment prefetch: none for a healthy
        read on a one-core host (nothing to overlap), else _iter_pool."""
        return (None if SERIAL_FANOUT and not self._degraded(metas)
                else self._iter_pool)

    def _plan_read(self, bucket: str, obj: str, offset: int, length: int,
                   version_id: str):
        """A GET's front half: the metadata election and the range
        check; (fi, metas by drive position, offset, resolved length).
        The election goes through the FileInfo cache."""
        fi, metas = self._read_metadata_cached(bucket, obj, version_id)
        if fi.deleted:
            raise ErrObjectNotFound(f"{bucket}/{obj} (delete marker)")
        size = fi.size
        if offset < 0 or offset > size:
            raise StorageError(f"offset {offset} outside object of size "
                               f"{size}")
        if length < 0:
            length = size - offset
        if offset + length > size:
            raise StorageError(f"range [{offset}, {offset + length}) "
                               f"outside object of size {size}")
        return fi, metas, offset, length

    def _plan_segments(self, fi, offset: int, length: int) -> list:
        """Map a byte range onto (part, offset, length) segments that end
        on batch boundaries: one device call per segment (cf.
        ObjectToPartOffset, cmd/erasure-metadata.go)."""
        batch_bytes = BATCH_BLOCKS * BLOCK_SIZE
        segs = []
        part_start, pos, remaining = 0, offset, length
        for part in fi.parts:
            part_end = part_start + part.size
            if remaining <= 0:
                break
            if pos < part_end:
                in_off = pos - part_start
                in_len = min(remaining, part.size - in_off)
                seg, stop = in_off, in_off + in_len
                while seg < stop:
                    seg_end = min(stop, (seg // batch_bytes + 1) * batch_bytes)
                    segs.append((part.number, seg, seg_end - seg))
                    seg = seg_end
                pos += in_len
                remaining -= in_len
            part_start = part_end
        return segs

    def _read_inline(self, fi, metas, offset: int, length: int) -> bytes:
        """Small objects: each drive's framed shard lives in its xl.meta.
        Only drives whose metadata matches the elected version count."""
        want = Q._fi_key(fi)
        by_shard: dict[int, bytes] = {}
        for pos, meta in enumerate(metas):
            if (meta is not None and meta.inline_data is not None
                    and Q._fi_key(meta) == want):
                by_shard[fi.erasure.distribution[pos] - 1] = meta.inline_data

        def fetch(s: int) -> bytes:
            if s not in by_shard:
                raise ErrFileNotFound(f"inline shard {s}")
            return by_shard[s]

        b1 = -(-fi.size // BLOCK_SIZE)
        data = self._read_blocks(fi, fi.size, 0, b1, fetch,
                                 sorted(by_shard))
        return data[offset:offset + length].tobytes()

    def _read_v1_object(self, bucket: str, obj: str, fi) -> bytes:
        """The whole body of a legacy (xl.json) object.

        v1 checksums are per drive: each drive's own xl.json holds the
        whole-file digest of its shard of each part, so every drive's
        document is read once.  A shard is trusted only when its drive's
        digest verifies; one with no readable xl.json, no (or an empty)
        digest, or the wrong length is treated as missing, never served
        unverified.  The shard files of a part all have one length, so
        each part's digests are one device call (one hh256 launch for
        HighwayHash).  The shards are v1's blocks back to back, each
        block's chunk ceil(block / k) bytes with a shorter last block;
        missing data rows are rebuilt on the device from the first k
        trusted shards, one GF call per chunk size."""
        ec = fi.erasure
        k, m, bs = ec.data_blocks, ec.parity_blocks, ec.block_size
        dist = ec.distribution
        own = [sums if e is None else None for sums, e in self._map_drives(
            lambda d: xlmeta_v1.parse_xl_json(
                d.read_all(bucket, f"{obj}/{xlmeta_v1.XL_JSON}"),
                bucket, obj).erasure.checksums)]
        out = bytearray()
        for part in fi.parts:
            name = f"part.{part.number}"
            full, last = divmod(part.size, bs)
            groups = [(bs, full)] if full else []
            if last:
                groups.append((last, 1))
            expect = sum(n * -(-cur // k) for cur, n in groups)

            def read_row(pos, d):
                want = next((c for c in own[pos] or () if c.get("name") == name
                             and c.get("hash")), None)
                if want is None or pos >= len(dist):
                    return None                    # unverifiable shard
                raw = d.read_file(bucket, f"{obj}/{name}")
                return (want, raw) if len(raw) == expect else None

            by_algo: dict[str, list] = {}
            for pos, (got, err) in enumerate(self._map_positions(read_row)):
                if err is None and got is not None:
                    by_algo.setdefault(got[0].get("algo", "highwayhash256"),
                                       []).append((pos, got))
            trusted: dict[int, bytes] = {}
            for algo, rows in by_algo.items():
                digests = bitrot_io.whole_file_digests(
                    [raw for _, (_, raw) in rows], algo, self.device)
                for (pos, (want, raw)), dg in zip(rows, digests):
                    if dg == want["hash"]:
                        trusted[dist[pos] - 1] = raw
            if len(trusted) < k:
                raise ErrErasureReadQuorum(
                    f"{bucket}/{obj} part {part.number} (v1): "
                    f"{len(trusted)}/{k} shards verified")
            sel = tuple(sorted(trusted)[:k])
            missing = tuple(s for s in range(k) if s not in trusted)
            rows_np = [np.frombuffer(trusted[s], dtype=np.uint8) for s in sel]
            off = 0
            for cur, n in groups:
                chunk = -(-cur // k)
                x = np.empty((n, k, chunk), dtype=np.uint8)
                for i, r in enumerate(rows_np):
                    x[:, i] = r[off:off + n * chunk].reshape(n, chunk)
                off += n * chunk
                rebuilt = (_host(fused.transform(x, k, m, sel, missing,
                                                 device=self.device))
                           if missing else None)
                y = _data_rows(x, rebuilt, sel, missing, k)
                out += y.reshape(n, k * chunk)[:, :cur].tobytes()
        return bytes(out)

    def _read_part(self, bucket, obj, fi, part_number: int, offset: int,
                   length: int, report: dict | None = None,
                   cache: bool = True) -> np.ndarray:
        """[offset, offset+length) of one part, reading only the frames
        that cover it; `report` is _get_object_direct's; `cache=False`
        keeps the read out of the device shard cache (a staged part,
        which a re-upload replaces under the same name).  The frames are
        read with read_file, not as an mmap view: they are copied into
        the device batch at once, so a view would save no copy, and its
        page faults would move the disk I/O out of the pooled (timed,
        hedged) fetch into the gather, with a SIGBUS for an EIO."""
        part_size = fi.parts[part_number - 1].size
        frame = (bitrot_io.digest_size(fi.erasure.bitrot_algo(part_number))
                 + fi.erasure.shard_size)
        b0 = offset // BLOCK_SIZE
        b1 = -(-(offset + length) // BLOCK_SIZE)
        order = Q.shuffle_by_distribution(list(range(self.n)),
                                          fi.erasure.distribution)
        path = f"{obj}/{fi.data_dir}/part.{part_number}"

        def fetch(s: int) -> bytes:
            pos = order[s]
            d = self.drives[pos]
            if d is None:
                raise ErrDiskNotFound("offline")
            t0 = time.monotonic()
            raw = d.read_file(bucket, path, b0 * frame, (b1 - b0) * frame)
            # Successful reads feed the hedge's per-position EWMA (a
            # fast failure must not make a drive look fast).
            self._note_read_ms(pos, (time.monotonic() - t0) * 1e3)
            return raw

        k_m = fi.erasure.data_blocks + fi.erasure.parity_blocks
        # Offline drives, holes and breaker-open circuits alike, never
        # yield a shard: a read goes straight to the parity spares.
        online = [s for s in range(k_m)
                  if drive_available(self.drives[order[s]])]
        data = self._read_blocks(fi, part_size, b0, b1, fetch, online,
                                 part_number,
                                 cache=(bucket, obj) if cache else None,
                                 order=order, report=report)
        lo = offset - b0 * BLOCK_SIZE
        return data[lo:lo + length]

    def _read_blocks(self, fi, part_size: int, b0: int, b1: int, fetch,
                     candidates: list[int], part_number: int = 1,
                     cache: tuple[str, str] | None = None,
                     order: list[int] | None = None,
                     report: dict | None = None) -> np.ndarray:
        """Blocks [b0, b1) of a part as one uint8 array (the ragged tail
        trimmed), from the frames `fetch(shard)` returns.

        Data shards are read first and parity shards are spares.  Each
        round verifies the chosen k rows on the device and, in the same
        call, rebuilds the data rows that are not among them; a row
        that fails to read, parse or verify is dropped and the next
        spare is read (the parallelReader of cmd/erasure-decode.go:101
        with the verifying ReadAt of cmd/bitrot-streaming.go:142).

        `cache` is (bucket, object) of a part read: a resident range of
        the device shard cache is served from its verified rows, and a
        read whose first round verified the k data shards fills it.

        `order` (shard -> drive position) marks a read of drives: its
        rounds are hedged (MTPU_HEDGE, `_hedged_fetch`), so a straggling
        shard is covered by a parity spare and rebuilt.

        `report` (a tier fill's evidence) counts the read as "fast" when
        it verified its k data shards in its first round or came from
        the device shard cache, as the reference's verify-only fast path
        does (which also needs BLOCK_SIZE % k == 0); else as "taint"."""
        ec = fi.erasure
        k, m, shard_size = ec.data_blocks, ec.parity_blocks, ec.shard_size
        algo = ec.bitrot_algo(part_number)
        hs = bitrot_io.digest_size(algo)
        n_full = part_size // BLOCK_SIZE
        tail_len = part_size % BLOCK_SIZE
        tail_shard = -(-tail_len // k) if tail_len else 0
        has_tail = b1 > n_full
        nb = min(b1, n_full) - b0
        expect = nb * (hs + shard_size) + (hs + tail_shard if has_tail else 0)

        # Only a read with every data shard's drive online takes the
        # cache, as the reference's fast path does.
        dcache = (devcache.get() if cache is not None and devcache.enabled()
                  and all(s in candidates for s in range(k)) else None)
        if dcache is not None:
            # The generation before any shard read: a write that races
            # this read rejects its fill.
            gen0 = dcache.current_gen(self._devcache_owner, cache[0])
            found = dcache.lookup_range(self._devcache_owner, *cache,
                                        part_number, fi.data_dir, algo,
                                        b0, b1)
            if found is not None:
                e, boff = found
                if not has_tail or e.tail is not None:
                    _report(report, BLOCK_SIZE % k == 0)
                    return _assemble(e.host[boff:boff + nb] if nb else None,
                                     e.tail if has_tail else None, tail_len)

        def read_row(s: int):
            buf = np.frombuffer(fetch(s), dtype=np.uint8)
            if buf.size != expect:
                raise ErrFileCorrupt(f"shard segment {buf.size} != {expect}")
            hashes, blocks = bitrot_io.split_frames(buf, nb, shard_size, algo)
            tail = buf[nb * (hs + shard_size):]
            return hashes, blocks, tail[:hs], tail[hs:]

        co = coalesce.get() if coalesce.enabled() else None
        if co is not None:
            co.note_read(1, self.device)
        # Stage timing, as the JAX package's two read paths have it: a
        # read whose k data shards all read and verify in the first
        # round (`fast`) records engine.read / engine.verify /
        # engine.assemble; any other round runs under engine.read and
        # engine.verify_decode spans.
        fast = healthy = all(s in candidates for s in range(k))
        t0 = time.monotonic()
        read_s = verify_s = 0.0
        try:
            rows: dict[int, tuple] = {}
            tried: set[int] = set()
            rounds = attempts = 0
            while True:
                want = [s for s in candidates if s not in tried
                        and s not in rows][:max(k - len(rows), 0)]
                if len(rows) < k and not want:
                    raise ErrErasureReadQuorum(
                        f"only {len(rows)}/{k} shards readable")
                timed = fast and attempts == 0
                attempts += 1
                tr = time.monotonic()
                with (contextlib.nullcontext() if timed
                      else ospan.span("engine.read")):
                    if order is not None and self._use_hedge(
                            [order[s] for s in want], candidates, k):
                        spares = [s for s in candidates if s not in tried
                                  and s not in rows and s not in want]
                        for s in self._hedged_fetch(read_row, order, rows,
                                                    tried, want, spares, k):
                            tried.discard(s)  # abandoned: may be retried
                    else:
                        tried.update(want)
                        for s, (row, err) in zip(want, self.pool.map(
                                ospan.wrap_ctx(_attempt(read_row)), want)):
                            if err is None:
                                rows[s] = row
                read_s += time.monotonic() - tr
                if len(rows) < k:
                    fast = False
                    continue
                rounds += 1
                sel = tuple(sorted(rows)[:k])
                missing = tuple(s for s in range(k) if s not in sel)
                fast = fast and not missing
                x = out = xt = out_t = None
                tv = time.monotonic()
                bad: set[int] = set()
                with (contextlib.nullcontext() if fast
                      else ospan.span("engine.verify_decode")):
                    if nb:
                        x = np.empty((nb, k, shard_size), dtype=np.uint8)
                        for i, s in enumerate(sel):
                            x[:, i, :] = rows[s][1]
                        verified = self._verify_rows(x, k, m, sel, missing,
                                                     algo, co)
                    if has_tail:
                        xt = np.stack([rows[s][3] for s in sel])[None]
                        verified_t = self._verify_rows(xt, k, m, sel,
                                                       missing, algo, co)
                    if nb:
                        digests, out = verified()
                        bad.update(s for i, s in enumerate(sel)
                                   if not np.array_equal(digests[:, i],
                                                         rows[s][0]))
                    if has_tail:
                        digests, out_t = verified_t()
                        bad.update(s for i, s in enumerate(sel)
                                   if not np.array_equal(digests[0, i],
                                                         rows[s][2]))
                verify_s += time.monotonic() - tv
                if not bad:
                    break
                fast = False
                for s in bad:
                    del rows[s]
        finally:
            if co is not None:
                co.note_read(-1, self.device)

        _report(report, rounds == 1 and not missing and BLOCK_SIZE % k == 0)
        if dcache is not None and rounds == 1 and not missing:
            # A healthy read, verified on its first round.  Filled before
            # the assembly: the cache makes the rows read-only, so the
            # views handed out below are too.
            dcache.fill((self._devcache_owner, *cache, part_number,
                         fi.data_dir, b0, b1, algo), gen0,
                        x if nb else np.empty((0, k, shard_size),
                                              dtype=np.uint8),
                        tail=xt, device=self.device)
        ta = time.monotonic()
        data = _assemble(_data_rows(x, out, sel, missing, k) if nb else None,
                         _data_rows(xt, out_t, sel, missing, k)
                         if has_tail else None, tail_len)
        done = time.monotonic()
        if healthy and not fast:
            DATA_PATH.record_fastpath_fallback()
        if fast:
            DATA_PATH.record_healthy_read(data.size, read_s, verify_s,
                                          done - ta)
            ospan.record("engine.read", read_s)
            ospan.record("engine.verify", verify_s)
        else:
            DATA_PATH.record_degraded_read(data.size, done - t0)
        ospan.record("engine.assemble", done - ta)
        return data

    # -- hedged shard reads ----------------------------------------------------

    def _note_read_ms(self, pos: int, ms: float) -> None:
        cur = self._read_ewma_ms[pos]
        self._read_ewma_ms[pos] = ms if cur == 0.0 else 0.25 * ms + 0.75 * cur

    def _hedge_delay_s(self) -> float:
        fixed = _hedge_fixed_ms()
        if fixed is not None:
            return fixed / 1e3
        return self._hedge_dyn.timeout()

    def _hedge_worthwhile(self, positions: list[int]) -> bool:
        """One-core host ignition: fanning k reads across threads costs
        real milliseconds there, so hedge only when the per-position
        EWMAs show a straggler, one position markedly slower than the
        fastest known (or > 5 ms absolute)."""
        known = [self._read_ewma_ms[p] for p in positions
                 if self._read_ewma_ms[p] > 0.0]
        if not known:
            return False
        return max(known) > max(5.0, 4.0 * min(known))

    def _use_hedge(self, positions: list[int], candidates: list[int],
                   k: int) -> bool:
        """Whether a read round at drive `positions` is hedged: the gate
        on, and a host with cores to fan out on, or a degraded read (a
        data shard not among the candidates), or EWMAs that show a
        straggler (the JAX set's rule)."""
        if not _hedge_enabled() or not positions:
            return False
        degraded = any(s not in candidates for s in range(k))
        return (not SERIAL_FANOUT or degraded
                or self._hedge_worthwhile(positions))

    def _hedged_fetch(self, read_row, order, rows, tried, want, spares,
                      k: int) -> set[int]:
        """First-k-wins gather.  Launch `want` shard reads at once; if
        stragglers outlive the adaptive hedge delay, launch parity
        `spares` to cover them; a FAILED read promotes a spare at once
        (no timer).  Fills `rows` until k distinct shards answered (or
        everything failed) and returns the shards still in flight:
        abandoned losers whose results are ignored, which the caller
        un-`tried`s so a later round may read them again."""
        q: _queuemod.Queue = _queuemod.Queue()
        inflight: set[int] = set()

        def launch(s):
            tried.add(s)
            inflight.add(s)

            def run():
                try:
                    q.put((s, read_row(s), None))
                except BaseException as e:  # noqa: BLE001 — marshalled
                    q.put((s, None, e))
            self.pool.submit(ospan.wrap_ctx(run))

        for s in want:
            launch(s)
        spares = list(spares)
        t0 = time.monotonic()
        deadline = t0 + self._hedge_delay_s()
        fired = False
        hedged: set[int] = set()
        n_spares = wins = 0
        while len(rows) < k and inflight:
            if not fired and spares:
                left = deadline - time.monotonic()
                if left <= 0:
                    # Timer: cover every straggler with a spare at once.
                    for _ in range(min(len(spares), k - len(rows))):
                        s = spares.pop(0)
                        hedged.add(s)
                        launch(s)
                        n_spares += 1
                    fired = True
                    self._hedge_dyn.log_timeout()
                    continue
                try:
                    item = q.get(timeout=left)
                except _queuemod.Empty:
                    continue
            else:
                # Every launched read puts exactly one item: blocking
                # cannot hang while reads are in flight.
                item = q.get()
            s, r, err = item
            inflight.discard(s)
            if err is None:
                rows[s] = r
                if s in hedged:
                    wins += 1
            elif spares:
                launch(spares.pop(0))
                n_spares += 1
        if not fired:
            self._hedge_dyn.log_success(time.monotonic() - t0)
        _count(hedged_reads=1, hedge_fired=int(fired), hedge_spares=n_spares,
               hedge_wins=wins)
        return inflight

    def _verify_rows(self, x: np.ndarray, k: int, m: int, sel: tuple,
                     missing: tuple, algo: str, co):
        """Start the device verify of `x` ((B, k, S) rows in `sel` order),
        rebuilding the `missing` data rows; returns a function that waits
        for (digests (B, k, 32), rebuilt (B, T, S) or None) on the host.

        A rebuild goes through the coalescer under ("vt", ...), a plain
        verify under ("digest", algo, S) on a card, and on the CPU while
        the lane is hot (the reference's `use_co` rule); otherwise, or
        when a handle fails, it is the direct call.  A host-route
        algorithm's plain verify is hashlib's on the host: its rows never
        go to the device."""
        b, _, s = x.shape
        h = None
        if co is not None and missing:
            h = co.submit(("vt", k, m, sel, missing, algo, s), x,
                          vt_kernel(k, m, sel, missing, algo, self.device),
                          weight=b, device=self.device)
        elif co is not None and not fused.is_host_algo(algo) and (
                self.device.type == "cuda" or co.hot(self.device)):
            h = co.submit(("digest", algo, s), x.reshape(b * k, s),
                          coalesce.make_digest_kernel(algo, self.device),
                          weight=b, device=self.device)

        def direct():
            digests, out = fused.verify_and_transform(
                x, k, m, sel, missing, algo=algo, device=self.device)
            return _host(digests), _host(out)

        if h is None:
            launched = direct()
            return lambda: launched

        def wait():
            try:
                res = h.result()
                h.release()
            except Exception:  # noqa: BLE001 — direct recompute
                coalesce.record_co_fallback()
                return direct()
            return res if missing else (res.reshape(b, k, 32), None)

        return wait

    # -- metadata --------------------------------------------------------------

    def _read_metadata(self, bucket: str, obj: str, version_id: str = ""):
        """Read the drives' xl.meta (every drive's, or the K+1 of a
        trimmed read) and elect the version a read quorum agrees on.
        Returns (fi, Metas by drive position)."""
        version_id = normalize_version_id(version_id)
        _count(meta_read_requests=1)
        mb = metalanes.get() if metalanes.enabled() else None
        with mb.reading() if mb is not None else \
                contextlib.nullcontext(), ospan.span("engine.quorum"):
            res = self._read_version_fanout(bucket, obj, version_id, mb)
        metas = Metas(fi for fi, _ in res)
        errs = [e for _, e in res]
        unread = frozenset(pos for pos, (fi, e) in enumerate(res)
                           if fi is None and e is None)
        if unread:
            metas.unread = unread
        if not any(m is not None for m in metas):
            err, _ = Q.reduce_errs(errs, ignored=(ErrDiskNotFound,))
            if isinstance(err, (ErrFileNotFound, ErrVolumeNotFound)):
                if not self.bucket_exists(bucket):
                    raise ErrBucketNotFound(bucket)
                raise ErrObjectNotFound(f"{bucket}/{obj}")
            if isinstance(err, ErrFileVersionNotFound):
                raise ErrVersionNotFound(f"{bucket}/{obj}@{version_id}")
            raise ErrErasureReadQuorum(f"{bucket}/{obj}: {err}")
        read_quorum, _ = Q.object_quorum_from_meta(metas, self.n,
                                                   self.default_parity)
        return Q.find_file_info_in_quorum(metas, read_quorum), metas

    def _read_positions(self, bucket, obj, version_id, positions,
                        mb) -> list:
        """read_version on the drives at `positions`: one (FileInfo |
        None, error | None) per position, in order.  While metadata reads
        are hot the reads go through the drives' read lanes (distinct
        keys' reads then share one read_version_many round per drive);
        otherwise the single-op fan-out."""
        if mb is not None and mb.read_hot():
            handles = []
            for pos in positions:
                d = self.drives[pos]
                if d is None:
                    handles.append(ErrDiskNotFound("offline"))
                    continue
                try:
                    handles.append(mb.submit_read(d, bucket, obj,
                                                  version_id))
                except Exception as e:  # noqa: BLE001 — quorum classifies
                    handles.append(e)
            return [_handle_result(h) for h in handles]
        res = self._map_positions(
            lambda pos, d: d.read_version(bucket, obj, version_id),
            positions)
        metalanes.record_read_round(len(positions), len(positions))
        return res

    def _read_version_fanout(self, bucket, obj, version_id, mb) -> list:
        """The election's reads with the K+1 trim: while reads are hot,
        read first the K+1 drives that hold the key's shards 0..K (its
        data shards and one parity shard, where every PUT of the key
        placed them); stand on them only when `_trim_acceptable`, else
        read the remaining drives too, so every drive is read once and
        the election and its errors equal the all-N read's.  Unread
        positions are padded (None, None), which no drive's outcome is
        (a failure carries its error).

        The JAX package trims to positions 0..K instead; on a healthy
        inline read those miss a data shard nearly always, and its host
        codec rebuilds it.  Here a rebuild would be a device launch, so
        the trim reads where the data shards are, and a trimmed election
        costs the healthy read no device work the all-N one does not.

        An idle plane (one reader) takes the full fan-out: the trim's
        checks cost more than one page-cached read saves there.

        K is the data shards at `trim_parity`: the set's default parity
        as in the JAX package, or in a server the parity of its STANDARD
        storage class (EC:4 on 12 drives, while the set's default stays
        N/2: K+1 drives at the default would never hold such an
        object's read quorum)."""
        k1 = (self.n - self.trim_parity) + 1
        everyone = list(range(self.n))
        if (not metalanes.trim_enabled() or k1 >= self.n
                or mb is None or not mb.read_hot()):
            return self._read_positions(bucket, obj, version_id, everyone,
                                        mb)
        dist = Q.hash_order(f"{bucket}/{obj}", self.n)
        first = [pos for pos in everyone if dist[pos] <= k1]
        res1 = self._read_positions(bucket, obj, version_id, first, mb)
        full: list = [(None, None)] * self.n
        for pos, r in zip(first, res1):
            full[pos] = r
        if self._trim_acceptable(res1):
            metalanes.record_trim(True)
            return full
        metalanes.record_trim(False)
        rest = [pos for pos in everyone if dist[pos] > k1]
        for pos, r in zip(rest, self._read_positions(
                bucket, obj, version_id, rest, mb)):
            full[pos] = r
        return full

    def _trim_acceptable(self, res) -> bool:
        """A trimmed round stands only when more drives could not change
        it: every read succeeded, all agree on one version (a lone
        dissenter might be the majority among the unread), the agreeing
        count meets the object's own read quorum, and the version has no
        shard files (inline or a delete marker), so no later step needs
        every drive's metadata."""
        metas = [fi for fi, _ in res]
        if any(e is not None for _, e in res) or \
                any(m is None for m in metas):
            return False
        if len({Q._fi_key(m) for m in metas}) != 1:
            return False
        read_quorum, _ = Q.object_quorum_from_meta(metas, self.n,
                                                   self.default_parity)
        if len(metas) < read_quorum:
            return False
        fi = metas[0]
        return (fi.deleted or fi.inline_data is not None
                or bool(fi.parts and not fi.data_dir))

    def _fi_cache_store(self, bucket, obj, version_id, gen,
                        entry) -> None:
        """Store an election in the LRU under `gen`, the bucket's
        generation read before the election began: a write that
        published while it ran has bumped the generation since, so the
        entry is stale on its first lookup.  Dict order is recency
        order: a hit re-inserts; pop first so a re-stored key moves to
        the MRU end."""
        cache = self._fi_cache
        key = (bucket, obj, normalize_version_id(version_id))
        cache.pop(key, None)
        while len(cache) >= self._FI_CACHE_MAX:
            try:
                cache.pop(next(iter(cache)))
            except (StopIteration, KeyError, RuntimeError):
                break  # racing eviction: capacity is advisory
        cache[key] = (gen, time.monotonic(), *entry)

    def _read_metadata_cached(self, bucket, obj, version_id=""):
        """The GET path's election through the parsed-quorum cache: a
        HEAD followed by a GET of one request, or the segments of one
        read, elect xl.meta once.  Any write through this set bumps the
        bucket's generation (_mark_dirty), which invalidates at once; a
        short TTL bounds what another process's write leaves stale."""
        key = (bucket, obj, normalize_version_id(version_id))
        hit = self._fi_cache.pop(key, None)
        if hit is not None:
            gen, stamp, fi, metas = hit
            if (gen == self._fi_generation(bucket)
                    and time.monotonic() - stamp < self._FI_CACHE_TTL):
                self._fi_cache[key] = hit
                return fi, metas
        gen = self._fi_generation(bucket)
        entry = self._read_metadata(bucket, obj, version_id)
        self._fi_cache_store(bucket, obj, version_id, gen, entry)
        return entry

    def _fi_generation(self, bucket: str) -> tuple[int, int]:
        """The generation a FileInfo-cache entry of `bucket` is stamped
        with: this set's own, and with a hot tier attached the tier's
        shared one, which a write through another worker process bumps
        too.  A tier's leader thus never elects through an entry older
        than the generation it fills under."""
        tier = self.hot_tier
        return (self._fi_gen.get(bucket, 0),
                tier.generation(bucket) if tier is not None else 0)

    def head_object(self, bucket: str, obj: str,
                    version_id: str = "") -> FileInfo:
        # A fresh hot-tier entry proves its version is current (every
        # mutation bumps the bucket's shared generation): no election.
        tier = self.hot_tier
        if tier is not None and tier.enabled:
            hfi = tier.lookup_meta(bucket, obj, version_id)
            if hfi is not None:
                return hfi
        # HEAD always elects (a peer's write is visible at once) but
        # writes through the FileInfo cache, so the GET that follows in
        # the same request does not elect again.
        gen = self._fi_generation(bucket)
        entry = self._read_metadata(bucket, obj, version_id)
        self._fi_cache_store(bucket, obj, version_id, gen, entry)
        fi = entry[0]
        if fi.deleted and not version_id:
            raise ErrObjectNotFound(f"{bucket}/{obj} (delete marker)")
        return fi

    def update_object_metadata(self, bucket: str, obj: str,
                               fi: FileInfo) -> None:
        """Set `fi.metadata` on every drive's own copy of the version
        (cf. updateObjectMetadata, cmd/erasure-object.go:1513).  Each
        drive's xl.meta holds that drive's erasure index and, for a small
        object, its own inline shard, so each drive's version is read,
        given the new metadata and written back.  Under the object's
        write lock, as a PUT: a stamp in one worker of the pool that
        overlapped another worker's PUT of a new version would write back
        an xl.meta without it."""
        def upd(d):
            own = d.read_version(bucket, obj, fi.version_id)
            own.metadata = dict(fi.metadata)
            d.update_metadata(bucket, obj, own)
        with self.nslock.write_locked(bucket, obj):
            res = self._map_drives(upd)
        # The write quorum of every other mutation: an update on a
        # minority would lose the read election.
        if sum(1 for _, e in res if e is None) < self.n // 2 + 1:
            errs = [e for _, e in res if e is not None]
            raise errs[0] if errs else ErrObjectNotFound(f"{bucket}/{obj}")
        self._mark_dirty(bucket)

    def delete_object(self, bucket: str, obj: str, version_id: str = "",
                      versioned: bool = False) -> FileInfo | None:
        """Delete one version ("" = the null version), or, when
        `versioned` and no version is named, write a delete marker and
        return it (cf. DeleteObject, cmd/erasure-object.go:1038)."""
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        with self.nslock.write_locked(bucket, obj):
            return self._delete_object_locked(bucket, obj, version_id,
                                              versioned)

    def _delete_object_locked(self, bucket, obj, version_id,
                              versioned) -> FileInfo | None:
        write_quorum = self.n // 2 + 1
        if versioned and version_id == "":
            dm = FileInfo(volume=bucket, name=obj, version_id=new_uuid(),
                          mod_time_ns=_now_ns(), deleted=True)

            def mark(d):
                try:
                    d.delete_version(bucket, obj, mark_delete=True, fi=dm)
                except ErrFileNotFound:
                    # A marker on a name no version holds is legal.
                    d.write_metadata(bucket, obj, dm)

            err = Q.reduce_write_quorum_errs(
                [e for _, e in self._map_drives(mark)], write_quorum)
            if err is not None:
                raise err
            self._mark_dirty(bucket)
            return dm

        vid = normalize_version_id(version_id)
        errs = [e for _, e in self._map_drives(
            lambda d: d.delete_version(bucket, obj, vid))]
        nf = (ErrFileNotFound, ErrFileVersionNotFound)
        if errs and all(isinstance(e, nf) for e in errs):
            if any(isinstance(e, ErrFileVersionNotFound) for e in errs):
                raise ErrVersionNotFound(f"{bucket}/{obj}@{version_id}")
            raise ErrObjectNotFound(f"{bucket}/{obj}")
        # A drive that never had the version counts as success.
        errs = [None if isinstance(e, nf) else e for e in errs]
        err = Q.reduce_write_quorum_errs(errs, write_quorum)
        if err is not None:
            raise err
        self._mark_dirty(bucket)
        return None

    # -- listing ---------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 10000,
                     marker: str = "") -> list[FileInfo]:
        """One page of the quorum-merged listing of the latest live
        versions, through the metacache (cf.
        cmd/metacache-server-pool.go:59)."""
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        return self.metacache.list(bucket, prefix, marker, max_keys)

    def list_object_names(self, bucket: str,
                          prefix: str = "") -> list[str]:
        """Every object name with any version on any drive, delete-marked
        ones included (the version listing needs them)."""
        names: set[str] = set()
        for entries, e in self._map_drives(
                lambda d: [n for n, _ in d.walk_dir(bucket, prefix)]):
            if e is None:
                names.update(entries)
        return sorted(names)

    def list_object_versions(self, bucket: str, obj: str) -> list[FileInfo]:
        """The quorum-elected version history, newest first: each version
        must be on enough drives' xl.meta, so a stale drive neither
        serves a stale history nor brings back a deleted version (cf.
        readAllFileInfo + findFileInfoInQuorum,
        cmd/erasure-metadata-utils.go).

        Where no drive holds an xl.meta, a legacy object's xl.json is one
        unversioned entry per drive that has it."""
        lists: list[list[FileInfo]] = []
        for raw, err in self._map_drives(
                lambda d: d.read_all(bucket, f"{obj}/xl.meta")):
            if err is not None or raw is None:
                continue
            try:
                lists.append(XLMeta.from_bytes(raw).list_versions(bucket,
                                                                  obj))
            except StorageError:
                continue
        if not lists:
            for raw, err in self._map_drives(lambda d: d.read_all(
                    bucket, f"{obj}/{xlmeta_v1.XL_JSON}")):
                if err is not None or raw is None:
                    continue
                try:
                    fi = xlmeta_v1.parse_xl_json(raw, bucket, obj)
                except StorageError:
                    continue
                fi.is_latest = True
                lists.append([fi])
        if not lists:
            raise ErrObjectNotFound(f"{bucket}/{obj}")
        counts: dict[tuple, int] = {}
        keep: dict[tuple, FileInfo] = {}
        for lst in lists:
            for fi in lst:
                key = (fi.version_id, fi.mod_time_ns, fi.data_dir,
                       fi.size, fi.deleted, fi.metadata.get("etag", ""))
                counts[key] = counts.get(key, 0) + 1
                keep.setdefault(key, fi)
        # One read quorum for every version: the data blocks of the
        # newest erasure-bearing version that at least half the drives
        # hold (cf. objectQuorumFromMeta, cmd/erasure-metadata.go:389,
        # and getLatestFileInfo, cmd/erasure-healing-common.go:196), so
        # a version readable from k shards stays listable with k copies
        # of its metadata, and one stale drive cannot set the quorum.
        # A history of delete markers only takes a simple majority.
        quorum = self.n // 2 + 1
        trust_floor = max(self.n // 2, 1)
        for key, fi in sorted(keep.items(),
                              key=lambda kv: -kv[1].mod_time_ns):
            if fi.erasure is not None and counts[key] >= trust_floor:
                quorum = fi.erasure.data_blocks
                break
        if len(lists) < quorum:
            raise ErrErasureReadQuorum(
                f"{bucket}/{obj}: {len(lists)}/{self.n} version lists")
        out = [keep[k] for k, c in counts.items() if c >= quorum]
        if not out:
            raise ErrObjectNotFound(f"{bucket}/{obj} (no version in "
                                    "quorum)")
        out.sort(key=lambda fi: (-fi.mod_time_ns, fi.version_id))
        return out


def _report(report: dict | None, fast: bool) -> None:
    """Count one segment of a tier fill's evidence: "fast" (verified on
    the full-k path), else "taint".  Segments of one read may run on two
    threads (the prefetch), so the count is taken under a lock."""
    if report is None:
        return
    with _STATS_MU:
        if fast:
            report["fast"] = report.get("fast", 0) + 1
        else:
            report["taint"] = True


def _handle_result(h) -> tuple:
    """A metadata lane's handle (or the error that kept an item from
    being submitted) as a fan-out's (result, error) pair."""
    if isinstance(h, Exception):
        return None, h
    try:
        return h.result(), None
    except Exception as e:  # noqa: BLE001 — quorum classifies
        return None, e


def _attempt(fn):
    """fn -> a function returning (result, error) instead of raising."""
    def call(arg):
        try:
            return fn(arg), None
        except (StorageError, OSError) as e:
            return None, e
    return call


def _host(t):
    """A device result on the host (numpy); None and numpy pass."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def enc_kernel(k: int, m: int, algo: str, dev):
    """The coalesced encode of stacked (B, K, S) blocks on `dev`:
    (parity, digests) per span, the pair `ErasureSet._direct_encode`
    gives; `launch` is its pipelined form.  The key ("enc", k, m, algo,
    S) names all it closes over but the device, so the pool's device
    owner (ops/ipc_dispatch.py) rebuilds the same kernel from the key."""

    def kernel(stacked, spans, ctx):
        x, n = coalesce.pad_batch(stacked, PAD_ROWS)
        parity, digests = fused.encode_and_hash(
            x, k, m, algo=algo, device=dev, items=len(spans))
        return _enc_slices(parity, digests, n, spans)

    def launch(x, n, spans, ctx):
        parity, digests = fused.encode_and_hash(
            x, k, m, algo=algo, device=dev, items=len(spans))
        return lambda: _enc_slices(parity, digests, n, spans)

    kernel.launch = launch
    kernel.pad_rows = PAD_ROWS
    return kernel


def vt_kernel(k: int, m: int, sources: tuple, targets: tuple, algo: str,
              dev):
    """The coalesced verify (+ rebuild of `targets`) of stacked (B, K, S)
    rows in `sources` order on `dev`: (digests (B, K, 32), rebuilt
    (B, T, S) or None) per span; `launch` is its pipelined form."""

    def kernel(stacked, spans, ctx):
        x, n = coalesce.pad_batch(stacked, PAD_ROWS)
        digests, out = fused.verify_and_transform(
            x, k, m, sources, targets, algo=algo, device=dev,
            items=len(spans))
        return _vt_slices(digests, out, n, spans)

    def launch(x, n, spans, ctx):
        digests, out = fused.verify_and_transform(
            x, k, m, sources, targets, algo=algo, device=dev,
            items=len(spans))
        return lambda: _vt_slices(digests, out, n, spans)

    kernel.launch = launch
    kernel.pad_rows = PAD_ROWS
    return kernel


def _enc_slices(parity, digests, n: int, spans) -> list[tuple]:
    """Per-span (parity, digests) of a coalesced encode's results."""
    parity = _host(parity)[:n]
    digests = _host(digests)[:, :n]
    return [(parity[lo:hi], digests[:, lo:hi]) for lo, hi in spans]


def _vt_slices(digests, out, n: int, spans) -> list[tuple]:
    """Per-span (digests, rebuilt or None) of a coalesced verify."""
    digests = _host(digests)[:n]
    out = _host(out)[:n] if out is not None else None
    return [(digests[lo:hi], out[lo:hi] if out is not None else None)
            for lo, hi in spans]


def _data_rows(x: np.ndarray, out, sel: tuple, missing: tuple,
               k: int) -> np.ndarray:
    """The k data rows in shard order, from the chosen rows `x` (in `sel`
    order) and the rebuilt `missing` rows `out`."""
    if not missing:
        return x                        # sel is range(k): x is the data
    y = np.empty((x.shape[0], k, x.shape[2]), dtype=np.uint8)
    for s in range(k):
        y[:, s] = x[:, sel.index(s)] if s in sel \
            else out[:, missing.index(s)]
    return y


def _assemble(y: np.ndarray | None, yt: np.ndarray | None,
              tail_len: int) -> np.ndarray:
    """The bytes of data rows `y` ((nb, k, S) full blocks) and `yt`
    ((1, k, tail shard) tail block, trimmed to `tail_len`) in order."""
    pieces = []
    if y is not None:
        nb, k, s = y.shape
        flat = y.reshape(nb, k * s)
        pieces.append(flat[:, :BLOCK_SIZE].reshape(-1)
                      if BLOCK_SIZE % k else flat.reshape(-1))
    if yt is not None:
        pieces.append(yt.reshape(-1)[:tail_len])
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
