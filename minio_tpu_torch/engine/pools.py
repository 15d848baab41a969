"""ServerPools: the object layer a server stands on.

Counterpart of minio_tpu/engine/pools.py (erasureServerPools, cf.
cmd/erasure-server-pool.go).  Pools are independent ErasureSets added
for capacity.  A write goes to the pool that already holds the object,
else to the pool with the most free space, ties to the lowest index
(getPoolIdx, :373); reads and deletes probe the pools in order;
listings merge the pools'; a multipart upload id carries its pool.

The pool lifecycle: `add_pool` attaches a formatted pool to a running
deployment (admin pool/add), `set_draining` takes a pool out of
placement for its decommission (background/decom.py).  While a drain
runs, the mover's copy and its source can both hold a version for a
moment and an overwrite lands beside the stale source, so reads of the
latest version go to the pool with the newest copy and a hard delete
removes every copy; an upload id of the drained pool follows its
relocation.

Every set of every pool marks the process's dirty-bucket tracker
(background/usage.DirtyTracker.shared()) on each mutation, so the data
scanner rescans a bucket written since its last cycle.  The JAX boot
wires no tracker: there a scanned bucket is carried forward unchanged
for up to 16 cycles.
"""

from __future__ import annotations

from ..storage.errors import (ErrBucketExists, ErrBucketNotFound,
                              ErrObjectNotFound, ErrVersionNotFound,
                              StorageError)
from ..storage.xlmeta import FileInfo
from .multipart import ErrUploadNotFound
from .sets import ErasureSets


class ServerPools:
    """The object layer over one or more pools.

    The sets carry their device (ErasureSets(device=...)).  Pools whose
    sets run on different kinds of device are refused, so one layer
    never mixes host and card sets."""

    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("need at least one pool")
        first = pools[0].sets[0].device
        for i, p in enumerate(pools):
            for es in p.sets:
                if es.device.type != first.type:
                    raise ValueError(
                        f"pool {i} set {es.set_index} runs on {es.device},"
                        f" not on {first.type} as pool 0 set 0 does")
        self.pools = list(pools)
        self._booted = len(self.pools)
        self.deployment_id = pools[0].deployment_id
        # The hot-object tier the boot attached to every all-local set
        # (engine/hotcache.attach_pools), for the server's metrics.
        self.hot_tier = None
        # Pools out of NEW placement (a decommission's drain): reads and
        # deletes still probe them.
        self.draining: set[int] = set()
        # pool idx -> background.decom.Decommissioner run by this process
        self.decommissions: dict[int, object] = {}
        # A drained pool's pending uploads, staged again elsewhere: old
        # full upload id -> new (background/decom.py's journal).
        self.upload_relocations: dict[str, str] = {}
        # The MRF queues of pools added at run time (server/topology.py).
        self.mrf_queues: list = []
        from ..background.usage import DirtyTracker
        self.dirty_tracker = DirtyTracker.shared()
        for p in self.pools:
            self._wire(p)

    def _wire(self, pool) -> None:
        for es in pool.sets:
            es._dirty_tracker = self.dirty_tracker

    def close(self) -> None:
        """Stop every set's executors, and the drive health wrappers of
        the pools added at run time (the boot closes its own)."""
        for q in self.mrf_queues:
            q.stop()
        for p in self.pools:
            p.close()
        for p in self.pools[self._booted:]:
            for es in p.sets:
                for d in es.drives:
                    if d is not None and hasattr(d, "close"):
                        d.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- placement -------------------------------------------------------------

    def _pool_with_object(self, bucket: str, obj: str,
                          version_id: str = "") -> int | None:
        for i, p in enumerate(self.pools):
            try:
                p.head_object(bucket, obj, version_id)
                return i
            except (ErrObjectNotFound, ErrVersionNotFound,
                    ErrBucketNotFound):
                continue
            # Any other error (a pool below read quorum) propagates: an
            # overwrite placed on another pool would leave a stale
            # duplicate behind.
        return None

    def set_draining(self, idx: int, flag: bool = True) -> None:
        if not 0 <= idx < len(self.pools):
            raise ValueError(f"no pool {idx}")
        if flag:
            if len(self.placement_pools()) <= 1 \
                    and idx not in self.draining:
                raise ValueError(
                    "cannot drain the last placement-eligible pool")
            self.draining.add(idx)
        else:
            self.draining.discard(idx)

    def placement_pools(self) -> list[int]:
        """The pools new writes may land on (the draining ones left out)."""
        out = [i for i in range(len(self.pools)) if i not in self.draining]
        return out or list(range(len(self.pools)))

    def get_pool_idx(self, bucket: str, obj: str) -> int:
        """The pool that holds the object; else the one with the most
        free space, ties to the lowest index, so placement is stable
        across restarts (cf. getPoolIdx, erasure-server-pool.go:373).
        With one candidate there is nothing to decide and nothing is
        probed (a key whose last write reached a minority would otherwise
        fail every overwrite on read quorum).  A draining pool is no
        candidate, and its copy of the object attracts no overwrite (the
        mover owns that copy)."""
        cands = self.placement_pools()
        if len(cands) == 1:
            return cands[0]
        existing = self._pool_with_object(bucket, obj)
        if existing is not None and existing not in self.draining:
            return existing
        frees = {i: self.pools[i].disk_usage()["free"] for i in cands}
        best = max(frees.values())
        return min(i for i in cands if frees[i] == best)

    # -- the pool lifecycle ----------------------------------------------------

    def add_pool(self, es) -> int:
        """Attach a formatted pool to the running deployment (admin
        pool/add).  Its sets must run on the device type the others do.
        Every bucket is made on it before it becomes a placement
        candidate, so a write routed there at once finds its bucket.  It
        joins the hot tier and the dirty tracker; close() stops it."""
        if es.deployment_id != self.deployment_id:
            raise ValueError(f"pool deployment id {es.deployment_id} != "
                             f"{self.deployment_id}")
        first = self.pools[0].sets[0].device
        for s in es.sets:
            if s.device.type != first.type:
                raise ValueError(
                    f"the new pool's set {s.set_index} runs on {s.device},"
                    f" not on {first.type} as pool 0 set 0 does")
        for b in self.list_buckets():
            try:
                es.make_bucket(b)
            except ErrBucketExists:
                pass
        self._wire(es)
        if self.hot_tier is not None:
            from .hotcache import attach_sets
            attach_sets(es, self.hot_tier)
        self.pools.append(es)
        return len(self.pools) - 1

    # -- buckets ---------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        """On every pool, or on none: a hard failure removes the copies
        this call made."""
        created: list[int] = []
        errs = []
        for i, p in enumerate(self.pools):
            try:
                p.make_bucket(bucket)
                created.append(i)
                errs.append(None)
            except ErrBucketExists as e:
                errs.append(e)
            except StorageError:
                for j in created:
                    try:
                        self.pools[j].delete_bucket(bucket)
                    except StorageError:
                        pass
                raise
        if errs and all(isinstance(e, ErrBucketExists) for e in errs):
            raise ErrBucketExists(bucket)

    def bucket_exists(self, bucket: str, cached: bool = False) -> bool:
        return any(p.bucket_exists(bucket, cached=cached)
                   for p in self.pools)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        """From every pool, or from none: a hard failure part way (a
        pool still holding objects) makes the bucket again on the pools
        it was already deleted from."""
        deleted: list[int] = []
        errs = []
        for i, p in enumerate(self.pools):
            try:
                p.delete_bucket(bucket, force=force)
                deleted.append(i)
                errs.append(None)
            except ErrBucketNotFound as e:
                errs.append(e)
            except StorageError:
                for j in deleted:
                    try:
                        self.pools[j].make_bucket(bucket)
                    except StorageError:
                        pass
                raise
        if errs and all(isinstance(e, ErrBucketNotFound) for e in errs):
            raise ErrBucketNotFound(bucket)

    def list_buckets(self) -> list[str]:
        names: set[str] = set()
        for p in self.pools:
            names.update(p.list_buckets())
        return sorted(names)

    # -- objects ---------------------------------------------------------------

    def put_object(self, bucket: str, obj: str, data, **kw) -> FileInfo:
        if not self.bucket_exists(bucket, cached=True):
            raise ErrBucketNotFound(bucket)
        idx = self.get_pool_idx(bucket, obj)
        fi = self.pools[idx].put_object(bucket, obj, data, **kw)
        # Where it landed, for placement checks; never stored.
        fi.pool_idx = idx
        return fi

    def _read_pool_idx(self, bucket: str, obj: str,
                       version_id: str = "") -> int | None:
        """The pool a read of the latest version serves from.  While a
        drain runs, the mover's copy and its source can both hold the
        object, and an overwrite lands beside the stale source: the
        newest mod time wins.  A named version is unique: first hit."""
        if not self.draining or version_id:
            return self._pool_with_object(bucket, obj, version_id)
        best: tuple[int, int] | None = None    # (mod_time_ns, idx)
        for i, p in enumerate(self.pools):
            try:
                fi = p.head_object(bucket, obj, version_id)
            except (ErrObjectNotFound, ErrVersionNotFound,
                    ErrBucketNotFound):
                continue
            if best is None or fi.mod_time_ns > best[0]:
                best = (fi.mod_time_ns, i)
        return None if best is None else best[1]

    def _read_order(self, bucket: str, obj: str, version_id: str) -> list:
        if self.draining and not version_id:
            idx = self._read_pool_idx(bucket, obj)
            return [self.pools[idx]] if idx is not None else []
        return self.pools

    def _first(self, bucket: str, obj: str, call, version_id: str = ""):
        """call(pool) on each pool in order until one holds the object
        (during a drain, on the pool with the newest copy)."""
        last: StorageError | None = None
        for p in self._read_order(bucket, obj, version_id):
            try:
                return call(p)
            except (ErrObjectNotFound, ErrVersionNotFound) as e:
                last = e
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        raise last or ErrObjectNotFound(f"{bucket}/{obj}")

    def get_object(self, bucket: str, obj: str, offset: int = 0,
                   length: int = -1, version_id: str = ""):
        return self._first(bucket, obj, lambda p: p.get_object(
            bucket, obj, offset, length, version_id), version_id)

    def get_object_iter(self, bucket: str, obj: str, offset: int = 0,
                        length: int = -1, version_id: str = ""):
        """Streaming read: (fi, iterator of chunks of at most one device
        batch) from the first pool that holds the object."""
        return self._first(bucket, obj, lambda p: p.get_object_iter(
            bucket, obj, offset, length, version_id), version_id)

    def sendfile_plan(self, bucket: str, obj: str, offset: int = 0,
                      length: int = -1, version_id: str = ""):
        """A kernel-send plan (fi, [FilePlan, ...]) from the first pool
        whose set plans one (ErasureSet.sendfile_plan), else None.  It
        never raises: the normal read is the error's source."""
        try:
            order = self._read_order(bucket, obj, version_id)
        except StorageError:
            return None
        for p in order:
            try:
                got = p.sendfile_plan(bucket, obj, offset, length,
                                      version_id)
            except StorageError:
                return None
            if got is not None:
                return got
        return None

    def head_object(self, bucket: str, obj: str,
                    version_id: str = "") -> FileInfo:
        return self._first(bucket, obj, lambda p: p.head_object(
            bucket, obj, version_id), version_id)

    def delete_object(self, bucket: str, obj: str, version_id: str = "",
                      versioned: bool = False):
        if self.draining and not (versioned and version_id == ""):
            # Mid-drain an object can live on two pools (copied, its
            # source not yet reaped): a hard delete removes every copy,
            # or the survivor would bring the object back.
            hit, res = False, None
            for p in self.pools:
                try:
                    res = p.delete_object(bucket, obj, version_id,
                                          versioned)
                    hit = True
                except (ErrObjectNotFound, ErrVersionNotFound,
                        ErrBucketNotFound):
                    continue
            if hit:
                return res
            if not self.bucket_exists(bucket):
                raise ErrBucketNotFound(bucket)
            raise ErrObjectNotFound(f"{bucket}/{obj}")
        idx = self._pool_with_object(bucket, obj, version_id)
        if idx is None:
            if not self.bucket_exists(bucket):
                raise ErrBucketNotFound(bucket)
            if versioned and version_id == "":
                # A delete marker still lands on the placement pool.
                idx = self.get_pool_idx(bucket, obj)
            else:
                raise ErrObjectNotFound(f"{bucket}/{obj}")
        return self.pools[idx].delete_object(bucket, obj, version_id,
                                             versioned)

    def update_object_metadata(self, bucket: str, obj: str,
                               fi: FileInfo) -> None:
        """Set fi.metadata on the object's version, each drive keeping its
        own inline shard and erasure index (the updateObjectMetadata
        seam, cmd/erasure-object.go:1513)."""
        for p in self.pools:
            try:
                p.update_object_metadata(bucket, obj, fi)
                return
            except StorageError:
                continue
        raise ErrObjectNotFound(f"{bucket}/{obj}")

    # -- listings --------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "",
                     max_keys: int = 10000) -> list[FileInfo]:
        """One page of the pools' merged listing: names after `marker`,
        each at its newest copy."""
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        merged: dict[str, FileInfo] = {}
        for p in self.pools:
            try:
                for fi in p.list_objects(bucket, prefix, marker=marker,
                                         max_keys=max_keys):
                    prev = merged.get(fi.name)
                    if prev is None or fi.mod_time_ns > prev.mod_time_ns:
                        merged[fi.name] = fi
            except ErrBucketNotFound:
                continue
        return [merged[k] for k in sorted(merged)][:max_keys]

    def list_object_names(self, bucket: str,
                          prefix: str = "") -> list[str]:
        names: set[str] = set()
        for p in self.pools:
            for es in p.sets:
                try:
                    names.update(es.list_object_names(bucket, prefix))
                except StorageError:
                    continue
        return sorted(names)

    def list_object_versions(self, bucket: str, obj: str) -> list[FileInfo]:
        """The version history merged across pools (an overwrite during a
        drain splits it between the source and the destination), one
        entry per version id, newest first."""
        merged: dict[str, FileInfo] = {}
        found = False
        for p in self.pools:
            try:
                vers = p.list_object_versions(bucket, obj)
            except StorageError:
                continue
            found = True
            for fi in vers:
                prev = merged.get(fi.version_id)
                if prev is None or fi.mod_time_ns > prev.mod_time_ns:
                    merged[fi.version_id] = fi
        if not found:
            raise ErrObjectNotFound(f"{bucket}/{obj}")
        out = sorted(merged.values(),
                     key=lambda fi: (-fi.mod_time_ns, fi.version_id))
        for i, fi in enumerate(out):
            fi.is_latest = i == 0
        return out

    # -- multipart -------------------------------------------------------------

    def new_multipart_upload(self, bucket: str, obj: str, **kw) -> str:
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        idx = self.get_pool_idx(bucket, obj)
        uid = self.pools[idx].new_multipart_upload(bucket, obj, **kw)
        # Uploads stay on their pool: the id carries it.
        return f"{idx}.{uid}"

    def _split_upload_id(self, upload_id: str) -> tuple[int, str]:
        # A drained pool's pending uploads were staged again elsewhere;
        # the client still holds the old id.
        upload_id = self.upload_relocations.get(upload_id, upload_id)
        idx, _, rest = upload_id.partition(".")
        try:
            idx = int(idx)
        except ValueError:
            raise ErrUploadNotFound(upload_id) from None
        if not 0 <= idx < len(self.pools):
            raise ErrUploadNotFound(upload_id)
        return idx, rest

    def put_object_part(self, bucket: str, obj: str, upload_id: str,
                        part_number: int, data):
        idx, uid = self._split_upload_id(upload_id)
        return self.pools[idx].put_object_part(bucket, obj, uid,
                                               part_number, data)

    def complete_multipart_upload(self, bucket: str, obj: str,
                                  upload_id: str, parts, **kw):
        idx, uid = self._split_upload_id(upload_id)
        return self.pools[idx].complete_multipart_upload(bucket, obj, uid,
                                                         parts, **kw)

    def abort_multipart_upload(self, bucket: str, obj: str,
                               upload_id: str) -> None:
        idx, uid = self._split_upload_id(upload_id)
        self.pools[idx].abort_multipart_upload(bucket, obj, uid)

    def list_parts(self, bucket: str, obj: str, upload_id: str):
        idx, uid = self._split_upload_id(upload_id)
        return self.pools[idx].list_parts(bucket, obj, uid)

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[dict]:
        out = []
        for i, p in enumerate(self.pools):
            for u in p.list_multipart_uploads(bucket, prefix):
                u = dict(u)
                u["upload_id"] = f"{i}.{u['upload_id']}"
                out.append(u)
        return sorted(out, key=lambda u: (u["object"], u["upload_id"]))

    # -- heal ------------------------------------------------------------------

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    **kw):
        idx = self._pool_with_object(bucket, obj)
        if idx is None:
            raise ErrObjectNotFound(f"{bucket}/{obj}")
        return self.pools[idx].heal_object(bucket, obj, version_id, **kw)

    def heal_bucket(self, bucket: str) -> dict:
        out = {}
        for i, p in enumerate(self.pools):
            healed = p.heal_bucket(bucket)
            if healed:
                out[i] = healed
        return out

    # -- capacity --------------------------------------------------------------

    def disk_usage(self) -> dict:
        """Capacity summed over every pool."""
        total = free = 0
        for p in self.pools:
            du = p.disk_usage()
            total += du["total"]
            free += du["free"]
        return {"total": total, "free": free}

    def pool_status(self) -> list[dict]:
        """Capacity and drain state per pool (the admin `pools` listing);
        a drain's status comes from its journal, as every worker of a
        pool reads it."""
        from ..background import decom
        out = []
        for i, p in enumerate(self.pools):
            du = p.disk_usage()
            row = {"pool": i, "total": du["total"], "free": du["free"],
                   "draining": i in self.draining}
            st = decom.pool_status(self, i)
            if st is not None:
                row["decommission"] = st
            out.append(row)
        return out
