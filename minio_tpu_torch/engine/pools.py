"""ServerPools: the object layer a server stands on.

Counterpart of minio_tpu/engine/pools.py (erasureServerPools, cf.
cmd/erasure-server-pool.go).  Pools are independent ErasureSets added
for capacity.  A write goes to the pool that already holds the object,
else to the pool with the most free space, ties to the lowest index
(getPoolIdx, :373); reads and deletes probe the pools in order;
listings merge the pools'; a multipart upload id carries its pool.

Left out: decommission and `set_draining` (ROADMAP.md Queue A item 9),
with the draining-aware read and delete paths they need, and adding a
pool to a running deployment.
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
        self.deployment_id = pools[0].deployment_id

    def close(self) -> None:
        """Stop every set's executors."""
        for p in self.pools:
            p.close()

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

    def get_pool_idx(self, bucket: str, obj: str) -> int:
        """The pool that holds the object; else the one with the most
        free space, ties to the lowest index, so placement is stable
        across restarts (cf. getPoolIdx, erasure-server-pool.go:373).
        With one pool there is nothing to decide and nothing is probed
        (a key whose last write reached a minority would otherwise fail
        every overwrite on read quorum)."""
        if len(self.pools) == 1:
            return 0
        existing = self._pool_with_object(bucket, obj)
        if existing is not None:
            return existing
        frees = [p.disk_usage()["free"] for p in self.pools]
        return frees.index(max(frees))

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
        return self.pools[self.get_pool_idx(bucket, obj)].put_object(
            bucket, obj, data, **kw)

    def _first(self, bucket: str, obj: str, call):
        """call(pool) on each pool in order until one holds the object."""
        last: StorageError | None = None
        for p in self.pools:
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
            bucket, obj, offset, length, version_id))

    def get_object_iter(self, bucket: str, obj: str, offset: int = 0,
                        length: int = -1, version_id: str = ""):
        """Streaming read: (fi, iterator of chunks of at most one device
        batch) from the first pool that holds the object."""
        return self._first(bucket, obj, lambda p: p.get_object_iter(
            bucket, obj, offset, length, version_id))

    def head_object(self, bucket: str, obj: str,
                    version_id: str = "") -> FileInfo:
        return self._first(bucket, obj, lambda p: p.head_object(
            bucket, obj, version_id))

    def delete_object(self, bucket: str, obj: str, version_id: str = "",
                      versioned: bool = False):
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
        """The version history merged across pools, one entry per version
        id, newest first."""
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
        """Capacity per pool (the admin `pools` listing)."""
        return [{"pool": i, "total": du["total"], "free": du["free"]}
                for i, du in enumerate(p.disk_usage() for p in self.pools)]
