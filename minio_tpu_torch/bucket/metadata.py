"""BucketMetadataSys: every per-bucket config in one cached store.

The port's copy of minio_tpu/bucket/metadata.py (the
cmd/bucket-metadata-sys.go role): configs persist per bucket under the
internal meta bucket, at the JAX package's paths, and are served from an
in-memory cache.  `on_change(bucket, kind)`, where set, runs after
every write or delete (once for a dropped bucket, kind "*"): a worker
of the pool bumps the plane's config generation there, and every other
worker `invalidate`s its cache and rewires (server/workers.py); a
cluster node broadcasts a `bucket-metadata` reload to its peers
(server/cluster.py).
"""

from __future__ import annotations

import threading

from ..storage.drive import SYS_VOL
from ..storage.errors import (ErrBucketNotFound, ErrFileNotFound,
                              ErrObjectNotFound, ErrVersionNotFound,
                              StorageError)

#: The internal meta bucket (minioMetaBucket): the drives' system volume.
META_BUCKET = SYS_VOL

CONFIG_FILES = {
    "versioning": "versioning.xml",
    "policy": "policy.json",
    "lifecycle": "lifecycle.xml",
    "notification": "notification.xml",
    "replication": "replication.xml",
    "quota": "quota.json",
    "object_lock": "object-lock.xml",
    "tagging": "tagging.xml",
    "encryption": "encryption.xml",
    "replication_targets": "bucket-targets.json",
}


class BucketMetadataSys:
    def __init__(self, pools):
        self.pools = pools
        self._mu = threading.Lock()
        self._cache: dict[tuple[str, str], bytes | None] = {}
        self.on_change = None

    def _path(self, bucket: str, kind: str) -> str:
        return f"buckets/{bucket}/{CONFIG_FILES[kind]}"

    def get(self, bucket: str, kind: str) -> bytes | None:
        key = (bucket, kind)
        with self._mu:
            if key in self._cache:
                return self._cache[key]
        try:
            _, data = self.pools.get_object(META_BUCKET,
                                            self._path(bucket, kind))
            data = bytes(data)
        except (ErrObjectNotFound, ErrVersionNotFound, ErrBucketNotFound,
                ErrFileNotFound):
            data = None                        # genuinely absent: cache it
        # Any other StorageError (quorum or IO on the meta bucket)
        # propagates uncached: caching 'absent' would fail open.
        with self._mu:
            self._cache[key] = data
        return data

    def put(self, bucket: str, kind: str, data: bytes) -> None:
        self.pools.put_object(META_BUCKET, self._path(bucket, kind),
                              data)
        with self._mu:
            self._cache[bucket, kind] = data
        if self.on_change is not None:
            self.on_change(bucket, kind)

    def delete(self, bucket: str, kind: str, announce: bool = True) -> None:
        try:
            self.pools.delete_object(META_BUCKET,
                                     self._path(bucket, kind))
        except StorageError:
            pass
        with self._mu:
            self._cache[bucket, kind] = None
        if announce and self.on_change is not None:
            self.on_change(bucket, kind)

    def invalidate(self, bucket: str | None = None) -> None:
        """Drop cached configs (every bucket's by default): another
        process wrote the store."""
        with self._mu:
            if bucket is None:
                self._cache.clear()
            else:
                for key in [k for k in self._cache if k[0] == bucket]:
                    del self._cache[key]

    def drop_bucket(self, bucket: str) -> None:
        """Every config of a deleted bucket goes, with one `on_change`."""
        for kind in CONFIG_FILES:
            self.delete(bucket, kind, announce=False)
        if self.on_change is not None:
            self.on_change(bucket, "*")
