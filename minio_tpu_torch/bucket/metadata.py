"""BucketMetadataSys: every per-bucket config in one cached store.

The port's copy of minio_tpu/bucket/metadata.py (the
cmd/bucket-metadata-sys.go role): configs persist per bucket under the
internal meta bucket, at the JAX package's paths, and are served from an
in-memory cache.  The server reads and writes versioning and tagging;
the other kinds' files are named here so that deleting a bucket removes
whatever either package stored for it.
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

    def delete(self, bucket: str, kind: str) -> None:
        try:
            self.pools.delete_object(META_BUCKET,
                                     self._path(bucket, kind))
        except StorageError:
            pass
        with self._mu:
            self._cache[bucket, kind] = None

    def drop_bucket(self, bucket: str) -> None:
        for kind in CONFIG_FILES:
            self.delete(bucket, kind)
