"""ErasureSets: one pool of N erasure sets behind a static hash ring.

Counterpart of minio_tpu/engine/sets.py.  Each object routes to exactly
one set by SipHash-2-4 of its name keyed by the deployment id (cf.
sipHashMod + getHashedSet, cmd/erasure-sets.go:734,771), so both
packages place every name on the same set.  Bucket operations fan out to
every set; listings merge the sets' listings.  The format bootstrap binds
each drive to its (set, position) slot (cf. newErasureSets,
cmd/erasure-sets.go:342).

Set i runs on `devices.resolve(device, i)`: with `device=None` that is
the CUDA card `i % n_devices()`, and `device="cpu"` puts every set on the
host.
"""

from __future__ import annotations

import uuid

from ..storage.drive import LocalDrive
from ..storage.errors import (ErrBucketExists, ErrBucketNotFound,
                              StorageError)
from ..storage.format import init_format_sets
from ..storage.xlmeta import FileInfo
from ..utils.siphash import sip_hash_mod
from . import heal as heal_mod
from . import multipart as mp
from .erasure_set import ErasureSet


class ErasureSets:
    """N sets x set_drive_count drives, one pool's worth of capacity."""

    def __init__(self, drives: list[LocalDrive | None],
                 set_drive_count: int,
                 default_parity: int | None = None,
                 deployment_id: str | None = None,
                 device=None):
        if set_drive_count < 2:
            raise ValueError("set_drive_count must be >= 2")
        if len(drives) % set_drive_count != 0:
            raise ValueError(
                f"{len(drives)} drives not divisible by set size "
                f"{set_drive_count}")
        self.set_drive_count = set_drive_count
        self.set_count = len(drives) // set_drive_count
        rows = [drives[i * set_drive_count:(i + 1) * set_drive_count]
                for i in range(self.set_count)]
        fmt = init_format_sets(rows, deployment_id)
        self.deployment_id = fmt["id"]
        self._dep_key = uuid.UUID(self.deployment_id).bytes
        self.sets: list[ErasureSet] = []
        try:
            for i, row in enumerate(rows):
                self.sets.append(ErasureSet(
                    row, default_parity=default_parity, set_index=i,
                    device=device))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop every set's executors."""
        for s in self.sets:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- placement -------------------------------------------------------------

    def set_for(self, obj: str) -> ErasureSet:
        """The set this object lives on (cf. getHashedSet,
        cmd/erasure-sets.go:771)."""
        return self.sets[sip_hash_mod(obj, self.set_count, self._dep_key)]

    # -- buckets (fan out to every set) ----------------------------------------

    def make_bucket(self, bucket: str) -> None:
        errs = []
        for s in self.sets:
            try:
                s.make_bucket(bucket)
                errs.append(None)
            except StorageError as e:
                errs.append(e)
        if errs and all(isinstance(e, ErrBucketExists) for e in errs):
            raise ErrBucketExists(bucket)
        real = [e for e in errs
                if e is not None and not isinstance(e, ErrBucketExists)]
        if real:
            raise real[0]

    def bucket_exists(self, bucket: str, cached: bool = False) -> bool:
        return any(s.bucket_exists(bucket, cached=cached)
                   for s in self.sets)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        errs = []
        for s in self.sets:
            try:
                s.delete_bucket(bucket, force=force)
                errs.append(None)
            except StorageError as e:
                errs.append(e)
        if errs and all(isinstance(e, ErrBucketNotFound) for e in errs):
            raise ErrBucketNotFound(bucket)
        real = [e for e in errs
                if e is not None and not isinstance(e, ErrBucketNotFound)]
        if real:
            raise real[0]

    def list_buckets(self) -> list[str]:
        names: set[str] = set()
        for s in self.sets:
            names.update(s.list_buckets())
        return sorted(names)

    # -- objects (route to one set) --------------------------------------------

    def put_object(self, bucket: str, obj: str, data, **kw) -> FileInfo:
        return self.set_for(obj).put_object(bucket, obj, data, **kw)

    def get_object(self, bucket: str, obj: str, offset: int = 0,
                   length: int = -1, version_id: str = ""):
        return self.set_for(obj).get_object(bucket, obj, offset, length,
                                            version_id)

    def get_object_iter(self, bucket: str, obj: str, offset: int = 0,
                        length: int = -1, version_id: str = ""):
        return self.set_for(obj).get_object_iter(bucket, obj, offset,
                                                 length, version_id)

    def head_object(self, bucket: str, obj: str,
                    version_id: str = "") -> FileInfo:
        return self.set_for(obj).head_object(bucket, obj, version_id)

    def delete_object(self, bucket: str, obj: str, version_id: str = "",
                      versioned: bool = False):
        return self.set_for(obj).delete_object(bucket, obj, version_id,
                                               versioned)

    def update_object_metadata(self, bucket: str, obj: str,
                               fi: FileInfo) -> None:
        self.set_for(obj).update_object_metadata(bucket, obj, fi)

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "",
                     max_keys: int = 10000) -> list[FileInfo]:
        merged: list[FileInfo] = []
        for s in self.sets:
            merged.extend(s.list_objects(bucket, prefix, marker=marker,
                                         max_keys=max_keys))
        merged.sort(key=lambda fi: fi.name)
        return merged[:max_keys]

    def list_object_versions(self, bucket: str, obj: str) -> list[FileInfo]:
        return self.set_for(obj).list_object_versions(bucket, obj)

    # -- multipart (route to one set) ------------------------------------------

    def new_multipart_upload(self, bucket: str, obj: str, **kw) -> str:
        return mp.new_multipart_upload(self.set_for(obj), bucket, obj, **kw)

    def put_object_part(self, bucket: str, obj: str, upload_id: str,
                        part_number: int, data):
        return mp.put_object_part(self.set_for(obj), bucket, obj,
                                  upload_id, part_number, data)

    def complete_multipart_upload(self, bucket: str, obj: str,
                                  upload_id: str, parts, **kw) -> FileInfo:
        return mp.complete_multipart_upload(self.set_for(obj), bucket, obj,
                                            upload_id, parts, **kw)

    def abort_multipart_upload(self, bucket: str, obj: str,
                               upload_id: str) -> None:
        mp.abort_multipart_upload(self.set_for(obj), bucket, obj, upload_id)

    def list_parts(self, bucket: str, obj: str, upload_id: str):
        return mp.list_parts(self.set_for(obj), bucket, obj, upload_id)

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[dict]:
        out = []
        for s in self.sets:
            out.extend(mp.list_multipart_uploads(s, bucket, prefix))
        return sorted(out, key=lambda u: (u["object"], u["upload_id"]))

    # -- heal ------------------------------------------------------------------

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    **kw) -> list[heal_mod.HealResult]:
        return heal_mod.heal_object(self.set_for(obj), bucket, obj,
                                    version_id, **kw)

    def heal_bucket(self, bucket: str) -> dict[int, list[int]]:
        """Bucket heal on every set, sets on different cards at once
        (heal.sweep_sets_device_parallel); {set index: healed drive
        positions} of the sets that healed any."""
        res = heal_mod.sweep_sets_device_parallel(
            self.sets, lambda s: heal_mod.heal_bucket(s, bucket))
        return {i: healed for i, s in enumerate(self.sets)
                if (healed := res.get(s.set_index))}

    # -- capacity --------------------------------------------------------------

    def disk_usage(self) -> dict:
        total = free = 0
        for s in self.sets:
            for d in s.drives:
                if d is None:
                    continue
                try:
                    info = d.disk_info()
                except (StorageError, OSError):
                    continue            # report the capacity still seen
                total += info["total"]
                free += info["free"]
        return {"total": total, "free": free}
