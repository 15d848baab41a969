"""Multipart uploads on the GPU: each part its own erasure-coded stream.

Counterpart of minio_tpu/engine/multipart.py, with the same staging
layout under the system volume's `multipart` directory and the same
published object, so an upload started by one package completes in the
other (cf. NewMultipartUpload, PutObjectPart and CompleteMultipartUpload,
cmd/erasure-multipart.go:39,400,771):

- the upload fixes the stripe geometry, so every part encodes alike;
- each part is encoded batch by batch on the device through the same
  path as `ErasureSet.put_object`, staged, then renamed into place with
  a part meta that records its ETag, size and bitrot algorithm (the
  MTPU_BITROT_ALGO current when the part was written, so one object can
  mix mxh256 and HighwayHash parts);
- completion checks the client's part list, renumbers the chosen parts
  part.1..part.N and publishes them as one version with rename_data.

S3 semantics: parts in any order, a part re-upload replaces the old one,
ETag = md5(concatenated part MD5s)-N, and every part but the last at
least MIN_PART_SIZE.
"""

from __future__ import annotations

import hashlib
import time
import uuid

from ..storage import bitrot_io
from ..storage.drive import MULTIPART_DIR, SYS_VOL, TMP_DIR
from ..storage.errors import (ErrBucketNotFound, ErrFileNotFound,
                              StorageError)
from ..storage.xlmeta import (ErasureInfo, FileInfo, ObjectPartInfo,
                              XLMeta, new_uuid)
from ..utils import msgpackx, streams
from . import quorum as Q
from .erasure_set import BLOCK_SIZE, ErasureSet

MIN_PART_SIZE = 5 * 1024 * 1024        # S3 minimum for all but the last part
MAX_PARTS = 10_000                     # docs/minio-limits.md:24-29

# Upload metadata keys (internal).
_MP_OBJECT_KEY = "x-mtpu-internal-mp-object"
_MP_BUCKET_KEY = "x-mtpu-internal-mp-bucket"


class ErrInvalidPart(StorageError):
    pass


class ErrInvalidPartOrder(StorageError):
    pass


class ErrPartTooSmall(StorageError):
    pass


class ErrUploadNotFound(StorageError):
    pass


def _upload_root(bucket: str, obj: str) -> str:
    h = hashlib.sha256(f"{bucket}/{obj}".encode()).hexdigest()[:32]
    return f"{MULTIPART_DIR}/{h}"


def _upload_path(bucket: str, obj: str, upload_id: str) -> str:
    return f"{_upload_root(bucket, obj)}/{upload_id}"


def _write_quorum(ec: ErasureInfo) -> int:
    k, m = ec.data_blocks, ec.parity_blocks
    return k + (1 if k == m else 0)


def new_multipart_upload(es: ErasureSet, bucket: str, obj: str, *,
                         metadata: dict | None = None,
                         parity: int | None = None) -> str:
    """Create an upload and fix its stripe geometry now, so every part
    encodes identically (cf. newMultipartUpload, erasure-multipart.go:39).
    Returns the upload id."""
    if not es.bucket_exists(bucket):
        raise ErrBucketNotFound(bucket)
    parity = es.clamp_parity(parity)
    offline = sum(1 for d in es.drives if d is None)
    if offline and parity < es.n // 2:
        parity = min(parity + offline, es.n // 2)
    k = es.n - parity
    distribution = Q.hash_order(f"{bucket}/{obj}", es.n)
    upload_id = f"{new_uuid()}x{time.time_ns()}"
    meta = dict(metadata or {})
    meta[_MP_OBJECT_KEY] = obj
    meta[_MP_BUCKET_KEY] = bucket
    path = _upload_path(bucket, obj, upload_id)

    def write_one(pos, d):
        ec = ErasureInfo(data_blocks=k, parity_blocks=parity,
                         block_size=BLOCK_SIZE, index=distribution[pos],
                         distribution=distribution, checksums=[])
        d.write_metadata(SYS_VOL, path, FileInfo(
            volume=SYS_VOL, name=path, mod_time_ns=time.time_ns(),
            metadata=meta, erasure=ec))

    res = es._map_positions(write_one)
    err = Q.reduce_write_quorum_errs([e for _, e in res], es.n // 2 + 1)
    if err is not None:
        raise err
    return upload_id


def _read_upload_fi(es: ErasureSet, bucket: str, obj: str,
                    upload_id: str) -> FileInfo:
    path = _upload_path(bucket, obj, upload_id)
    metas = [m for m, _ in es._map_drives(
        lambda d: d.read_version(SYS_VOL, path))]
    if sum(1 for m in metas if m is not None) < es._live_quorum():
        raise ErrUploadNotFound(f"{bucket}/{obj}: {upload_id}")
    return next(m for m in metas if m is not None)


def _part_meta_blob(part_number: int, etag: str, total: int,
                    algo: str) -> bytes:
    return msgpackx.packb({
        "n": part_number, "etag": etag, "size": total,
        "as": total, "mt": time.time_ns(), "algo": algo})


def put_object_part(es: ErasureSet, bucket: str, obj: str, upload_id: str,
                    part_number: int, data) -> ObjectPartInfo:
    """Encode one part as its own stream into the upload's staging dir
    (cf. PutObjectPart, erasure-multipart.go:400).  `data` is bytes or a
    reader; a reader streams through the device in O(batch) memory."""
    if not 1 <= part_number <= MAX_PARTS:
        raise ErrInvalidPart(f"part number {part_number}")
    fi = _read_upload_fi(es, bucket, obj, upload_id)
    ec = fi.erasure
    path = _upload_path(bucket, obj, upload_id)
    write_quorum = _write_quorum(ec)
    stream = None
    if streams.is_reader(data):
        stream, data = data, b""
    # Staged under a unique name, then renamed into place, so a concurrent
    # re-upload of the same part cannot interleave appends.
    stage = f"{path}/stage-{uuid.uuid4().hex}.{part_number}"
    algo = bitrot_io.write_algo()
    failed = [d is None for d in es.drives]
    md5 = streams.PipelinedMD5()
    try:
        total = es.stage_stream(data, stream, md5, ec.data_blocks,
                                ec.parity_blocks, algo, ec.distribution,
                                stage, failed, write_quorum)
        etag = md5.hexdigest()
        part_meta = _part_meta_blob(part_number, etag, total, algo)

        def publish(pos, d):
            if failed[pos]:
                raise ErrFileNotFound("staging failed")
            if total == 0:
                d.append_file(SYS_VOL, f"{path}/part.{part_number}", b"")
            else:
                d.rename_file(SYS_VOL, stage, SYS_VOL,
                              f"{path}/part.{part_number}")
            d.write_all(SYS_VOL, f"{path}/part.{part_number}.meta",
                        part_meta)

        res = es._map_positions(publish)
        err = Q.reduce_write_quorum_errs([e for _, e in res], write_quorum)
        if err is not None:
            raise err
    finally:
        md5.close()
        _remove_everywhere(es, stage)
    return ObjectPartInfo(number=part_number, size=total, actual_size=total,
                          etag=etag)


def _remove_everywhere(es: ErasureSet, path: str,
                       recursive: bool = False) -> None:
    def rm(d):
        try:
            d.delete(SYS_VOL, path, recursive=recursive)
        except StorageError:
            pass
    es._map_drives(rm)


def list_parts(es: ErasureSet, bucket: str, obj: str,
               upload_id: str) -> list[ObjectPartInfo]:
    """Quorum-agreed part list (cf. ListObjectParts)."""
    return _list_parts_with_algos(es, bucket, obj, upload_id)[0]


def _list_parts_with_algos(es: ErasureSet, bucket: str, obj: str,
                           upload_id: str):
    """The part list and each part's bitrot algorithm, from the part
    metas a quorum of drives agrees on."""
    _read_upload_fi(es, bucket, obj, upload_id)
    path = _upload_path(bucket, obj, upload_id)

    def scan(d) -> list[tuple]:
        keys = []
        try:
            names = d.list_raw(SYS_VOL, path)
        except StorageError:
            return keys
        for name in names:
            if not name.endswith(".meta") or not name.startswith("part."):
                continue
            try:
                pm = msgpackx.unpackb(d.read_all(SYS_VOL, f"{path}/{name}"))
            except StorageError:
                continue
            keys.append((pm["n"], pm["etag"], pm["size"], pm["as"],
                         pm.get("algo", bitrot_io.DEFAULT_ALGO)))
        return keys

    votes: dict[tuple, int] = {}
    for keys, _ in es._map_drives(scan):
        for key in keys or ():
            votes[key] = votes.get(key, 0) + 1
    quorum = es._live_quorum()
    best: dict[int, tuple] = {}
    for key, count in votes.items():
        if count >= quorum:
            n = key[0]
            if n not in best or votes[best[n]] < count:
                best[n] = key
    parts = [ObjectPartInfo(number=n, size=key[2], actual_size=key[3],
                            etag=key[1])
             for n, key in sorted(best.items())]
    return parts, {n: key[4] for n, key in best.items()}


def upload_metadata(es: ErasureSet, bucket: str, obj: str,
                    upload_id: str) -> dict:
    """The client metadata an upload was created with (the internal
    staging keys stripped): what a relocated upload is created with
    again (background/decom.py)."""
    fi = _read_upload_fi(es, bucket, obj, upload_id)
    return {k: v for k, v in fi.metadata.items()
            if not k.startswith("x-mtpu-internal-mp-")}


def read_part_bytes(es: ErasureSet, bucket: str, obj: str,
                    upload_id: str, part_number: int) -> bytes:
    """One staged part decoded back to its bytes, the decommission
    mover's relocation read.  A staged part is an erasure-coded stream
    under the system volume, so the object read path decodes it, aimed
    at the staging layout: `_read_part` reads `{name}/{data_dir}/part.n`,
    and name = the upload root, data_dir = the upload id land on
    `multipart/<hash>/<id>/part.n`.  Verify and any rebuild run on the
    set's device, as a GET's do."""
    fi_up = _read_upload_fi(es, bucket, obj, upload_id)
    ec = fi_up.erasure
    parts, algos = _list_parts_with_algos(es, bucket, obj, upload_id)
    info = next((p for p in parts if p.number == part_number), None)
    if info is None:
        raise ErrInvalidPart(f"part {part_number}")
    if info.size == 0:
        return b""
    # Part numbers may be sparse; _read_part indexes parts[n - 1].
    pad = [ObjectPartInfo(number=i + 1, size=0, actual_size=0, etag="")
           for i in range(part_number - 1)]
    ec_read = ErasureInfo(
        data_blocks=ec.data_blocks, parity_blocks=ec.parity_blocks,
        block_size=ec.block_size, index=0, distribution=ec.distribution,
        checksums=[{"part": part_number,
                    "algo": algos.get(part_number, "highwayhash256S"),
                    "hash": b""}])
    fi = FileInfo(volume=SYS_VOL, name=_upload_root(bucket, obj),
                  data_dir=upload_id, size=info.size,
                  parts=pad + [info], erasure=ec_read)
    got = es._read_part(SYS_VOL, fi.name, fi, part_number, 0, info.size,
                        cache=False)
    return got.tobytes()


def abort_multipart_upload(es: ErasureSet, bucket: str, obj: str,
                           upload_id: str) -> None:
    _read_upload_fi(es, bucket, obj, upload_id)  # unknown upload raises
    _remove_everywhere(es, _upload_path(bucket, obj, upload_id),
                       recursive=True)


def _list_or_empty(d, path: str) -> list[str]:
    try:
        return d.list_raw(SYS_VOL, path)
    except StorageError:
        return []


def list_multipart_uploads(es: ErasureSet, bucket: str,
                           prefix: str = "") -> list[dict]:
    """Active uploads of a bucket (cf. ListMultipartUploads): the upload
    dirs multipart/<hash>/<upload id> that hold an xl.meta."""
    found: dict[str, dict] = {}
    for d in es.drives:
        if d is None:
            continue
        for h in _list_or_empty(d, MULTIPART_DIR):
            for upload_id in _list_or_empty(d, f"{MULTIPART_DIR}/{h}"):
                rel = f"{MULTIPART_DIR}/{h}/{upload_id}"
                try:
                    fi = XLMeta.from_bytes(d.read_all(
                        SYS_VOL, f"{rel}/xl.meta")).latest(SYS_VOL, rel)
                except StorageError:
                    continue
                o = fi.metadata.get(_MP_OBJECT_KEY, "")
                if fi.metadata.get(_MP_BUCKET_KEY) != bucket or \
                        (prefix and not o.startswith(prefix)):
                    continue
                found.setdefault(upload_id, {
                    "object": o, "upload_id": upload_id,
                    "initiated_ns": fi.mod_time_ns})
    return sorted(found.values(),
                  key=lambda u: (u["object"], u["upload_id"]))


def complete_multipart_upload(es: ErasureSet, bucket: str, obj: str,
                              upload_id: str,
                              parts: list[tuple[int, str]], *,
                              versioned: bool = False) -> FileInfo:
    """Check the client's part list, move the chosen parts into a fresh
    data dir and publish one version atomically (cf.
    CompleteMultipartUpload, erasure-multipart.go:771): a new version
    when `versioned`, else the null version."""
    fi_up = _read_upload_fi(es, bucket, obj, upload_id)
    ec = fi_up.erasure
    listed, part_algos = _list_parts_with_algos(es, bucket, obj, upload_id)
    stored = {p.number: p for p in listed}
    if [n for n, _ in parts] != sorted({n for n, _ in parts}):
        raise ErrInvalidPartOrder("parts must be ascending and unique")
    chosen: list[ObjectPartInfo] = []
    for i, (n, etag) in enumerate(parts):
        p = stored.get(n)
        if p is None or p.etag != etag.strip('"'):
            raise ErrInvalidPart(f"part {n}")
        if p.size < MIN_PART_SIZE and i != len(parts) - 1:
            raise ErrPartTooSmall(f"part {n}: {p.size} < {MIN_PART_SIZE}")
        chosen.append(p)
    if not chosen:
        raise ErrInvalidPart("no parts")

    total = sum(p.size for p in chosen)
    data_dir = new_uuid()
    version_id = new_uuid() if versioned else ""
    mod_time = time.time_ns()
    meta = {k: v for k, v in fi_up.metadata.items()
            if not k.startswith("x-mtpu-internal-mp-")}
    meta["etag"] = streams.multipart_etag([p.etag for p in chosen])
    path = _upload_path(bucket, obj, upload_id)
    tmp_id = f"complete-{uuid.uuid4().hex}"
    write_quorum = _write_quorum(ec)

    def fi_for(pos: int) -> FileInfo:
        ec_pos = ErasureInfo(
            data_blocks=ec.data_blocks, parity_blocks=ec.parity_blocks,
            block_size=BLOCK_SIZE, index=ec.distribution[pos],
            distribution=ec.distribution,
            checksums=[{"part": i + 1,
                        "algo": part_algos.get(p.number,
                                               bitrot_io.DEFAULT_ALGO),
                        "hash": b""}
                       for i, p in enumerate(chosen)])
        return FileInfo(
            volume=bucket, name=obj, version_id=version_id,
            data_dir=data_dir, mod_time_ns=mod_time, size=total,
            metadata=meta,
            parts=[ObjectPartInfo(i + 1, p.size, p.actual_size, p.etag)
                   for i, p in enumerate(chosen)],
            erasure=ec_pos)

    def publish(pos, d):
        # This drive must hold every chosen part at the right size AND
        # with the quorum's ETag in its own part meta: a drive that missed
        # a same-size re-upload still holds the old bytes, whose frames
        # verify, and would publish a torn stripe.
        for p in chosen:
            algo = part_algos.get(p.number, bitrot_io.DEFAULT_ALGO)
            want = bitrot_io.bitrot_shard_file_size(
                ec.shard_file_size(p.size), ec.shard_size, algo)
            if d.file_size(SYS_VOL, f"{path}/part.{p.number}") != want:
                raise ErrFileNotFound(f"part {p.number} incomplete here")
            try:
                pm = msgpackx.unpackb(
                    d.read_all(SYS_VOL, f"{path}/part.{p.number}.meta"))
            except StorageError:
                raise ErrFileNotFound(f"part {p.number} meta missing here") \
                    from None
            if pm.get("etag") != p.etag or pm.get("size") != p.size:
                raise ErrFileNotFound(f"part {p.number} stale here")
        # Client part numbers may be sparse; on disk the object has
        # part.1..part.N.
        for i, p in enumerate(chosen):
            d.rename_file(SYS_VOL, f"{path}/part.{p.number}",
                          SYS_VOL, f"{TMP_DIR}/{tmp_id}/part.{i + 1}")
        d.rename_data(SYS_VOL, f"{TMP_DIR}/{tmp_id}", fi_for(pos),
                      bucket, obj)

    # The publish mutates the object namespace: the same write lock as
    # PUT and DELETE, so a concurrent overwrite cannot interleave its
    # per-drive metadata writes (cf. NSLock in CompleteMultipartUpload,
    # erasure-multipart.go:771).
    with es.nslock.write_locked(bucket, obj, timeout=30.0):
        res = es._map_positions(publish)
    errs = [e for _, e in res]
    err = Q.reduce_write_quorum_errs(errs, write_quorum)
    if err is not None:
        # Roll back so the upload stays retryable: parts parked in tmp go
        # back, a sub-quorum published version is dropped, and the upload
        # dir stays.
        def rollback(pos, d):
            for i, p in enumerate(chosen):
                try:
                    d.rename_file(SYS_VOL,
                                  f"{TMP_DIR}/{tmp_id}/part.{i + 1}",
                                  SYS_VOL, f"{path}/part.{p.number}")
                except StorageError:
                    pass
            if errs[pos] is None:
                try:
                    d.delete_version(bucket, obj, version_id)
                except StorageError:
                    pass
            try:
                d.delete(SYS_VOL, f"{TMP_DIR}/{tmp_id}", recursive=True)
            except StorageError:
                pass
        es._map_positions(rollback)
        raise err
    _remove_everywhere(es, f"{TMP_DIR}/{tmp_id}", recursive=True)
    _remove_everywhere(es, path, recursive=True)
    es._mark_dirty(bucket)
    return fi_for(0)
