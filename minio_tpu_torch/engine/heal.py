"""Object and bucket heal on the GPU.

Counterpart of minio_tpu/engine/heal.py (`heal_object`, `heal_bucket`),
with the same drive states, results and on-disk outcome, so a tree
healed here equals the tree the JAX package's heal leaves:

- `heal_object` classifies every drive's copy of each version (ok /
  offline / missing / outdated / corrupt), elects the quorum metadata,
  and rebuilds the copies that are not ok (cf. healObject,
  cmd/erasure-healing.go:244).  Dangling versions, provably below read
  quorum, are purged (cf. isObjectDangling, :834); `dry_run` only
  reports.
- Data is rebuilt batch by batch, HEAL_BATCH_BLOCKS frames at a time:
  ranged frame reads of k sources, then one device call
  (ops/fused.verify_and_transform) that verifies their digests and
  rebuilds every needed row, parity rows included; a source that fails
  to read or verify is dropped and a spare read in its place.  The
  rebuilt rows' new frame digests come from the device too
  (ops/fused.hash_rows), and the tail fragment goes the same way at its
  own shard size.  The frames are appended to a staging file per target
  and published with rename_data.
- A deep check (`deep=True`) verifies every frame of every drive's copy
  on the device.
- Inline objects are healed by reading them through the GET path and
  encoding them again, which gives each target its framed shard.

Left out of this slice: `heal_format`, `heal_drive` with its
`HealingTracker`, `heal_bucket_objects` and the device-parallel sweeps,
namespace locks, and the read/decode/write overlap of the JAX package's
pipeline.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

import numpy as np

from ..ops import fused
from ..storage import bitrot_io
from ..storage.drive import SYS_VOL, TMP_DIR
from ..storage.errors import (ErrErasureReadQuorum, ErrFileCorrupt,
                              ErrFileNotFound, ErrFileVersionNotFound,
                              ErrVolumeExists, ErrVolumeNotFound,
                              StorageError)
from ..storage.xlmeta import ErasureInfo, FileInfo, XLMeta
from . import quorum as Q
from .erasure_set import BATCH_BLOCKS, BLOCK_SIZE, ErasureSet

# Drive states (cf. madmin drive states in the reference heal API).
DRIVE_OK = "ok"
DRIVE_OFFLINE = "offline"
DRIVE_MISSING = "missing"
DRIVE_OUTDATED = "outdated"
DRIVE_CORRUPT = "corrupt"

#: Frames per device call when verifying or rebuilding a part.
HEAL_BATCH_BLOCKS = BATCH_BLOCKS


@dataclass
class HealResult:
    """Outcome of healing one object version (madmin.HealResultItem-like)."""
    bucket: str
    object: str
    version_id: str = ""
    size: int = 0
    before: list[str] = field(default_factory=list)
    after: list[str] = field(default_factory=list)
    healed_drives: list[int] = field(default_factory=list)
    purged: bool = False          # dangling object removed

    @property
    def healed(self) -> bool:
        return bool(self.healed_drives) or self.purged


def object_version_ids(es: ErasureSet, bucket: str, obj: str) -> list[str]:
    """Union of version ids seen on any drive, newest first."""
    seen: dict[str, int] = {}
    for raw, e in es._map_drives(lambda d: d.read_all(bucket,
                                                      f"{obj}/xl.meta")):
        if e is not None:
            continue
        try:
            meta = XLMeta.from_bytes(raw)
        except StorageError:
            continue
        for v in meta.versions:
            vid = v.get("id", "")
            seen[vid] = max(seen.get(vid, 0), v.get("mt", 0))
    return [vid for vid, _ in
            sorted(seen.items(), key=lambda kv: kv[1], reverse=True)]


def _frame_batches(size: int, ec: ErasureInfo, algo: str,
                   batch: int = HEAL_BATCH_BLOCKS) -> list[tuple]:
    """(offset, frames, shard length) of every device batch over one
    shard file of a part of `size` bytes: the full frames in groups of
    `batch`, then the tail frame at its own length."""
    s = ec.shard_size
    frame = bitrot_io.digest_size(algo) + s
    n_full = size // BLOCK_SIZE
    tail = ec.shard_file_size(size) - n_full * s
    out = [(b0 * frame, min(batch, n_full - b0), s)
           for b0 in range(0, n_full, batch)]
    if tail:
        out.append((n_full * frame, 1, tail))
    return out


def _verify_frames(es: ErasureSet, read, size: int, ec: ErasureInfo,
                   algo: str) -> None:
    """Verify every frame of one shard file on the device; `read(offset,
    length)` returns its bytes.  Raises ErrFileCorrupt on a short read or
    a digest mismatch."""
    hs = bitrot_io.digest_size(algo)
    for lo, nb, s_len in _frame_batches(size, ec, algo):
        raw = read(lo, nb * (hs + s_len))
        if len(raw) != nb * (hs + s_len):
            raise ErrFileCorrupt("short shard file")
        frames = np.frombuffer(raw, dtype=np.uint8).reshape(nb, hs + s_len)
        digests, _ = fused.verify_and_transform(
            frames[:, None, hs:], ec.data_blocks, ec.parity_blocks, (), (),
            algo=algo, device=es.device)
        if not np.array_equal(digests.cpu().numpy()[:, 0], frames[:, :hs]):
            raise ErrFileCorrupt("bitrot hash mismatch")


def classify_drives(es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
                    metas: list[FileInfo | None],
                    errs: list[Exception | None],
                    deep: bool = False) -> list[str]:
    """Per-drive-position state for one elected version (cf.
    shouldHealObjectOnDisk + disksWithAllParts,
    cmd/erasure-healing.go:206)."""
    want_key = Q._fi_key(fi)
    states: list[str] = []
    for pos, d in enumerate(es.drives):
        if d is None:
            states.append(DRIVE_OFFLINE)
            continue
        meta = metas[pos]
        if meta is None:
            err = errs[pos]
            if isinstance(err, (ErrFileNotFound, ErrFileVersionNotFound,
                                ErrVolumeNotFound)):
                states.append(DRIVE_MISSING)
            elif isinstance(err, ErrFileCorrupt):
                states.append(DRIVE_CORRUPT)
            else:
                states.append(DRIVE_OFFLINE)
            continue
        if Q._fi_key(meta) != want_key:
            states.append(DRIVE_OUTDATED)
            continue
        states.append(_verify_drive_data(es, d, bucket, obj, fi, meta, deep))
    return states


def _verify_drive_data(es: ErasureSet, d, bucket: str, obj: str,
                       fi: FileInfo, meta: FileInfo, deep: bool) -> str:
    """Check this drive's shard data for the version: sizes always, every
    frame's digest on the device when deep (cf. VerifyFile,
    cmd/xl-storage.go:2194)."""
    if fi.deleted:
        return DRIVE_OK
    ec = fi.erasure
    if fi.inline_data is not None or not fi.data_dir:
        if meta.inline_data is None:
            return DRIVE_CORRUPT
        if deep and ec is not None:
            inline = meta.inline_data
            try:
                if len(inline) != bitrot_io.bitrot_shard_file_size(
                        ec.shard_file_size(fi.size), ec.shard_size,
                        ec.bitrot_algo()):
                    raise ErrFileCorrupt("inline shard size")
                _verify_frames(es, lambda lo, ln: inline[lo:lo + ln],
                               fi.size, ec, ec.bitrot_algo())
            except StorageError:
                return DRIVE_CORRUPT
        return DRIVE_OK
    for part in fi.parts:
        path = f"{obj}/{fi.data_dir}/part.{part.number}"
        algo = ec.bitrot_algo(part.number)
        want = bitrot_io.bitrot_shard_file_size(
            ec.shard_file_size(part.size), ec.shard_size, algo)
        try:
            if d.file_size(bucket, path) != want:
                return DRIVE_CORRUPT
            if deep:
                _verify_frames(
                    es, lambda lo, ln: d.read_file(bucket, path, lo, ln),
                    part.size, ec, algo)
        except ErrFileNotFound:
            return DRIVE_MISSING
        except StorageError:
            return DRIVE_CORRUPT
    return DRIVE_OK


def heal_object(es: ErasureSet, bucket: str, obj: str, version_id: str = "",
                deep: bool = False,
                dry_run: bool = False) -> list[HealResult]:
    """Heal one object: every version when version_id == "", else that one.

    Returns one HealResult per version examined (cf. healObject,
    cmd/erasure-healing.go:244).
    """
    if version_id:
        vids = [version_id]
    else:
        vids = object_version_ids(es, bucket, obj)
    return [_heal_version(es, bucket, obj, vid, deep, dry_run)
            for vid in vids]


def _heal_version(es: ErasureSet, bucket: str, obj: str, version_id: str,
                  deep: bool, dry_run: bool) -> HealResult:
    res = es._map_drives(lambda d: d.read_version(bucket, obj, version_id))
    metas = [m for m, _ in res]
    errs = [e for _, e in res]
    result = HealResult(bucket=bucket, object=obj, version_id=version_id)

    n_found = sum(1 for m in metas if m is not None)
    read_quorum, _ = Q.object_quorum_from_meta(metas, es.n,
                                               es.default_parity)
    try:
        fi = Q.find_file_info_in_quorum(metas, read_quorum) \
            if n_found else None
    except ErrErasureReadQuorum:
        fi = None

    if fi is None:
        # Sub-quorum metadata.  Purge only when provably dangling: every
        # drive gave a definite answer (no offline drive could be hiding
        # a copy) and there is still no quorum.
        definite = all(
            d is None or m is not None or isinstance(
                e, (ErrFileNotFound, ErrFileVersionNotFound,
                    ErrVolumeNotFound, ErrFileCorrupt))
            for d, m, e in zip(es.drives, metas, errs))
        offline = sum(1 for d in es.drives if d is None)
        if definite and n_found + offline < read_quorum:
            result.before = [DRIVE_OFFLINE if d is None else
                             (DRIVE_OK if m is not None else DRIVE_MISSING)
                             for d, m in zip(es.drives, metas)]
            if not dry_run:
                _purge_version(es, bucket, obj, version_id)
            result.purged = True
            result.after = [DRIVE_OFFLINE if d is None else DRIVE_MISSING
                            for d in es.drives]
            return result
        raise ErrErasureReadQuorum(
            f"heal {bucket}/{obj}@{version_id}: "
            f"{n_found} metas < quorum {read_quorum}")

    result.version_id = fi.version_id
    result.size = fi.size
    states = classify_drives(es, bucket, obj, fi, metas, errs, deep)
    result.before = list(states)
    targets = [pos for pos, st in enumerate(states)
               if st in (DRIVE_MISSING, DRIVE_OUTDATED, DRIVE_CORRUPT)
               and es.drives[pos] is not None]
    result.after = list(states)
    if not targets:
        return result
    if dry_run:
        result.healed_drives = targets
        return result

    if fi.deleted or fi.inline_data is not None or not fi.data_dir:
        _heal_metadata_only(es, bucket, obj, fi, metas, targets)
    else:
        sources = [pos for pos, st in enumerate(states) if st == DRIVE_OK]
        k = fi.erasure.data_blocks
        if len(sources) < k:
            raise ErrErasureReadQuorum(
                f"heal {bucket}/{obj}: only {len(sources)} intact copies "
                f"< {k} needed")
        _heal_data(es, bucket, obj, fi, sources, targets)

    for pos in targets:
        result.after[pos] = DRIVE_OK
    result.healed_drives = targets
    return result


def _purge_version(es: ErasureSet, bucket: str, obj: str,
                   version_id: str) -> None:
    """Remove a dangling version wherever it exists."""
    def rm(d):
        try:
            d.delete_version(bucket, obj, version_id)
        except (ErrFileNotFound, ErrFileVersionNotFound):
            pass
    es._map_drives(rm)


def _ensure_bucket_on(drive, bucket: str) -> None:
    """Heal recreates a missing bucket volume on its target drive; the
    data path itself never resurrects a volume."""
    try:
        drive.make_volume(bucket)
    except ErrVolumeExists:
        pass


def _fi_for_drive(fi: FileInfo, pos: int,
                  inline: bytes | None = None) -> FileInfo:
    """Per-drive FileInfo: erasure.index points at this drive's shard."""
    ec = fi.erasure
    ec_pos = None
    if ec is not None:
        ec_pos = ErasureInfo(
            data_blocks=ec.data_blocks, parity_blocks=ec.parity_blocks,
            block_size=ec.block_size, index=ec.distribution[pos],
            distribution=list(ec.distribution), algorithm=ec.algorithm,
            checksums=list(ec.checksums))
    return FileInfo(
        volume=fi.volume, name=fi.name, version_id=fi.version_id,
        data_dir=fi.data_dir if inline is None else "",
        mod_time_ns=fi.mod_time_ns, size=fi.size, deleted=fi.deleted,
        metadata=dict(fi.metadata), parts=list(fi.parts), erasure=ec_pos,
        inline_data=inline)


def _heal_metadata_only(es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
                        metas: list, targets: list[int]) -> None:
    """Delete markers and inline objects: rewrite xl.meta on the targets.

    An inline object is read through the GET path (verified, rebuilt
    where a shard is missing or corrupt) and encoded again on the
    device; each target gets the framed shard its stripe position owns,
    the same bytes the PUT wrote."""
    if fi.deleted:
        for pos in targets:
            _ensure_bucket_on(es.drives[pos], bucket)
            es.drives[pos].write_metadata(bucket, obj, fi)
        return
    ec = fi.erasure
    k, m = ec.data_blocks, ec.parity_blocks
    data = es._read_inline(fi, metas, 0, fi.size) if fi.size else b""
    shards = [bytearray() for _ in range(k + m)]
    for framed in es._encode_chunk(data, True, k, m, ec.bitrot_algo()):
        for s, piece in enumerate(framed):
            shards[s] += memoryview(piece)
    for pos in targets:
        fi_pos = _fi_for_drive(fi, pos,
                               inline=bytes(shards[ec.distribution[pos] - 1]))
        _ensure_bucket_on(es.drives[pos], bucket)
        es.drives[pos].write_metadata(bucket, obj, fi_pos)


def _heal_data(es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
               sources: list[int], targets: list[int]) -> None:
    """Rebuild every part's shard files onto the target drives and publish
    them atomically with rename_data."""
    dist = fi.erasure.distribution
    tmp_id = f"heal-{uuid.uuid4().hex}"
    need = sorted({dist[pos] - 1 for pos in targets})
    try:
        for part in fi.parts:
            _heal_part(es, bucket, obj, fi, part, sources, targets, need,
                       tmp_id)
        for pos in targets:
            _ensure_bucket_on(es.drives[pos], bucket)
            es.drives[pos].rename_data(SYS_VOL, f"{TMP_DIR}/{tmp_id}",
                                       _fi_for_drive(fi, pos), bucket, obj)
    finally:
        for pos in targets:
            try:
                es.drives[pos].delete(SYS_VOL, f"{TMP_DIR}/{tmp_id}",
                                      recursive=True)
            except StorageError:
                pass


def _heal_part(es: ErasureSet, bucket: str, obj: str, fi: FileInfo, part,
               sources: list[int], targets: list[int], need: list[int],
               tmp_id: str) -> None:
    """Rebuild one part onto the targets, one device call per batch of
    frames (the Erasure.Heal role, cmd/erasure-lowlevel-heal.go:31).

    Each batch reads the same frame range from k sources, verifies their
    digests and rebuilds the `need` rows in one verify_and_transform, then
    hashes the rebuilt rows for their new frames with hash_rows; a source
    that fails to read or verify is dropped for this batch onward and a
    spare read in its place, as on the GET path."""
    ec = fi.erasure
    dist = ec.distribution
    k, m = ec.data_blocks, ec.parity_blocks
    algo = ec.bitrot_algo(part.number)
    hs = bitrot_io.digest_size(algo)
    want = bitrot_io.bitrot_shard_file_size(
        ec.shard_file_size(part.size), ec.shard_size, algo)
    path = f"{obj}/{fi.data_dir}/part.{part.number}"
    tmp_path = f"{TMP_DIR}/{tmp_id}/part.{part.number}"
    src_pos = {dist[pos] - 1: pos for pos in sources}

    def quorum_err(got: int) -> ErrErasureReadQuorum:
        return ErrErasureReadQuorum(
            f"heal {bucket}/{obj} part {part.number}: {got} readable < {k}")

    # A size check weeds out missing and truncated shards before any data
    # moves.
    def usable(s: int) -> bool:
        try:
            return es.drives[src_pos[s]].file_size(bucket, path) == want
        except StorageError:
            return False

    if part.size == 0:                    # an empty last part: no frames
        for pos in targets:
            es.drives[pos].append_file(SYS_VOL, tmp_path, b"")
        return
    candidates = sorted(src_pos)
    good = [s for s, ok in zip(candidates, es.pool.map(usable, candidates))
            if ok]
    if len(good) < k:
        raise quorum_err(len(good))
    sel, spares = good[:k], good[k:]

    def read_one(s: int, lo: int, ln: int) -> bytes:
        raw = es.drives[src_pos[s]].read_file(bucket, path, lo, ln)
        if len(raw) != ln:
            raise ErrFileCorrupt(f"short shard segment ({len(raw)} != {ln})")
        return raw

    for lo, nb, s_len in _frame_batches(part.size, ec, algo):
        ln = nb * (hs + s_len)
        data: dict[int, bytes] = {}
        while True:
            for s in [s for s in sel if s not in data]:
                try:
                    data[s] = read_one(s, lo, ln)
                except StorageError:
                    sel.remove(s)
            while len(sel) < k:
                if not spares:
                    raise quorum_err(len(sel))
                s = spares.pop(0)
                try:
                    data[s] = read_one(s, lo, ln)
                except StorageError:
                    continue
                sel.append(s)
                sel.sort()
            frames = {s: np.frombuffer(data[s], dtype=np.uint8).reshape(
                nb, hs + s_len) for s in sel}
            x = np.empty((nb, k, s_len), dtype=np.uint8)
            for i, s in enumerate(sel):
                x[:, i, :] = frames[s][:, hs:]
            digests, rebuilt = fused.verify_and_transform(
                x, k, m, tuple(sel), tuple(need), algo=algo,
                device=es.device)
            digests = digests.cpu().numpy()
            bad = [s for i, s in enumerate(sel)
                   if not np.array_equal(digests[:, i], frames[s][:, :hs])]
            if not bad:
                break
            for s in bad:
                sel.remove(s)
                del data[s]
        rows = rebuilt.transpose(0, 1).contiguous()       # (T, nb, s_len)
        new_digests = fused.hash_rows(
            rows.reshape(len(need) * nb, s_len), algo, device=es.device)
        framed = bitrot_io.frame_shard_views(
            None, None, new_digests.cpu().numpy().reshape(len(need), nb, hs),
            algo, shards=rows.cpu().numpy())
        payload = dict(zip(need, framed))
        for pos in targets:
            es.drives[pos].append_file(SYS_VOL, tmp_path,
                                       payload[dist[pos] - 1])


def heal_bucket(es: ErasureSet, bucket: str) -> list[int]:
    """Create the bucket volume on drives missing it; returns the healed
    positions (cf. HealBucket, cmd/erasure-bucket.go)."""
    res = es._map_drives(lambda d: d.stat_volume(bucket))
    present = sum(1 for _, e in res if e is None)
    if present < es._live_quorum():
        raise ErrVolumeNotFound(bucket)
    healed = []
    for pos, (_, e) in enumerate(res):
        if e is not None and es.drives[pos] is not None:
            try:
                es.drives[pos].make_volume(bucket)
                healed.append(pos)
            except StorageError:
                pass
    return healed
