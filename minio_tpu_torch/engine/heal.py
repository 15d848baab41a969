"""Object, bucket and drive heal on the GPU.

Counterpart of minio_tpu/engine/heal.py, with the same drive states,
results and on-disk outcome, so a tree healed here equals the tree the
JAX package's heal leaves:

- `heal_object` classifies every drive's copy of each version (ok /
  offline / missing / outdated / corrupt), elects the quorum metadata,
  and rebuilds the copies that are not ok (cf. healObject,
  cmd/erasure-healing.go:244), under the object's namespace write lock.
  Dangling versions, provably below read quorum, are purged unless
  `remove_dangling` is False (cf. isObjectDangling, :834); `dry_run`
  only reports.
- Data is rebuilt batch by batch, HEAL_BATCH_BLOCKS frames at a time:
  ranged frame reads of k sources, then one device call
  (ops/fused.verify_and_transform) that verifies their digests and
  rebuilds every needed row, parity rows included; a source that fails
  to read or verify is dropped and a spare read in its place.  The
  rebuilt rows' new frame digests come from the device too
  (ops/fused.hash_rows), and the tail fragment goes the same way at its
  own shard size.  Both calls go through the coalescer (ops/coalesce.py)
  under ("vt", ...) and ("digest", ...), so concurrent heals and degraded
  GETs of the same geometry share launches; a failed handle is
  recomputed by the direct call.  A sha256 or blake2b512 part (no device
  program) is verified and framed with hashlib's digests on the host
  while its rows are still rebuilt on the device.  A batch whose verified data rows are
  resident in the device shard cache (ops/devcache.py, filled by healthy
  GETs) is rebuilt from their tensor on the card, with no source read
  used and no copy of them to the card after the first.  The frames are appended to a staging file per target
  and published with rename_data.  By default the batches run through a
  read -> verify+rebuild -> write pipeline (parallel/pipeline.py): batch
  i+1's source reads fan out across drives while batch i is on the
  device and batch i-1's frames are appended.  MTPU_HEAL_PIPELINE=0
  runs them one after another, the equivalence oracle.
- A deep check (`deep=True`) verifies every frame of every drive's copy
  on the device.
- Inline objects are healed by reading them through the GET path and
  encoding them again, which gives each target its framed shard.
- A replaced drive: `heal_format` writes its format.json back, then
  `heal_drive` walks every bucket and object of the set onto it with a
  bounded pool of object heals, checkpointing a resumable
  `HealingTracker` on the drive (cf. healErasureSet,
  cmd/global-heal.go:166).  `heal_bucket_objects` heals a bucket or a
  prefix of it through the same pool.

- `sweep_sets_device_parallel` runs a job over the sets of a pool with
  one thread per card, each running its card's sets in order
  (engine/sets.py and background/heal_ops.py call it).

Heal yields to foreground traffic through the admission plane
(server/qos.py): the worker pool shrinks with its pressure
(`_heal_workers`), and `heal_bucket_objects` pauses between objects
(`bg_pause`), both no-ops under MTPU_QOS=0 or below the threshold.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..ops import coalesce, devcache, fused
from ..parallel import pipeline as pl
from ..server import qos as _qos
from ..storage import bitrot_io
from ..storage.drive import SYS_VOL, TMP_DIR, LocalDrive
from ..storage.errors import (ErrErasureReadQuorum, ErrFileCorrupt,
                              ErrFileNotFound, ErrFileVersionNotFound,
                              ErrVolumeExists, ErrVolumeNotFound,
                              StorageError)
from ..storage.format import load_format, new_format, save_format
from ..storage.xlmeta import ErasureInfo, FileInfo, XLMeta
from ..utils import msgpackx
from . import quorum as Q
from .erasure_set import (BATCH_BLOCKS, BLOCK_SIZE, SERIAL_FANOUT, ErasureSet,
                          vt_kernel)

# Drive states (cf. madmin drive states in the reference heal API).
DRIVE_OK = "ok"
DRIVE_OFFLINE = "offline"
DRIVE_MISSING = "missing"
DRIVE_OUTDATED = "outdated"
DRIVE_CORRUPT = "corrupt"

HEALING_FILE = "healing.bin"  # lives under <drive>/.mtpu.sys/

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


def _frame_batches(size: int, ec: ErasureInfo, algo: str) -> list[tuple]:
    """(offset, frames, shard length) of every device batch over one
    shard file of a part of `size` bytes: the full frames in groups of
    HEAL_BATCH_BLOCKS, then the tail frame at its own length."""
    batch = HEAL_BATCH_BLOCKS
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
                deep: bool = False, dry_run: bool = False,
                remove_dangling: bool = True) -> list[HealResult]:
    """Heal one object: every version when version_id == "", else that one.

    Returns one HealResult per version examined (cf. healObject,
    cmd/erasure-healing.go:244); an object no drive holds is a no-op.
    """
    if version_id:
        vids = [version_id]
    else:
        vids = object_version_ids(es, bucket, obj)
        if not vids:
            return []
    # Heal rewrites shard files and metadata: the same write lock as PUT
    # and DELETE (cf. NSLock in healObject, cmd/erasure-healing.go:276).
    with es.nslock.write_locked(bucket, obj, timeout=30.0):
        results = [_heal_version(es, bucket, obj, vid, deep, dry_run,
                                 remove_dangling) for vid in vids]
        # Heal is a mutation: a listing must not be served from a cache
        # taken before it.
        if not dry_run and any(r.healed_drives or r.purged
                               for r in results):
            es._mark_dirty(bucket)
        return results


def _heal_version(es: ErasureSet, bucket: str, obj: str, version_id: str,
                  deep: bool, dry_run: bool,
                  remove_dangling: bool) -> HealResult:
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
        # Sub-quorum metadata.  Purge only when asked to and provably
        # dangling: every drive gave a definite answer (no offline drive
        # could be hiding a copy) and there is still no quorum.
        definite = all(
            d is None or m is not None or isinstance(
                e, (ErrFileNotFound, ErrFileVersionNotFound,
                    ErrVolumeNotFound, ErrFileCorrupt))
            for d, m, e in zip(es.drives, metas, errs))
        offline = sum(1 for d in es.drives if d is None)
        if remove_dangling and definite and n_found + offline < read_quorum:
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
    for framed in es._encode_chunks([(data, True)], k, m, ec.bitrot_algo()):
        for s, piece in enumerate(framed):
            shards[s] += memoryview(piece)
    for pos in targets:
        fi_pos = _fi_for_drive(fi, pos,
                               inline=bytes(shards[ec.distribution[pos] - 1]))
        _ensure_bucket_on(es.drives[pos], bucket)
        es.drives[pos].write_metadata(bucket, obj, fi_pos)


def _pipelined() -> bool:
    """MTPU_HEAL_PIPELINE=0 runs each part's batches one after another
    (the equivalence oracle of the pipelined heal), read per call."""
    return os.environ.get("MTPU_HEAL_PIPELINE", "1") != "0"


def _heal_data(es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
               sources: list[int], targets: list[int]) -> None:
    """Rebuild every part's shard files onto the target drives and publish
    them atomically with rename_data."""
    dist = fi.erasure.distribution
    tmp_id = f"heal-{uuid.uuid4().hex}"
    need = sorted({dist[pos] - 1 for pos in targets})
    heal_part = _heal_part_pipelined if _pipelined() else _heal_part_serial
    try:
        for part in fi.parts:
            if part.size == 0:            # an empty last part: no frames
                for pos in targets:
                    es.drives[pos].append_file(
                        SYS_VOL, f"{TMP_DIR}/{tmp_id}/part.{part.number}",
                        b"")
                continue
            heal_part(es, bucket, obj, fi, part, sources, targets, need,
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


class _PartRebuild:
    """One part's source election and its per-batch verify + rebuild,
    shared by the serial and the pipelined heal (the Erasure.Heal role,
    cmd/erasure-lowlevel-heal.go:31).

    A size check weeds out missing and truncated source shards before
    any data moves; the first k good ones are selected and the rest are
    spares.  `rebuild` verifies one batch of frames of the selected
    sources and rebuilds the `need` rows in one verify_and_transform,
    then hashes the rebuilt rows for their new frames with hash_rows; a
    source that fails to read or verify is dropped for this batch onward
    and a spare read in its place, as on the GET path.  A batch whose
    data rows are resident in the device shard cache is rebuilt from
    them instead.  `sel` changes only in `rebuild`."""

    def __init__(self, es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
                 part, sources: list[int], need: list[int]):
        ec = fi.erasure
        self.es, self.need = es, need
        self.k, self.m = ec.data_blocks, ec.parity_blocks
        self.shard_size = ec.shard_size
        self.algo = ec.bitrot_algo(part.number)
        self.hs = bitrot_io.digest_size(self.algo)
        self.path = f"{obj}/{fi.data_dir}/part.{part.number}"
        self.bucket = bucket
        self.cache_id = (es._devcache_owner, bucket, obj, part.number,
                         fi.data_dir)
        self.what = f"heal {bucket}/{obj} part {part.number}"
        self.src_pos = {ec.distribution[pos] - 1: pos for pos in sources}
        want = bitrot_io.bitrot_shard_file_size(
            ec.shard_file_size(part.size), ec.shard_size, self.algo)

        def usable(s: int) -> bool:
            try:
                return es.drives[self.src_pos[s]].file_size(
                    bucket, self.path) == want
            except StorageError:
                return False

        candidates = sorted(self.src_pos)
        good = [s for s, ok in zip(candidates,
                                   es.pool.map(usable, candidates)) if ok]
        if len(good) < self.k:
            raise self.quorum_err(len(good))
        self.sel, self.spares = good[:self.k], good[self.k:]

    def quorum_err(self, got: int) -> ErrErasureReadQuorum:
        return ErrErasureReadQuorum(f"{self.what}: {got} readable < {self.k}")

    def read(self, s: int, lo: int, ln: int) -> bytes:
        raw = self.es.drives[self.src_pos[s]].read_file(self.bucket,
                                                        self.path, lo, ln)
        if len(raw) != ln:
            raise ErrFileCorrupt(f"short shard segment ({len(raw)} != {ln})")
        return raw

    def rebuild(self, data: dict[int, bytes], lo: int, nb: int,
                s_len: int) -> dict[int, np.ndarray]:
        """Framed rebuilt frames {shard: bytes} of the batch of `nb`
        frames of shard length `s_len` at offset `lo`.  `data` holds the
        frames already read, by source; sources of `sel` missing from it
        are read here."""
        k, m, hs, sel, spares = self.k, self.m, self.hs, self.sel, self.spares
        es, algo, need = self.es, self.algo, tuple(self.need)
        co = coalesce.get() if coalesce.enabled() else None
        resident = self._resident(lo, nb, s_len)
        if resident is not None:
            # Verified data rows already on the card: rebuild from them.
            _, rebuilt = fused.verify_and_transform(
                resident, k, m, tuple(range(k)), need, algo=algo,
                device=es.device)
            return self._frame(rebuilt, nb, s_len, None)
        ln = nb * (hs + s_len)
        while True:
            for s in [s for s in sel if s not in data]:
                try:
                    data[s] = self.read(s, lo, ln)
                except StorageError:
                    sel.remove(s)
            while len(sel) < k:
                if not spares:
                    raise self.quorum_err(len(sel))
                s = spares.pop(0)
                try:
                    data[s] = self.read(s, lo, ln)
                except StorageError:
                    continue
                sel.append(s)
                sel.sort()
            frames = {s: np.frombuffer(data[s], dtype=np.uint8).reshape(
                nb, hs + s_len) for s in sel}
            x = np.empty((nb, k, s_len), dtype=np.uint8)
            for i, s in enumerate(sel):
                x[:, i, :] = frames[s][:, hs:]
            digests, rebuilt = self._verify(x, tuple(sel), co)
            bad = [s for i, s in enumerate(sel)
                   if not np.array_equal(digests[:, i], frames[s][:, :hs])]
            if not bad:
                break
            for s in bad:
                sel.remove(s)
                del data[s]
        return self._frame(rebuilt, nb, s_len, co)

    def _resident(self, lo: int, nb: int, s_len: int):
        """The batch's verified data rows as a tensor on the card, when
        the device shard cache holds them (full frames only)."""
        if s_len != self.shard_size or not devcache.enabled():
            return None
        cache = devcache.get()
        b0 = lo // (self.hs + s_len)
        found = cache.lookup_range(*self.cache_id, self.algo, b0, b0 + nb)
        if found is None:
            return None
        e, boff = found
        return cache.device_array(e)[boff:boff + nb]

    def _verify(self, x: np.ndarray, sel: tuple, co):
        """Digests of `x` (host) and the rebuilt `need` rows (host from
        the coalescer, a tensor on the card from the direct call)."""
        k, m, need, es = self.k, self.m, tuple(self.need), self.es
        if co is not None:
            h = co.submit(("vt", k, m, sel, need, self.algo, x.shape[2]), x,
                          vt_kernel(k, m, sel, need, self.algo, es.device),
                          weight=x.shape[0], device=es.device)
            try:
                res = h.result()
                h.release()
                return res
            except Exception:  # noqa: BLE001 — direct recompute
                coalesce.record_co_fallback()
        digests, rebuilt = fused.verify_and_transform(
            x, k, m, sel, need, algo=self.algo, device=es.device)
        return digests.cpu().numpy(), rebuilt

    def _frame(self, rebuilt, nb: int, s_len: int, co) -> dict:
        """Frame the rebuilt (nb, T, s_len) rows with their new digests
        (through the coalescer when the rows are on the host)."""
        t, es, algo = len(self.need), self.es, self.algo
        if isinstance(rebuilt, np.ndarray):
            rows = np.ascontiguousarray(rebuilt.transpose(1, 0, 2))
        else:
            rows = rebuilt.transpose(0, 1).contiguous()   # (T, nb, s_len)
        flat = rows.reshape(t * nb, s_len)
        digests = None
        if co is not None and isinstance(rows, np.ndarray) \
                and not fused.is_host_algo(algo):
            h = co.submit(("digest", algo, s_len), flat,
                          coalesce.make_digest_kernel(algo, es.device),
                          weight=nb, device=es.device)
            try:
                digests = h.result()
                h.release()
            except Exception:  # noqa: BLE001 — direct recompute
                coalesce.record_co_fallback()
        if digests is None:
            digests = fused.hash_rows(flat, algo,
                                      device=es.device).cpu().numpy()
        if not isinstance(rows, np.ndarray):
            rows = rows.cpu().numpy()
        framed = bitrot_io.frame_shard_views(
            None, None, digests.reshape(t, nb, self.hs), algo, shards=rows)
        return dict(zip(self.need, framed))


def _heal_part_serial(es: ErasureSet, bucket: str, obj: str, fi: FileInfo,
                      part, sources: list[int], targets: list[int],
                      need: list[int], tmp_id: str) -> None:
    """Rebuild one part onto the targets, one batch after another: the
    sources are read one by one, then the device call, then the appends
    one target at a time.  The oracle of `_heal_part_pipelined`."""
    tmp_path = f"{TMP_DIR}/{tmp_id}/part.{part.number}"
    dist = fi.erasure.distribution
    job = _PartRebuild(es, bucket, obj, fi, part, sources, need)
    for lo, nb, s_len in _frame_batches(part.size, fi.erasure, job.algo):
        payload = job.rebuild({}, lo, nb, s_len)
        for pos in targets:
            es.drives[pos].append_file(SYS_VOL, tmp_path,
                                       payload[dist[pos] - 1])


class StageSeconds:
    """Seconds the pipelined heal spends in each stage, summed over
    batches (and over concurrent heals, so the sums can exceed the wall
    time), and the batches counted.  Thread-safe."""

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._mu:
            self._sums = {"read": 0.0, "compute": 0.0, "write": 0.0,
                          "batches": 0}

    def add(self, read_s: float, compute_s: float, write_s: float) -> None:
        with self._mu:
            self._sums["read"] += read_s
            self._sums["compute"] += compute_s
            self._sums["write"] += write_s
            self._sums["batches"] += 1

    def read(self) -> dict:
        with self._mu:
            return dict(self._sums)


#: Stage times of every pipelined part heal in the process: "read" is the
#: wait for a batch's source frames, "compute" its verify + rebuild +
#: framing, "write" its appends to the targets.
STAGES = StageSeconds()


def _heal_part_pipelined(es: ErasureSet, bucket: str, obj: str,
                         fi: FileInfo, part, sources: list[int],
                         targets: list[int], need: list[int],
                         tmp_id: str) -> None:
    """Rebuild one part onto the targets through a read -> verify +
    rebuild -> write pipeline (cf. _heal_part_pipelined,
    minio_tpu/engine/heal.py:514).

    Each batch's source frames are read in parallel across drives, one
    batch ahead of the device; the device call and the framing run on
    the caller's thread; the appends to the targets (in parallel across
    them) run with one batch in flight, so batch i+1's reads and batch
    i-1's appends overlap batch i on the device.  Memory stays
    O(batch).  The tail fragment is the last batch, at its own shard
    size.  The bytes are those of `_heal_part_serial`."""
    tmp_path = f"{TMP_DIR}/{tmp_id}/part.{part.number}"
    dist = fi.erasure.distribution
    job = _PartRebuild(es, bucket, obj, fi, part, sources, need)

    def read_batch(batch):
        """The selected sources' frames, read in parallel; a failed
        read is left out, and `rebuild` drops its source."""
        lo, nb, s_len = batch
        ln = nb * (job.hs + s_len)
        futs = {s: es.pool.submit(job.read, s, lo, ln) for s in list(job.sel)}
        data = {}
        for s, f in futs.items():
            try:
                data[s] = f.result()
            except StorageError:
                pass
        return batch, data

    def compute(item):
        (lo, nb, s_len), data = item
        return job.rebuild(data, lo, nb, s_len)

    def write(payload):
        def put(pos):
            es.drives[pos].append_file(SYS_VOL, tmp_path,
                                       payload[dist[pos] - 1])
        if len(targets) == 1:
            put(targets[0])
        else:
            list(es.pool.map(put, targets))

    batches = _frame_batches(part.size, fi.erasure, job.algo)
    pl.StagePipeline(es._iter_pool).run(
        pl.prefetch_map(read_batch, batches, es._iter_pool, depth=1),
        compute, write, on_batch=STAGES.add)


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


def heal_format(es: ErasureSet) -> list[int]:
    """Write format.json and the system volume back on drives that lost
    them (a wiped or replaced disk), in the slot the deployment's layout
    gives each; the step before bucket and object heal, since every
    write stages through the system volume (cf. HealFormat,
    cmd/format-erasure.go:798).  Returns the healed positions."""
    fmts: list[dict | None] = []
    for d in es.drives:
        try:
            fmts.append(None if d is None else load_format(d))
        except StorageError:
            fmts.append(None)
    ref = next((f for f in fmts if f), None)
    if ref is None:
        return []
    layout = ref["xl"]["sets"]
    healed = []
    for pos, (d, f) in enumerate(zip(es.drives, fmts)):
        if d is None or f is not None:
            continue
        try:
            d.init_sys_volume()
            save_format(d, new_format(ref["id"], layout,
                                      layout[es.set_index][pos]))
            healed.append(pos)
        except StorageError:
            continue
    return healed


# ---------------------------------------------------------------------------
# Resumable drive healing (new or replaced disk).
# ---------------------------------------------------------------------------

@dataclass
class HealingTracker:
    """Persisted on the drive being healed, so a heal resumes after a
    restart (cf. healingTracker, cmd/background-newdisks-heal-ops.go:48).
    The bytes are the JAX package's: either package resumes the
    other's tracker."""
    heal_id: str = ""
    started_ns: int = 0
    resume_bucket: str = ""
    resume_object: str = ""
    objects_healed: int = 0
    objects_failed: int = 0
    bytes_healed: int = 0
    finished: bool = False

    def save(self, drive: LocalDrive) -> None:
        drive.write_all(SYS_VOL, HEALING_FILE, msgpackx.packb({
            "id": self.heal_id, "start": self.started_ns,
            "rb": self.resume_bucket, "ro": self.resume_object,
            "oh": self.objects_healed, "of": self.objects_failed,
            "bh": self.bytes_healed, "fin": self.finished}))

    @classmethod
    def load(cls, drive: LocalDrive) -> "HealingTracker | None":
        try:
            d = msgpackx.unpackb(drive.read_all(SYS_VOL, HEALING_FILE))
        except StorageError:
            return None
        return cls(heal_id=d.get("id", ""), started_ns=d.get("start", 0),
                   resume_bucket=d.get("rb", ""),
                   resume_object=d.get("ro", ""),
                   objects_healed=d.get("oh", 0),
                   objects_failed=d.get("of", 0),
                   bytes_healed=d.get("bh", 0),
                   finished=d.get("fin", False))


def _set_objects(es: ErasureSet, bucket: str, skip_pos: int) -> list[str]:
    """Sorted union of a bucket's object names on every drive but
    `skip_pos`."""
    names: set[str] = set()
    for pos, d in enumerate(es.drives):
        if d is None or pos == skip_pos:
            continue
        try:
            for name, _ in d.walk_dir(bucket):
                names.add(name)
        except StorageError:
            continue
    return sorted(names)


def _heal_workers(workers: int | None) -> int:
    """Concurrent object heals: `workers` when given, else 1 on a
    one-core host and min(4, cores) elsewhere; under foreground pressure
    the overload plane shrinks either further — heal yields to GET/PUT
    for drives and coalescer lanes (server/qos.scale_workers)."""
    if workers is not None:
        return _qos.scale_workers(max(1, int(workers)), "heal")
    n = 1 if SERIAL_FANOUT else min(4, os.cpu_count() or 1)
    return _qos.scale_workers(n, "heal")


def heal_drive(es: ErasureSet, pos: int, checkpoint_every: int = 64,
               workers: int | None = None,
               stop: threading.Event | None = None) -> HealingTracker:
    """Walk the whole set onto one new, replaced or wiped drive,
    resumably, healing up to `workers` objects at once (a bounded
    submission window: no queue grows with the set).

    The HealingTracker checkpoint advances only over the CONTIGUOUS
    completed prefix of the sorted walk: with concurrent workers object
    i+1 may finish before object i, and saving i+1 as the resume point
    would skip i for good if the heal is interrupted.  Healing an object
    past the frontier again on resume is a no-op.  Setting `stop` ends
    the walk after the heals in flight; the tracker is saved unfinished.

    cf. healErasureSet, cmd/global-heal.go:166."""
    drive = es.drives[pos]
    if drive is None:
        raise ErrVolumeNotFound(f"drive position {pos} offline")
    tracker = HealingTracker.load(drive)
    if tracker is None or tracker.finished:
        tracker = HealingTracker(heal_id=str(uuid.uuid4()),
                                 started_ns=time.time_ns())
        tracker.save(drive)
    workers = _heal_workers(workers)

    def walk():
        for bucket in es.list_buckets():
            if bucket < tracker.resume_bucket:
                continue
            heal_bucket(es, bucket)
            for obj in _set_objects(es, bucket, skip_pos=pos):
                if (bucket == tracker.resume_bucket
                        and obj <= tracker.resume_object):
                    continue
                yield bucket, obj

    def heal_one(item):
        bucket, obj = item
        healed = nbytes = 0
        for r in heal_object(es, bucket, obj):
            if pos in r.healed_drives:
                healed += 1
                nbytes += r.size
        return healed, nbytes

    frontier = pl.Frontier()
    items: dict[int, tuple[str, str]] = {}
    done_below = 0          # items the frontier has passed
    since_ckpt = 0
    pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None
    try:
        for idx, item, res, err in pl.run_window(
                heal_one, walk(), pool, window=workers * 2, stop=stop):
            if err is not None and not isinstance(err, StorageError):
                raise err
            if err is not None:
                tracker.objects_failed += 1
            else:
                tracker.objects_healed += res[0]
                tracker.bytes_healed += res[1]
            items[idx] = item
            front = frontier.mark(idx)
            while done_below < front:
                tracker.resume_bucket, tracker.resume_object = \
                    items.pop(done_below)
                done_below += 1
                since_ckpt += 1
            if since_ckpt >= checkpoint_every:
                tracker.save(drive)
                since_ckpt = 0
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if stop is None or not stop.is_set():
        tracker.finished = True
    tracker.save(drive)
    return tracker


def heal_bucket_objects(es: ErasureSet, bucket: str, prefix: str = "",
                        deep: bool = False, remove_dangling: bool = True,
                        workers: int | None = None,
                        stop: threading.Event | None = None,
                        on_object=None) -> list[HealResult]:
    """Heal every object of a bucket whose name starts with `prefix`,
    through the same bounded worker pool as heal_drive.
    `on_object(name, results, err)` observes each object as it
    completes; errors other than storage errors propagate."""
    workers = _heal_workers(workers)
    names = [n for n in _set_objects(es, bucket, skip_pos=-1)
             if n.startswith(prefix)]

    def one(name):
        return heal_object(es, bucket, name, deep=deep,
                           remove_dangling=remove_dangling)

    results: list[HealResult] = []
    pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None
    try:
        for _, name, res, err in pl.run_window(
                one, names, pool, window=workers * 2, stop=stop):
            if err is not None and not isinstance(err, StorageError):
                raise err
            if on_object is not None:
                on_object(name, res, err)
            if err is None and res:
                results.extend(res)
            # Pace between objects under foreground pressure (no-op
            # below the threshold: one float compare per object).
            _qos.bg_pause("heal")
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    return results


def device_parallel_enabled() -> bool:
    """MTPU_HEAL_DEVICE_PARALLEL=0 makes every sweep the serial in-order
    loop (read per call)."""
    return os.environ.get("MTPU_HEAL_DEVICE_PARALLEL", "1") != "0"


def sweep_sets_device_parallel(sets, job, stop: threading.Event | None = None):
    """Run `job(es)` over every erasure set, the sets grouped by their
    card (`es.device.index`): one thread per card runs its group's sets
    in order, so sets on different cards heal at once while one card's
    own jobs stay serial.  With one group, a stop request, or
    MTPU_HEAL_DEVICE_PARALLEL=0, it is the plain in-order loop on the
    caller's thread.

    Returns {set_index: job result}.  The first exception of any group is
    raised again after every group finished, so no set is skipped
    because a set on another card failed."""
    groups: dict = {}
    for es in sets:
        groups.setdefault(es.device.index, []).append(es)
    results: dict[int, object] = {}
    if not device_parallel_enabled() or len(groups) <= 1 or \
            (stop is not None and stop.is_set()):
        for es in sets:
            if stop is not None and stop.is_set():
                break
            results[es.set_index] = job(es)
        return results
    mu = threading.Lock()
    errors: list[BaseException] = []

    def run_group(group):
        for es in group:
            if stop is not None and stop.is_set():
                return
            try:
                r = job(es)
            except BaseException as e:  # noqa: BLE001 — raised after join
                with mu:
                    errors.append(e)
                return
            with mu:
                results[es.set_index] = r

    threads = [threading.Thread(target=run_group, args=(g,),
                                name=f"mtpu-heal-d{d}", daemon=True)
               for d, g in groups.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
