"""Local drive backend: the subset of minio_tpu/storage/drive.py that the
erasure data path, heal, multipart, the listings and the pools call, with
the same on-disk format.

One `LocalDrive` owns one directory tree (cf. xlStorage,
cmd/xl-storage.go in the reference):

- volumes (buckets) are top-level directories;
- an object is a directory holding ``xl.meta`` plus one subdirectory per
  version data-dir holding the bitrot-framed shard files (``part.N``);
- writes are staged under the drive's tmp area and published atomically
  by renaming the data-dir into place and adding the version to xl.meta
  (RenameData, cmd/xl-storage.go:1830);
- deletes rename into the tmp trash first, so they appear atomic.

A drive the JAX package wrote reads here, and the other way round.

Staged shard appends have two forms: `append_file` (one open and write
per batch) and `write_file_batches` (one open and `pwritev` per drive
per batch list, O_DIRECT under MTPU_ODIRECT=direct), which the engine
takes while zero-copy is on (ops/zerocopy.py).  Shard reads have two
zero-copy forms beside `read_file`: `read_file_view` (an mmap over the
page cache) and `open_read_fd` (the fd a verified sendfile plan reads
and sends through).  `sweep_stale` is the boot-time recovery sweep of a
dead process's staging (storage/recovery.py).  `stats()` counts the
vectored writes and the metadata plane's publishes.

Group-committed metadata (ops/metalanes.py): `write_metadata_many`
stages a batch of xl.meta publishes, persists every blob in ONE fsynced
journal segment under ``.mtpu.sys/metajournal`` (the JAX package's
format: ``MJ01``, a CRC-32 of the payload, then msgpack ``{"v": 1,
"entries": [{"vol", "obj", "blob"}]}``), publishes each blob by an
unsynced tmp + rename and unlinks the segment; `read_version_many`
resolves a batch of lookups in one call.  `replay_meta_journal` (the
boot sweep's first step) republishes what a killed batch left, in
commit order (the segments' modification times), and never over an
xl.meta written after the segment: in the worker pool each worker
publishes through its own drive objects, so a dead worker's segment
can be older than another worker's acknowledged write.
`retire_meta_segments` drops a dead process's segments unreplayed
(their items were never acknowledged: a batch acks only after its
unlink), which a respawned pool worker does for its predecessor.
"""

from __future__ import annotations

import errno
import os
import shutil
import threading
import time
import uuid
import zlib

import numpy as np

from . import bitrot_io, diskio, oscounters, xlmeta_v1
from .errors import (ErrDiskNotFound, ErrFileAccessDenied, ErrFileCorrupt,
                     ErrFileNotFound, ErrFileVersionNotFound,
                     ErrIsNotRegular, ErrPathNotFound, ErrVolumeExists,
                     ErrVolumeNotEmpty, ErrVolumeNotFound)
from ..utils import msgpackx
from .xlmeta import FileInfo, XLMeta

# Reserved system namespace on every drive (reference: .minio.sys).
SYS_VOL = ".mtpu.sys"
TMP_DIR = "tmp"
MULTIPART_DIR = "multipart"
XL_META_FILE = "xl.meta"
FORMAT_FILE = "format.json"
META_JOURNAL_DIR = "metajournal"
# The JAX package's system subdirectories, created alike so a drive
# looks the same whichever package opened it first.
_SYS_SUBDIRS = (TMP_DIR, META_JOURNAL_DIR, MULTIPART_DIR, "buckets")
#: the first bytes of a journal segment (then a CRC-32 and the payload)
_SEG_MAGIC = b"MJ01"

# Objects <= this are stored inline in xl.meta (cf. smallFileThreshold,
# cmd/xl-storage.go:59).
SMALL_FILE_THRESHOLD = 128 * 1024
#: frames a verify_file device call takes at once
_VERIFY_FRAMES = 32

_STATS_MU = threading.Lock()
_STATS = {"vectored_writes": 0, "vectored_write_bytes": 0,
          "meta_publishes": 0, "meta_fsyncs": 0, "meta_group_commits": 0,
          "meta_group_items": 0, "meta_group_max": 0,
          "meta_journal_replays": 0}


def stats() -> dict:
    """The vectored writes and xl.meta publishes of every drive in the
    process, which the metrics registry (observe/metrics.py) renders as
    its mtpu_zerocopy_vectored_* and mtpu_meta_* families: publishes
    and the syncs paying for them (one fsync each for a solo
    write_metadata; for a whole group commit two, the journal's fsync
    and the drive's sync), group commits, the
    publishes inside them and the most in one, and entries republished
    from the journal."""
    with _STATS_MU:
        return dict(_STATS)


def _count(**kw) -> None:
    with _STATS_MU:
        for key, n in kw.items():
            _STATS[key] += n


def _segment_pid(name: str) -> int:
    """The writer's pid in a segment name, ``seg-<stamp>-<pid>-<hex>``
    (the JAX package's stamp is a per-process sequence number, the
    port's a nanosecond clock); 0 when the name has another form."""
    parts = name.split("-")
    try:
        return int(parts[2]) if len(parts) == 4 else 0
    except ValueError:
        return 0


def _is_valid_volname(vol: str) -> bool:
    return bool(vol) and "/" not in vol and vol not in (".", "..")


class LocalDrive:
    """One local drive rooted at `root`."""

    def __init__(self, root: str, create: bool = True):
        self.root = os.path.abspath(root)
        if create:
            os.makedirs(self.root, exist_ok=True)
        elif not os.path.isdir(self.root):
            raise ErrDiskNotFound(root)
        # Per-drive syscall counts and times (disk_info()["os"]); inside
        # a traced request each timed call is also a per-drive I/O span
        # ("drive.read", ...), as in the JAX package.
        self._osc = oscounters.Counters(drive=os.path.basename(self.root))
        self.init_sys_volume()
        self._meta_lock = threading.Lock()
        # This drive's id in the deployment's format.json (set when the
        # format is loaded or saved, storage/format.py).
        self.disk_id: str = ""

    # -- path helpers --------------------------------------------------------

    def _vol_path(self, vol: str) -> str:
        if not _is_valid_volname(vol):
            raise ErrVolumeNotFound(vol)
        return os.path.join(self.root, vol)

    def _file_path(self, vol: str, path: str) -> str:
        base = self._vol_path(vol)
        p = os.path.normpath(os.path.join(base, path))
        # Confine to the volume: '..' must not reach sibling volumes or
        # the reserved system namespace.
        if not (p + os.sep).startswith(base + os.sep):
            raise ErrFileAccessDenied(f"{vol}/{path}")
        return p

    def _check_vol(self, vol: str) -> str:
        p = self._vol_path(vol)
        with self._osc.timed("stat"):
            isdir = os.path.isdir(p)
        if not isdir:
            raise ErrVolumeNotFound(vol)
        return p

    def _ensure_parent_in_vol(self, vol: str, p: str) -> None:
        """mkdir the parent of `p`, re-validating the volume when the
        chain is missing so a deleted bucket is never recreated."""
        d = os.path.dirname(p)
        try:
            with self._osc.timed("mkdir"):
                os.mkdir(d)
        except FileExistsError:
            pass
        except FileNotFoundError:
            self._check_vol(vol)
            with self._osc.timed("mkdir"):
                os.makedirs(d, exist_ok=True)

    # -- volume ops ----------------------------------------------------------

    def init_sys_volume(self) -> None:
        """Create the reserved system volume's subdirectories.  A wiped
        drive has none; format heal calls this before it writes
        format.json (cf. makeFormatErasureMetaVolumes,
        cmd/format-erasure.go)."""
        for sub in _SYS_SUBDIRS:
            os.makedirs(os.path.join(self.root, SYS_VOL, sub), exist_ok=True)

    def make_volume(self, vol: str) -> None:
        p = self._vol_path(vol)
        with self._osc.timed("stat"):
            exists = os.path.isdir(p)
        if exists:
            raise ErrVolumeExists(vol)
        with self._osc.timed("mkdir"):
            os.makedirs(p)

    def list_volumes(self) -> list[str]:
        """The drive's volumes (buckets), sorted; the system volume and
        other dot-names are not volumes."""
        with self._osc.timed("listdir"):
            names = sorted(os.listdir(self.root))
        return [name for name in names
                if not name.startswith(".")
                and os.path.isdir(os.path.join(self.root, name))]

    def stat_volume(self, vol: str) -> dict:
        p = self._check_vol(vol)
        with self._osc.timed("stat"):
            st = os.stat(p)
        return {"name": vol, "created_ns": int(st.st_mtime_ns)}

    def delete_volume(self, vol: str, force: bool = False) -> None:
        """Remove a volume: an empty one, or with `force` whatever it
        holds."""
        p = self._check_vol(vol)
        if force:
            self._move_to_trash(p)
            return
        try:
            os.rmdir(p)
        except OSError as e:
            if e.errno == errno.ENOTEMPTY:
                raise ErrVolumeNotEmpty(vol) from e
            raise

    def disk_info(self) -> dict:
        """Capacity of the filesystem under the drive, for the pools'
        free-space placement."""
        st = os.statvfs(self.root)
        return {"total": st.f_blocks * st.f_frsize,
                "free": st.f_bavail * st.f_frsize,
                "used": (st.f_blocks - st.f_bfree) * st.f_frsize,
                "endpoint": self.root, "id": self.disk_id, "online": True,
                "os": self._osc.snapshot()}

    # -- small files ---------------------------------------------------------

    def write_all(self, vol: str, path: str, data: bytes) -> None:
        """Atomic small-file write (tmp + fsync + rename)."""
        self._check_vol(vol)
        p = self._file_path(vol, path)
        self._ensure_parent_in_vol(vol, p)
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR,
                           f"wa-{uuid.uuid4().hex}")
        with self._osc.timed("write"):
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        with self._osc.timed("rename"):
            os.replace(tmp, p)

    def read_all(self, vol: str, path: str) -> bytes:
        p = self._file_path(vol, path)
        try:
            with self._osc.timed("read"), open(p, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            raise ErrFileNotFound(f"{vol}/{path}") from None
        except PermissionError:
            raise ErrFileAccessDenied(f"{vol}/{path}") from None

    def delete(self, vol: str, path: str, recursive: bool = False) -> None:
        with self._osc.timed("delete"):
            p = self._file_path(vol, path)
            if not os.path.exists(p):
                raise ErrFileNotFound(f"{vol}/{path}")
            if os.path.isdir(p):
                if not recursive:
                    raise ErrFileAccessDenied(
                        f"{vol}/{path} is a directory")
                self._move_to_trash(p)
            else:
                os.remove(p)

    # -- shard files ---------------------------------------------------------

    def append_file(self, vol: str, path: str, data) -> None:
        """Append a contiguous buffer (bytes or a uint8 ndarray view) to a
        staged shard file; parents are created."""
        self._check_vol(vol)
        p = self._file_path(vol, path)
        self._ensure_parent_in_vol(vol, p)
        buf = memoryview(data).cast("B")
        with self._osc.timed("write"), open(p, "ab") as f:
            f.write(buf)
            f.flush()
            diskio.write_done(f.fileno(), len(buf))

    def create_file(self, vol: str, path: str, data) -> None:
        """Write a whole (bitrot-framed) shard file, parents created, and
        sync it (the JAX drive's create_file; the storage plane serves
        it)."""
        self._check_vol(vol)
        p = self._file_path(vol, path)
        self._ensure_parent_in_vol(vol, p)
        buf = memoryview(data).cast("B")
        with self._osc.timed("write"), open(p, "wb") as f:
            f.write(buf)
            f.flush()
            if not diskio.write_done(f.fileno(), len(buf)):
                os.fsync(f.fileno())

    def write_file_batches(self, vol: str, path: str, batches) -> None:
        """Vectored staged-shard append: every buffer in `batches` lands
        at EOF through ONE open + pwritev sequence instead of an
        open/write/close round per batch.

        With MTPU_ODIRECT=direct and a page-aligned (offset, total) the
        write goes O_DIRECT (preallocated with fallocate); EINVAL (tmpfs
        refuses O_DIRECT) redoes it buffered.  Byte-identical to the
        append_file loop."""
        self._check_vol(vol)
        p = self._file_path(vol, path)
        self._ensure_parent_in_vol(vol, p)
        iov = [v for v in (memoryview(b).cast("B") for b in batches)
               if len(v)]
        total = sum(len(v) for v in iov)
        with self._osc.timed("write"):
            self._write_vectored(p, iov, total)
        with _STATS_MU:
            _STATS["vectored_writes"] += 1
            _STATS["vectored_write_bytes"] += total

    @staticmethod
    def _write_vectored(p: str, iov: list, total: int) -> None:
        """write_file_batches' open + pwritev sequence."""
        fd = os.open(p, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            pos = os.fstat(fd).st_size
            direct_mode = diskio.mode() == "direct"
            if total and direct_mode:
                # Preallocate only for unbuffered writes: under buffered
                # IO fallocate costs an unwritten-extent conversion per
                # write for a file that is written once and renamed.
                try:
                    os.posix_fallocate(fd, pos, total)
                except (AttributeError, OSError):
                    pass             # preallocation is best-effort
            wfd = fd
            direct = -1
            if (direct_mode and hasattr(os, "O_DIRECT")
                    and total >= diskio.BULK
                    and pos % diskio.ALIGN == 0
                    and total % diskio.ALIGN == 0
                    and all(len(v) % diskio.ALIGN == 0 for v in iov)):
                try:
                    direct = os.open(p, os.O_WRONLY | os.O_DIRECT)
                    wfd = direct
                except OSError:
                    direct = -1      # fs refuses O_DIRECT: buffered
            try:
                off = pos
                while iov:
                    try:
                        n = os.pwritev(wfd, iov[:512], off)
                    except OSError as e:
                        if wfd == direct and e.errno == errno.EINVAL:
                            # Alignment looked right but the fs still
                            # refused (tmpfs): redo buffered.
                            wfd = fd
                            continue
                        raise
                    if n <= 0:
                        raise OSError(errno.EIO, "short pwritev")
                    off += n
                    while iov and n >= len(iov[0]):
                        n -= len(iov[0])
                        iov.pop(0)
                    if n:
                        iov[0] = iov[0][n:]
            finally:
                if direct >= 0:
                    os.close(direct)
            diskio.write_done(fd, total)
        finally:
            os.close(fd)

    def read_file(self, vol: str, path: str, offset: int = 0,
                  length: int = -1) -> bytes:
        p = self._file_path(vol, path)
        try:
            with self._osc.timed("read"):
                return diskio.read_range(p, offset, length)
        except FileNotFoundError:
            raise ErrFileNotFound(f"{vol}/{path}") from None
        except IsADirectoryError:
            raise ErrIsNotRegular(f"{vol}/{path}") from None

    def read_file_view(self, vol: str, path: str, offset: int = 0,
                       length: int = -1) -> memoryview:
        """Zero-copy bulk read: a read-only memoryview over an mmap of
        the page cache, with read_file's error surface, a range past EOF
        included (the view is short; callers size-check the framed
        layout as they do a short read).  For a reader that consumes the
        bytes in place: the engine's shard reads copy their frames into
        a device batch at once, so they use read_file (its I/O timed in
        the pooled fetch, an EIO an error and not a SIGBUS)."""
        p = self._file_path(vol, path)
        try:
            with self._osc.timed("read"):
                return diskio.read_range_view(p, offset, length)
        except FileNotFoundError:
            raise ErrFileNotFound(f"{vol}/{path}") from None
        except IsADirectoryError:
            raise ErrIsNotRegular(f"{vol}/{path}") from None

    def open_read_fd(self, vol: str, path: str) -> int:
        """Open a shard file read-only and hand the caller the fd (the
        sendfile plan: one fd serves the verify pass and the sends, so a
        racing delete only unlinks the name).  The caller closes it."""
        p = self._file_path(vol, path)
        try:
            with self._osc.timed("read"):
                return os.open(p, os.O_RDONLY)
        except FileNotFoundError:
            raise ErrFileNotFound(f"{vol}/{path}") from None
        except IsADirectoryError:
            raise ErrIsNotRegular(f"{vol}/{path}") from None

    def rename_file(self, src_vol: str, src_path: str, dst_vol: str,
                    dst_path: str) -> None:
        """Atomic same-drive file move (parents created)."""
        src = self._file_path(src_vol, src_path)
        dst = self._file_path(dst_vol, dst_path)
        if not os.path.isfile(src):
            raise ErrFileNotFound(f"{src_vol}/{src_path}")
        self._ensure_parent_in_vol(dst_vol, dst)
        with self._osc.timed("rename"):
            os.replace(src, dst)

    def file_size(self, vol: str, path: str) -> int:
        p = self._file_path(vol, path)
        try:
            with self._osc.timed("stat"):
                st = os.stat(p)
        except FileNotFoundError:
            raise ErrFileNotFound(f"{vol}/{path}") from None
        if not os.path.isfile(p):
            raise ErrIsNotRegular(f"{vol}/{path}")
        return st.st_size

    # -- listing ---------------------------------------------------------------

    def list_raw(self, vol: str, path: str = "") -> list[str]:
        """Every entry (files and dirs) under a path, unfiltered: for
        bookkeeping dirs such as multipart staging."""
        self._check_vol(vol)
        p = self._file_path(vol, path) if path else self._vol_path(vol)
        try:
            with self._osc.timed("listdir"):
                return sorted(os.listdir(p))
        except (FileNotFoundError, NotADirectoryError):
            raise ErrPathNotFound(f"{vol}/{path}") from None

    def list_dir(self, vol: str, path: str = "") -> list[str]:
        """Entries directly under a prefix dir; directories get a trailing
        slash, object dirs (holding xl.meta) count as entries."""
        self._check_vol(vol)
        p = self._file_path(vol, path) if path else self._vol_path(vol)
        try:
            with self._osc.timed("listdir"):
                names = sorted(os.listdir(p))
        except (FileNotFoundError, NotADirectoryError):
            raise ErrPathNotFound(f"{vol}/{path}") from None
        out = []
        for name in names:
            full = os.path.join(p, name)
            if os.path.isdir(full):
                out.append(name if os.path.isfile(
                    os.path.join(full, XL_META_FILE)) else name + "/")
        return out

    def verify_file(self, vol: str, path: str, shard_size: int,
                    expected_logical: int | None = None,
                    algo: str = bitrot_io.DEFAULT_ALGO,
                    device=None) -> None:
        """Full-file bitrot verification (cf. VerifyFile,
        cmd/xl-storage.go:2194): every frame's digest through the device
        programs (ops/fused.hash_rows, the host route for sha256) on
        `device`, None meaning the CUDA card; the storage plane passes
        its node's.  Raises ErrFileCorrupt."""
        from ..ops import fused
        buf = np.frombuffer(self.read_file(vol, path), dtype=np.uint8)
        if expected_logical is not None:
            want = bitrot_io.bitrot_shard_file_size(expected_logical,
                                                    shard_size, algo)
            if buf.size != want:
                raise ErrFileCorrupt(f"size mismatch: {buf.size} != {want}")
        hs = bitrot_io.digest_size(algo)
        frame = hs + shard_size
        n_full, rest = divmod(buf.size, frame)
        if rest and rest <= hs:
            raise ErrFileCorrupt("truncated bitrot frame")
        for lo in range(0, n_full, _VERIFY_FRAMES):
            nb = min(_VERIFY_FRAMES, n_full - lo)
            hashes, blocks = bitrot_io.split_frames(buf[lo * frame:], nb,
                                                    shard_size, algo)
            got = fused.hash_rows(np.ascontiguousarray(blocks), algo,
                                  device=device).cpu().numpy()
            if not np.array_equal(got, hashes):
                raise ErrFileCorrupt("bitrot hash mismatch")
        if rest:
            tail = buf[n_full * frame:]
            got = fused.hash_rows(np.ascontiguousarray(tail[hs:])[None],
                                  algo, device=device).cpu().numpy()
            if got[0].tobytes() != tail[:hs].tobytes():
                raise ErrFileCorrupt("bitrot hash mismatch (tail)")

    def walk_dir(self, vol: str, prefix: str = ""):
        """Yield (object name, xl.meta bytes) depth-first in lexical
        order of directory names (cf. WalkDir, cmd/metacache-walk.go:60).
        An object's directory is not descended into."""
        base = self._check_vol(vol)
        start = self._file_path(vol, prefix) if prefix else base
        # The prefix may be a partial name: walk its parent and filter.
        walk_root = start if os.path.isdir(start) else os.path.dirname(start)
        if not os.path.isdir(walk_root):
            return
        for dirpath, dirnames, filenames in os.walk(walk_root):
            dirnames.sort()
            if XL_META_FILE in filenames:
                rel = os.path.relpath(dirpath, base).replace(os.sep, "/")
                if rel.startswith(prefix) or not prefix:
                    try:
                        with open(os.path.join(dirpath, XL_META_FILE),
                                  "rb") as f:
                            yield rel, f.read()
                    except OSError:
                        pass
                dirnames[:] = []

    def walk_page(self, vol: str, prefix: str = "", after: str = "",
                  limit: int = 1000):
        """One bounded page of the lexical walk: up to `limit` (object
        name, xl.meta bytes) entries with name > `after`, and an eof
        flag.  Subtrees that cannot hold names past `after` are pruned,
        so paging a large bucket never reads again what earlier pages
        covered (WalkDir with a resume marker, cf.
        cmd/metacache-walk.go:60)."""
        base = self._check_vol(vol)
        start = self._file_path(vol, prefix) if prefix else base
        walk_root = start if os.path.isdir(start) \
            else os.path.dirname(start)
        out: list[tuple[str, bytes]] = []

        def emit(dirpath: str, rel: str) -> bool:
            if (not prefix or rel.startswith(prefix)) and rel > after:
                if len(out) >= limit:
                    return False
                try:
                    with open(os.path.join(dirpath, XL_META_FILE),
                              "rb") as f:
                        out.append((rel, f.read()))
                except OSError:
                    pass
            return True

        def descend(dirpath: str) -> bool:
            """False when the page filled inside the subtree."""
            try:
                names = os.listdir(dirpath)
            except OSError:
                return True
            # An object dir d emits "d", a container dir d names that
            # start "d/": siblings go in (name if object else name + "/")
            # order, or "x/..." would come before a sibling "x!a".
            items = []
            for name in names:
                sub = os.path.join(dirpath, name)
                if not os.path.isdir(sub):
                    continue
                is_obj = os.path.isfile(os.path.join(sub, XL_META_FILE))
                items.append((name if is_obj else name + "/", is_obj, sub))
            items.sort()
            for _, is_obj, sub in items:
                rel = os.path.relpath(sub, base).replace(os.sep, "/")
                if is_obj:
                    if not emit(sub, rel):
                        return False
                    continue         # an object dir holds data dirs only
                # Every name under rel starts with rel + "/": skip the
                # subtree when that whole range sorts before `after`.
                if after and rel + "/" < after[:len(rel) + 1]:
                    continue
                if len(out) >= limit:
                    return False
                if not descend(sub):
                    return False
            return True

        if not os.path.isdir(walk_root):
            return [], True
        if os.path.isfile(os.path.join(walk_root, XL_META_FILE)):
            # The prefix names an object.
            rel = os.path.relpath(walk_root, base).replace(os.sep, "/")
            return ([], True) if not emit(walk_root, rel) else (out, True)
        return out, descend(walk_root)

    # -- versioned metadata --------------------------------------------------

    def _read_xlmeta(self, vol: str, obj: str) -> XLMeta:
        try:
            buf = self.read_all(vol, os.path.join(obj, XL_META_FILE))
        except ErrFileNotFound:
            raise ErrFileNotFound(f"{vol}/{obj}") from None
        return XLMeta.from_bytes(buf)

    def _write_xlmeta(self, vol: str, obj: str, meta: XLMeta,
                      new: bool = False) -> None:
        if not meta.versions:
            # Last version gone: remove the whole object dir.
            self._move_to_trash(self._file_path(vol, obj))
            return
        if new:
            # First xl.meta of the object: no reader can hold it yet, so
            # no tmp+rename (a torn write fails the integrity checksum).
            p = self._file_path(vol, os.path.join(obj, XL_META_FILE))
            self._ensure_parent_in_vol(vol, p)
            with self._osc.timed("write"), open(p, "wb") as f:
                f.write(meta.to_bytes())
            return
        self.write_all(vol, os.path.join(obj, XL_META_FILE), meta.to_bytes())

    def read_version(self, vol: str, obj: str,
                     version_id: str = "") -> FileInfo:
        """One version's FileInfo (inline data included when present)."""
        return self._read_version(vol, obj, version_id)

    def _read_version(self, vol: str, obj: str, version_id: str) -> FileInfo:
        # read_version's body, which read_version_many calls too: a test
        # drive that wraps the public method sees a batch's items once.
        # Where no xl.meta exists it falls back to the legacy xl.json
        # (format v1, the migration read path,
        # cmd/xl-storage-format-v1.go).
        self._check_vol(vol)
        try:
            meta = self._read_xlmeta(vol, obj)
        except ErrFileNotFound:
            try:
                raw = self.read_all(vol, os.path.join(obj, xlmeta_v1.XL_JSON))
            except ErrFileNotFound:
                raise ErrFileNotFound(f"{vol}/{obj}") from None
            fi = xlmeta_v1.parse_xl_json(raw, vol, obj)
            if version_id and fi.version_id != version_id:
                raise ErrFileVersionNotFound(
                    f"{vol}/{obj}@{version_id}") from None
            return fi
        return meta.get(version_id, vol, obj)

    def write_metadata(self, vol: str, obj: str, fi: FileInfo) -> None:
        """Add/replace one version in xl.meta.  A corrupt xl.meta starts
        fresh, so the quorum-elected metadata can replace it."""
        self._check_vol(vol)
        with self._meta_lock:
            try:
                meta = self._read_xlmeta(vol, obj)
            except (ErrFileNotFound, ErrFileCorrupt):
                meta = XLMeta()
            meta.add_version(fi)
            self._write_xlmeta(vol, obj, meta)
        _count(meta_publishes=1, meta_fsyncs=1)

    # -- group-committed metadata (ops/metalanes.py) ---------------------------

    def _journal_dir(self) -> str:
        return os.path.join(self.root, SYS_VOL, META_JOURNAL_DIR)

    def write_metadata_many(self, items: list) -> list:
        """Group-commit a batch of write_metadata ops: stage each item's
        next xl.meta blob, persist them all in ONE fsynced journal
        segment, publish each blob by an unsynced tmp + rename, make the
        published blobs durable with ONE sync of the drive's filesystem
        (`diskio.sync_fs`), and only then unlink the segment.  `items`
        is a list of ``(vol, obj, fi)``; returns one ``exception |
        None`` per item, so one poisoned item fails alone.

        No item is acknowledged before the call returns, after the
        unlink, so an acknowledged item's blob is on stable storage as a
        solo write_metadata's is; while a renamed blob may not be yet,
        the fsynced segment still covers it.  A kill before the
        segment's fsync leaves a torn segment (dropped by its CRC at
        replay); a kill or power loss after it leaves a segment whose
        items were never acknowledged, and the boot sweep republishes
        them only where nothing newer landed.  Items of one key chain
        onto each other's staged metadata, so the final xl.meta equals a
        sequence of solo writes."""
        out: list = [None] * len(items)
        blobs: list = []            # (index, vol, obj, blob)
        with self._meta_lock:
            staged: dict = {}
            for i, (vol, obj, fi) in enumerate(items):
                try:
                    self._check_vol(vol)
                    meta = staged.get((vol, obj))
                    if meta is None:
                        try:
                            meta = self._read_xlmeta(vol, obj)
                        except (ErrFileNotFound, ErrFileCorrupt):
                            meta = XLMeta()
                    meta.add_version(fi)
                    staged[(vol, obj)] = meta
                    blobs.append((i, vol, obj, meta.to_bytes()))
                except Exception as e:  # noqa: BLE001 — per-item verdict
                    out[i] = e
            if not blobs:
                return out
            payload = msgpackx.packb({
                "v": 1,
                "entries": [{"vol": vol, "obj": obj, "blob": blob}
                            for _, vol, obj, blob in blobs]})
            # The stamp orders segments in commit order across processes
            # sharing the drive (replay sorts by mtime, then by name).
            seg = os.path.join(
                self._journal_dir(),
                f"seg-{time.time_ns():020d}-{os.getpid()}-"
                f"{uuid.uuid4().hex}")
            with self._osc.timed("write"), open(seg, "wb") as f:
                f.write(_SEG_MAGIC)
                f.write(zlib.crc32(payload).to_bytes(4, "big"))
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            for i, vol, obj, blob in blobs:
                try:
                    self._publish_meta_blob(vol, obj, blob)
                except Exception as e:  # noqa: BLE001 — per-item verdict
                    out[i] = e
            # The segment is the only synced record of the renamed
            # blobs: it goes only once they are durable themselves.
            diskio.sync_fs(self.root)
            try:
                os.unlink(seg)
            except OSError:
                pass
        _count(meta_group_commits=1, meta_group_items=len(blobs),
               meta_publishes=len(blobs), meta_fsyncs=2)
        with _STATS_MU:
            _STATS["meta_group_max"] = max(_STATS["meta_group_max"],
                                           len(blobs))
        return out

    def _publish_meta_blob(self, vol: str, obj: str, blob: bytes) -> None:
        p = self._file_path(vol, os.path.join(obj, XL_META_FILE))
        self._ensure_parent_in_vol(vol, p)
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR,
                           f"mj-{uuid.uuid4().hex}")
        with self._osc.timed("write"), open(tmp, "wb") as f:
            f.write(blob)
        with self._osc.timed("rename"):
            os.replace(tmp, p)

    @staticmethod
    def _segment_entries(path: str) -> list:
        """A segment's entries, or [] when it is torn or unreadable (it
        was never fsync-complete, so nothing in it was acknowledged)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            if raw[:4] == _SEG_MAGIC and len(raw) >= 8:
                payload = raw[8:]
                if zlib.crc32(payload) == int.from_bytes(raw[4:8], "big"):
                    return list(msgpackx.unpackb(payload).get("entries",
                                                              []))
        except (OSError, msgpackx.MsgpackError, ValueError, AttributeError):
            pass
        return []

    def replay_meta_journal(self) -> int:
        """Boot recovery: republish the xl.meta blobs of the segments a
        kill or a power loss left behind, and remove every segment.

        Nothing in a surviving segment was acknowledged (the writer
        acknowledges after its unlink), so the replay only rolls
        unacknowledged writes forward, and never over a newer state:
        segments apply in commit order (modification time, then name),
        so the last blob of a key wins, and a key's blob is republished
        only where its xl.meta is older than the segment, or is corrupt
        (a rename whose data a power loss lost: the blob holds every
        version the file had when staged), or is missing while the
        key's nearest existing directory is older than the segment too.
        A missing xl.meta under a directory changed since is a delete
        that landed after the segment, or a publish that never did.
        Torn segments are dropped.  Returns the entries republished."""
        jdir = self._journal_dir()
        try:
            names = os.listdir(jdir)
        except FileNotFoundError:
            return 0
        segs = []
        for name in names:
            try:
                segs.append((os.stat(os.path.join(jdir, name)).st_mtime_ns,
                             name))
            except OSError:
                pass
        segs.sort()
        replayed = 0
        with self._meta_lock:
            last: dict = {}         # (vol, obj) -> (segment mtime, blob)
            for mtime, name in segs:
                for ent in self._segment_entries(os.path.join(jdir, name)):
                    try:
                        last[(ent["vol"], ent["obj"])] = (mtime,
                                                          ent["blob"])
                    except (KeyError, TypeError):
                        pass
            # Every verdict is taken before the first republish, whose
            # new directories would read as changes since a segment.
            land = []
            for (vol, obj), (mtime, blob) in last.items():
                try:
                    if not self._replay_would_replace(vol, obj, mtime):
                        land.append((vol, obj, blob))
                except (OSError, ErrFileAccessDenied):
                    pass
            for vol, obj, blob in land:
                try:
                    self._publish_meta_blob(vol, obj, blob)
                    replayed += 1
                except (OSError, TypeError, ErrVolumeNotFound,
                        ErrFileAccessDenied):
                    # The volume went since: the entry has nowhere to
                    # land.
                    pass
            for _, name in segs:
                try:
                    os.unlink(os.path.join(jdir, name))
                except OSError:
                    pass
        return replayed

    def _replay_would_replace(self, vol: str, obj: str,
                              mtime_ns: int) -> bool:
        """Whether republishing a segment blob of `vol/obj` committed at
        `mtime_ns` could replace a state written after it (the rule of
        replay_meta_journal)."""
        p = self._file_path(vol, os.path.join(obj, XL_META_FILE))
        try:
            if os.stat(p).st_mtime_ns < mtime_ns:
                return False
            try:
                self._read_xlmeta(vol, obj)
            except ErrFileCorrupt:
                return False
            return True
        except FileNotFoundError:
            pass
        # No xl.meta: a delete since the segment would have removed the
        # key's directory from its parent (or removed emptied parents in
        # turn), so the nearest existing ancestor would have changed.
        d = os.path.dirname(p)
        stop = os.path.dirname(self._file_path(vol, ""))
        while len(d) > len(stop):
            try:
                return os.stat(d).st_mtime_ns >= mtime_ns
            except FileNotFoundError:
                d = os.path.dirname(d)
        return True

    def retire_meta_segments(self, pid: int) -> int:
        """Remove, unreplayed, the journal segments that process `pid`
        left (a dead pool worker's: its items were never acknowledged,
        and the live workers may have written newer versions of their
        keys since).  Returns the segments removed."""
        removed = 0
        try:
            names = os.listdir(self._journal_dir())
        except FileNotFoundError:
            return 0
        for name in names:
            if pid and _segment_pid(name) == pid:
                try:
                    os.unlink(os.path.join(self._journal_dir(), name))
                    removed += 1
                except OSError:
                    pass
        return removed

    def read_version_many(self, items: list) -> list:
        """Batched read_version: one call resolves a list of ``(vol,
        obj, version_id)`` lookups into one ``(FileInfo | None,
        exception | None)`` pair per item.  Each key is still its own
        read; concurrent requests share one dispatch into the drive."""
        out = []
        for vol, obj, vid in items:
            try:
                out.append((self._read_version(vol, obj, vid), None))
            except Exception as e:  # noqa: BLE001 — per-item verdict
                out.append((None, e))
        return out

    def rename_data(self, src_vol: str, src_dir: str, fi: FileInfo,
                    dst_vol: str, dst_obj: str) -> None:
        """Atomic publish: move the staged data-dir (whose contents are
        the part files) to <dst_obj>/<fi.data_dir>/ and add the version
        to xl.meta."""
        self._check_vol(dst_vol)
        with self._meta_lock:
            fresh = False
            try:
                meta = self._read_xlmeta(dst_vol, dst_obj)
            except ErrFileNotFound:
                meta, fresh = XLMeta(), True
            except ErrFileCorrupt:
                meta = XLMeta()
            # Non-versioned overwrite of the null version frees its
            # old data-dir.
            old_dd = ""
            if fi.version_id == "":
                try:
                    old_dd = meta.delete_version("")
                except ErrFileVersionNotFound:
                    pass
                if old_dd == fi.data_dir:
                    old_dd = ""
            if fi.uses_data_dir():
                src = self._file_path(src_vol, src_dir)
                if not os.path.isdir(src):
                    raise ErrFileNotFound(f"{src_vol}/{src_dir}")
                if diskio.osync():
                    # Durability before visibility: the staged part
                    # files, then the staging directory's entries.
                    for name in os.listdir(src):
                        fp = os.path.join(src, name)
                        if os.path.isfile(fp):
                            fd = os.open(fp, os.O_RDONLY)
                            try:
                                os.fsync(fd)
                            finally:
                                os.close(fd)
                    dfd = os.open(src, os.O_RDONLY)
                    try:
                        os.fsync(dfd)
                    finally:
                        os.close(dfd)
                dst = self._file_path(dst_vol,
                                      os.path.join(dst_obj, fi.data_dir))
                self._ensure_parent_in_vol(dst_vol, dst)
                if os.path.isdir(dst):
                    self._move_to_trash(dst)
                with self._osc.timed("rename"):
                    os.replace(src, dst)
            meta.add_version(fi)
            self._write_xlmeta(dst_vol, dst_obj, meta, new=fresh)
            if old_dd:
                self._remove_data_dir(dst_vol, dst_obj, old_dd)

    def update_metadata(self, vol: str, obj: str, fi: FileInfo) -> None:
        """Replace an existing version's entry in xl.meta."""
        with self._meta_lock:
            meta = self._read_xlmeta(vol, obj)
            meta.find_version(fi.version_id)      # must exist
            meta.add_version(fi)
            self._write_xlmeta(vol, obj, meta)

    def delete_version(self, vol: str, obj: str, version_id: str = "",
                       mark_delete: bool = False,
                       fi: FileInfo | None = None) -> None:
        """Remove one version, its data-dir when no other version shares
        it, and the object dir with its last version; or, with
        `mark_delete`, add the delete marker `fi` (cf. DeleteVersion,
        cmd/xl-storage.go, and the xlMetaV2 state machine)."""
        self._check_vol(vol)
        with self._meta_lock:
            meta = self._read_xlmeta(vol, obj)
            if mark_delete:
                if fi is None or not fi.deleted:
                    raise ValueError("mark_delete takes a delete marker")
                meta.add_version(fi)
                self._write_xlmeta(vol, obj, meta)
                return
            dd = meta.delete_version(version_id)
            self._write_xlmeta(vol, obj, meta)
            if dd:
                self._remove_data_dir(vol, obj, dd)
            if not meta.versions:
                self._cleanup_empty_parents(vol, obj)

    def _remove_data_dir(self, vol: str, obj: str, data_dir: str) -> None:
        p = self._file_path(vol, os.path.join(obj, data_dir))
        if os.path.isdir(p):
            self._move_to_trash(p)

    def _cleanup_empty_parents(self, vol: str, obj: str) -> None:
        """Remove now-empty parent dirs up to the volume root."""
        base = self._check_vol(vol)
        p = os.path.dirname(self._file_path(vol, obj))
        while p.startswith(base + os.sep):
            try:
                os.rmdir(p)
            except OSError:
                break
            p = os.path.dirname(p)

    # -- internals -----------------------------------------------------------

    def _move_to_trash(self, path: str) -> None:
        """Atomic disappearance: rename into the tmp trash, then remove."""
        trash = os.path.join(self.root, SYS_VOL, TMP_DIR,
                             f"trash-{uuid.uuid4().hex}")
        try:
            with self._osc.timed("rename"):
                os.replace(path, trash)
        except FileNotFoundError:
            return
        shutil.rmtree(trash, ignore_errors=True)

    def get_disk_id(self) -> str:
        return self.disk_id

    def clear_tmp(self) -> None:
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR)
        for name in os.listdir(tmp):
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)

    def sweep_stale(self) -> dict:
        """Boot-time recovery sweep (formatErasureCleanupTmpLocalEndpoints
        role, cmd/prepare-storage.go): everything under tmp belongs to a
        dead boot epoch: staged writes that never published, trash that
        never finished deleting.  The whole tmp dir is renamed aside (one
        atomic op, so a concurrent boot cannot race the file walk), a
        fresh one is created, and the aside tree is deleted.  Orphaned
        multipart ``stage-*`` files (a part upload killed between encode
        and rename) are swept too; parked part files and upload metadata
        stay, so the upload itself is still resumable.

        Returns the counts; `meta_journal` is the xl.meta entries the
        journal replay republished, which runs first: nothing below may
        run ahead of re-establishing them.
        """
        counts = {"tmp_entries": 0, "mp_stage": 0, "meta_journal": 0}
        counts["meta_journal"] = self.replay_meta_journal()
        _count(meta_journal_replays=counts["meta_journal"])
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR)
        try:
            stale = os.listdir(tmp)
        except FileNotFoundError:
            stale = []
        if stale:
            counts["tmp_entries"] = len(stale)
            aside = os.path.join(self.root, SYS_VOL,
                                 f"{TMP_DIR}-old-{uuid.uuid4().hex}")
            try:
                os.replace(tmp, aside)
            except OSError:
                aside = tmp  # fall back to in-place removal
            os.makedirs(tmp, exist_ok=True)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.makedirs(tmp, exist_ok=True)
        mp = os.path.join(self.root, SYS_VOL, MULTIPART_DIR)
        for dirpath, _dirnames, filenames in os.walk(mp):
            for name in filenames:
                if name.startswith("stage-"):
                    try:
                        os.remove(os.path.join(dirpath, name))
                        counts["mp_stage"] += 1
                    except OSError:
                        pass
        return counts

    def __repr__(self) -> str:
        return f"LocalDrive({self.root!r})"
