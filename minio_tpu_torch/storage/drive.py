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
vectored writes.
"""

from __future__ import annotations

import errno
import os
import shutil
import threading
import uuid

from . import diskio
from .errors import (ErrDiskNotFound, ErrFileAccessDenied, ErrFileCorrupt,
                     ErrFileNotFound, ErrFileVersionNotFound,
                     ErrIsNotRegular, ErrPathNotFound, ErrVolumeExists,
                     ErrVolumeNotEmpty, ErrVolumeNotFound)
from .xlmeta import FileInfo, XLMeta

# Reserved system namespace on every drive (reference: .minio.sys).
SYS_VOL = ".mtpu.sys"
TMP_DIR = "tmp"
MULTIPART_DIR = "multipart"
XL_META_FILE = "xl.meta"
FORMAT_FILE = "format.json"
# The JAX package's system subdirectories, created alike so a drive
# looks the same whichever package opened it first.
_SYS_SUBDIRS = (TMP_DIR, "metajournal", MULTIPART_DIR, "buckets")

# Objects <= this are stored inline in xl.meta (cf. smallFileThreshold,
# cmd/xl-storage.go:59).
SMALL_FILE_THRESHOLD = 128 * 1024

_STATS_MU = threading.Lock()
_STATS = {"vectored_writes": 0, "vectored_write_bytes": 0}


def stats() -> dict:
    """The vectored writes of every drive in the process (the JAX
    package records them as DATA_PATH's zerocopy_vectored_writes)."""
    with _STATS_MU:
        return dict(_STATS)


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
        if not os.path.isdir(p):
            raise ErrVolumeNotFound(vol)
        return p

    def _ensure_parent_in_vol(self, vol: str, p: str) -> None:
        """mkdir the parent of `p`, re-validating the volume when the
        chain is missing so a deleted bucket is never recreated."""
        d = os.path.dirname(p)
        try:
            os.mkdir(d)
        except FileExistsError:
            pass
        except FileNotFoundError:
            self._check_vol(vol)
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
        if os.path.isdir(p):
            raise ErrVolumeExists(vol)
        os.makedirs(p)

    def list_volumes(self) -> list[str]:
        """The drive's volumes (buckets), sorted; the system volume and
        other dot-names are not volumes."""
        return [name for name in sorted(os.listdir(self.root))
                if not name.startswith(".")
                and os.path.isdir(os.path.join(self.root, name))]

    def stat_volume(self, vol: str) -> dict:
        p = self._check_vol(vol)
        return {"name": vol, "created_ns": int(os.stat(p).st_mtime_ns)}

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
                "endpoint": self.root, "id": self.disk_id, "online": True}

    # -- small files ---------------------------------------------------------

    def write_all(self, vol: str, path: str, data: bytes) -> None:
        """Atomic small-file write (tmp + fsync + rename)."""
        self._check_vol(vol)
        p = self._file_path(vol, path)
        self._ensure_parent_in_vol(vol, p)
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR,
                           f"wa-{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def read_all(self, vol: str, path: str) -> bytes:
        p = self._file_path(vol, path)
        try:
            with open(p, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            raise ErrFileNotFound(f"{vol}/{path}") from None
        except PermissionError:
            raise ErrFileAccessDenied(f"{vol}/{path}") from None

    def delete(self, vol: str, path: str, recursive: bool = False) -> None:
        p = self._file_path(vol, path)
        if not os.path.exists(p):
            raise ErrFileNotFound(f"{vol}/{path}")
        if os.path.isdir(p):
            if not recursive:
                raise ErrFileAccessDenied(f"{vol}/{path} is a directory")
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
        with open(p, "ab") as f:
            f.write(buf)
            f.flush()
            diskio.write_done(f.fileno(), len(buf))

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
        with _STATS_MU:
            _STATS["vectored_writes"] += 1
            _STATS["vectored_write_bytes"] += total

    def read_file(self, vol: str, path: str, offset: int = 0,
                  length: int = -1) -> bytes:
        p = self._file_path(vol, path)
        try:
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
        os.replace(src, dst)

    def file_size(self, vol: str, path: str) -> int:
        p = self._file_path(vol, path)
        try:
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
            return sorted(os.listdir(p))
        except (FileNotFoundError, NotADirectoryError):
            raise ErrPathNotFound(f"{vol}/{path}") from None

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
            with open(p, "wb") as f:
                f.write(meta.to_bytes())
            return
        self.write_all(vol, os.path.join(obj, XL_META_FILE), meta.to_bytes())

    def read_version(self, vol: str, obj: str,
                     version_id: str = "") -> FileInfo:
        """One version's FileInfo (inline data included when present)."""
        self._check_vol(vol)
        return self._read_xlmeta(vol, obj).get(version_id, vol, obj)

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
            os.replace(path, trash)
        except FileNotFoundError:
            return
        shutil.rmtree(trash, ignore_errors=True)

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

        Returns the counts.  `meta_journal` is always 0: the drive's
        group-commit metadata journal and its replay
        (`replay_meta_journal`) come with the metadata lanes, ROADMAP
        Queue A item 7; until then nothing writes the journal.
        """
        counts = {"tmp_entries": 0, "mp_stage": 0, "meta_journal": 0}
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
