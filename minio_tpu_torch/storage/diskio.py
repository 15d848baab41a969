"""Page-cache policy for bulk shard IO (the internal/disk + O_DIRECT role).

Counterpart of minio_tpu/storage/diskio.py.  The reference opens shard
files O_DIRECT with aligned buffers and fdatasync
(cmd/xl-storage.go:1424,1533; internal/disk) so object bytes do not
double-buffer through the page cache.

Modes (MTPU_ODIRECT, a config knob like the reference's
MINIO_DRIVE_SYNC):
  - "fadvise" (default): buffered IO + POSIX_FADV_DONTNEED after bulk
    transfers;
  - "direct": O_DIRECT aligned reads for bulk data (page-aligned scratch
    leased from ops/bpool.py), O_DIRECT vectored writes when aligned
    (storage/drive.write_file_batches); falls back to buffered when
    alignment or the filesystem refuses (tmpfs refuses O_DIRECT);
  - "off": plain buffered IO.

MTPU_OSYNC=on fdatasyncs bulk writes (default off, as the reference only
fsyncs under MINIO_FS_OSYNC; durability otherwise comes from the write
quorum).
"""

from __future__ import annotations

import os

ALIGN = 4096
BULK = 128 * 1024          # below this, cache behaviour is irrelevant


def mode() -> str:
    m = os.environ.get("MTPU_ODIRECT", "fadvise")
    return m if m in ("off", "fadvise", "direct") else "fadvise"


def osync() -> bool:
    return os.environ.get("MTPU_OSYNC", "off") == "on"


def drop_cache(fd: int) -> None:
    """Advise the kernel to evict this file's pages (post-IO)."""
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    except (AttributeError, OSError):
        pass


def read_range(path: str, offset: int, length: int) -> bytes:
    """Read [offset, offset+length) (length < 0 = to EOF) in the
    configured cache mode.  Raises FileNotFoundError/IsADirectoryError
    like open()."""
    m = mode()
    if length < 0:
        length = max(os.path.getsize(path) - offset, 0)
    if m == "direct" and length >= BULK:
        data = _direct_read(path, offset, length)
        if data is not None:
            return data
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        data = f.read(length)
        if m != "off" and length >= BULK:
            drop_cache(f.fileno())
        return data


def _direct_read(path: str, offset: int, length: int) -> bytes | None:
    """O_DIRECT read into page-aligned scratch leased from the buffer
    pool; None -> the caller reads buffered (unsupported fs, EINVAL)."""
    if not hasattr(os, "O_DIRECT"):
        return None
    a_off = offset & ~(ALIGN - 1)
    a_end = (offset + length + ALIGN - 1) & ~(ALIGN - 1)
    need = a_end - a_off
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError:
        return None
    try:
        from ..ops import bpool
        with bpool.default_pool().get(need) as buf:
            view = memoryview(buf)
            os.lseek(fd, a_off, os.SEEK_SET)
            got = 0
            while got < need:
                with view[got:] as window:
                    n = os.readv(fd, [window])
                if n <= 0:
                    break              # EOF (file shorter than aligned end)
                got += n
            lo = offset - a_off
            hi = min(lo + length, got)
            return b"" if hi <= lo else bytes(view[lo:hi])
    except OSError:
        return None
    finally:
        os.close(fd)


def write_done(fd: int, nbytes: int) -> bool:
    """Post-write policy for bulk shard writes.  Dirty pages cannot be
    evicted, so a bulk write is synced before its cache is dropped.
    Returns True when the durability policy is satisfied (callers then
    skip their own fsync), which includes osync() off, where no sync is
    wanted."""
    if not osync():
        return True
    if mode() != "off" and nbytes >= BULK:
        try:
            os.fdatasync(fd)
        except OSError:
            return False
        drop_cache(fd)
        return True
    return False
