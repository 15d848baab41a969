"""Page-cache policy for bulk shard IO (the internal/disk role).

The subset of minio_tpu/storage/diskio.py's default mode that the local
drive uses: buffered IO, then POSIX_FADV_DONTNEED after bulk transfers,
so object bytes do not linger in the page cache.  MTPU_OSYNC=on
fdatasyncs bulk writes (default off, as the reference only fsyncs under
MINIO_FS_OSYNC; durability otherwise comes from the write quorum).
"""

from __future__ import annotations

import os

BULK = 128 * 1024          # below this, cache behaviour is irrelevant


def osync() -> bool:
    return os.environ.get("MTPU_OSYNC", "off") == "on"


def drop_cache(fd: int) -> None:
    """Advise the kernel to evict this file's pages (post-IO)."""
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    except (AttributeError, OSError):
        pass


def read_range(path: str, offset: int, length: int) -> bytes:
    """Read [offset, offset+length) (length < 0 = to EOF).  Raises
    FileNotFoundError/IsADirectoryError like open()."""
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        data = f.read() if length < 0 else f.read(length)
        if len(data) >= BULK:
            drop_cache(f.fileno())
        return data


def write_done(fd: int, nbytes: int) -> bool:
    """Post-write policy for bulk shard writes.  Returns True when the
    durability policy is satisfied (callers then skip their own fsync),
    which includes osync() off, where no sync is wanted."""
    if not osync():
        return True
    if nbytes >= BULK:
        try:
            os.fdatasync(fd)
        except OSError:
            return False
        drop_cache(fd)
        return True
    return False
