"""Transparent object compression with incompressibility detection.

The port of minio_tpu/utils/compress.py (the cmd/object-api-utils.go:442,
903 role: isCompressible + newS2CompressReader): an object whose key
extension and content type pass the filter is compressed before erasure
coding, unless a 64 KiB probe does not shrink by 5% (media that is
already compressed).  The codec is DEFLATE, zlib at level 1, where the
reference uses S2; the metadata keys are the JAX package's, so either
package stores the same bytes and reads the other's.
"""

from __future__ import annotations

import zlib

META_COMPRESSION = "x-mtpu-internal-compression"
META_ACTUAL_SIZE = "x-mtpu-internal-uncompressed-size"

# Extensions/content-types that are already compressed (skip list,
# cf. standardExcludeCompressExtensions).
EXCLUDE_EXT = {".gz", ".bz2", ".zst", ".zip", ".7z", ".rar", ".xz",
               ".mp4", ".mkv", ".mov", ".jpg", ".jpeg", ".png", ".gif",
               ".webp", ".mp3", ".aac", ".ogg"}
EXCLUDE_TYPES = ("video/", "audio/", "image/",
                 "application/zip", "application/x-gzip",
                 "application/zstd")

PROBE_SIZE = 64 * 1024
MIN_SIZE = 4 * 1024        # too small to be worth it


def is_compressible(key: str, content_type: str = "",
                    size: int = 0) -> bool:
    if size and size < MIN_SIZE:
        return False
    dot = key.rfind(".")
    if dot >= 0 and key[dot:].lower() in EXCLUDE_EXT:
        return False
    return not any(content_type.startswith(t) for t in EXCLUDE_TYPES)


def compress(data: bytes) -> tuple[bytes, dict]:
    """-> (possibly-compressed bytes, metadata updates)."""
    # Probe: if a sample doesn't shrink ~5%, store raw (the reference's
    # incompressible passthrough keeps >2 GiB/s by not trying).
    probe = data[:PROBE_SIZE]
    if len(zlib.compress(probe, 1)) > len(probe) * 0.95:
        return data, {}
    out = zlib.compress(data, 1)
    if len(out) >= len(data):
        return data, {}
    return out, {META_COMPRESSION: "deflate",
                 META_ACTUAL_SIZE: str(len(data))}


def decompress(data: bytes, metadata: dict) -> bytes:
    if metadata.get(META_COMPRESSION) != "deflate":
        return data
    return zlib.decompress(data)


def is_compressed(metadata: dict) -> bool:
    return META_COMPRESSION in metadata


def actual_size(metadata: dict, stored_size: int) -> int:
    if is_compressed(metadata):
        return int(metadata.get(META_ACTUAL_SIZE, stored_size))
    return stored_size
