"""Copy of minio_tpu/server/extract.py: the port keeps its own, so that it imports
nothing of the JAX package.

Snowball auto-extract (tar PUT) and serving files inside zip objects.

- PUT with `X-Amz-Meta-Snowball-Auto-Extract: true` and a tar body
  explodes the archive into individual objects under the key prefix
  (cf. PutObjectExtract / untar, cmd/untar.go:100). gzip/bzip2/xz tars
  are handled by tarfile transparently.
- GET with `x-minio-extract: true` on `bucket/archive.zip/inner/path`
  serves the zip member without extracting the whole archive
  (cf. cmd/s3-zip-handlers.go).
"""

from __future__ import annotations

import io
import tarfile
import zipfile

from .api_errors import S3Error

SNOWBALL_HEADER = "x-amz-meta-snowball-auto-extract"
ZIP_EXTRACT_HEADER = "x-minio-extract"


def is_snowball_put(headers: dict) -> bool:
    h = {k.lower(): v for k, v in headers.items()}
    return h.get(SNOWBALL_HEADER, "").lower() == "true"


def extract_tar(body: bytes, key_prefix: str):
    """Yield (key, data, metadata) per regular tar member."""
    try:
        tf = tarfile.open(fileobj=io.BytesIO(body), mode="r:*")
    except tarfile.TarError:
        raise S3Error("MalformedXML", "body is not a tar archive") from None
    with tf:
        for member in tf:
            if not member.isreg():
                continue
            name = member.name
            # Path-escape guard BEFORE any normalization: absolute paths
            # and any '..' component are dropped, matching untar.go's
            # sanitization.
            if (not name or name.startswith("/")
                    or ".." in name.split("/")):
                continue
            while name.startswith("./"):
                name = name[2:]
            if not name:
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            key = f"{key_prefix.rstrip('/')}/{name}" if key_prefix \
                else name
            yield key, f.read(), {}


def is_zip_extract_get(headers: dict) -> bool:
    h = {k.lower(): v for k, v in headers.items()}
    return h.get(ZIP_EXTRACT_HEADER, "").lower() == "true"


def split_zip_path(key: str) -> tuple[str, str] | None:
    """'a/b.zip/inner/x' -> ('a/b.zip', 'inner/x')."""
    low = key.lower()
    idx = low.find(".zip/")
    if idx < 0:
        return None
    return key[:idx + 4], key[idx + 5:]


def read_zip_member(zip_bytes: bytes, member: str) -> bytes:
    try:
        with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
            try:
                return zf.read(member)
            except KeyError:
                raise S3Error("NoSuchKey",
                              f"no such member {member!r}") from None
    except zipfile.BadZipFile:
        raise S3Error("InvalidRequest", "object is not a zip") from None


def list_zip_members(zip_bytes: bytes) -> list[str]:
    try:
        with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
            return [i.filename for i in zf.infolist()
                    if not i.is_dir()]
    except zipfile.BadZipFile:
        raise S3Error("InvalidRequest", "object is not a zip") from None
