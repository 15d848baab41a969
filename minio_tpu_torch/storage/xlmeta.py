"""Copy of minio_tpu/storage/xlmeta.py: the port keeps its own, so that it imports
nothing of the JAX package.

Versioned per-object metadata — the xl.meta equivalent.

Mirrors the reference's xl.meta v2 design (reference cmd/
xl-storage-format-v2.go:257): one small file per object holding an ordered
array of versions (objects and delete markers), each with its erasure
geometry, per-part stats, user metadata, and optionally the object bytes
inline (small objects, reference cmd/xl-storage.go:59).

On-disk layout: ``b"XLM1" + <crc32 payload, 4B BE> + msgpack(payload)``.
The checksum serves the same role as the xxhash trailer in the reference
(reference cmd/xl-storage-format-v2.go:719): detect torn/corrupt
metadata before trusting it.

Versions are kept sorted by (mod_time, version_id) descending — newest
first — matching the reference's sort invariant so "latest version" is
versions[0].
"""

from __future__ import annotations

import binascii
import struct
import uuid
from dataclasses import dataclass, field

from ..utils import msgpackx
from .errors import ErrFileCorrupt, ErrFileVersionNotFound

XL_MAGIC = b"XLM1"       # legacy: crc32 (4B BE) integrity
XL_MAGIC2 = b"XLM2"      # current: xxhash64 (8B BE) integrity

try:                     # resolved once; read AND write key off the same flag
    import xxhash as _xxhash
except ImportError:      # pragma: no cover — baked into the target env
    _xxhash = None

# Version types (cf. VersionType in xl-storage-format-v2.go).
VT_OBJECT = 1
VT_DELETE_MARKER = 2

ERASURE_ALGO = "rs-vandermonde"  # ours; reference: "rs-vandermonde" ReedSolo
# The null (unversioned) version is stored with id ""; clients address it
# as "null" (S3 semantics; cf. nullVersionID in the reference).
NULL_VERSION_ID = ""
NULL_VERSION_ALIAS = "null"


def normalize_version_id(version_id: str) -> str:
    return NULL_VERSION_ID if version_id == NULL_VERSION_ALIAS else version_id


def new_uuid() -> str:
    return str(uuid.uuid4())


@dataclass
class ObjectPartInfo:
    """One part of an object (cf. ObjectPartInfo, erasure-metadata.go)."""
    number: int
    size: int            # stored (on-wire) size
    actual_size: int     # pre-compression/encryption size
    etag: str = ""

    def to_obj(self) -> dict:
        return {"n": self.number, "s": self.size, "as": self.actual_size,
                "e": self.etag}

    @classmethod
    def from_obj(cls, d: dict) -> "ObjectPartInfo":
        return cls(number=d["n"], size=d["s"], actual_size=d["as"],
                   etag=d.get("e", ""))


@dataclass
class ErasureInfo:
    """Erasure geometry + per-part bitrot checksums for one drive's copy
    (cf. ErasureInfo, reference cmd/xl-storage-format-v1.go)."""
    data_blocks: int
    parity_blocks: int
    block_size: int
    index: int                      # 1-based shard index on this drive
    distribution: list[int]         # shard index per drive position
    algorithm: str = ERASURE_ALGO
    # Streaming bitrot: one entry per part, hash empty (hashes interleaved
    # in the shard file frames), cf. ChecksumInfo / HighwayHash256S.
    checksums: list[dict] = field(default_factory=list)

    @property
    def shard_size(self) -> int:
        return -(-self.block_size // self.data_blocks)

    def bitrot_algo(self, part_number: int = 1) -> str:
        """Bitrot algorithm recorded for a part (cf. ChecksumInfo lookup,
        reference cmd/erasure-metadata.go GetChecksumInfo). Metadata
        from before per-object recording defaults to HighwayHash256S."""
        for c in self.checksums:
            if c.get("part") == part_number:
                return c.get("algo", "highwayhash256S")
        if self.checksums:
            return self.checksums[0].get("algo", "highwayhash256S")
        return "highwayhash256S"

    def shard_file_size(self, total_length: int) -> int:
        if total_length <= 0:
            return 0
        num_blocks = total_length // self.block_size
        last = total_length % self.block_size
        return (num_blocks * self.shard_size
                + -(-last // self.data_blocks))

    def to_obj(self) -> dict:
        return {"algo": self.algorithm, "k": self.data_blocks,
                "m": self.parity_blocks, "bs": self.block_size,
                "idx": self.index, "dist": list(self.distribution),
                "cs": self.checksums}

    @classmethod
    def from_obj(cls, d: dict) -> "ErasureInfo":
        return cls(data_blocks=d["k"], parity_blocks=d["m"],
                   block_size=d["bs"], index=d["idx"],
                   distribution=list(d["dist"]), algorithm=d.get("algo", ERASURE_ALGO),
                   checksums=d.get("cs", []))


@dataclass
class FileInfo:
    """One object version as seen by the engine and the storage layer
    (cf. FileInfo, reference cmd/storage-datatypes.go)."""
    volume: str = ""
    name: str = ""
    version_id: str = NULL_VERSION_ID
    data_dir: str = ""
    mod_time_ns: int = 0
    size: int = 0
    deleted: bool = False            # delete marker
    metadata: dict = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)
    erasure: ErasureInfo | None = None
    inline_data: bytes | None = None
    is_latest: bool = True
    # Successor mod time for delete-marker expiry decisions (ILM).
    num_versions: int = 0

    @property
    def etag(self) -> str:
        return self.metadata.get("etag", "")

    def to_obj(self) -> dict:
        d = {
            "type": VT_DELETE_MARKER if self.deleted else VT_OBJECT,
            "id": self.version_id,
            "dd": self.data_dir,
            "mt": self.mod_time_ns,
            "size": self.size,
            "meta": dict(self.metadata),
        }
        if self.parts:
            d["parts"] = [p.to_obj() for p in self.parts]
        if self.erasure is not None:
            d["ec"] = self.erasure.to_obj()
        if self.inline_data is not None:
            d["inline"] = self.inline_data
        return d

    @classmethod
    def from_obj(cls, d: dict, volume: str = "", name: str = "") -> "FileInfo":
        return cls(
            volume=volume, name=name,
            version_id=d.get("id", NULL_VERSION_ID),
            data_dir=d.get("dd", ""),
            mod_time_ns=d.get("mt", 0),
            size=d.get("size", 0),
            deleted=d.get("type") == VT_DELETE_MARKER,
            metadata=dict(d.get("meta", {})),
            parts=[ObjectPartInfo.from_obj(p) for p in d.get("parts", [])],
            erasure=ErasureInfo.from_obj(d["ec"]) if "ec" in d else None,
            inline_data=d.get("inline"),
        )

    def uses_data_dir(self) -> bool:
        return not self.deleted and self.inline_data is None and bool(self.data_dir)


class XLMeta:
    """The versions container serialized to the xl.meta file."""

    def __init__(self, versions: list[dict] | None = None):
        # Raw version dicts, newest first.
        self.versions: list[dict] = versions or []

    # -- serialization -------------------------------------------------------

    def to_bytes(self) -> bytes:
        """New writes use XLM2: xxhash64 integrity trailer-in-header
        (the reference's choice for multi-MB inline-data metadata blobs,
        cmd/xl-storage-format-v2.go:719 — CRC32 at 4 bytes is weak
        there).  XLM1 (crc32) stays readable."""
        payload = msgpackx.packb({"v": 1, "versions": self.versions})
        if _xxhash is not None:
            digest = _xxhash.xxh64(payload).intdigest()
            return XL_MAGIC2 + struct.pack(">Q", digest) + payload
        crc = binascii.crc32(payload) & 0xFFFFFFFF
        return XL_MAGIC + struct.pack(">I", crc) + payload

    @classmethod
    def from_bytes(cls, buf: bytes) -> "XLMeta":
        if len(buf) >= 12 and buf[:4] == XL_MAGIC2:
            if _xxhash is None:
                # Environment lost the module after XLM2 was written:
                # a typed storage error keeps quorum accounting sane.
                raise ErrFileCorrupt(
                    "xl.meta is XLM2 but xxhash is unavailable")
            want = struct.unpack(">Q", buf[4:12])[0]
            payload = buf[12:]
            if _xxhash.xxh64(payload).intdigest() != want:
                raise ErrFileCorrupt("xl.meta checksum mismatch")
        elif len(buf) >= 8 and buf[:4] == XL_MAGIC:
            # legacy rounds 1-3 format
            crc = struct.unpack(">I", buf[4:8])[0]
            payload = buf[8:]
            if binascii.crc32(payload) & 0xFFFFFFFF != crc:
                raise ErrFileCorrupt("xl.meta checksum mismatch")
        else:
            raise ErrFileCorrupt("bad xl.meta header")
        try:
            obj = msgpackx.unpackb(payload)
        except msgpackx.MsgpackError as e:
            raise ErrFileCorrupt(f"xl.meta decode: {e}") from e
        if not isinstance(obj, dict) or "versions" not in obj:
            raise ErrFileCorrupt("xl.meta missing versions")
        return cls(list(obj["versions"]))

    # -- version ops (cf. AddVersion/DeleteVersion state machine,
    #    xl-storage-format-v2.go:813,1132) --------------------------------

    def _sort(self) -> None:
        self.versions.sort(key=lambda v: (v.get("mt", 0), v.get("id", "")),
                           reverse=True)

    def add_version(self, fi: FileInfo) -> None:
        """Insert or replace the version with fi.version_id."""
        self.versions = [v for v in self.versions
                         if v.get("id") != fi.version_id]
        self.versions.append(fi.to_obj())
        self._sort()

    def find_version(self, version_id: str) -> dict:
        version_id = normalize_version_id(version_id)
        for v in self.versions:
            if v.get("id", NULL_VERSION_ID) == version_id:
                return v
        raise ErrFileVersionNotFound(version_id or "null")

    def delete_version(self, version_id: str) -> str:
        """Remove a version; returns its data_dir ('' if none/shared)."""
        v = self.find_version(version_id)
        self.versions.remove(v)
        dd = v.get("dd", "")
        if dd and any(u.get("dd") == dd for u in self.versions):
            return ""  # still referenced by another version
        return dd

    def latest(self, volume: str = "", name: str = "") -> FileInfo:
        if not self.versions:
            raise ErrFileVersionNotFound("empty")
        fi = FileInfo.from_obj(self.versions[0], volume, name)
        fi.is_latest = True
        fi.num_versions = len(self.versions)
        return fi

    def get(self, version_id: str, volume: str = "", name: str = "") -> FileInfo:
        """Empty version_id = latest (S3 GET without versionId); the null
        version is addressed explicitly as "null"."""
        if version_id == "":
            return self.latest(volume, name)
        version_id = normalize_version_id(version_id)
        v = self.find_version(version_id)
        fi = FileInfo.from_obj(v, volume, name)
        fi.is_latest = self.versions and self.versions[0] is v
        fi.num_versions = len(self.versions)
        return fi

    def list_versions(self, volume: str = "", name: str = "") -> list[FileInfo]:
        out = []
        for i, v in enumerate(self.versions):
            fi = FileInfo.from_obj(v, volume, name)
            fi.is_latest = i == 0
            fi.num_versions = len(self.versions)
            out.append(fi)
        return out

    @property
    def data_dirs(self) -> set[str]:
        return {v["dd"] for v in self.versions if v.get("dd")}
