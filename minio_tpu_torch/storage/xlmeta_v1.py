"""Copy of minio_tpu/storage/xlmeta_v1.py: the port keeps its own, so that it
imports nothing of the JAX package.

xl.json (xl.meta format v1) read path — legacy interop/migration.

The reference's pre-v2 per-drive metadata is a JSON document named
`xl.json` in the object directory, with part files beside it (the
"legacy" data dir): cf. xlMetaV1Object,
reference cmd/xl-storage-format-v1.go:60-145.  v1 shard files are
NOT bitrot-framed — each part carries one whole-file checksum per drive
(cmd/bitrot-whole.go), and the erasure block size is 10 MiB (blockSizeV1).

This module parses that document into the engine's FileInfo so v1
objects written by an old deployment remain readable; writes always
produce v2 (migration happens by rewrite, as in the reference's
healing-led migration)."""

from __future__ import annotations

import datetime
import json

from .errors import ErrFileCorrupt
from .xlmeta import ErasureInfo, FileInfo, ObjectPartInfo

XL_JSON = "xl.json"
V1_META_MARKER = "x-mtpu-internal-xlv1"     # flags the unframed read path


def _parse_mod_time(s: str) -> int:
    try:
        return int(datetime.datetime.fromisoformat(
            s.replace("Z", "+00:00")).timestamp() * 1e9)
    except ValueError:
        return 0


def parse_xl_json(raw: bytes, bucket: str, obj: str) -> FileInfo:
    """xl.json bytes -> FileInfo (one version; v1 had no versioning)."""
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ErrFileCorrupt(f"xl.json parse: {e}") from None
    if doc.get("format") != "xl":
        raise ErrFileCorrupt(f"xl.json format {doc.get('format')!r}")
    stat = doc.get("stat", {})
    er = doc.get("erasure", {})
    checksums = [{
        "part": i + 1,
        # v1 algorithm strings match the registry's names
        "algo": c.get("algorithm", "highwayhash256"),
        "hash": bytes.fromhex(c.get("hash", "")),
        "name": c.get("name", ""),
    } for i, c in enumerate(er.get("checksum", []))]
    ec = ErasureInfo(
        data_blocks=int(er.get("data", 0)),
        parity_blocks=int(er.get("parity", 0)),
        block_size=int(er.get("blockSize", 10 * 1024 * 1024)),
        index=int(er.get("index", 0)),
        distribution=list(er.get("distribution", [])),
        checksums=checksums)
    meta = dict(doc.get("meta", {}))
    meta[V1_META_MARKER] = "1"
    parts = [ObjectPartInfo(int(p.get("number", i + 1)),
                            int(p.get("size", 0)),
                            int(p.get("actualSize", p.get("size", 0))))
             for i, p in enumerate(doc.get("parts", []))]
    return FileInfo(
        volume=bucket, name=obj,
        version_id=doc.get("versionId", ""),
        data_dir="legacy",                  # v1 parts live beside xl.json
        mod_time_ns=_parse_mod_time(str(stat.get("modTime", ""))),
        size=int(stat.get("size", 0)),
        metadata=meta, parts=parts, erasure=ec)


def is_v1(fi: FileInfo) -> bool:
    return fi.metadata.get(V1_META_MARKER) == "1"


def make_xl_json(fi: FileInfo) -> bytes:
    """Serialize a FileInfo as a v1 document (tests/migration tooling
    only — production writes are always v2)."""
    doc = {
        "version": "1.0.3", "format": "xl",
        "stat": {"size": fi.size,
                 "modTime": datetime.datetime.fromtimestamp(
                     fi.mod_time_ns / 1e9,
                     datetime.timezone.utc).isoformat()
                 .replace("+00:00", "Z")},
        "erasure": {
            "algorithm": "klauspost/reedsolomon/vandermonde",
            "data": fi.erasure.data_blocks,
            "parity": fi.erasure.parity_blocks,
            "blockSize": fi.erasure.block_size,
            "index": fi.erasure.index,
            "distribution": list(fi.erasure.distribution),
            "checksum": [{"name": c.get("name", f"part.{c['part']}"),
                          "algorithm": c["algo"],
                          "hash": c["hash"].hex()}
                         for c in fi.erasure.checksums],
        },
        "minio": {"release": "minio_tpu"},
        "meta": {k: v for k, v in fi.metadata.items()
                 if k != V1_META_MARKER},
        "parts": [{"number": p.number, "size": p.size,
                   "actualSize": p.actual_size,
                   "name": f"part.{p.number}"} for p in fi.parts],
    }
    return json.dumps(doc).encode()
