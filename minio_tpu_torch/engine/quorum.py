"""Copy of minio_tpu/engine/quorum.py: the port keeps its own, so that it imports
nothing of the JAX package.

Quorum primitives: error reduction, metadata election, shard placement.

These are the subtle-bug reservoir of the reference (SURVEY.md §7 hard-part
#4): reduceErrs / findFileInfoInQuorum / hashOrder, cf.
reference cmd/erasure-metadata-utils.go and cmd/erasure-metadata.go.
"""

from __future__ import annotations

import binascii

from ..storage.errors import (ErrDiskNotFound, ErrErasureReadQuorum,
                              ErrErasureWriteQuorum, ErrFileNotFound,
                              ErrFileVersionNotFound, StorageError)
from ..storage.xlmeta import FileInfo


def hash_order(key: str, cardinality: int) -> list[int]:
    """Deterministic shard rotation for an object key: returns a permutation
    of 1..cardinality (cf. hashOrder, reference cmd/erasure-metadata.go).

    distribution[i] is the 1-based shard index stored on drive position i.
    """
    if cardinality <= 0:
        return []
    crc = binascii.crc32(key.encode("utf-8")) & 0xFFFFFFFF
    start = crc % cardinality
    return [1 + (start + i) % cardinality for i in range(cardinality)]


def reduce_errs(errs: list[Exception | None],
                ignored: tuple[type, ...] = ()) -> tuple[Exception | None, int]:
    """Return (most common error, count), treating None as success.

    Errors of `ignored` types are skipped entirely (cf. reduceErrs,
    reference cmd/erasure-metadata-utils.go:116).
    """
    counts: dict[str, int] = {}
    samples: dict[str, Exception | None] = {}
    for e in errs:
        if e is not None and isinstance(e, ignored):
            continue
        key = "" if e is None else f"{type(e).__name__}:{e}"
        counts[key] = counts.get(key, 0) + 1
        samples[key] = e
    if not counts:
        return None, 0
    key = max(counts, key=lambda k: (counts[k], k == ""))
    return samples[key], counts[key]


def reduce_quorum_errs(errs: list[Exception | None], quorum: int,
                       quorum_err: StorageError,
                       ignored: tuple[type, ...] = ()) -> Exception | None:
    """The max-count error if it reaches quorum, else `quorum_err`.

    None (success) reaching quorum returns None.
    """
    err, count = reduce_errs(errs, ignored)
    if count >= quorum:
        return err
    return quorum_err


def reduce_write_quorum_errs(errs, quorum, ignored=()):
    return reduce_quorum_errs(errs, quorum, ErrErasureWriteQuorum(), ignored)


def reduce_read_quorum_errs(errs, quorum, ignored=()):
    return reduce_quorum_errs(errs, quorum, ErrErasureReadQuorum(), ignored)


def _fi_key(fi: FileInfo) -> tuple:
    """Version identity for quorum grouping: same logical write."""
    ec = fi.erasure
    return (fi.version_id, fi.mod_time_ns, fi.data_dir, fi.deleted,
            fi.size, None if ec is None else (ec.data_blocks,
                                              ec.parity_blocks))


def find_file_info_in_quorum(metas: list[FileInfo | None],
                             quorum: int) -> FileInfo:
    """Elect the version that at least `quorum` drives agree on
    (cf. findFileInfoInQuorum, reference cmd/erasure-metadata.go).

    Among agreeing groups prefers the newest mod time.
    """
    groups: dict[tuple, list[FileInfo]] = {}
    for fi in metas:
        if fi is None:
            continue
        groups.setdefault(_fi_key(fi), []).append(fi)
    best = None
    for key, group in groups.items():
        if len(group) >= quorum:
            if best is None or group[0].mod_time_ns > best[0].mod_time_ns:
                best = group
    if best is None:
        raise ErrErasureReadQuorum(
            f"no version reaches quorum {quorum} "
            f"({len([m for m in metas if m])} readable)")
    return best[0]


def object_quorum_from_meta(metas: list[FileInfo | None], n_drives: int,
                            default_parity: int) -> tuple[int, int]:
    """(read_quorum, write_quorum) from the elected metadata's parity
    (cf. objectQuorumFromMeta, reference cmd/erasure-metadata.go:339)."""
    # Most-common parity across metas (cf. commonParity in the reference):
    # with per-object parity upgrade, mixed-parity metas are an expected
    # state, and trusting the first one could legitimize a torn write.
    counts: dict[int, int] = {}
    for fi in metas:
        if fi is not None and fi.erasure is not None:
            p = fi.erasure.parity_blocks
            counts[p] = counts.get(p, 0) + 1
    parity = (max(counts, key=lambda p: counts[p]) if counts
              else default_parity)
    data = n_drives - parity
    write_quorum = data
    if data == parity:
        write_quorum += 1
    return data, write_quorum


def shuffle_by_distribution(items: list, distribution: list[int]) -> list:
    """Reorder drive-position-ordered `items` into shard-index order:
    out[shard] = items[drive holding that shard]
    (cf. shuffleDisks, reference cmd/erasure-metadata-utils.go)."""
    out = [None] * len(items)
    for drive_pos, shard_1b in enumerate(distribution):
        out[shard_1b - 1] = items[drive_pos]
    return out


def unshuffle_to_drives(shard_items: list, distribution: list[int]) -> list:
    """Inverse: out[drive_pos] = shard_items[distribution[drive_pos]-1]."""
    return [shard_items[s - 1] for s in distribution]
