"""Remote tiers: warm backends, transitions, restore, the tier journal.

The port's copy of minio_tpu/bucket/tier.py (cmd/tier*.go,
cmd/warm-backend-*.go, cmd/tier-journal.go): named tiers map to warm
backends (a remote S3 endpoint, a directory, or an object layer); a
lifecycle transition moves a version's bytes to its tier and leaves a
stub version whose metadata records (tier, tier key, size, digest); GETs
stream through the stub from the tier; a restore copies the bytes back,
for good or, with `x-amz-restore` semantics, for some days, after which
the scanner drops the hot copy again.

The bytes a transition moves come off the engine's verified read
(`ServerPools.get_object_iter`): bitrot verify on the card, and the GF
decode when shards are missing.  A restore and a pool tier write through
the engine's PUT: GF encode and digests on the card.  This module itself
imports no torch.

Durability: every transition appends an *intent* record to an fsynced
JSONL journal before any byte moves and a *done* record once the stub is
published; every delete of a transitioned version appends a *free*
record before the remote delete.  Boot replay folds the journal and
resolves each pending intent exactly once: a kill -9 anywhere in the
window leaves the whole hot version or a valid stub and tier object,
never a tier object no record will reap.  Crash points: `ilm.{pre_stub,
post_copy,pre_delete,checkpoint}` (utils/crashpoints.py).  The records
and the stub's metadata keys are the JAX package's, byte for byte, so
either package serves the other's stubs and replays its journal.

Where the port differs: one journal serves every process that opens the
drives (the worker pool's workers, a restarted server).  Each append and
each compaction holds an flock on `<journal>.lock`, a compaction folds
the FILE (every process's records) rather than its own memory, an
append reopens the journal when a compaction replaced it, and an intent
names its process (`owner`), so no process reaps the copy of a
transition another live process is running.  In the JAX package each
worker compacts its own fold over the shared file and drops the other
workers' pending records.  A tier registered in one process is found by
another from the persisted configs (`get_tier` reloads them on a miss;
`on_change` lets the worker pool tell the others at once).

Memory: transitions, read-through and restores stream in bounded chunks
(MTPU_ILM_CHUNK_MB, default 8 MiB), but `S3TierBackend.put_stream`
buffers the whole object for its single PUT, as in the JAX package.

Env knobs (the JAX package's, with its defaults):
  MTPU_ILM             1; 0 = oracle, the scanner never tiers
  MTPU_ILM_WORKERS     transition worker lanes (2)
  MTPU_ILM_CHUNK_MB    streaming chunk size (8)
  MTPU_ILM_FSYNC       1 fsyncs each journal append
  MTPU_ILM_CKPT_EVERY  journal appends between compactions (256)
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import threading
import time
import uuid

from ..storage.drive import SYS_VOL
from ..storage.errors import (ErrFileNotFound, ErrObjectNotFound,
                              ErrVolumeNotFound, StorageError)
from ..utils.crashpoints import crash_point

TIER_NAME_KEY = "x-mtpu-internal-tier"
TIER_OBJ_KEY = "x-mtpu-internal-tier-key"
TIER_SIZE_KEY = "x-mtpu-internal-tier-size"
TIER_DIGEST_KEY = "x-mtpu-internal-tier-digest"
TIER_TIME_KEY = "x-mtpu-internal-tier-time"
RESTORE_EXPIRY_KEY = "x-mtpu-internal-restore-expiry"

_TIER_META_KEYS = (TIER_NAME_KEY, TIER_OBJ_KEY, TIER_SIZE_KEY,
                   TIER_DIGEST_KEY, TIER_TIME_KEY, RESTORE_EXPIRY_KEY)

# Pre-JSONL whole-JSON delete journal (adopted once at boot).
JOURNAL_PATH = "tier/journal.json"
JOURNAL_FILE = "tier-journal.jsonl"


class ErrTierUnavailable(StorageError):
    """The warm backend failed mid-operation: retryable, 503."""


class ErrRestoreInProgress(StorageError):
    """A restore of this version is already running: 409."""


def ilm_enabled() -> bool:
    return os.environ.get("MTPU_ILM", "1") != "0"


def ilm_workers() -> int:
    try:
        return max(1, int(os.environ.get("MTPU_ILM_WORKERS", "2")))
    except ValueError:
        return 2


def _chunk_bytes() -> int:
    try:
        mb = float(os.environ.get("MTPU_ILM_CHUNK_MB", "8"))
    except ValueError:
        mb = 8.0
    return max(1 << 16, int(mb * (1 << 20)))


def _first_root(pools) -> str | None:
    """The first local drive root of the stack (the decommission
    journal's home-drive rule); None when every drive is remote.  A
    remote drive's root names its peer: it is no directory here."""
    for p in getattr(pools, "pools", [pools]):
        for es in getattr(p, "sets", [p]):
            for d in getattr(es, "drives", []):
                root = getattr(d, "root", None)
                if d is not None and root and os.path.isdir(root):
                    return root
    return None


def default_journal_path(pools) -> str | None:
    root = _first_root(pools)
    return os.path.join(root, SYS_VOL, JOURNAL_FILE) if root else None


def _proc_start(pid: int) -> str | None:
    """A process's start time in clock ticks since boot (field 22 of
    /proc/<pid>/stat), None when it does not exist."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return None
    # The command name (field 2) may hold spaces: split after its ')'.
    return stat[stat.rfind(b")") + 2:].split()[19].decode()


def _owner_token() -> str:
    """`<pid>:<start ticks>` of this process: a pid a later process
    reuses does not pass for the one that wrote the record."""
    pid = os.getpid()
    return f"{pid}:{_proc_start(pid) or 0}"


def _owner_alive(token) -> bool:
    """Is the process that wrote an intent alive, and not this one?"""
    if not token or token == _owner_token():
        return False
    pid, _, start = str(token).partition(":")
    try:
        return _proc_start(int(pid)) == start
    except ValueError:
        return False


def _rechunk(chunks, limit: int | None = None):
    """Re-slice a chunk stream to MTPU_ILM_CHUNK_MB pieces: the engine
    yields whole device batches, the backends see bounded ones."""
    limit = limit or _chunk_bytes()
    for piece in chunks:
        view = memoryview(piece)
        for off in range(0, len(view), limit):
            yield bytes(view[off:off + limit])


class _ChunkReader:
    """File-like `.read(n)` over a chunk iterator, for the engine's
    streaming PUT.  A short stream RAISES instead of ending early, so
    the PUT aborts and the stub stays whole."""

    def __init__(self, chunks, expect_size: int | None = None):
        self._it = iter(chunks)
        self._buf = bytearray()
        self._n = 0
        self._expect = expect_size
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            try:
                piece = next(self._it)
            except StopIteration:
                self._eof = True
                if self._expect is not None and self._n != self._expect:
                    raise ErrTierUnavailable(
                        f"tier stream truncated: got {self._n} of "
                        f"{self._expect} bytes") from None
                break
            piece = memoryview(piece).cast("B")  # engine chunks: arrays
            self._buf += piece
            self._n += len(piece)
        if n < 0:
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out


class DirTierBackend:
    """Warm backend over a local directory (a NAS tier).  Writes are
    atomic (tmp, fsync, rename); a filesystem error other than ENOENT is
    ErrTierUnavailable: the tier is down, not the object missing."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def put(self, key: str, data: bytes) -> None:
        self.put_stream(key, (data,))

    def put_stream(self, key: str, chunks) -> int:
        path = self._p(key)
        tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        n = 0
        try:
            try:
                with open(tmp, "wb") as f:
                    for piece in chunks:
                        f.write(piece)
                        n += len(piece)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except OSError as e:
                raise ErrTierUnavailable(f"tier write {key}: {e}") from None
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    def get(self, key: str) -> bytes:
        return b"".join(self.get_stream(key))

    def get_stream(self, key: str, offset: int = 0, length: int = -1):
        path = self._p(key)
        chunk = _chunk_bytes()
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            raise ErrObjectNotFound(f"tier object {key}") from None
        except OSError as e:
            raise ErrTierUnavailable(f"tier read {key}: {e}") from None

        def gen():
            with f:
                try:
                    if offset:
                        f.seek(offset)
                    left = length if length is not None and length >= 0 \
                        else None
                    while left is None or left > 0:
                        want = chunk if left is None else min(chunk, left)
                        piece = f.read(want)
                        if not piece:
                            break
                        if left is not None:
                            left -= len(piece)
                        yield piece
                except OSError as e:
                    raise ErrTierUnavailable(
                        f"tier read {key}: {e}") from None
        return gen()

    def size(self, key: str) -> int:
        try:
            return os.stat(self._p(key)).st_size
        except FileNotFoundError:
            raise ErrObjectNotFound(f"tier object {key}") from None
        except OSError as e:
            raise ErrTierUnavailable(f"tier stat {key}: {e}") from None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._p(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise ErrTierUnavailable(f"tier delete {key}: {e}") from None


class S3TierBackend:
    """Warm backend over a remote S3 endpoint (warm-backend-s3): reads
    stream through ranged GETs; a write is one PUT of the whole object,
    buffered (the client has no multipart writer here)."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 bucket: str, prefix: str = "tier/"):
        from ..server.client import S3Client
        self.cli = S3Client(endpoint, access_key, secret_key)
        self.bucket = bucket
        self.prefix = prefix

    def _err(self, e, key: str) -> StorageError:
        if getattr(e, "status", 0) == 404:
            return ErrObjectNotFound(f"tier object {key}")
        return ErrTierUnavailable(f"tier s3 {key}: {e}")

    def put(self, key: str, data: bytes) -> None:
        from ..server.client import S3ClientError
        try:
            self.cli.put_object(self.bucket, self.prefix + key, data)
        except (S3ClientError, OSError) as e:
            raise self._err(e, key) from None

    def put_stream(self, key: str, chunks) -> int:
        data = b"".join(chunks)
        self.put(key, data)
        return len(data)

    def get(self, key: str) -> bytes:
        from ..server.client import S3ClientError
        try:
            return self.cli.get_object(self.bucket, self.prefix + key)
        except (S3ClientError, OSError) as e:
            raise self._err(e, key) from None

    def get_stream(self, key: str, offset: int = 0, length: int = -1):
        from ..server.client import S3ClientError
        total = self.size(key)
        end = total if (length is None or length < 0) \
            else min(total, offset + length)

        def gen():
            pos = offset
            chunk = _chunk_bytes()
            while pos < end:
                hi = min(end, pos + chunk) - 1
                try:
                    piece = self.cli.get_object(
                        self.bucket, self.prefix + key, range_=(pos, hi))
                except (S3ClientError, OSError) as e:
                    raise self._err(e, key) from None
                if not piece:
                    break
                yield piece
                pos += len(piece)
        return gen()

    def size(self, key: str) -> int:
        from ..server.client import S3ClientError
        try:
            h = self.cli.head_object(self.bucket, self.prefix + key)
        except (S3ClientError, OSError) as e:
            raise self._err(e, key) from None
        items = h.items() if hasattr(h, "items") else h
        for hk, hv in items:
            if str(hk).lower() == "content-length":
                return int(hv)
        return len(self.get(key))

    def delete(self, key: str) -> None:
        from ..server.client import S3ClientError
        try:
            self.cli.delete_object(self.bucket, self.prefix + key)
        except (S3ClientError, OSError) as e:
            if getattr(e, "status", 0) != 404:
                raise ErrTierUnavailable(f"tier s3 {key}: {e}") from None


class PoolTierBackend:
    """Warm backend over another object layer (the MinIO-to-MinIO warm
    backend, cmd/warm-backend-minio.go): the cold bytes live in one
    bucket of that layer, erasure-coded and bitrot-verified there."""

    TIER_BUCKET = "mtpu-tier"

    def __init__(self, layer, bucket: str | None = None):
        self.layer = layer
        self.bucket = bucket or self.TIER_BUCKET
        try:
            self.layer.make_bucket(self.bucket)
        except StorageError:
            pass                         # already exists

    def put(self, key: str, data: bytes) -> None:
        self.put_stream(key, (data,))

    def put_stream(self, key: str, chunks) -> int:
        try:
            fi = self.layer.put_object(self.bucket, key,
                                       _ChunkReader(chunks), metadata={})
        except ErrTierUnavailable:
            raise
        except StorageError as e:
            raise ErrTierUnavailable(f"pool tier write {key}: {e}") \
                from None
        return fi.size

    def get(self, key: str) -> bytes:
        return b"".join(self.get_stream(key))

    def get_stream(self, key: str, offset: int = 0, length: int = -1):
        try:
            _, it = self.layer.get_object_iter(self.bucket, key, offset,
                                               length)
            return it
        except ErrObjectNotFound:
            raise
        except StorageError as e:
            raise ErrTierUnavailable(f"pool tier read {key}: {e}") \
                from None

    def size(self, key: str) -> int:
        try:
            return self.layer.head_object(self.bucket, key).size
        except ErrObjectNotFound:
            raise
        except StorageError as e:
            raise ErrTierUnavailable(f"pool tier stat {key}: {e}") \
                from None

    def delete(self, key: str) -> None:
        try:
            self.layer.delete_object(self.bucket, key)
        except ErrObjectNotFound:
            pass
        except StorageError as e:
            raise ErrTierUnavailable(f"pool tier delete {key}: {e}") \
                from None


class ChaosTierBackend:
    """Seeded faults and latency around any backend (storage/chaos.py's
    discipline): one RNG draw per fault class per call, always, so the
    schedule is a function of (seed, call order) and replays exactly."""

    def __init__(self, backend, seed: int = 0, error_rate: float = 0.0,
                 slow_rate: float = 0.0, slow_s: float = 0.02):
        import random
        self.backend = backend
        self.error_rate = error_rate
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.injected = {"errors": 0, "slows": 0}
        self._rng = random.Random(seed)
        self._mu = threading.Lock()

    @property
    def root(self):
        return getattr(self.backend, "root", None)

    def chaos_off(self) -> None:
        self.error_rate = self.slow_rate = 0.0

    def _weather(self, op: str) -> None:
        with self._mu:
            err, slow = self._rng.random(), self._rng.random()
        if slow < self.slow_rate:
            self.injected["slows"] += 1
            time.sleep(self.slow_s)
        if err < self.error_rate:
            self.injected["errors"] += 1
            raise ErrTierUnavailable(f"chaos: injected tier fault ({op})")

    def put(self, key, data):
        self._weather("put")
        return self.backend.put(key, data)

    def put_stream(self, key, chunks):
        self._weather("put")
        return self.backend.put_stream(key, chunks)

    def get(self, key):
        self._weather("get")
        return self.backend.get(key)

    def get_stream(self, key, offset=0, length=-1):
        self._weather("get")             # eager: fail before streaming
        return self.backend.get_stream(key, offset, length)

    def size(self, key):
        self._weather("size")
        return self.backend.size(key)

    def delete(self, key):
        self._weather("delete")
        return self.backend.delete(key)


class TierJournal:
    """The crash-replayable fsynced JSONL journal of transitions and tier
    deletes (cmd/tier-journal.go).

    Records, folded to net state:
      {"op":"intent","tkey",...}  transition begun: a tier copy MAY exist
      {"op":"done","tkey"}        transition resolved (stub or rollback)
      {"op":"free","tier","tkey"} tier object awaiting its remote delete
      {"op":"freed","tkey"}       remote delete confirmed
      {"op":"ckpt",...}           compaction (tmp, fsync, replace)

    A torn last line (a kill -9 mid-append) is skipped.  An OSError on
    append degrades to memory only (replay re-derives from the
    namespace).  Every process that opens the drives shares the file:
    appends and compactions hold `<path>.lock` (flock, on a descriptor
    opened for the hold: a fork inherits none, a dead holder's lock dies
    with it), `refresh` folds what every process wrote, and a compaction
    writes that fold."""

    def __init__(self, path: str | None, fsync: bool | None = None,
                 ckpt_every: int | None = None):
        self.path = path
        self._fsync = (os.environ.get("MTPU_ILM_FSYNC", "1") != "0"
                       if fsync is None else fsync)
        if ckpt_every is None:
            try:
                ckpt_every = int(os.environ.get("MTPU_ILM_CKPT_EVERY",
                                                "256"))
            except ValueError:
                ckpt_every = 256
        self.ckpt_every = max(1, ckpt_every)
        self._mu = threading.Lock()
        self._jf = None
        self._since_ckpt = 0
        self.intents: dict[str, dict] = {}
        self.frees: dict[str, dict] = {}
        self.torn_lines = 0
        if self.path:
            self._load()

    @contextlib.contextmanager
    def _held(self):
        """This process's lock, then the file lock of every process."""
        with self._mu:
            fd = None
            if self.path:
                try:
                    os.makedirs(os.path.dirname(self.path), exist_ok=True)
                    fd = os.open(self.path + ".lock",
                                 os.O_RDWR | os.O_CREAT, 0o644)
                    fcntl.flock(fd, fcntl.LOCK_EX)
                except OSError:
                    if fd is not None:
                        os.close(fd)
                    fd = None
            try:
                yield
            finally:
                if fd is not None:
                    os.close(fd)         # drops the flock

    def _load(self) -> None:
        self.intents, self.frees, self.torn_lines = {}, {}, 0
        try:
            f = open(self.path, "r", encoding="utf-8")
        except OSError:
            return
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    self.torn_lines += 1
                    continue
                self._fold(rec)

    def _fold(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "intent":
            self.intents[rec["tkey"]] = rec
        elif op == "done":
            self.intents.pop(rec.get("tkey"), None)
        elif op == "free":
            self.frees[rec["tkey"]] = rec
        elif op == "freed":
            self.frees.pop(rec.get("tkey"), None)
        elif op == "ckpt":
            self.intents = {r["tkey"]: r for r in rec.get("intents", [])}
            self.frees = {r["tkey"]: r for r in rec.get("frees", [])}

    def _append_locked(self, rec: dict) -> None:
        if not self.path:
            return
        try:
            if self._jf is not None:
                # Another process's compaction replaced the file: append
                # to the new one.
                try:
                    same = (os.fstat(self._jf.fileno()).st_ino
                            == os.stat(self.path).st_ino)
                except OSError:
                    same = False
                if not same:
                    self._jf.close()
                    self._jf = None
            if self._jf is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._jf = open(self.path, "a", encoding="utf-8")
            self._jf.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._jf.flush()
            if self._fsync:
                os.fsync(self._jf.fileno())
        except OSError:
            self._jf = None

    def record(self, rec: dict) -> None:
        """Fold into memory AND durably append, before the caller goes
        on (write-ahead)."""
        with self._held():
            self._fold(rec)
            self._append_locked(rec)
            self._since_ckpt += 1
            if self._since_ckpt >= self.ckpt_every:
                self._checkpoint_locked()

    def refresh(self) -> None:
        """Fold the file again: every process's records."""
        if not self.path:
            return
        with self._held():
            self._load()

    def snapshot(self) -> tuple[list, list]:
        """(intents, frees) as (tkey, record) pairs, from the file."""
        self.refresh()
        with self._mu:
            return list(self.intents.items()), list(self.frees.items())

    def checkpoint(self) -> None:
        with self._held():
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        self._since_ckpt = 0
        if not self.path:
            return
        self._load()
        rec = {"op": "ckpt",
               "intents": list(self.intents.values()),
               "frees": list(self.frees.values())}
        tmp = self.path + ".tmp"
        try:
            if self._jf is not None:
                self._jf.close()
                self._jf = None
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            pass

    def pending(self) -> int:
        self.refresh()
        with self._mu:
            return len(self.intents) + len(self.frees)

    def close(self) -> None:
        with self._mu:
            if self._jf is not None:
                self._jf.close()
                self._jf = None


class TierManager:
    """Tier registry, transitions, read-through, restore and the journal's
    replay (the TierConfigMgr and transition worker roles).  `kms`
    (crypto/kms.py, default from MTPU_KMS_SECRET_KEY) seals persisted
    configs that carry credentials; without one they are refused."""

    def __init__(self, pools, kms=None, journal_path: str | None = None):
        self.pools = pools
        if kms is None:
            from ..crypto.kms import kms_from_env
            kms = kms_from_env()
        self.kms = kms
        self._mu = threading.Lock()      # tier registry + config RMW
        self._smu = threading.Lock()     # counters + in-flight guards
        self._tiers: dict[str, object] = {}
        self._persisted: set[str] = set()         # names from the configs
        self._inflight: set[str] = set()          # tkeys mid-transition
        self._restoring: set[tuple] = set()       # (bucket, key, vid)
        #: called after a registration persists or goes (the worker
        #: pool bumps its config generation there)
        self.on_change = None
        self.counters = {
            "transitioned": 0, "transition_bytes": 0,
            "transition_errors": 0,
            "restored": 0, "restore_bytes": 0, "restore_errors": 0,
            "restore_expired": 0,
            "read_through": 0, "read_through_bytes": 0,
            "freed": 0, "orphans_reaped": 0, "replayed": 0,
        }
        self.per_tier: dict[str, dict] = {}       # TIER -> objects/bytes
        self.journal = TierJournal(
            journal_path if journal_path is not None
            else default_journal_path(pools))
        self._adopt_legacy_journal()
        # The persisted tiers first (transitioned objects survive a
        # restart), then whatever the journal says a crash left undone.
        self.load_persisted_tiers()
        self.replay_boot()

    # -- registry ------------------------------------------------------------

    TIER_CONFIG_PATH = "tier/config.json"

    def add_tier(self, name: str, backend, config: dict | None = None,
                 replace: bool = False) -> None:
        """Register a warm tier.  A duplicate is refused unless `replace`
        (swapping a live tier's backend orphans its objects); `config`
        (a JSON-able dict) persists the registration."""
        key = name.upper()
        with self._mu:
            if key in self._tiers and not replace:
                raise ValueError(f"tier {name!r} already exists")
            if config is not None:
                with self.journal._held():
                    self._persist_config(key, config)
                self._persisted.add(key)
            self._tiers[key] = backend
        if config is not None:
            self._changed()

    def remove_tier(self, name: str) -> bool:
        """Unregister a tier; refused while the journal holds its work."""
        key = name.upper()
        intents, frees = self.journal.snapshot()
        if any(r.get("tier") == key for _, r in intents + frees):
            raise ValueError(
                f"tier {name!r} has pending journal work; drain first")
        with self._mu:
            if key not in self._tiers:
                return False
            del self._tiers[key]
            self._persisted.discard(key)
            with self.journal._held():
                configs = self._load_configs(strict=True)
                if key in configs:
                    del configs[key]
                    self._persist_configs(configs)
        self._changed()
        return True

    def _changed(self) -> None:
        if self.on_change is not None:
            self.on_change()

    _SECRET_FIELDS = ("accessKey", "secretKey", "sessionToken")

    def _persist_config(self, name: str, config: dict) -> None:
        # strict: a blob that exists but cannot be read must abort the
        # read-modify-write, or the other tiers' registrations go.
        configs = self._load_configs(strict=True)
        configs[name] = config
        self._persist_configs(configs)

    def _persist_configs(self, configs: dict) -> None:
        # Credentials are sealed with the KMS (cmd/tier.go
        # saveTierConfig) and never written in the clear.
        has_secrets = any(c.get(f) for c in configs.values()
                          for f in self._SECRET_FIELDS)
        if self.kms is not None:
            from ..crypto.kms import seal_with_kms
            blob = json.dumps(seal_with_kms(
                self.kms, json.dumps(configs).encode(),
                b"tier-config")).encode()
        elif has_secrets:
            raise StorageError(
                "refusing to persist tier credentials unencrypted: "
                "configure a KMS (MTPU_KMS_SECRET_KEY)")
        else:
            blob = json.dumps(configs).encode()
        self._write_sys(self.TIER_CONFIG_PATH, blob)

    def _load_configs(self, strict: bool = False) -> dict:
        """The persisted config map, unsealed.  strict=True raises
        StorageError instead of {} whenever an existing blob might still
        be recoverable (sealed without a KMS, unsealable, unparseable,
        unreadable); only an absent file is {}."""
        from ..crypto.kms import is_sealed_doc, unseal_with_kms
        try:
            raw = self._read_sys(self.TIER_CONFIG_PATH, strict=strict)
            if not raw:
                return {}
            doc = json.loads(raw)
        except StorageError:
            raise
        except Exception:  # noqa: BLE001
            if strict:
                raise StorageError(
                    "tier config exists but does not parse; refusing "
                    "to overwrite it") from None
            return {}
        if is_sealed_doc(doc):
            if self.kms is None:
                if strict:
                    raise StorageError(
                        "tier config is sealed but no KMS is "
                        "configured; refusing to overwrite it")
                return {}
            try:
                return json.loads(
                    unseal_with_kms(self.kms, doc, b"tier-config"))
            except Exception:  # noqa: BLE001
                if strict:
                    raise StorageError(
                        "tier config cannot be unsealed with the "
                        "configured KMS key; refusing to overwrite "
                        "it") from None
                return {}
        return doc if isinstance(doc, dict) else {}

    def backend_for(self, cfg: dict):
        """The backend a persisted config describes (None for an unknown
        type)."""
        kind = cfg.get("type", "fs")
        if kind == "fs":
            return DirTierBackend(cfg["path"])
        if kind == "s3":
            return S3TierBackend(cfg["endpoint"], cfg["accessKey"],
                                 cfg["secretKey"], cfg["bucket"])
        if kind == "pool":
            # The cold bucket on this deployment's own object layer.
            return PoolTierBackend(self.pools, cfg.get("bucket"))
        return None

    def load_persisted_tiers(self) -> list[str]:
        """(Re)build the backends the persisted configs name, and drop
        the ones loaded from a config another process removed."""
        try:
            configs = self._load_configs(strict=True)
            complete = True
        except StorageError:
            configs = self._load_configs()
            complete = False
        loaded = []
        for name, cfg in configs.items():
            try:
                backend = self.backend_for(cfg)
            except (KeyError, OSError):
                continue
            if backend is None:
                continue
            with self._mu:
                self._tiers[name] = backend
                self._persisted.add(name)
            loaded.append(name)
        if complete:
            with self._mu:
                for name in self._persisted - set(configs):
                    self._tiers.pop(name, None)
                self._persisted &= set(configs)
        return loaded

    def get_tier(self, name: str):
        key = name.upper()
        with self._mu:
            backend = self._tiers.get(key)
        if backend is None:
            # Another process may have registered it since: read the
            # persisted configs once before refusing.
            self.load_persisted_tiers()
            with self._mu:
                backend = self._tiers.get(key)
        if backend is None:
            raise StorageError(f"unknown tier {name!r}")
        return backend

    def list_tiers(self) -> list[str]:
        with self._mu:
            return sorted(self._tiers)

    # -- counters ------------------------------------------------------------

    def _bump(self, name: str, n: int = 1) -> None:
        with self._smu:
            self.counters[name] = self.counters.get(name, 0) + n

    def _tier_acct(self, tier: str, dobj: int, dbytes: int) -> None:
        with self._smu:
            t = self.per_tier.setdefault(tier.upper(),
                                         {"objects": 0, "bytes": 0})
            t["objects"] = max(0, t["objects"] + dobj)
            t["bytes"] = max(0, t["bytes"] + dbytes)

    def stats(self) -> dict:
        with self._smu:
            out = dict(self.counters)
            out["tiers"] = {t: dict(v) for t, v in self.per_tier.items()}
        out["journal_pending"] = self.journal.pending()
        out["names"] = self.list_tiers()
        out["enabled"] = ilm_enabled()
        out["workers"] = ilm_workers()
        return out

    def _mark_dirty(self, bucket: str) -> None:
        """Bump every set's generation of `bucket`: the hot tier and the
        FileInfo cache must not serve what a replay resolved past them
        (the engine's own PUT and DELETE bump it themselves)."""
        for p in getattr(self.pools, "pools", [self.pools]):
            for es in getattr(p, "sets", [p]):
                md = getattr(es, "_mark_dirty", None)
                if md is not None:
                    try:
                        md(bucket)
                    except Exception:  # noqa: BLE001
                        pass

    # -- transition ----------------------------------------------------------

    def _get_iter(self, bucket: str, key: str, version_id: str = ""):
        """(fi, chunks) through the engine's verified read: bitrot
        verify on the card, the GF decode for missing shards."""
        return self.pools.get_object_iter(bucket, key,
                                          version_id=version_id)

    def transition_object(self, bucket: str, key: str, tier: str,
                          version_id: str = "") -> bool:
        """Move a version's bytes to the tier and leave a stub
        (TransitionObject, cmd/erasure-object.go:1556): journal the
        intent (fsync), stream the copy, verify it by digest, publish
        the stub IN PLACE (same version id, mod time + 1, so a newer
        client write wins), journal done.  A crash in the window is
        resolved by boot replay; a tier failure leaves the intent for
        drain_journal to reap."""
        backend = self.get_tier(tier)
        fi, chunks = self._get_iter(bucket, key, version_id)
        if self.is_transitioned(fi):
            return False
        if fi.size == 0:
            return False                 # stubs are zero-byte already
        tkey = f"{bucket}/{uuid.uuid4().hex}"
        with self._smu:
            self._inflight.add(tkey)
        try:
            self.journal.record({
                "op": "intent", "tkey": tkey, "tier": tier.upper(),
                "bucket": bucket, "key": key,
                "vid": fi.version_id or "", "size": fi.size,
                "owner": _owner_token()})
            crash_point("ilm.pre_stub")
            digest = hashlib.blake2b(digest_size=16)
            copied = {"n": 0}

            def hashed():
                for piece in _rechunk(chunks):
                    digest.update(piece)
                    copied["n"] += len(piece)
                    yield piece

            try:
                backend.put_stream(tkey, hashed())
                # Verify the tier copy before the hot bytes go.
                vh = hashlib.blake2b(digest_size=16)
                vn = 0
                for piece in backend.get_stream(tkey):
                    vh.update(piece)
                    vn += len(piece)
                if vn != copied["n"] or vh.digest() != digest.digest():
                    raise ErrTierUnavailable(
                        f"tier {tier}: copy verify failed for "
                        f"{bucket}/{key} ({vn} vs {copied['n']} bytes)")
            except StorageError:
                self._bump("transition_errors")
                raise                    # the intent stays: drain reaps
            crash_point("ilm.post_copy")
            meta = dict(fi.metadata)
            meta[TIER_NAME_KEY] = tier.upper()
            meta[TIER_OBJ_KEY] = tkey
            meta[TIER_SIZE_KEY] = str(copied["n"])
            meta[TIER_DIGEST_KEY] = digest.hexdigest()
            meta[TIER_TIME_KEY] = str(time.time())
            new = self.pools.put_object(
                bucket, key, b"", metadata=meta,
                versioned=bool(fi.version_id),
                version_id=fi.version_id or None,
                mod_time_ns=fi.mod_time_ns + 1)
            if new.metadata.get(TIER_OBJ_KEY) != tkey:
                # A racing client write won the slot: the tier copy is
                # garbage.  A failed reap leaves the intent to drain.
                try:
                    backend.delete(tkey)
                    self.journal.record({"op": "done", "tkey": tkey})
                except StorageError:
                    pass
                return False
            crash_point("ilm.checkpoint")
            self.journal.record({"op": "done", "tkey": tkey})
            self._bump("transitioned")
            self._bump("transition_bytes", copied["n"])
            self._tier_acct(tier, +1, copied["n"])
            return True
        finally:
            with self._smu:
                self._inflight.discard(tkey)

    # -- read-through / restore ----------------------------------------------

    def is_transitioned(self, fi) -> bool:
        return bool(fi.metadata.get(TIER_NAME_KEY))

    def restore_fresh(self, fi, now: float | None = None) -> bool:
        """A live temporary restore: the stub carries the whole body
        (size > 0) and its window has not passed, so it is served hot."""
        if not self.is_transitioned(fi) or fi.size == 0:
            return False
        exp = fi.metadata.get(RESTORE_EXPIRY_KEY)
        if not exp:
            return True
        try:
            return float(exp) > (time.time() if now is None else now)
        except ValueError:
            return False

    def restore_expiry(self, fi) -> float | None:
        exp = fi.metadata.get(RESTORE_EXPIRY_KEY)
        try:
            return float(exp) if exp else None
        except ValueError:
            return None

    def read_through_iter(self, fi, offset: int = 0, length: int = -1):
        """A transitioned version's bytes from its tier, in bounded
        chunks.  A whole read checks the digest at the end and raises on
        a mismatch (a ranged read cannot; the backend's own integrity
        applies)."""
        backend = self.get_tier(fi.metadata[TIER_NAME_KEY])
        tkey = fi.metadata[TIER_OBJ_KEY]
        expect = fi.metadata.get(TIER_DIGEST_KEY)
        size = int(fi.metadata.get(TIER_SIZE_KEY, "0") or 0)
        self._bump("read_through")
        full = offset == 0 and (length is None or length < 0
                                or length >= size)
        stream = backend.get_stream(tkey, offset, length)

        def gen():
            h = hashlib.blake2b(digest_size=16) \
                if (full and expect) else None
            n = 0
            for piece in stream:
                if h is not None:
                    h.update(piece)
                n += len(piece)
                yield piece
            if h is not None and (n != size
                                  or h.hexdigest() != expect):
                raise ErrTierUnavailable(
                    f"tier object {tkey}: digest verify failed "
                    f"({n} of {size} bytes)")
            self._bump("read_through_bytes", n)
        return gen()

    def read_through(self, fi) -> bytes:
        return b"".join(self.read_through_iter(fi))

    def restore_object(self, bucket: str, key: str,
                       version_id: str = "",
                       days: float | None = None) -> bool:
        """Copy a tiered version back (PostRestoreObject).  days=None is
        permanent: the tier keys go and the tier object is freed through
        the journal.  days=N is temporary: the stub keeps its pointers,
        gains an expiry the scanner honours, and the body comes back
        hot.  False when the version is not transitioned (the caller's
        InvalidObjectState); a concurrent restore of it raises
        ErrRestoreInProgress."""
        fi = self.pools.head_object(bucket, key, version_id)
        if not self.is_transitioned(fi):
            return False
        rkey = (bucket, key, fi.version_id or "")
        with self._smu:
            if rkey in self._restoring:
                raise ErrRestoreInProgress(
                    f"restore of {bucket}/{key} already in progress")
            self._restoring.add(rkey)
        try:
            tier = fi.metadata[TIER_NAME_KEY]
            tkey = fi.metadata[TIER_OBJ_KEY]
            size = int(fi.metadata.get(TIER_SIZE_KEY, "0") or 0)
            if days is None:
                meta = {k: v for k, v in fi.metadata.items()
                        if k not in _TIER_META_KEYS}
            else:
                meta = dict(fi.metadata)
                meta[RESTORE_EXPIRY_KEY] = str(time.time()
                                               + days * 86400.0)
            reader = _ChunkReader(self.read_through_iter(fi),
                                  expect_size=size)
            try:
                new = self.pools.put_object(
                    bucket, key, reader, metadata=meta,
                    versioned=bool(fi.version_id),
                    version_id=fi.version_id or None,
                    mod_time_ns=fi.mod_time_ns + 1)
            except StorageError:
                self._bump("restore_errors")
                raise
            if new.mod_time_ns != fi.mod_time_ns + 1:
                # A client write superseded the stub; its overwrite
                # freed the tier object.
                return True
            self._bump("restored")
            self._bump("restore_bytes", size)
            if days is None:
                self.enqueue_delete(tier, tkey, size)
                self.drain_journal()
            return True
        finally:
            with self._smu:
                self._restoring.discard(rkey)

    def expire_restores(self, bucket: str,
                        now: float | None = None) -> int:
        """Scanner hook: a temporary restore whose window passed is
        rewritten as an empty stub (pointers kept), and the next GET
        reads from the tier again."""
        now = time.time() if now is None else now
        try:
            infos = self.pools.list_objects(bucket, max_keys=1000000)
        except StorageError:
            return 0
        expired = 0
        for fi in infos:
            exp = fi.metadata.get(RESTORE_EXPIRY_KEY)
            if (not exp or not self.is_transitioned(fi)
                    or fi.size == 0):
                continue
            try:
                if float(exp) > now:
                    continue
            except ValueError:
                pass
            meta = dict(fi.metadata)
            meta.pop(RESTORE_EXPIRY_KEY, None)
            try:
                self.pools.put_object(
                    bucket, fi.name, b"", metadata=meta,
                    versioned=bool(fi.version_id),
                    version_id=fi.version_id or None,
                    mod_time_ns=fi.mod_time_ns + 1)
            except StorageError:
                continue
            expired += 1
            self._bump("restore_expired")
        return expired

    # -- system-volume files -------------------------------------------------

    def _write_sys(self, path: str, payload: bytes) -> None:
        for pool in getattr(self.pools, "pools", []):
            for es in getattr(pool, "sets", [pool]):
                try:
                    for d in es.drives:
                        if d is not None:
                            d.write_all(SYS_VOL, path, payload)
                    return
                except StorageError:
                    continue

    def _read_sys(self, path: str, strict: bool = False) -> bytes | None:
        """The first drive's copy, or None when none has the file.
        strict=True raises when no drive returned it but one failed with
        another error than not-found (it may exist but be unreadable)."""
        saw_real_error = False
        for pool in getattr(self.pools, "pools", []):
            for es in getattr(pool, "sets", [pool]):
                for d in es.drives:
                    if d is None:
                        continue
                    try:
                        return d.read_all(SYS_VOL, path)
                    except (ErrFileNotFound, ErrVolumeNotFound):
                        continue
                    except StorageError:
                        saw_real_error = True
                        continue
        if strict and saw_real_error:
            raise StorageError(
                f"{path}: unreadable on every drive (non-notfound "
                "errors seen); refusing to treat as absent")
        return None

    def _adopt_legacy_journal(self) -> None:
        """Adopt the pre-JSONL whole-JSON delete journal once: its
        entries become `free` records."""
        try:
            raw = self._read_sys(JOURNAL_PATH)
            entries = json.loads(raw) if raw else []
        except Exception:  # noqa: BLE001
            entries = []
        if not isinstance(entries, list) or not entries:
            return
        for e in entries:
            try:
                self.journal.record({"op": "free",
                                     "tier": str(e["tier"]).upper(),
                                     "tkey": e["key"]})
            except (KeyError, TypeError):
                continue
        self._write_sys(JOURNAL_PATH, b"[]")

    # -- journal replay / drain ----------------------------------------------

    def replay_boot(self) -> dict:
        """Resolve what a crash left half-done, once: a pending intent
        whose stub published rolls FORWARD; one whose stub never did
        means the hot version is whole and the tier copy (if any) is an
        orphan: reap it.  Pending frees retry their delete.  Ends with a
        compaction."""
        out = {"rolled_forward": 0, "orphans_reaped": 0, "freed": 0}
        intents, _ = self.journal.snapshot()
        for tkey, rec in intents:
            res = self._resolve_intent(tkey, rec)
            if res == "forward":
                out["rolled_forward"] += 1
            elif res == "reaped":
                out["orphans_reaped"] += 1
        out["freed"] = self._drain_frees()
        replayed = sum(out.values())
        if replayed:
            self._bump("replayed", replayed)
            self.journal.checkpoint()
        return out

    def _resolve_intent(self, tkey: str, rec: dict) -> str:
        with self._smu:
            if tkey in self._inflight:
                return "pending"         # a live transition here owns it
        if _owner_alive(rec.get("owner")):
            return "pending"             # ... or one in another process
        try:
            backend = self.get_tier(rec.get("tier", ""))
        except StorageError:
            return "pending"             # tier not registered (yet)
        bucket, key = rec.get("bucket", ""), rec.get("key", "")
        try:
            fi = self.pools.head_object(bucket, key,
                                        rec.get("vid", "") or "")
            stub_live = fi.metadata.get(TIER_OBJ_KEY) == tkey
        except StorageError:
            stub_live = False
        if stub_live:
            # The stub published before the crash: roll forward.
            self.journal.record({"op": "done", "tkey": tkey})
            self._tier_acct(rec.get("tier", ""), +1,
                            int(rec.get("size", 0) or 0))
            self._mark_dirty(bucket)
            return "forward"
        try:
            backend.delete(tkey)         # idempotent: absent is fine
        except StorageError:
            return "pending"             # tier unreachable; retry later
        self.journal.record({"op": "done", "tkey": tkey})
        self._bump("orphans_reaped")
        if bucket:
            self._mark_dirty(bucket)
        return "reaped"

    def _drain_frees(self) -> int:
        done = 0
        _, frees = self.journal.snapshot()
        for tkey, rec in frees:
            try:
                backend = self.get_tier(rec.get("tier", ""))
            except StorageError:
                continue
            crash_point("ilm.pre_delete")
            try:
                backend.delete(tkey)
            except ErrObjectNotFound:
                pass
            except StorageError:
                continue                 # stays queued; retried later
            self.journal.record({"op": "freed", "tkey": tkey})
            done += 1
            self._bump("freed")
            self._tier_acct(rec.get("tier", ""), -1,
                            -int(rec.get("size", 0) or 0))
        return done

    def enqueue_delete(self, tier: str, tier_key: str,
                       size: int = 0) -> None:
        self.journal.record({"op": "free", "tier": tier.upper(),
                             "tkey": tier_key, "size": size})

    def drain_journal(self) -> int:
        """Retry pending work: frees their remote delete, intents of
        FAILED transitions their reap.  Returns the frees completed."""
        intents, _ = self.journal.snapshot()
        for tkey, rec in intents:
            self._resolve_intent(tkey, rec)
        return self._drain_frees()

    def on_version_deleted(self, fi) -> None:
        """Hook: a transitioned version left the hot store."""
        if self.is_transitioned(fi):
            self.enqueue_delete(
                fi.metadata[TIER_NAME_KEY], fi.metadata[TIER_OBJ_KEY],
                int(fi.metadata.get(TIER_SIZE_KEY, "0") or 0))
            self.drain_journal()

    def close(self) -> None:
        self.journal.close()


def run_transitions(pools, bucket: str, lc, tier_mgr: TierManager,
                    now: float | None = None,
                    workers: int | None = None) -> int:
    """Apply a bucket's lifecycle transitions (initBackgroundTransition,
    cmd/bucket-lifecycle.go:213): the eligible versions of one listing,
    moved on MTPU_ILM_WORKERS lanes that shrink under foreground
    pressure (server/qos.scale_workers).  MTPU_ILM=0 moves nothing."""
    if not ilm_enabled():
        return 0
    from .lifecycle import _object_tags
    try:
        infos = pools.list_objects(bucket, max_keys=1000000)
    except StorageError:
        return 0
    cands: list[tuple[str, str]] = []
    for fi in infos:
        if fi.metadata.get(TIER_NAME_KEY):
            continue                     # already transitioned
        action = lc.eval(fi.name, fi.mod_time_ns,
                         tags=_object_tags(fi), now=now)
        if action.startswith("transition:"):
            cands.append((fi.name, action.split(":", 1)[1]))
    if not cands:
        return 0
    if workers is None:
        workers = ilm_workers()
    from ..server import qos as _qos
    workers = _qos.scale_workers(workers, "ilm")
    workers = max(1, min(workers, len(cands)))
    moved = [0]
    mu = threading.Lock()

    def one(item: tuple[str, str]) -> None:
        name, tier = item
        try:
            if tier_mgr.transition_object(bucket, name, tier):
                with mu:
                    moved[0] += 1
        except StorageError:
            pass                         # the journal reaps; next scan retries

    if workers == 1:
        for item in cands:
            one(item)
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="ilm") as ex:
            list(ex.map(one, cands))
    return moved[0]
