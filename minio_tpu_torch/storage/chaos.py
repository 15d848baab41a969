"""Seeded chaos drive (counterpart of minio_tpu/storage/chaos.py):
probabilistic fault injection over NaughtyDrive.

Where NaughtyDrive is a scalpel (fail THIS method on THAT call: the
quorum-edge proofs), ChaosDrive is weather: every intercepted call rolls
a seeded RNG for intermittent errors, latency spikes and torn writes,
the fault mix of an aging disk.  The chaos tests sweep PUT, GET, ranged
GET and heal over seeds and assert what no single-fault test can: no
acknowledged write lost, clean quorum errors (never wrong bytes) under
the storm, and heal back to full width once it passes.

The per-drive fault sequence is a pure function of (seed, call order):
three draws per intercepted call, whatever the rates.  A batched
metadata call (`write_metadata_many`, `read_version_many`) is one call
and draws once; an error fails the whole batch, whose lane then retries
each item solo (each solo call drawing again).

NaughtyDrive's programming (fail/slow/offline/heal_thyself) still works:
chaos layers in front of the deterministic program, so a test can run
background weather plus one scripted fault.
"""

from __future__ import annotations

import os
import random
import threading
import time

from .errors import ErrDiskNotFound, StorageError
from .naughty import INTERCEPTED, NaughtyDrive

#: Mutating calls eligible for torn-write injection (prefix lands on
#: disk, then the call fails — the partial artifact must never become
#: visible data).  rename_data tears BETWEEN its two halves: the data
#: dir moves into place but xl.meta is never updated — the exact state
#: a kill lands between shard publishes (crash point rename.pre_meta).
#: Adding it here does NOT shift the seeded draw sequence: r_torn is
#: drawn unconditionally for every intercepted call either way.
TORN_METHODS = ("write_all", "create_file", "append_file",
                "rename_data", "write_file_batches")


class ErrChaosInjected(StorageError):
    """Marker for chaos-injected faults (distinguishable in logs)."""


class ChaosDrive(NaughtyDrive):
    """NaughtyDrive with seeded probabilistic error/latency/torn faults.

    rates are per-call probabilities; slow_s is the spike magnitude.
    `injected` counts what actually fired; `chaos_off()` stops the
    weather (the heal-convergence phase of the matrix).
    """

    def __init__(self, root: str, seed: int = 0, create: bool = True, *,
                 error_rate: float = 0.0, slow_rate: float = 0.0,
                 slow_s: float = 0.005, torn_rate: float = 0.0,
                 methods: tuple[str, ...] = INTERCEPTED):
        super().__init__(root, create=create)
        self._chaos_rng = random.Random(seed)
        self._chaos_mu = threading.Lock()
        self.seed = seed
        self.error_rate = error_rate
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.torn_rate = torn_rate
        self.injected = {"errors": 0, "slow": 0, "torn": 0}
        for name in methods:
            real = getattr(self, name, None)   # the naughty wrapper
            if real is None:
                continue
            setattr(self, name, self._chaos_wrap(name, real))

    def chaos_off(self) -> "ChaosDrive":
        """Stop injecting (rates to zero); the scripted naughty program,
        if any, keeps running."""
        with self._chaos_mu:
            self.error_rate = self.slow_rate = self.torn_rate = 0.0
        return self

    def _torn_rename_data(self, src_vol, src_dir, fi, dst_vol, dst_obj,
                          **_kw) -> None:
        """First half of rename_data only: the staged data dir moves
        into place but xl.meta is never updated — the on-disk state a
        kill leaves at crash point rename.pre_meta.  The unreferenced
        data dir must stay invisible to reads, and heal's republish of
        the SAME data_dir reclaims it."""
        if not fi.uses_data_dir():
            return               # inline version: nothing to tear
        src = self._file_path(src_vol, src_dir)
        if not os.path.isdir(src):
            return
        dst = self._file_path(dst_vol, os.path.join(dst_obj,
                                                    fi.data_dir))
        try:
            self._ensure_parent_in_vol(dst_vol, dst)
            if os.path.isdir(dst):
                self._move_to_trash(dst)
            os.replace(src, dst)
        except OSError:
            pass                 # tearing is best-effort; call fails next

    def _chaos_wrap(self, name, real):
        def chaotic(*a, **kw):
            with self._chaos_mu:
                # One draw per fault class per call keeps the sequence a
                # function of call count alone (rates don't shift it).
                r_slow = self._chaos_rng.random()
                r_torn = self._chaos_rng.random()
                r_err = self._chaos_rng.random()
                do_slow = r_slow < self.slow_rate
                do_torn = (r_torn < self.torn_rate
                           and name in TORN_METHODS)
                do_err = r_err < self.error_rate
                if do_slow:
                    self.injected["slow"] += 1
                if do_torn:
                    self.injected["torn"] += 1
                elif do_err:
                    self.injected["errors"] += 1
            if do_slow:
                time.sleep(self.slow_s)
            if do_torn:
                if name == "rename_data":
                    self._torn_rename_data(*a, **kw)
                    raise ErrChaosInjected(
                        f"chaos[{self.seed}]: torn rename_data")
                data = a[2] if len(a) >= 3 else kw.get("data", b"")
                if name == "write_file_batches":
                    # vectored appends carry a LIST of buffers: tear the
                    # flattened stream at its midpoint, still vectored.
                    data = b"".join(bytes(memoryview(b)) for b in data)
                half = bytes(memoryview(data)[:max(0, len(data) // 2)])
                try:
                    if name == "write_file_batches":
                        real(a[0], a[1], [half])
                    else:
                        real(a[0], a[1], half)
                except Exception:  # noqa: BLE001 — already failing the call
                    pass
                raise ErrChaosInjected(f"chaos[{self.seed}]: torn {name}")
            if do_err:
                raise ErrDiskNotFound(f"chaos[{self.seed}]: {name} error")
            return real(*a, **kw)
        return chaotic
