"""Cross-process kernel dispatch: the remote face of ops/coalesce.py
(torch).

Counterpart of minio_tpu/ops/ipc_dispatch.py.  In the pre-fork worker
pool (server/workers.py) every HTTP worker runs the full parse, auth,
digest and drive-IO vertical, but one process, the device owner, runs
the kernels on the card through its own `DispatchCoalescer`.  This
module is the wire between them:

  worker                          owner
  ------                          -----
  RemoteCoalescer.submit(key,     serve_owner(): pop a descriptor,
    payload)                        map the arena slot without a copy,
    -> write header + payload       rebuild the kernel from the key
       into a ShmArena slot         (kernel_from_key: a coalescer key
    -> push a 64-byte descriptor    names every parameter its kernel
       on the request ring          closes over), submit to the owner's
    -> return a RemoteHandle        lanes, where items of different
                                    workers pack into one launch, then
  RemoteHandle.result()             write the result arrays back and
    <- the listener thread pops     push a descriptor on the worker's
       the response, copies the     response ring.
       arrays out, frees the slot

Nothing larger than 64 bytes is queued; shard batches cross through the
preallocated arena.  The wire is the JAX package's: `_DESC`, the status
codes, the JSON header and `_encode_arrays` / `_decode_arrays`.

Where the port differs:

- the registry rebuilds the port's keys, ("enc", k, m, algo, S), ("vt",
  k, m, sources, targets, algo, S) and ("digest", algo, S), with the
  kernels the in-process coalescer runs (engine/erasure_set.enc_kernel
  and vt_kernel, coalesce.make_digest_kernel); there is no "pf" kind and
  no host codec (the port loads nothing from native/);
- the descriptor's device field names the card (`_CPU_DEV` for the
  host), and the owner places the item on that card's lane;
- the worker owns its request slot until the response is read, and the
  owner always answers inside that slot (an answer too large for it is
  an error the engine recomputes), so a dying owner strands no arena
  space: a worker frees the slots of a dead generation once the
  supervisor has reaped it and started the next, and the owner drops
  descriptors of an older generation unread;
- request ids carry the worker's incarnation (its slot's respawn count)
  in their high half, and each worker slot records the arena slots it
  holds in a shared ledger (`plane.inflight`): a respawned worker adopts
  what its predecessor held, frees each slot when its answer comes (an
  answer that can never match one of its own ids) or when the
  generation it was sent to is gone;
- every slot is allocated with its owner, (worker slot + 1, request
  id), recorded by the arena under its own lock: a respawned worker
  frees the predecessor's slots that never reached the ledger (a worker
  killed between the alloc and the ledger row), and each party frees a
  slot only while it still carries that owner;
- an answer the owner cannot push (the worker's response ring stays
  full) frees its slot there, once; the worker's watchdog sees the slot
  gone from its owner, fails the handle (the engine recomputes the
  item) and drops its ledger row without a second free.

Ladder when the owner cannot serve (liveness first):

- arena or ring full: the item runs on the worker's own in-process
  coalescer, on the set's device (counted in `fallbacks`);
- owner heartbeat stale, or a new owner generation: every pending
  handle fails now, and its engine caller recomputes the item directly
  on the set's device; later items route locally (counted) until a new
  generation beats;
- an item the owner failed: its handle raises, and the engine's direct
  recompute serves the request.

Routing (`MTPU_IPC_DISPATCH`, ops/ipc_knobs.py): `auto` routes the three
device kinds when the submitting set is on a CUDA card; `all` routes
them whatever the device (the CPU tests); `0` never.
"""

from __future__ import annotations

import itertools
import json
import struct
import threading
import time

import numpy as np
import torch

from . import coalesce
from .ipc_knobs import alloc_timeout_s, mode
from .shm_arena import ArenaFull

#: descriptor wire format (one ipc_ring record): magic, worker_id,
#: req_id, slot_off, total_len, hdr_len, status, gen, device.  48 bytes,
#: inside the 64-byte ring record.
_DESC = struct.Struct("<IIQQQIiII")
_MAGIC = 0x4D545055            # "MTPU"

#: descriptor status codes
ST_REQ = 0                     # request (worker -> owner)
ST_OK = 0                      # response: slot holds hdr+arrays
ST_ERR = 1                     # response: slot holds {"error": ...}
ST_DROP = 2                    # response: no slot (the JAX owner's
                               # overload answer; the port's never sends it)

#: the descriptor's device field for an item on the host CPU
_CPU_DEV = 0xFFFFFFFF

#: the kinds the owner rebuilds (kernel_from_key)
KINDS = ("enc", "vt", "digest")

#: the owner's descriptor readers: several let its coalescer pack items
#: of different workers into one launch
OWNER_THREADS = 4

#: called, when set, right after a worker's arena alloc and before its
#: ledger row: tests kill a worker there
after_alloc_hook = None


def _owner_tag(wid: int, req: int) -> tuple[int, int]:
    """The arena owner of a request's slot: worker slot + 1 (0 is no
    owner) and the request id."""
    return int(wid) + 1, int(req)


def _dev_field(device) -> int:
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cpu":
        return _CPU_DEV
    return int(dev.index or 0)


def _lane_device(field: int) -> torch.device:
    if field == _CPU_DEV:
        return torch.device("cpu")
    return torch.device("cuda", int(field))


# -- kernel registry ----------------------------------------------------------

def kernel_from_key(key: tuple, device):
    """The dispatch kernel for a coalescer key, on `device`: the same one
    the in-process coalescer runs.  KeyError for a kind it does not
    know."""
    from ..engine import erasure_set
    kind = key[0]
    if kind == "digest":
        _, algo, _shard = key
        return coalesce.make_digest_kernel(str(algo), device)
    if kind == "enc":
        _, k, m, algo, _shard = key
        return erasure_set.enc_kernel(int(k), int(m), str(algo), device)
    if kind == "vt":
        _, k, m, sources, targets, algo, _shard = key
        return erasure_set.vt_kernel(int(k), int(m), tuple(sources),
                                     tuple(targets), str(algo), device)
    raise KeyError(f"no remote kernel for key kind {kind!r}")


def _key_to_json(key: tuple) -> list:
    return [list(e) if isinstance(e, (tuple, list)) else e for e in key]


def _key_from_json(items: list) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in items)


# -- result wire codec --------------------------------------------------------

def _flatten_result(kind: str, res) -> list:
    if kind == "digest":
        return [np.asarray(res)]
    a, b = res                       # enc: (parity, digests) / vt: (dg, out?)
    return [np.asarray(a), None if b is None else np.asarray(b)]


def _rebuild_result(kind: str, arrays: list):
    if kind == "digest":
        return arrays[0]
    return arrays[0], arrays[1]


def _encode_arrays(arrays: list) -> tuple[bytes, list[np.ndarray]]:
    """-> (header json bytes, arrays to copy after the header)."""
    meta = []
    payload = []
    for a in arrays:
        if a is None:
            meta.append(None)
            continue
        a = np.ascontiguousarray(a)
        meta.append({"shape": list(a.shape), "dtype": str(a.dtype)})
        payload.append(a)
    return json.dumps({"arrays": meta}).encode(), payload


def _decode_arrays(view: np.ndarray, hdr_len: int) -> list:
    meta = json.loads(bytes(view[:hdr_len]))["arrays"]
    out = []
    cur = int(hdr_len)
    for m in meta:
        if m is None:
            out.append(None)
            continue
        dt = np.dtype(m["dtype"])
        shape = tuple(m["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nb = n * dt.itemsize
        # .copy(): the slot is freed as soon as decoding returns.
        out.append(view[cur:cur + nb].view(dt).reshape(shape).copy())
        cur += nb
    return out


# -- worker side --------------------------------------------------------------

class RemoteHandle(coalesce.Handle):
    """Future for one item dispatched to the owner: a coalesce.Handle,
    which the engine takes it for, that the listener thread resolves.
    Results are copies out of the arena: nothing pooled to release."""

    __slots__ = ("_kind", "_gen")

    #: The caller's wait for the owner's answer, enqueue to answer.
    WAIT_SPAN = "ipc.wait"

    def __init__(self, kind: str, weight: int, nrows: int, gen: int):
        super().__init__(weight, nrows)
        self._kind = kind
        self._gen = gen

    def _finish(self, res=None, exc: BaseException | None = None) -> None:
        self._res = res
        self._exc = exc
        self._t_disp = time.monotonic()
        self._ev.set()


class RemoteCoalescer:
    """A worker's coalescer front end: the device kinds ship to the
    owner, everything else (and every item the owner cannot take) runs
    on the worker's own in-process DispatchCoalescer."""

    def __init__(self, plane, worker_id: int):
        self.plane = plane
        self.wid = int(worker_id)
        self.local = coalesce.DispatchCoalescer()
        self._mu = threading.Lock()
        self._pending: dict[int, RemoteHandle] = {}
        #: every arena slot this worker slot holds, by request id:
        #: (generation, offset, length, ledger row).  A slot outlives a
        #: failed handle while a dead owner may still write it: it is
        #: freed once a newer generation is up (the supervisor reaped the
        #: old one first).  plane.inflight mirrors it for a successor.
        self._slots: dict[int, tuple[int, int, int, int]] = {}
        #: ids whose payload is being copied in: not yet pending, and no
        #: sweep may free their slot
        self._filling: set[int] = set()
        self._ledger = plane.inflight[self.wid]
        self._rows: list[int] = []
        # The high half of a request id is this incarnation: an answer to
        # a predecessor's request never matches one of ours.
        inc = plane.state.respawns(self.wid) & 0x7FFFFFFF
        self._seq = itertools.count((inc << 32) + 1)
        self._listener: threading.Thread | None = None
        self._stopped = False
        #: the last owner generation seen up, and the one seen dead:
        #: routing stays local until a newer one beats (the supervisor
        #: bumps the generation before the new owner has registered).
        self._live_gen = -1
        self._dead_gen = -1
        self.remote_submits = 0
        self.remote_results = 0
        self.remote_errors = 0
        self.fallbacks = 0
        self.owner_deaths = 0
        self._adopt()

    # engine-facing surface ---------------------------------------------------

    def submit(self, key: tuple, payload, fn, weight: int | None = None,
               device=None):
        if self._routes(key, device):
            if self._remote_active():
                try:
                    return self._submit_remote(key, payload, weight, device)
                except Exception:  # noqa: BLE001 — arena/ring full, closed
                    pass
            with self._mu:
                self.fallbacks += 1
        return self.local.submit(key, payload, fn, weight, device=device)

    def hot(self, device=None) -> bool:
        # Routed digests still pack on the owner while this worker's own
        # lanes are idle.
        if self._remote_active() and mode() == "all":
            return True
        return self.local.hot(device)

    def note_read(self, delta: int, device=None) -> None:
        self.local.note_read(delta, device=device)

    def lane_stats(self) -> dict:
        return self.local.lane_stats()

    def stats(self) -> dict:
        st = self.local.stats()
        with self._mu:
            st.update({
                "remote_submits": self.remote_submits,
                "remote_results": self.remote_results,
                "remote_errors": self.remote_errors,
                "remote_fallbacks": self.fallbacks,
                "remote_pending": len(self._pending),
                "remote_owner_deaths": self.owner_deaths,
            })
        st["remote_active"] = self._remote_active()
        return st

    def close(self) -> None:
        self._stopped = True
        with self._mu:
            victims = list(self._pending.values())
            self._pending.clear()
        for h in victims:
            h._finish(exc=RuntimeError("remote coalescer closed"))
        self.local.close()

    # internals ---------------------------------------------------------------

    def _remote_active(self) -> bool:
        if mode() == "0":
            return False
        return (self.plane.owner_ok()
                and self.plane.owner_gen() != self._dead_gen)

    @staticmethod
    def _routes(key: tuple, device) -> bool:
        """Whether the mode sends this item to the owner while it is up."""
        m = mode()
        if m == "0" or key[0] not in KINDS:
            return False
        if m == "all":
            return True
        return device is not None and torch.device(device).type == "cuda"

    def _adopt(self) -> None:
        """Take over the slots a dead predecessor in this worker slot
        still held (the ledger's live rows): their answers, or the end of
        the generation they were sent to, free them."""
        for row, (req, off, total, gen) in enumerate(self._ledger.tolist()):
            if req:
                self._slots[req] = (gen, off, total, row)
            else:
                self._rows.append(row)
        # What the predecessor allocated but never recorded (it died in
        # between) goes back now: no descriptor names it.
        self.plane.arena.reclaim(self.wid + 1,
                                 keep=lambda req: req in self._slots)
        if self._slots:
            self._ensure_listener()

    def _hold(self, req: int, gen: int, off: int, total: int) -> None:
        """Record a slot (caller holds _mu).  The id goes in last: a
        worker killed mid-write leaves no row a successor would free."""
        row = self._rows.pop()
        self._slots[req] = (gen, off, total, row)
        self._ledger[row, 1:] = (off, total, gen)
        self._ledger[row, 0] = req

    def _release(self, req: int) -> None:
        """Free a held slot.  The row is cleared first: a worker killed
        between the two leaks the slot instead of handing its successor
        a slot that is already free."""
        with self._mu:
            ent = self._slots.pop(req, None)
            if ent is None:
                return
            _, off, total, row = ent
            self._ledger[row, 0] = 0
            self._rows.append(row)
        self.plane.arena.free(off, total, owner=_owner_tag(self.wid, req))

    def _submit_remote(self, key: tuple, payload, weight,
                       device) -> RemoteHandle:
        payload = np.ascontiguousarray(payload)
        nrows = int(payload.shape[0]) if payload.ndim else 1
        w = int(weight) if weight is not None else nrows
        hdr = json.dumps({
            "key": _key_to_json(key),
            "shape": list(payload.shape),
            "dtype": str(payload.dtype),
            "w": w,
        }).encode()
        total = len(hdr) + payload.nbytes
        arena = self.plane.arena
        gen = self.plane.owner_gen()
        req = next(self._seq)
        tag = _owner_tag(self.wid, req)
        # ArenaFull: the caller runs the item locally.
        off = arena.alloc(total, timeout=alloc_timeout_s(), owner=tag)
        if after_alloc_hook is not None:
            after_alloc_hook()
        with self._mu:
            if self._stopped or not self._rows:
                arena.free(off, total, owner=tag)
                raise RuntimeError("remote coalescer closed")
            self._hold(req, gen, off, total)
            self._filling.add(req)
        pending = False
        try:
            view = arena.view(off, total)
            view[:len(hdr)] = np.frombuffer(hdr, dtype=np.uint8)
            if payload.nbytes:
                view[len(hdr):] = payload.reshape(-1).view(np.uint8)
            h = RemoteHandle(key[0], w, nrows, gen)
            with self._mu:
                self._filling.discard(req)
                if self._stopped:
                    raise RuntimeError("remote coalescer closed")
                self._live_gen = gen
                self._pending[req] = h
                pending = True
                self.remote_submits += 1
            rec = _DESC.pack(_MAGIC, self.wid, req, off, total, len(hdr),
                             ST_REQ, gen & 0xFFFFFFFF, _dev_field(device))
            if not self.plane.req_ring.put(rec, timeout=1.0):
                raise ArenaFull("request ring full")
        except BaseException:
            with self._mu:
                self._filling.discard(req)
                # Not sent: the slot is this call's to free, unless the
                # watchdog already failed the handle (its sweep frees it).
                mine = not pending or self._pending.pop(req, None) is not None
                if pending and mine:
                    self.remote_submits -= 1
            if mine:
                self._release(req)
            raise
        self._ensure_listener()
        return h

    def _ensure_listener(self) -> None:
        if self._listener is None or not self._listener.is_alive():
            with self._mu:
                if self._listener is None or not self._listener.is_alive():
                    self._listener = threading.Thread(
                        target=self._listen, name="mtpu-ipc-listen",
                        daemon=True)
                    self._listener.start()

    def _listen(self) -> None:
        ring = self.plane.resp_rings[self.wid]
        checked = 0.0
        while not self._stopped:
            rec = ring.get(timeout=0.25)
            now = time.monotonic()
            if rec is None or now - checked > 0.25:
                checked = now
                self._check_owner()
            if rec is not None:
                self._on_response(rec)

    def _on_response(self, rec: bytes) -> None:
        try:
            (magic, _, req, off, total, hlen, status,
             _gen, _dev) = _DESC.unpack(rec[:_DESC.size])
        except struct.error:
            return
        if magic != _MAGIC:
            return
        arena = self.plane.arena
        with self._mu:
            h = self._pending.pop(req, None)
            held = req in self._slots
        if not held:
            return                 # not a slot of this worker slot
        try:
            if h is None:
                # A failed handle's late answer, or one to a predecessor's
                # request: only the space goes back.
                return
            if status == ST_OK:
                arrays = _decode_arrays(arena.view(off, total), hlen)
                h._finish(res=_rebuild_result(h._kind, arrays))
                with self._mu:
                    self.remote_results += 1
                return
            else:
                msg = "owner dispatch failed"
                try:
                    msg = json.loads(bytes(arena.view(off, total)[:hlen])
                                     ).get("error", msg)
                except Exception:  # noqa: BLE001 — torn header
                    pass
                h._finish(exc=RuntimeError(msg))
            with self._mu:
                self.remote_errors += 1
        except Exception as e:  # noqa: BLE001 — decode fault
            h._finish(exc=e)
        finally:
            self._release(req)

    def _check_owner(self) -> None:
        """Owner-death watchdog: a stale heartbeat fails every pending
        handle now (their engine callers recompute directly) and pins
        routing local; a new generation fails what was sent to the old
        one.  Slots of a reaped generation go back to the arena."""
        ok = self.plane.owner_ok()
        gen = self.plane.owner_gen()
        with self._mu:
            if ok and gen != self._dead_gen:
                self._live_gen = gen
            elif not ok and self._live_gen != self._dead_gen:
                self._dead_gen = self._live_gen
                self.owner_deaths += 1
            victims = [(r, h) for r, h in self._pending.items()
                       if not ok or h._gen != gen]
            for r, _ in victims:
                del self._pending[r]
            stale = ok and any(g != gen and r not in self._filling
                               for r, (g, _, _, _) in self._slots.items())
        for _, h in victims:
            h._finish(exc=RuntimeError("device owner died"))
        self._drop_undelivered()
        if not stale:
            return
        # A newer owner is up, so the old one was reaped: take in what it
        # pushed before it died, then free the slots it never answered.
        for rec in self.plane.resp_rings[self.wid].drain():
            self._on_response(rec)
        with self._mu:
            old = [r for r, (g, _, _, _) in self._slots.items()
                   if g != gen and r not in self._pending
                   and r not in self._filling]
        for r in old:
            self._release(r)

    def _drop_undelivered(self) -> None:
        """Slots the owner freed because it could not push their answers
        (the response ring stayed full): their handles fail now, and the
        ledger rows go without a second free."""
        arena = self.plane.arena
        with self._mu:
            gone = [r for r, (_, off, _, _) in self._slots.items()
                    if r not in self._filling
                    and arena.owner_of(off) != _owner_tag(self.wid, r)]
            victims = []
            for r in gone:
                _, _, _, row = self._slots.pop(r)
                self._ledger[row, 0] = 0
                self._rows.append(row)
                h = self._pending.pop(r, None)
                if h is not None:
                    victims.append(h)
                    self.remote_errors += 1
        for h in victims:
            h._finish(exc=RuntimeError("the owner could not deliver the "
                                       "answer"))


# -- owner side ---------------------------------------------------------------

def serve_owner(plane, stop, co=None,
                nthreads: int = OWNER_THREADS) -> list:
    """Run the owner service: reader threads that each pop a request
    descriptor and carry its item through submit -> result -> respond.
    Several readers are what lets the owner's coalescer pack items from
    different workers into one launch.  Returns the threads; `stop` is a
    threading.Event the caller sets to retire them."""
    co = co or coalesce.get()
    threads = []
    for i in range(nthreads):
        t = threading.Thread(target=_owner_loop, args=(plane, stop, co),
                             name=f"mtpu-ipc-owner-{i}", daemon=True)
        t.start()
        threads.append(t)
    return threads


def _owner_loop(plane, stop, co) -> None:
    while not stop.is_set():
        rec = plane.req_ring.get(timeout=0.25)
        if rec is None:
            continue
        try:
            _serve_one(plane, co, rec)
        except Exception:  # noqa: BLE001 — never kill the service loop
            pass


def _serve_one(plane, co, rec: bytes) -> None:
    try:
        (magic, wid, req, off, total, hlen, _status,
         gen, dev) = _DESC.unpack(rec[:_DESC.size])
    except struct.error:
        return
    if magic != _MAGIC:
        return
    if gen != plane.owner_gen() & 0xFFFFFFFF:
        # Sent to a dead generation: its worker failed the handle and
        # frees the slot; nothing here may touch it.
        return
    slot = (off, total)
    h = None
    try:
        view = plane.arena.view(off, total)
        meta = json.loads(bytes(view[:hlen]))
        key = _key_from_json(meta["key"])
        kind = key[0]
        shape = tuple(meta["shape"])
        payload = view[hlen:].view(np.dtype(meta["dtype"])).reshape(shape)
        device = _lane_device(dev)
        fn = kernel_from_key(key, device)
        h = co.submit(key, payload, fn, weight=meta.get("w"),
                      device=device)
        hdr, arrays = _encode_arrays(_flatten_result(
            kind, h.result(timeout=120.0)))
    except Exception as e:  # noqa: BLE001 — report, don't die
        if h is not None:
            h.release()
        _respond_error(plane, wid, req, gen, slot, e)
        return
    try:
        _respond_ok(plane, wid, req, gen, hdr, arrays, slot)
    finally:
        h.release()


def _respond_ok(plane, wid, req, gen, hdr: bytes, arrays: list[np.ndarray],
                slot: tuple[int, int]) -> None:
    """Write the answer into the request's own slot: the results are
    copies already, so the request's bytes are no longer read, and the
    worker frees the slot once it has read them."""
    arena = plane.arena
    rtotal = len(hdr) + sum(a.nbytes for a in arrays)
    off, total = slot
    cap = -(-total // arena.slot_bytes) * arena.slot_bytes
    if rtotal > cap:
        _respond_error(plane, wid, req, gen, slot, ValueError(
            f"answer of {rtotal} B exceeds its request's slot of {cap} B"))
        return
    view = arena.view(off, rtotal)
    view[:len(hdr)] = np.frombuffer(hdr, dtype=np.uint8)
    cur = len(hdr)
    for a in arrays:
        if a.nbytes:
            view[cur:cur + a.nbytes] = a.reshape(-1).view(np.uint8)
        cur += a.nbytes
    _push_resp(plane, wid, req, off, _DESC.pack(
        _MAGIC, wid, req, off, max(total, rtotal), len(hdr), ST_OK, gen, 0))


def _respond_error(plane, wid, req, gen, slot: tuple[int, int],
                   exc: BaseException) -> None:
    hdr = json.dumps({"error": f"{type(exc).__name__}: {exc}"[:400]}).encode()
    off, total = slot
    # An error header (at most ~450 bytes) always fits the request's
    # slot, which is at least one arena slot long.
    plane.arena.view(off, len(hdr))[:] = np.frombuffer(hdr, dtype=np.uint8)
    _push_resp(plane, wid, req, off, _DESC.pack(
        _MAGIC, wid, req, off, max(total, len(hdr)), len(hdr), ST_ERR, gen,
        0))


def _push_resp(plane, wid: int, req: int, off: int, rec: bytes) -> bool:
    """Push an answer; one that cannot be pushed within 2 s frees its
    slot here, once (only while the slot still carries the request's
    owner), and the worker's watchdog drops the request."""
    try:
        if plane.resp_rings[wid].put(rec, timeout=2.0):
            return True
    except Exception:  # noqa: BLE001 — ring torn down mid-shutdown
        pass
    plane.arena.free(off, 0, owner=_owner_tag(wid, req))
    return False
