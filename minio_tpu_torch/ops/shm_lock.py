"""A fork-shared lock that survives a killed holder.

The worker pool (server/workers.py) shares three structures across its
processes: the hot tier's table (engine/hotcache.py), the slot arenas
(ops/shm_arena.py) and the admission slab (server/qos.py).  The JAX
package guards each with a ``multiprocessing`` lock, a POSIX semaphore:
a worker SIGKILLed while it holds one never posts it, and every other
worker then blocks at its next tier lookup, arena alloc or admission.

`ShmLock` is a process-shared, robust ``pthread_mutex_t`` in an
anonymous shared mapping, reached through ctypes on libc:

* When a holder dies, the kernel marks the mutex (the robust futex
  list), and the next locker gets EOWNERDEAD instead of blocking.  It
  calls ``pthread_mutex_consistent`` and then the structure's repair
  hook (`on_owner_dead`) before it goes on, still holding the lock: the
  structure is consistent again before anyone reads it.
* A ctypes call releases the GIL, so a wait blocks only its thread.
* A fork while another thread holds the mutex leaves the child seeing it
  held by that thread of the parent, which releases it as usual (a
  ``multiprocessing`` or ``threading`` lock stays held in the child).

The condition is a futex word beside the mutex: `wait` reads the word
under the mutex, unlocks, and sleeps in FUTEX_WAIT while the word is
unchanged; `notify_all` bumps it under the mutex and wakes every
sleeper.  A waiter killed in its sleep leaves nothing behind (the
kernel drops it from the futex queue), where a killed waiter of a
pthread condvar can leave the condvar's counts wrong.

The other design that fits, an OFD byte-range lock (``F_OFD_SETLK``)
under a threading lock in each process, drops the lock of a dead holder
too, but says nothing of the death (a dirty flag in the mapping must),
needs its file description reopened after every fork, and polls for a
timed wait; the robust mutex gives all three directly.
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import platform
import time

#: layout of a lock's mapping: the pthread_mutex_t (40 bytes on x86-64
#: glibc, 48 on aarch64), the futex word of the condition, the count of
#: repairs after a dead holder
_MUTEX_BYTES = 64
_SEQ_OFF = _MUTEX_BYTES
_REPAIRS_OFF = 72
_BYTES = 128

_PTHREAD_MUTEX_RECURSIVE = 1
_PTHREAD_PROCESS_SHARED = 1
_PTHREAD_MUTEX_ROBUST = 1

_FUTEX_WAIT = 0
_FUTEX_WAKE = 1
#: futex(2)'s syscall number by machine (Linux only)
_SYS_FUTEX = {"x86_64": 202, "aarch64": 98}


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


_LIBC = None


def _libc():
    """libc with the prototypes this module calls (loaded on first use,
    not at import)."""
    global _LIBC
    if _LIBC is None:
        lib = ctypes.CDLL("libc.so.6", use_errno=True)
        vp = ctypes.c_void_p
        for name, args in (
                ("pthread_mutexattr_init", [vp]),
                ("pthread_mutexattr_destroy", [vp]),
                ("pthread_mutexattr_setpshared", [vp, ctypes.c_int]),
                ("pthread_mutexattr_setrobust", [vp, ctypes.c_int]),
                ("pthread_mutexattr_settype", [vp, ctypes.c_int]),
                ("pthread_mutex_init", [vp, vp]),
                ("pthread_mutex_lock", [vp]),
                ("pthread_mutex_timedlock", [vp, ctypes.POINTER(_Timespec)]),
                ("pthread_mutex_unlock", [vp]),
                ("pthread_mutex_consistent", [vp])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.syscall.restype = ctypes.c_long
        _LIBC = lib
    return _LIBC


def _check(rc: int, what: str) -> None:
    if rc:
        raise OSError(rc, f"{what}: {errno.errorcode.get(rc, rc)}")


class ShmLock:
    """A robust, process-shared mutex with a futex condition, in its own
    anonymous shared mapping.  Create it BEFORE the fork: every process
    that inherits the object locks the same mutex.

    `recursive` lets the holding thread lock it again (the hot tier's
    nested calls).  `on_owner_dead()` runs, under the lock, whenever a
    locker finds the previous holder dead; `repairs` counts those, pool-
    wide."""

    def __init__(self, recursive: bool = False, on_owner_dead=None):
        lib = _libc()
        self._mm = mmap.mmap(-1, _BYTES)
        self._buf = (ctypes.c_char * _BYTES).from_buffer(self._mm)
        base = ctypes.addressof(self._buf)
        self._mutex = ctypes.c_void_p(base)
        self._seq = ctypes.c_uint32.from_address(base + _SEQ_OFF)
        self._repairs = ctypes.c_int64.from_address(base + _REPAIRS_OFF)
        attr = ctypes.create_string_buffer(64)
        _check(lib.pthread_mutexattr_init(attr), "mutexattr_init")
        try:
            _check(lib.pthread_mutexattr_setpshared(
                attr, _PTHREAD_PROCESS_SHARED), "setpshared")
            _check(lib.pthread_mutexattr_setrobust(
                attr, _PTHREAD_MUTEX_ROBUST), "setrobust")
            if recursive:
                _check(lib.pthread_mutexattr_settype(
                    attr, _PTHREAD_MUTEX_RECURSIVE), "settype")
            _check(lib.pthread_mutex_init(self._mutex, attr), "mutex_init")
        finally:
            lib.pthread_mutexattr_destroy(attr)
        self.on_owner_dead = on_owner_dead
        self._sys_futex = _SYS_FUTEX[platform.machine()]

    # -- the mutex -----------------------------------------------------------

    def acquire(self, timeout: float | None = None) -> bool:
        """Lock; False if `timeout` seconds pass first.  A dead holder is
        not a wait: its state is repaired (`on_owner_dead`) and the lock
        is ours."""
        lib = _libc()
        if timeout is None:
            rc = lib.pthread_mutex_lock(self._mutex)
        else:
            t = time.time() + max(0.0, timeout)
            ts = _Timespec(int(t), int((t - int(t)) * 1e9))
            rc = lib.pthread_mutex_timedlock(self._mutex, ctypes.byref(ts))
        if rc == 0:
            return True
        if rc == errno.ETIMEDOUT:
            return False
        if rc == errno.EOWNERDEAD:
            _check(lib.pthread_mutex_consistent(self._mutex), "consistent")
            self._repairs.value += 1
            if self.on_owner_dead is not None:
                try:
                    self.on_owner_dead()
                except BaseException:
                    self.release()
                    raise
            return True
        _check(rc, "pthread_mutex_lock")
        return False

    def release(self) -> None:
        _check(_libc().pthread_mutex_unlock(self._mutex),
               "pthread_mutex_unlock")

    def __enter__(self) -> "ShmLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def repairs(self) -> int:
        """Times a locker found the holder dead (across the pool)."""
        return int(self._repairs.value)

    # -- the condition -------------------------------------------------------

    def wait(self, timeout: float | None = None) -> None:
        """Release the lock (held once by this thread), sleep until a
        notify_all or `timeout`, take the lock again.  Callers re-check
        their predicate, as with any condition."""
        seq = self._seq.value
        self.release()
        try:
            ts = None
            if timeout is not None:
                t = max(0.0, timeout)
                ts = ctypes.byref(_Timespec(int(t), int((t - int(t)) * 1e9)))
            # EAGAIN (the word moved on), EINTR and ETIMEDOUT all mean: go
            # and look again.
            _libc().syscall(ctypes.c_long(self._sys_futex),
                            ctypes.byref(self._seq),
                            ctypes.c_int(_FUTEX_WAIT), ctypes.c_uint32(seq),
                            ts, None, ctypes.c_int(0))
        finally:
            self.acquire()

    def notify_all(self) -> None:
        """Wake every waiter (call with the lock held)."""
        self._seq.value = (self._seq.value + 1) & 0xFFFFFFFF
        _libc().syscall(ctypes.c_long(self._sys_futex),
                        ctypes.byref(self._seq), ctypes.c_int(_FUTEX_WAKE),
                        ctypes.c_int(0x7FFFFFFF), None, None,
                        ctypes.c_int(0))
