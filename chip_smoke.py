#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (minio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--hh256-baseline CU]

Phases, each printing its own lines; any failure exits non-zero:

1. The card (nvidia-smi name and power limit) and the build of both
   kernels (one nvcc per source, started together), timed, with ptxas's
   register, shared-memory and spill lines, and the packet loop of each
   HighwayHash kernel variant (aligned rows, rows at any offset) read off
   cuobjdump -sass: integer instructions per packet per thread by
   issuing pipe, per stream (times the threads that carry a stream),
   every instruction, and the opcodes (PRMT for the zipper; no byte-wise
   global load).
2. The hand-written GF(2^8) kernel against its plain PyTorch version on
   the card, bit-exact (torch.equal), at the shapes the main path gives
   it; its time (CUDA events, median, L2 flushed between runs) beside
   its bound and the plain version's time.
3. mxh256 on the card against the numpy spec at one PUT batch's shape.
4. The hand-written HighwayHash-256 kernel against its plain version
   (torch.equal) at n = 384 and L in {0, 4096, 4097, 4113, 4127}, rows
   misaligned by one byte included, at n odd (383) and n = 1, and
   against the plain version and a sample of rows of the numpy spec at
   the PUT batch (384, 131072), the GET batch (256, 131072) and a tail
   block (12, 38401), whose rows start at every offset mod 16; its time
   at those shapes and at (4224, 131072) and (16896, 131072), each with
   the SM clocks per packet, beside its bound (bytes and operations) and
   the plain version's time; and (384, 131072) with rows one byte off
   16, which takes the unaligned variant.  With --hh256-baseline, another
   build of csrc/hh256.cu is checked equal and timed against the kernel
   in turns (baseline, kernel, kernel, baseline) at each of those shapes.
5. The main paths, each with both kernels' launch counts set to 0 just
   before it and read just after, on an EC:8+4 ErasureSet over 12 drive
   directories (in /dev/shm when present):
   a. mxh256 objects: PUT, GET (MD5 and ETag), HEAD, degraded GET with
      two data-shard drives away, GET with a corrupted frame, DELETE;
   b. the same under MTPU_BITROT_ALGO=highwayhash256S, with a
      64 MiB + 300 KiB + 5 B object whose 38401-byte tail shard takes the
      remainder packet;
   c. heal: two drives wiped and reopened, heal_bucket and heal_object
      restore every part file to its recorded SHA-256, then the healed
      drives serve a GET with two other drives away;
   d. multipart: three parts under mxh256, highwayhash256S and mxh256,
      completed, read whole, ranged across a part boundary and degraded,
      then healed and read again.
6. Where one 32 MiB PUT batch's time goes, layer by layer, and the
   device's busy share over one 64 MiB PUT + GET (torch.profiler).

The line before the last is the kernels' JSON record, whose launches
are the main paths'; the last line is {"ok": true, "device": {...}}.
Without CUDA, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
# H100 SXM: 132 SMs; each SM's integer ALU pipe and its FMA pipe (which
# runs IMAD) take 64 thread-instructions a clock each, and the SM issues
# at most 128 a clock (4 schedulers x 32 threads).
SMS, PIPE_LANES = 132, 64
# 32-bit integer SASS opcodes by the pipe that runs them: the ALU pipe,
# the FMA pipe, or either (moves and VIADD, counted on whichever pipe is
# less loaded so the bound stays a lower bound).
ALU_OPS = ("LOP3", "SHF", "IADD3", "IADD", "PRMT", "LEA", "SHL", "SHR",
           "BMSK", "SGXT", "IABS", "IMNMX", "ISCADD")
FMA_OPS = ("IMAD", "IMUL")
EITHER_OPS = ("IMAD.MOV", "VIADD")
MIB = 1 << 20
OBJECT_BYTES = 64 * MIB        # BASELINE.json config 2's object size
# 64 MiB + 300 KiB + 5 B: a tail block whose shard (38401 B) is not a
# multiple of 32, so the HighwayHash remainder packet is on the path.
TAIL_OBJECT_BYTES = OBJECT_BYTES + 300 * 1024 + 5
HH = "highwayhash256S"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return float(out[0]) * 1e6


class Launches:
    """Sets to 0 and reads the launch counts of every kernel wrapper."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers

    def reset(self) -> None:
        for mod in self.wrappers.values():
            mod.LAUNCHES = 0

    def read(self) -> dict[str, int]:
        return {name: mod.LAUNCHES for name, mod in self.wrappers.items()}


def sass_packet_loop(lib, source) -> dict[str, dict]:
    """The packet loop of each HighwayHash kernel variant ("aligned",
    "unaligned"), read off `cuobjdump -sass` of its library.

    The packet loop is the function's longest backward branch; the source
    names the packets one trip hashes (kPacketsPerTrip) and the threads
    that carry a stream (kThreadsPerStream).  Per variant: "per_thread",
    the 32-bit integer instructions per packet per thread by issuing pipe
    ("alu", "fma", "either"); "all", every instruction per packet per
    thread; "ops", the count of each opcode per packet per thread;
    "threads".  Fails if the loop found holds fewer than the 4 wide
    multiplies a thread spends on a packet (then it is not the packet
    loop) or any byte-wise global load."""
    from collections import Counter

    from minio_tpu_torch.ops import cuda_build
    text = source.read_text()
    per_trip = int(re.search(r"kPacketsPerTrip = (\d+)", text).group(1))
    threads = int(re.search(r"kThreadsPerStream = (\d+)", text).group(1))
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout

    def target(t):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    def opcode(t):
        return t.split()[1] if t.startswith("@") else t.split()[0]

    result = {}
    for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        variant = next((v for v in ("aligned", "unaligned")
                        if f"hh256_{v}" in name), None)
        if variant is None:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = [(target(t), a) for a, t in ins
                 if target(t) is not None and target(t) < a]
        start, end = max(loops, key=lambda se: se[1] - se[0])
        ops = Counter(opcode(t) for a, t in ins if start <= a <= end)
        count = {"alu": 0, "fma": 0, "either": 0}
        for op, k in ops.items():
            if op.startswith(EITHER_OPS):
                count["either"] += k
            elif op.split(".")[0] in FMA_OPS:
                count["fma"] += k
            elif op.split(".")[0] in ALU_OPS:
                count["alu"] += k
        if ops["IMAD.WIDE.U32"] < 4 * per_trip:
            raise SystemExit(f"hh256 {variant}: the longest loop holds "
                             f"{ops['IMAD.WIDE.U32']} wide multiplies for "
                             f"{per_trip} packets: not the packet loop")
        byte_loads = [op for op in ops if op.startswith("LDG")
                      and ("U8" in op or "S8" in op)]
        if byte_loads:
            raise SystemExit(f"hh256 {variant}: byte-wise global loads in "
                             f"the packet loop: {byte_loads}")
        result[variant] = {
            "per_thread": {p: c / per_trip for p, c in count.items()},
            "all": sum(ops.values()) / per_trip,
            "ops": {op: k / per_trip for op, k in ops.most_common()},
            "threads": threads}
    if set(result) != {"aligned", "unaligned"}:
        raise SystemExit(f"hh256 variants not found in the SASS: {result}")
    return result


def time_ms(torch, fn, runs: int, flush) -> float:
    """Median device time of fn() over `runs` runs, L2 flushed before
    each, measured with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(b: int, c: int, r: int, s: int) -> tuple[float, str]:
    """Least time for (B, C, S) -> (B, R, S): bytes moved over HBM rate
    vs the bit-plane product's int8 operations over the int8 peak."""
    bytes_ms = (b * c * s + b * r * s) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (8 * r) * (8 * c) * s * b / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_kernel(torch, ec, et, gen, card):
    """Kernel == plain version on every case; returns its JSON record
    (without launches)."""
    dev = torch.device("cuda", 0)
    enc = et._encode_matrix_bits(8, 4)
    deg = et._transform_matrix_bits(8, 4, (2, 3, 4, 5, 6, 7, 8, 9), (0, 1))

    def rand(shape, misalign=0):
        n = 1
        for d in shape:
            n *= d
        buf = torch.randint(0, 256, (n + misalign,), dtype=torch.uint8,
                            device=dev, generator=gen)
        return buf[misalign:].view(shape)

    cases = [
        ("encode (32, 8, 131072) -> R=4", enc, 4, rand((32, 8, 131072)),
         None),
        ("degraded 2-row transform (32, 8, 131072) -> R=2", deg, 2,
         rand((32, 8, 131072)), None),
        ("one block (1, 8, 131072) -> R=4", enc, 4, rand((1, 8, 131072)),
         None),
        ("ragged S=43691, row start 1 byte off 16 (3, 8, 43691) -> R=4",
         enc, 4, rand((3, 8, 43691), misalign=1), None),
        ("salted 0x5A (4, 8, 131072) -> R=4", enc, 4, rand((4, 8, 131072)),
         0x5A),
    ]
    max_err = 0
    for name, mat, rows, x, salt in cases:
        got = ec.gf_matmul_blocks(mat, x, rows, salt=salt)
        want = et.gf_matmul_blocks_ref(mat, x, rows, salt=salt)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        ok = torch.equal(got, want)
        print(f"[kernel] {name}: kernel == plain version: {ok} "
              f"(max_abs_err {err})")
        if not ok:
            raise SystemExit(f"kernel disagrees with plain version: {name}")

    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    x = cases[0][3]
    b, c, s = x.shape
    ms = time_ms(torch, lambda: ec.gf_matmul_blocks(enc, x, 4), 30, flush)
    plain_ms = time_ms(torch, lambda: et.gf_matmul_blocks_ref(enc, x, 4),
                       20, flush)
    bound_ms, bound_by = bound(b, c, 4, s)
    xd = cases[1][3]
    deg_ms = time_ms(torch, lambda: ec.gf_matmul_blocks(deg, xd, 2), 30,
                     flush)
    deg_bound, _ = bound(b, c, 2, s)
    print(f"[kernel] encode (32, 8, 131072) -> R=4: {ms:.4f} ms median of "
          f"30 (bound {bound_ms:.4f} ms by {bound_by}, "
          f"{bound_ms / ms:.1%} of it); plain version {plain_ms:.4f} ms; "
          f"library call: none; card {card}")
    print(f"[kernel] degraded 2-row transform: {deg_ms:.4f} ms median of 30 "
          f"(bound {deg_bound:.4f} ms); card {card}")
    del flush
    return {"name": "gf_matmul", "route": "cuda",
            "source": "minio_tpu_torch/csrc/gf_matmul.cu",
            "replaces": "minio_tpu/ops/erasure_pallas.py:58",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_mxh(torch, mxhash, mt, gen, card):
    dev = torch.device("cuda", 0)
    x = torch.randint(0, 256, (12 * 32, 131072), dtype=torch.uint8,
                      device=dev, generator=gen)
    got = mt.mxh256_rows(x)
    torch.cuda.synchronize()
    want = mxhash.mxh256_batch(x.cpu().numpy())
    ok = bool((got.cpu().numpy() == want).all())
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    ms = time_ms(torch, lambda: mt.mxh256_rows(x), 10, flush)
    print(f"[mxh256] (384, 131072) on the card == numpy spec: {ok}; "
          f"float64 tree levels {ms:.4f} ms median of 10 "
          f"({x.numel() / ms / 1e6:.2f} GB/s); card {card}")
    if not ok:
        raise SystemExit("mxh256 on the card disagrees with the spec")


def hh_updates(length: int) -> int:
    """Packet updates in one stream's chain: bulk, remainder and the 10
    finalisation rounds."""
    return length // 32 + (1 if length % 32 else 0) + 10


def hh_bound(n: int, length: int, loop: dict, clock_hz: float
             ) -> tuple[float, str, float, float]:
    """Least time to hash n rows of `length` bytes: bytes moved over HBM
    rate vs the integer instructions of every packet update on the busier
    pipe, or at the SM's issue rate, whichever takes longer.  `loop` is
    one variant of sass_packet_loop: its per-thread count times the
    threads per stream is the work of one stream-packet, whatever the
    mapping.  Returns (bound ms, what bounds it, bytes ms, operations
    ms)."""
    bytes_ms = (n * length + n * 32) / HBM_BYTES_PER_S * 1e3
    c = loop["per_thread"]
    per_pipe = loop["threads"] * max(c["alu"], c["fma"], sum(c.values()) / 2)
    ops_ms = (n * hh_updates(length) * per_pipe
              / (SMS * PIPE_LANES * clock_hz) * 1e3)
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", bytes_ms, ops_ms
    return ops_ms, "operations", bytes_ms, ops_ms


def hh_launch(torch, fn, x):
    """(n, L) CUDA uint8 -> (n, 32) digests through a library's
    hh256_launch `fn` (another build of the kernel, for comparison)."""
    import numpy as np
    from minio_tpu_torch.ops.highwayhash import MAGIC_KEY
    out = torch.empty((x.shape[0], 32), dtype=torch.uint8, device=x.device)
    words = [int(w) for w in np.frombuffer(MAGIC_KEY, dtype="<u8")]
    err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], *words,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"baseline hh256 launch failed: CUDA error {err}")
    return out


def phase_hh_kernel(torch, hc, ht, spec, gen, card, loops, baseline):
    """HighwayHash kernel == plain version (and the numpy spec on sampled
    rows at the main path's shapes); its times with the SM clocks per
    packet, and, with `baseline` (another build's hh256_launch), both
    kernels timed in turns.  Returns its JSON record (without
    launches)."""
    import numpy as np
    dev = torch.device("cuda", 0)

    def rand(n, length, misalign=0):
        buf = torch.randint(0, 256, (n * length + misalign,),
                            dtype=torch.uint8, device=dev, generator=gen)
        return buf[misalign:].view(n, length)

    cases = [(f"(384, {4096 + r})", rand(384, 4096 + r))
             for r in (0, 1, 17, 31)]
    cases += [("(384, 0)", rand(384, 0)),
              ("(384, 4113), rows start 1 byte off 16", rand(384, 4113, 1)),
              ("(383, 4113), n odd", rand(383, 4113)),
              ("(1, 4127), n = 1", rand(1, 4127))]
    max_err = 0

    def compare(got, want) -> int:
        return int((got.int() - want.int()).abs().max())

    for name, x in cases:
        got = hc.hh256_rows(x)
        want = ht.hh256_rows_ref(x)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(got, want))
        ok = torch.equal(got, want)
        print(f"[hh256] {name}: kernel == plain version: {ok}")
        if not ok:
            raise SystemExit(f"hh256 kernel disagrees with plain: {name}")

    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    clock = max_sm_clock_hz()
    rec = {}
    # The PUT batch, the GET batch, a tail block's 12 rows of 38401 B
    # (rows at offsets i * 38401: every offset mod 16, the unaligned
    # variant), then the scaling lines: two threads per stream and one
    # warp per block, 24 warps at n = 384, 264 (two per SM) at 4224,
    # 1056 (eight per SM) at 16896.
    for n, length, runs in ((384, 131072, 20), (256, 131072, 20),
                            (12, 38401, 20), (4224, 131072, 5),
                            (16896, 131072, 5)):
        x = rand(n, length)
        name = f"({n}, {length})"
        got = hc.hh256_rows(x)
        checked = ""
        if n <= 384:                          # the main path's shapes
            t0 = time.perf_counter()
            want = ht.hh256_rows_ref(x)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            sample = np.linspace(0, n - 1, min(n, 16)).astype(int)
            spec_ok = np.array_equal(got.cpu().numpy()[sample],
                                     spec.highwayhash256_batch(
                                         x.cpu().numpy()[sample]))
            ok = torch.equal(got, want) and spec_ok
            max_err = max(max_err, compare(got, want))
            if not ok:
                raise SystemExit(f"hh256 kernel disagrees at {name}")
            checked = (f"kernel == plain version and == numpy spec on "
                       f"{len(sample)} sampled rows: {ok}; plain version "
                       f"{plain_ms:.1f} ms (one run, host clock); ")
        variant = "aligned" if length % 16 == 0 else "unaligned"
        ms = time_ms(torch, lambda: hc.hh256_rows(x), runs, flush)
        bound_ms, bound_by, bytes_ms, ops_ms = hh_bound(
            n, length, loops[variant], clock)
        per_packet = ms * 1e-3 * clock / hh_updates(length)
        print(f"[hh256] {name}, {variant} variant: {checked}{ms:.4f} ms "
              f"median of {runs} ({n * length / ms / 1e6:.2f} GB/s; "
              f"{per_packet:.1f} SM clocks per packet at "
              f"{clock / 1e6:.0f} MHz over {hh_updates(length)} updates; "
              f"bound {bound_ms:.4f} ms by {bound_by} (bytes "
              f"{bytes_ms:.4f}, operations {ops_ms:.4f}), "
              f"{bound_ms / ms:.1%} of it); library call: none; card {card}")
        if baseline is not None:
            old = hh_launch(torch, baseline, x)
            if not torch.equal(old, got):
                raise SystemExit(f"baseline hh256 disagrees at {name}")
            times = [time_ms(torch, f, runs, flush) for f in (
                lambda: hh_launch(torch, baseline, x),
                lambda: hc.hh256_rows(x), lambda: hc.hh256_rows(x),
                lambda: hh_launch(torch, baseline, x))]
            old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] +
                                                        times[2]) / 2
            print(f"[hh256 turns] {name}: baseline, new, new, baseline = "
                  f"{', '.join(f'{t:.4f}' for t in times)} ms; baseline "
                  f"{old_ms:.4f} ms ({old_ms * 1e-3 * clock / hh_updates(length):.1f}"
                  f" clocks/packet), new {new_ms:.4f} ms "
                  f"({new_ms * 1e-3 * clock / hh_updates(length):.1f} "
                  f"clocks/packet), {old_ms / new_ms:.2f}x; outputs equal; "
                  f"card {card}")
        if (n, length) == (384, 131072):
            rec = {"name": "hh256", "route": "cuda",
                   "source": "minio_tpu_torch/csrc/hh256.cu",
                   "replaces": "minio_tpu/ops/highwayhash_pallas.py:76",
                   "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
        del x, got
    # The same work with every row one byte off 16: what the unaligned
    # variant costs where the aligned one could run.
    x = rand(384, 131072, misalign=1)
    ms = time_ms(torch, lambda: hc.hh256_rows(x), 20, flush)
    print(f"[hh256] (384, 131072), rows 1 byte off 16, unaligned variant: "
          f"{ms:.4f} ms median of 20 "
          f"({ms * 1e-3 * clock / hh_updates(131072):.1f} SM clocks per "
          f"packet); card {card}")
    del x
    x = cases[0][1]
    plain_ms = time_ms(torch, lambda: ht.hh256_rows_ref(x), 3, flush)
    ms = time_ms(torch, lambda: hc.hh256_rows(x), 20, flush)
    print(f"[hh256] reduced shape (384, 4096): kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms (CUDA events, median); card {card}")
    rec["max_abs_err"] = max_err
    return rec


def _tmp_root(prefix: str) -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    return tempfile.mkdtemp(prefix=prefix, dir=base)


def _data_positions(Q, fi, count):
    order = Q.shuffle_by_distribution(list(range(12)),
                                      fi.erasure.distribution)
    return [order[s] for s in range(count)]


def phase_slice(args, counts, card, algo, sizes):
    """One main path: PUT, GET, HEAD, degraded GET, corrupted-frame GET
    and DELETE of `sizes` objects under bitrot algorithm `algo`.  Returns
    the launch counts of the path."""
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.errors import ErrObjectNotFound
    import numpy as np

    root = _tmp_root("chip_smoke-")
    rng = np.random.default_rng(args.seed)
    bodies = {f"obj{i}": rng.bytes(n) for i, n in enumerate(sizes)}
    total = sum(sizes)
    os.environ["MTPU_BITROT_ALGO"] = algo
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(12)], default_parity=4)
    steps = {}
    try:
        es.make_bucket("smoke")
        counts.reset()                        # the main path starts here

        def step(name, before):
            now = counts.read()
            steps[name] = {k: now[k] - before[k] for k in now}
            return now

        t0 = time.perf_counter()
        fis = {k: es.put_object("smoke", k, v) for k, v in bodies.items()}
        put_s = time.perf_counter() - t0
        mark = step("put", {k: 0 for k in counts.read()})
        if any(fi.erasure.bitrot_algo() != algo for fi in fis.values()):
            raise SystemExit(f"PUT did not record {algo}")

        get_s = 0.0
        for key, body in bodies.items():
            t0 = time.perf_counter()
            fi, got = es.get_object("smoke", key)
            get_s += time.perf_counter() - t0
            if hashlib.md5(got).hexdigest() != fi.etag or bytes(got) != body:
                raise SystemExit(f"GET {key}: bytes or ETag differ")
        mark = step("get", mark)

        for key, body in bodies.items():
            fi = es.head_object("smoke", key)
            if fi.size != len(body) or fi.etag != hashlib.md5(
                    body).hexdigest():
                raise SystemExit(f"HEAD {key}: size or ETag differ")

        deg_s = 0.0
        for key, body in bodies.items():
            saved = list(es.drives)
            for pos in _data_positions(Q, fis[key], 2):  # two data shards
                es.drives[pos] = None
            t0 = time.perf_counter()
            _, got = es.get_object("smoke", key)
            deg_s += time.perf_counter() - t0
            es.drives = saved
            if bytes(got) != body:
                raise SystemExit(f"degraded GET {key}: bytes differ")
        mark = step("degraded_get", mark)

        key = "obj1"
        fi = fis[key]
        part = os.path.join(es.drives[_data_positions(Q, fi, 3)[2]].root,
                            "smoke", key, fi.data_dir, "part.1")
        with open(part, "r+b") as f:          # a frame mid-file
            f.seek(fi.size // MIB // 2 * (32 + fi.erasure.shard_size) + 1000)
            f.write(b"\xff" * 16)
        _, got = es.get_object("smoke", key)
        if bytes(got) != bodies[key]:
            raise SystemExit("GET with a corrupted frame: bytes differ")
        step("corrupt_get", mark)
        launches = counts.read()              # the main path ends here

        for key in bodies:
            es.delete_object("smoke", key)
            try:
                es.head_object("smoke", key)
                raise SystemExit(f"DELETE {key}: object still there")
            except ErrObjectNotFound:
                pass
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("MTPU_BITROT_ALGO", None)

    need = {"put": ("gf_matmul", "hh256") if algo == HH else ("gf_matmul",),
            "get": ("hh256",) if algo == HH else (),
            "degraded_get": ("gf_matmul", "hh256") if algo == HH
            else ("gf_matmul",),
            "corrupt_get": ("gf_matmul", "hh256") if algo == HH
            else ("gf_matmul",)}
    for name, kernels in need.items():
        for kernel in kernels:
            if steps[name][kernel] == 0:
                raise SystemExit(f"{algo} {name} did not launch {kernel}")
    gb = total / 1e9
    print(f"[slice {algo}] EC:8+4, 12 drives, {len(sizes)} objects, {total}"
          f" bytes: PUT {gb / put_s:.3f} GB/s, GET {gb / get_s:.3f} GB/s, "
          f"degraded GET {gb / deg_s:.3f} GB/s (host clock); card {card}")
    print(f"[slice {algo}] launches per step: {steps}; GET, HEAD, degraded "
          "GET, corrupted-frame GET byte-exact; DELETE done")
    return launches


def _part_hashes(es, bucket, objects) -> dict:
    """SHA-256 of every part file of `objects` on every drive."""
    out = {}
    for pos, d in enumerate(es.drives):
        for obj, fi in objects.items():
            for part in fi.parts:
                p = os.path.join(d.root, bucket, obj, fi.data_dir,
                                 f"part.{part.number}")
                with open(p, "rb") as f:
                    out[pos, obj, part.number] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


def _wipe(es, LocalDrive, positions) -> None:
    """A replaced drive: its whole directory gone, reopened empty."""
    for pos in positions:
        root = es.drives[pos].root
        shutil.rmtree(root)
        es.drives[pos] = LocalDrive(root)


def phase_heal(args, counts, card):
    """Heal path: one mxh256 and one HighwayHash object, two drives
    wiped, heal_bucket + heal_object, every part file back to its
    recorded SHA-256, then a GET the healed drives serve."""
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    root = _tmp_root("chip_smoke-heal-")
    rng = np.random.default_rng(args.seed + 1)
    bodies = {"mxh": rng.bytes(TAIL_OBJECT_BYTES),
              "hh": rng.bytes(TAIL_OBJECT_BYTES)}
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(12)], default_parity=4)
    try:
        es.make_bucket("heal")
        fis = {}
        for key, algo in (("mxh", "mxh256"), ("hh", HH)):
            os.environ["MTPU_BITROT_ALGO"] = algo
            fis[key] = es.put_object("heal", key, bodies[key])
        os.environ.pop("MTPU_BITROT_ALGO", None)
        golden = _part_hashes(es, "heal", fis)
        order = Q.shuffle_by_distribution(list(range(12)),
                                          fis["hh"].erasure.distribution)
        wiped = [order[0], order[11]]         # a data and a parity shard
        _wipe(es, LocalDrive, wiped)

        counts.reset()                        # the main path starts here
        t0 = time.perf_counter()
        if sorted(heal.heal_bucket(es, "heal")) != sorted(wiped):
            raise SystemExit("heal_bucket did not recreate the volume")
        results = {key: heal.heal_object(es, "heal", key)[0] for key in fis}
        heal_s = time.perf_counter() - t0
        launches = counts.read()              # the main path ends here
        for key, r in results.items():
            if sorted(r.healed_drives) != sorted(wiped):
                raise SystemExit(f"heal {key}: healed {r.healed_drives}")
        if _part_hashes(es, "heal", fis) != golden:
            raise SystemExit("healed part files differ from the originals")
        if min(launches.values()) == 0:
            raise SystemExit(f"heal did not launch every kernel: {launches}")

        others = [p for p in order if p not in wiped][:2]
        saved = list(es.drives)
        for pos in others:
            es.drives[pos] = None
        for key, body in bodies.items():
            if bytes(es.get_object("heal", key)[1]) != body:
                raise SystemExit(f"GET {key} after heal: bytes differ")
        es.drives = saved
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("MTPU_BITROT_ALGO", None)
    total = sum(len(b) for b in bodies.values())
    print(f"[heal] EC:8+4, drives {wiped} wiped; heal_bucket + heal_object "
          f"of 2 objects ({total} bytes, mxh256 and {HH}): "
          f"{total / heal_s / 1e9:.3f} GB/s (host clock); every part file "
          f"equals its recorded SHA-256; GET with drives {others} away "
          f"byte-exact; launches {launches}; card {card}")
    return launches


def phase_multipart(args, counts, card):
    """Multipart path: three parts under mxh256, highwayhash256S and
    mxh256; complete; whole, ranged and degraded GETs; heal of a wiped
    drive; GET again."""
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import multipart as mp
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    root = _tmp_root("chip_smoke-mp-")
    rng = np.random.default_rng(args.seed + 2)
    parts = [(OBJECT_BYTES, "mxh256"), (OBJECT_BYTES, HH),
             (5 * MIB + 7, "mxh256")]
    bodies = [rng.bytes(n) for n, _ in parts]
    whole = b"".join(bodies)
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(12)], default_parity=4)
    try:
        es.make_bucket("mp")
        counts.reset()                        # the main path starts here
        t0 = time.perf_counter()
        uid = mp.new_multipart_upload(es, "mp", "obj")
        listed = []
        for i, ((_, algo), body) in enumerate(zip(parts, bodies)):
            os.environ["MTPU_BITROT_ALGO"] = algo
            info = mp.put_object_part(es, "mp", "obj", uid, i + 1, body)
            listed.append((i + 1, info.etag))
        os.environ.pop("MTPU_BITROT_ALGO", None)
        fi = mp.complete_multipart_upload(es, "mp", "obj", uid, listed)
        put_s = time.perf_counter() - t0
        want = hashlib.md5(b"".join(hashlib.md5(b).digest()
                                    for b in bodies)).hexdigest() + "-3"
        if fi.etag != want or [c["algo"] for c in fi.erasure.checksums] != \
                [a for _, a in parts]:
            raise SystemExit(f"multipart ETag or algorithms wrong: {fi}")
        if bytes(es.get_object("mp", "obj")[1]) != whole:
            raise SystemExit("multipart GET: bytes differ")
        off = OBJECT_BYTES - 3 * MIB - 11     # across the part 1/2 boundary
        if bytes(es.get_object("mp", "obj", off, 6 * MIB)[1]) != \
                whole[off:off + 6 * MIB]:
            raise SystemExit("multipart ranged GET: bytes differ")
        saved = list(es.drives)
        data = _data_positions(Q, fi, 2)
        for pos in data:
            es.drives[pos] = None
        if bytes(es.get_object("mp", "obj")[1]) != whole:
            raise SystemExit("multipart degraded GET: bytes differ")
        es.drives = saved
        golden = _part_hashes(es, "mp", {"obj": fi})
        _wipe(es, LocalDrive, [data[1]])
        heal.heal_bucket(es, "mp")
        r = heal.heal_object(es, "mp", "obj")[0]
        if r.healed_drives != [data[1]] or \
                _part_hashes(es, "mp", {"obj": fi}) != golden:
            raise SystemExit("multipart heal did not restore the drive")
        if bytes(es.get_object("mp", "obj")[1]) != whole:
            raise SystemExit("multipart GET after heal: bytes differ")
        launches = counts.read()              # the main path ends here
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("MTPU_BITROT_ALGO", None)
    if min(launches.values()) == 0:
        raise SystemExit(f"multipart did not launch every kernel: {launches}")
    print(f"[multipart] 3 parts ({len(whole)} bytes; mxh256, {HH}, mxh256): "
          f"upload + complete {len(whole) / put_s / 1e9:.3f} GB/s (host "
          f"clock); ETag {fi.etag}; whole, ranged across parts 1/2, "
          f"degraded and after-heal GETs byte-exact; launches {launches}; "
          f"card {card}")
    return launches


def phase_layers(torch, card, dev):
    """Where one 32 MiB EC:8+4 PUT batch's time goes, layer by layer
    (host clock around synchronised work, median of 5), and the device's
    busy share over one 64 MiB PUT + GET (torch.profiler)."""
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.ops import devices, fused
    from minio_tpu_torch.storage import bitrot_io
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    blocks = np.random.default_rng(1).integers(0, 256, (32, 8, 131072),
                                               dtype=np.uint8)
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="chip_smoke-layers-", dir=base)

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), out

    def write(views):
        for i, v in enumerate(views):
            with open(os.path.join(root, f"shard{i}"), "wb") as f:
                f.write(v)

    try:
        rows = {}
        rows["host-to-device copy (pageable)"], xt = timed(
            lambda: devices.put(blocks, dev))
        rows["encode + digests on the device"], (p, d) = timed(
            lambda: fused.encode_and_hash(xt, 8, 4, device=dev))
        rows["device-to-host copy"], (pn, dn) = timed(
            lambda: (p.cpu().numpy(), d.cpu().numpy()))
        rows["framing"], views = timed(
            lambda: bitrot_io.frame_shard_views(blocks, pn, dn, "mxh256"))
        rows["12 shard writes, serial"], _ = timed(lambda: write(views))
        rows["MD5 of the batch"], _ = timed(
            lambda: hashlib.md5(blocks).hexdigest())
        for name, ms in rows.items():
            print(f"[layers] 32 MiB PUT batch: {name}: {ms:.3f} ms")
        print(f"[layers] sum {sum(rows.values()):.3f} ms "
              f"({32 * MIB / sum(rows.values()) / 1e6:.3f} GB/s if serial);"
              f" card {card}")

        body = np.random.default_rng(2).bytes(64 * MIB)
        with ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                         for i in range(12)], default_parity=4) as es:
            es.make_bucket("prof")
            es.put_object("prof", "warm", body)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                es.put_object("prof", "obj", body)
                es.get_object("prof", "obj")
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                      for e in prof.key_averages())
        share = (f"{busy_us / wall_us:.2%}" if busy_us > 0
                 else "not measured (no device time in the trace)")
        print(f"[layers] 64 MiB PUT + GET: wall {wall_us / 1e3:.3f} ms, "
              f"device busy {busy_us / 1e3:.3f} ms = {share}; card {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hh256-baseline", metavar="CU",
                    help="another build of csrc/hh256.cu (same hh256_launch)"
                    " to time against the kernel in turns in phase 4")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from minio_tpu_torch.ops import cuda_build
        from minio_tpu_torch.ops import erasure_cuda as ec
        from minio_tpu_torch.ops import erasure_torch as et
        from minio_tpu_torch.ops import highwayhash as spec
        from minio_tpu_torch.ops import highwayhash_cuda as hc
        from minio_tpu_torch.ops import highwayhash_torch as ht
        from minio_tpu_torch.ops import mxhash
        from minio_tpu_torch.ops import mxhash_torch as mt
    except ImportError as e:
        print(f"chip_smoke: minio_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    card = card_line()
    print(card)
    print(f"[card] nvidia-smi: {card}; torch: "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = [ec.LIBRARY.source, hc.LIBRARY.source]
    built = cuda_build.build(sources, verbose=True)
    print(f"[build] {', '.join(built[s][0].name for s in sources)} in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, started "
          "together)")
    for src in sources:
        for line in built[src][1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src.name}: {line.strip()}")
    loops = sass_packet_loop(built[hc.LIBRARY.source][0], hc.LIBRARY.source)
    for variant, loop in loops.items():
        per_thread = sum(loop["per_thread"].values())
        top = ", ".join(f"{op} {k:g}" for op, k in loop["ops"].items())
        print(f"[build] hh256.cu {variant} packet loop (cuobjdump -sass), "
              f"per packet per thread: 32-bit integer instructions by pipe "
              f"{loop['per_thread']}, {per_thread:g} in all; per stream "
              f"({loop['threads']} threads) {loop['threads'] * per_thread:g};"
              f" every instruction {loop['all']:g} per thread; opcodes: "
              f"{top}")
    baseline = None
    if args.hh256_baseline:
        from pathlib import Path
        src = Path(args.hh256_baseline).resolve()
        lib = cuda_build.build([src])[src][0]
        baseline = ctypes.CDLL(str(lib)).hh256_launch
        baseline.argtypes = hc.LIBRARY.argtypes
        baseline.restype = ctypes.c_int
        print(f"[build] baseline {src.name} built for the turns of phase 4")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = [phase_kernel(torch, ec, et, gen, card)]
    phase_mxh(torch, mxhash, mt, gen, card)
    records.append(phase_hh_kernel(torch, hc, ht, spec, gen, card, loops,
                                   baseline))

    counts = Launches({"gf_matmul": ec, "hh256": hc})
    paths = {
        "mxh256 slice": lambda: phase_slice(
            args, counts, card, "mxh256",
            [OBJECT_BYTES] * 2 + [OBJECT_BYTES + 300 * 1024]),
        "highwayhash256S slice": lambda: phase_slice(
            args, counts, card, HH, [OBJECT_BYTES] * 2 + [TAIL_OBJECT_BYTES]),
        "heal": lambda: phase_heal(args, counts, card),
        "multipart": lambda: phase_multipart(args, counts, card),
    }
    per_path = {name: run() for name, run in paths.items()}
    print(f"[launches] per main path: {per_path}")
    for rec in records:
        rec["launches"] = sum(p[rec["name"]] for p in per_path.values())
    phase_layers(torch, card, torch.device("cuda", 0))

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
