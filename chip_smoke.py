#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (minio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--hh256-baseline CU] [--gf-baseline CU]

Phases, each printing its own lines; any failure exits non-zero:

1. The card (nvidia-smi name and power limit) and the build of both
   kernels (one nvcc per source, started together), timed, with ptxas's
   register, shared-memory and spill lines; the packet loop of each
   HighwayHash kernel variant (aligned rows, rows at any offset) read off
   cuobjdump -sass: integer instructions per packet per thread by
   issuing pipe, per stream (times the threads that carry a stream),
   every instruction, and the opcodes (PRMT for the zipper; no byte-wise
   global load); and the GF kernel's lookup loop at C = 8 (both
   variants): integer instructions per input byte by pipe, LDS per input
   byte, the opcodes, failing on an LDS.U8, on other than 2 LDS per byte
   or on a byte-wise global load.
2. The hand-written GF(2^8) kernel against its plain PyTorch version on
   the card, bit-exact (torch.equal), at the shapes the main path gives
   it (encode, 2-row transform, one block, a PUT tail block (1, 8, 38401)
   whose rows start at offsets 0-7 mod 16, ragged and misaligned rows,
   salted) and at R = 1, 3 and 6, C = 16 and 20 and a 100-row random
   matrix; its time (CUDA events, median, L2 flushed between runs) at the
   encode, the 2-row transform and the tail block beside its bound, and
   the plain version's time; at the encode, its time with the L2 flushed
   by reads and back to back, and an empty launch's time, which show
   what the timing protocol adds.  With --gf-baseline, another build of
   csrc/gf_matmul.cu in the byte-table form of PRs 1-4 is checked equal
   on every unsalted case, its lookup loop counted as in phase 1, and it
   is timed against the kernel in turns (baseline, kernel, kernel,
   baseline) at those three shapes.
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
      then healed and read again;
   e. drive heal: a formatted set holding 16 mxh256 objects of 64 MiB,
      4 HighwayHash objects of 64 MiB + 300 KiB + 5 B, 32 inline
      objects, a multipart object and a versioned object with a delete
      marker (a versioned DELETE); a data-shard drive wiped whole; heal_format, heal_drive
      with four workers stopped after a third of the objects (the saved
      tracker checked) and resumed; every file of the drive back to its
      recorded SHA-256, launches equal to those the sizes call for, and
      every version read byte-exact with three other drives away.  Then
      pipelined and serial (MTPU_HEAL_PIPELINE=0), with four workers and
      with one, uninterrupted, each twice in turns on a fresh wipe.
   f. object layer: one ServerPools of 4 EC:8+4 sets x 12 drives
      (MinIO's MINIO_ERASURE_SET_DRIVE_COUNT=12, STANDARD=EC:4), a
      versioned bucket of 2048 objects of 1-100 KiB, 96 of 4 MiB + 1 B
      and 24 of 64 MiB (6 HighwayHash), about 2.1 GB: PUT with SipHash
      placement checked, second versions, delete markers, a version
      deleted by id, metadata updates, 1000-key pages listed cold and
      warm and after a PUT, version histories, GET of every live object
      by SHA-256, degraded GETs, a heal sequence after one drive of every
      set was wiped (every file back to its SHA-256), GETs with other
      drives away, a bucket emptied and deleted; launches equal to the
      counts the sizes call for.  The 64 MiB objects also go through one
      ErasureSet alone, for what the layers add.
   g. the S3 server: an in-process S3Server on loopback TCP over the
      deployment of f, driven by the port's S3Client signing SigV4: a
      versioned bucket, 16 objects of 64 MiB by streamed UNSIGNED-PAYLOAD
      PUT from 1 and 4 clients (2 highwayhash256S), one of 64 MiB +
      300 KiB + 5 B by signed aws-chunked PUT, 1024 of 1-100 KiB by
      signed-payload PUT from 1 and 8 clients, a multipart upload of
      64 MiB + 64 MiB + 5 MiB + 7 B; GETs of every object, ranged GETs,
      an If-None-Match 304, HEADs, a presigned GET, ListObjectsV2 in
      pages of 1000, ListObjectVersions, a versioned DELETE, degraded
      GETs with two data-shard drives away; every body by SHA-256 and
      the three device programs' launches equal to the counts the sizes
      call for; PUT and GET GB/s over HTTP beside ServerPools directly,
      small-object operations/s, ms a listing page and the split of one
      64 MiB HTTP PUT.  Then `python -m minio_tpu_torch.server` boots in
      a subprocess on the card, serves a 64 MiB PUT and GET and exits 0
      on SIGTERM.
   h. concurrent dispatch: the deployment of f through ServerPools and
      through the S3 server, with the cross-request coalescer
      (ops/coalesce.py) and its pinned, double-buffered copies, with
      MTPU_COALESCE=0 and with MTPU_H2D_PIPELINE=0: 16 clients x 8
      objects of 1 MiB PUT and GET, 4 clients x 2 HighwayHash objects,
      four 64 MiB objects PUT and GET from 1 and from 4 clients and read
      degraded with two drives of every set away, and a 16 MiB object
      read twice, the second read a device-shard-cache hit that copies 0
      bytes to the card by the ledger (ops/devcache.py).  Bodies equal,
      part files' SHA-256 equal in every mode, no fallback or batch
      fault, every lane-thread dispatch pipelined when the pipeline is
      on; per step GB/s, operations/s, dispatches and items per
      dispatch, the lanes' time split, bytes copied per byte served.
   i. the front door's identity planes: an S3Server with an IAMSys and
      an HS256 OIDC provider over one EC:8+4 set of 12 drives; root
      creates 1000 users in 20 groups, 50 custom policies scoped to a
      bucket and prefix and 100 service accounts over the admin API
      (each IAM object an inline PUT on the card); a SigV2-header PUT of
      64 MiB read back by a SigV2 presigned GET and by SigV4; a readonly
      user's 64 MiB PUT refused; a prefix-scoped user, service accounts,
      AssumeRole with an inline GetObject-only policy (no session token
      refused), AssumeRoleWithWebIdentity; a 32 MiB POST-policy upload
      under content-length-range and starts-with, and one over the range
      refused; a snowball tar of 512 members read back; zip-extract GETs
      from a 64 MiB stored zip; a bucket policy serving an anonymous
      64 MiB GET and refusing an anonymous PUT; a new server whose fresh
      IAMSys loads every identity from the drives.  Items equal the
      counts the objects call for; every refused request adds no launch,
      no item and no staging entry.  ms and GB/s per step, the IAM
      create and load seconds, SigV2 against SigV4 per request and the
      ms to issue STS credentials.
   j. the host planes (phase_host_planes): the standalone boot on
      drives seeded with a dead process's staging (self-tests' ms and
      launches, the sweep's counts); 8 streamed 64 MiB PUTs (2
      HighwayHash) on one EC:8+4 set from 1 and 4 clients with
      zero-copy on and MTPU_ZEROCOPY=0 (GB/s, part files equal across
      modes, MD5 updates in flight at once); get_object and
      get_object_iter of each; the metadata elections of HEAD + GET
      with and without the FileInfo cache; a hedged GET over a stalled
      data-shard drive against MTPU_HEDGE=0, and one over HTTP with
      every default on (FileInfo cache, adaptive hedge delay); a
      breaker-offline drive, a
      parity-5 PUT, its MRF heal, every drive equal to a set that never
      lost the drive.  Items exact in every step.
   Phases a-g, i and j run with MTPU_DEVCACHE=0: their counts assume
   every GET reads its shards, and a and b probe a GET of a corrupted
   frame.  Phases a-i run with MTPU_HEDGE=0 and the FileInfo cache's TTL
   at 0: a hedge that fires turns a slow healthy read into a rebuild,
   and a cache hit serves an inline object from metadata elected before
   drives were taken away or wiped; their counts allow neither.
6. Where one 32 MiB PUT batch's time goes, layer by layer (the shard
   writes as one write_file_batches per drive; the ingest ring over the
   default buffer pool and a 512 MiB one against the bytearray chunker,
   from 1 and 4 streams; MD5 of a ring view against bytes), one 32 MiB
   GET batch's (shard reads, the host gather, H2D, verify, D2H,
   assembly) and one HTTP HEAD's (the new connection, the metadata election with and
   without the FileInfo cache, the handler), and the device's busy
   share over one 64 MiB PUT + GET (torch.profiler).

Launch counts are read for gf_matmul, hh256 and mxh256 (its calls on the
card), and beside them the work items of each (ops/fused.ITEMS: one per
direct call, the requests packed into a coalesced dispatch).  Where a
phase holds counts (e-j), the items must equal what the sizes call for
and the launches must be at most the items (equal with
MTPU_COALESCE=0).  Each path starts on fresh coalescer lanes; after each
of a-g, i and j their dispatches are printed, and a batch fault, a lane-thread
dispatch that was not pipelined, or a fallback to the direct call on any
path fails the run.  The line before the last is the kernels' JSON record,
whose launches are the main paths'; mxh256 is no hand-written kernel and
its row stands under "torch_ops" beside "kernels", with route "torch".
The last line is {"ok": true, "device": {...}}.
Without CUDA, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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
# The drive-heal deployment (phase 5e): 16 mxh256 objects of
# DRIVE_HEAL_OBJECT and 4 HighwayHash objects of DRIVE_HEAL_TAIL_OBJECT in
# bucket a; 32 inline objects, a multipart object of DRIVE_HEAL_PARTS and
# an object with DRIVE_HEAL_VERSIONS and a delete marker in bucket b.
DRIVE_HEAL_OBJECT = OBJECT_BYTES
DRIVE_HEAL_TAIL_OBJECT = TAIL_OBJECT_BYTES
DRIVE_HEAL_PARTS = (OBJECT_BYTES, OBJECT_BYTES, 5 * MIB + 7)
DRIVE_HEAL_VERSIONS = (8 * MIB + 1, 3 * MIB + 17)
# The object-layer deployment (phase 5f): MinIO's
# MINIO_ERASURE_SET_DRIVE_COUNT=12 with MINIO_STORAGE_CLASS_STANDARD=EC:4,
# one pool of LAYER_SETS sets; a versioned bucket of LAYER_SMALL objects
# of LAYER_SMALL_BYTES (inline), LAYER_MID of LAYER_MID_BYTES (a ragged
# tail block) and LAYER_BIG of LAYER_BIG_BYTES, LAYER_BIG_HH of them
# under highwayhash256S.
LAYER_SETS, LAYER_SET_DRIVES = 4, 12
LAYER_SMALL, LAYER_SMALL_BYTES = 2048, (1024, 100 * 1024)
LAYER_MID, LAYER_MID_BYTES = 96, 4 * MIB + 1
LAYER_BIG, LAYER_BIG_HH, LAYER_BIG_BYTES = 24, 6, OBJECT_BYTES
# The S3 server on the card (phase 5g), over the deployment of 5f:
# SERVER_BIG objects of SERVER_BIG_BYTES (SERVER_BIG_HH highwayhash256S),
# one of SERVER_CHUNKED_BYTES by aws-chunked PUT, SERVER_SMALL of
# SERVER_SMALL_BYTES (the first SERVER_SMALL_SERIAL from one client),
# one multipart upload of SERVER_PARTS, a ranged GET of SERVER_RANGE
# (offset, length) per large object.
SERVER_SETS = LAYER_SETS
SERVER_BIG, SERVER_BIG_HH, SERVER_BIG_BYTES = 16, 2, OBJECT_BYTES
SERVER_CHUNKED_BYTES = TAIL_OBJECT_BYTES
SERVER_SMALL, SERVER_SMALL_SERIAL = 1024, 128
SERVER_SMALL_BYTES = (1024, 100 * 1024)
SERVER_PARTS = (OBJECT_BYTES, OBJECT_BYTES, 5 * MIB + 7)
SERVER_RANGE = (300 * 1024, MIB)
# Concurrent dispatch on the card (phase 5h), over the deployment of 5f,
# through ServerPools and through the S3 server, in each of
# DISPATCH_MODES: DISPATCH_SMALL_CLIENTS clients each PUT and GET
# DISPATCH_SMALL_PER objects of DISPATCH_SMALL_BYTES; DISPATCH_HH_CLIENTS
# clients DISPATCH_HH_PER highwayhash256S objects of that size each;
# DISPATCH_BIG_CLIENTS objects of DISPATCH_BIG_BYTES from 1 client and
# from DISPATCH_BIG_CLIENTS, and their degraded GETs with drives
# DISPATCH_AWAY of every set away; one DISPATCH_HIT_BYTES object read
# twice (the second read a device-cache hit).
DISPATCH_SMALL_CLIENTS, DISPATCH_SMALL_PER, DISPATCH_SMALL_BYTES = 16, 8, MIB
DISPATCH_HH_CLIENTS, DISPATCH_HH_PER = 4, 2
DISPATCH_BIG_CLIENTS, DISPATCH_BIG_BYTES = 4, OBJECT_BYTES
DISPATCH_AWAY = (0, 1)
DISPATCH_HIT_BYTES = 16 * MIB
# The host planes (phase 5j) over BASELINE.json config 2's deployment:
# HOST_OBJECTS streamed PUTs of HOST_BYTES (HOST_HH highwayhash256S) from
# 1 client and HOST_CLIENTS; a data-shard drive stalled HOST_STALL_S a
# read under a hedge delay pinned to HOST_HEDGE_MS; the breaker's
# thresholds of HOST_BREAKER_ENV.
HOST_OBJECTS, HOST_HH, HOST_BYTES, HOST_CLIENTS = 8, 2, OBJECT_BYTES, 4
HOST_STALL_S, HOST_HEDGE_MS = 0.05, 10
HOST_BREAKER_ENV = {"MTPU_BREAKER_ERRS": "2",
                    "MTPU_BREAKER_OFFLINE_ERRS": "4",
                    "MTPU_BREAKER_PROBE_S": "30"}
DISPATCH_MODES = (
    ("coalesced", {"MTPU_COALESCE": "1", "MTPU_H2D_PIPELINE": "1"}),
    ("direct", {"MTPU_COALESCE": "0", "MTPU_H2D_PIPELINE": "1"}),
    ("serial copies", {"MTPU_COALESCE": "1", "MTPU_H2D_PIPELINE": "0"}))


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
    """Sets to 0 and reads the launch counts of every kernel wrapper, the
    work items the fused programs computed per kernel (`items`: one per
    direct call, the requests packed into a coalesced dispatch), and
    with them the tally of mxh256's shapes (`shapes`, a MxhShapes) when
    one is installed: `last_shapes` is the tally as the last read()
    found it."""

    def __init__(self, wrappers: dict, fused):
        self.wrappers = wrappers
        self.fused = fused
        self.shapes = None
        self.last_shapes: dict[tuple[int, int], int] = {}

    def reset(self) -> None:
        for mod in self.wrappers.values():
            mod.LAUNCHES = 0
        self.fused.reset_items()
        if self.shapes is not None:
            self.shapes.reset()

    def read(self) -> dict[str, int]:
        if self.shapes is not None:
            self.last_shapes = self.shapes.snapshot()
        return {name: mod.LAUNCHES for name, mod in self.wrappers.items()}

    def items(self) -> dict[str, int]:
        return dict(self.fused.ITEMS)


def kernel_name(mangled: str) -> str:
    """The GF kernel's template arguments (C, variant) for its mangled
    symbol; any other symbol as it is."""
    m = re.search(r"gf_matmul_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if not m:
        return mangled
    return (f"gf_matmul_kernel<C={m.group(1)}, "
            f"{'aligned' if m.group(2) == '1' else 'unaligned'}"
            f"{', chunked' if m.group(3) == '1' else ''}>")


def _sass_functions(lib) -> list[tuple[str, list[tuple[int, str]]]]:
    """Every function of a library's cuobjdump -sass: (mangled name,
    [(address, instruction)])."""
    from minio_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return [(name, [(int(a, 16), t.strip()) for a, t in
                    re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)])
            for name, body in re.findall(
                r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S)]


def _opcode(t: str) -> str:
    return t.split()[1] if t.startswith("@") else t.split()[0]


def _loops(ins) -> list[tuple[int, int]]:
    """(start, end) of every backward branch."""
    out = []
    for a, t in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            out.append((int(m.group(1), 16), a))
    return out


def _by_pipe(ops) -> dict[str, int]:
    """32-bit integer instructions of an opcode Counter by issuing pipe."""
    count = {"alu": 0, "fma": 0, "either": 0}
    for op, k in ops.items():
        if op.startswith(EITHER_OPS):
            count["either"] += k
        elif op.split(".")[0] in FMA_OPS:
            count["fma"] += k
        elif op.split(".")[0] in ALU_OPS:
            count["alu"] += k
    return count


def _byte_loads(ops) -> list[str]:
    return [op for op in ops if op.startswith("LDG")
            and ("U8" in op or "S8" in op)]


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

    text = source.read_text()
    per_trip = int(re.search(r"kPacketsPerTrip = (\d+)", text).group(1))
    threads = int(re.search(r"kThreadsPerStream = (\d+)", text).group(1))
    result = {}
    for name, ins in _sass_functions(lib):
        variant = next((v for v in ("aligned", "unaligned")
                        if f"hh256_{v}" in name), None)
        if variant is None:
            continue
        start, end = max(_loops(ins), key=lambda se: se[1] - se[0])
        ops = Counter(_opcode(t) for a, t in ins if start <= a <= end)
        if ops["IMAD.WIDE.U32"] < 4 * per_trip:
            raise SystemExit(f"hh256 {variant}: the longest loop holds "
                             f"{ops['IMAD.WIDE.U32']} wide multiplies for "
                             f"{per_trip} packets: not the packet loop")
        if _byte_loads(ops):
            raise SystemExit(f"hh256 {variant}: byte-wise global loads in "
                             f"the packet loop: {_byte_loads(ops)}")
        result[variant] = {
            "per_thread": {p: c / per_trip for p, c in _by_pipe(ops).items()},
            "all": sum(ops.values()) / per_trip,
            "ops": {op: k / per_trip for op, k in ops.most_common()},
            "threads": threads}
    if set(result) != {"aligned", "unaligned"}:
        raise SystemExit(f"hh256 variants not found in the SASS: {result}")
    return result


def sass_gf_loop(lib, baseline: bool = False) -> dict[str, dict]:
    """The hot loop of the GF(2^8) kernel at C = 8 input rows, read off
    `cuobjdump -sass` of its library: a loop that holds the most
    shared-memory loads (the table lookups).

    csrc/gf_matmul.cu holds a thread's 16 bytes of all C rows in
    registers and loops over groups of four output rows: a trip is one
    group, 16 * C input bytes (the lookups, 2 LDS per input byte, the
    transpose and the stores).  Its instances at C = 8 are read
    ("aligned", "unaligned").  `baseline`: the form of PRs 1-4 (one
    function, "aligned" only), whose innermost loop over input rows, the
    shortest such loop, takes one row a trip (16 bytes; rows per trip
    counted by its 16-byte global loads) for four output rows.
    Per variant:
    "per_byte", 32-bit integer instructions per input byte by issuing
    pipe; "lds", shared-memory loads per input byte; "all", every
    instruction per input byte; "ops", each opcode per input byte;
    "stores", the function's global store opcodes.  Fails, for the
    kernel, if the loop holds an LDS.U8 or other than 2 LDS per byte, or
    the function a byte-wise global load."""
    from collections import Counter

    result = {}
    for name, ins in _sass_functions(lib):
        if "gf_matmul_kernel" not in name:
            continue
        m = re.search(r"gf_matmul_kernelILi(\d+)ELb([01])ELb([01])E", name)
        if baseline:
            variant = "aligned"
        elif m and m.group(1) == "8" and m.group(3) == "0":
            variant = "aligned" if m.group(2) == "1" else "unaligned"
        else:
            continue

        def lds(a0, a1):
            return sum(1 for a, t in ins if a0 <= a <= a1
                       and _opcode(t).startswith("LDS"))
        start, end = max(_loops(ins),          # the shortest such loop
                         key=lambda se: (lds(*se), se[0] - se[1]))
        ops = Counter(_opcode(t) for a, t in ins if start <= a <= end)
        every = Counter(_opcode(t) for _, t in ins)
        if baseline:
            rows = sum(k for op, k in ops.items()
                       if op.startswith("LDG") and "128" in op)
            per_trip = 16 * max(rows, 1)
        else:
            per_trip = 16 * 8
            if any(op.startswith("LDS.U8") for op in ops) or \
                    lds(start, end) != 2 * per_trip:
                raise SystemExit(
                    f"gf_matmul {variant}: the lookup loop holds "
                    f"{dict(ops)}: not 2 LDS.32 per input byte")
            if _byte_loads(every):
                raise SystemExit(f"gf_matmul {variant}: byte-wise global "
                                 f"loads: {_byte_loads(every)}")
        result[variant] = {
            "per_byte": {p: c / per_trip for p, c in _by_pipe(ops).items()},
            "lds": lds(start, end) / per_trip,
            "all": sum(ops.values()) / per_trip,
            "ops": {op: k / per_trip for op, k in ops.most_common()},
            "stores": sorted(op for op in every if op.startswith("STG"))}
    want = {"aligned"} if baseline else {"aligned", "unaligned"}
    if set(result) != want:
        raise SystemExit(f"gf_matmul instances at C = 8 not found in the "
                         f"SASS: {sorted(result)}")
    return result


def time_ms(torch, fn, runs: int, flush, read: bool = False) -> float:
    """Median device time of fn() over `runs` runs, L2 flushed before
    each (by writing `flush`, or by reading it: then the L2 holds no
    dirty lines to write back), measured with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if read:
            torch.amax(flush)
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(torch, fn, n: int) -> float:
    """Device time per launch of n launches of fn() in a row (CUDA events
    around all of them; the L2 keeps what the last launch left)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(b: int, c: int, r: int, s: int) -> tuple[float, str]:
    """Least time for (B, C, S) -> (B, R, S): bytes moved over HBM rate
    vs the bit-plane product's int8 operations over the int8 peak."""
    bytes_ms = (b * c * s + b * r * s) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (8 * r) * (8 * c) * s * b / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def byte_tables(mat_bits):
    """(8R, 8C) plane-major bit matrix -> the (R, C, 32) uint8 byte-wide
    nibble tables of the GF kernel of PRs 1-4 (for --gf-baseline): entry
    [r, c, v] is M[r, c] * v and [r, c, 16 + v] is M[r, c] * (v << 4)."""
    import numpy as np
    m = np.asarray(mat_bits).astype(np.uint8)
    rows, cols = m.shape[0] // 8, m.shape[1] // 8
    m = m.reshape(8, rows, 8, cols)                         # [i, r, j, c]
    weights = (1 << np.arange(8, dtype=np.uint32)).reshape(8, 1, 1, 1)
    col = (m.astype(np.uint32) * weights).sum(axis=0)       # [r, j, c]
    col = col.transpose(0, 2, 1).astype(np.uint8)           # [r, c, j]
    sel = ((np.arange(16)[:, None] >> np.arange(4)[None, :]) & 1
           ).astype(bool)                                   # [v, j]
    out = np.zeros((rows, cols, 32), dtype=np.uint8)
    for j in range(4):
        out[:, :, :16] ^= np.where(sel[:, j], col[:, :, j, None], 0
                                   ).astype(np.uint8)
        out[:, :, 16:] ^= np.where(sel[:, j], col[:, :, j + 4, None], 0
                                   ).astype(np.uint8)
    return out


def gf_launch(torch, fn, tables, x, rows):
    """(B, C, S) CUDA uint8 -> (B, R, S) through another build's
    gf_matmul_launch `fn` with its byte tables (for comparison)."""
    b, c, s = x.shape
    out = torch.empty((b, rows, s), dtype=torch.uint8, device=x.device)
    err = fn(tables.data_ptr(), x.data_ptr(), out.data_ptr(), b, rows, c, s,
             0, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"baseline gf_matmul launch failed: CUDA error {err}")
    return out


def phase_kernel(torch, ec, et, gen, card, baseline):
    """Kernel == plain version on every case; times at the encode shape,
    the 2-row transform and a PUT tail block beside their bounds and, with
    `baseline` (another build's gf_matmul_launch), both kernels timed in
    turns there.  Returns the kernel's JSON record (without launches)."""
    import numpy as np
    dev = torch.device("cuda", 0)
    enc = et._encode_matrix_bits(8, 4)
    deg = et._transform_matrix_bits(8, 4, (2, 3, 4, 5, 6, 7, 8, 9), (0, 1))

    def transform(k, m, lost):
        sources = tuple(i for i in range(k + m) if i not in lost)[:k]
        return et._transform_matrix_bits(k, m, sources, lost)

    def rand(shape, misalign=0):
        n = 1
        for d in shape:
            n *= d
        buf = torch.randint(0, 256, (n + misalign,), dtype=torch.uint8,
                            device=dev, generator=gen)
        return buf[misalign:].view(shape)

    wide = np.random.default_rng(5).integers(0, 2, (800, 128), dtype=np.uint8)
    cases = [
        ("encode (32, 8, 131072) -> R=4", enc, 4, rand((32, 8, 131072)),
         None),
        ("degraded 2-row transform (32, 8, 131072) -> R=2", deg, 2,
         rand((32, 8, 131072)), None),
        ("one block (1, 8, 131072) -> R=4", enc, 4, rand((1, 8, 131072)),
         None),
        ("R=1 transform (4, 8, 131072)", transform(8, 4, (0,)), 1,
         rand((4, 8, 131072)), None),
        ("R=3 transform (4, 8, 131072)", transform(8, 4, (0, 5, 9)), 3,
         rand((4, 8, 131072)), None),
        ("R=6 transform, EC:8+8 with 6 lost (4, 8, 131072)",
         transform(8, 8, (0, 2, 4, 9, 12, 15)), 6, rand((4, 8, 131072)),
         None),
        ("PUT tail block (1, 8, 38401) -> R=4, rows at offsets c mod 16",
         enc, 4, rand((1, 8, 38401)), None),
        ("tail degraded (1, 8, 38401) -> R=2", deg, 2, rand((1, 8, 38401)),
         None),
        ("ragged S=43691, row start 1 byte off 16 (3, 8, 43691) -> R=4",
         enc, 4, rand((3, 8, 43691), misalign=1), None),
        ("x 3 bytes off 16, S = 131072 (2, 8, 131072) -> R=4", enc, 4,
         rand((2, 8, 131072), misalign=3), None),
        ("salted 0x5A (4, 8, 131072) -> R=4", enc, 4, rand((4, 8, 131072)),
         0x5A),
        ("salted 0x5A tail (1, 8, 38401) -> R=4", enc, 4,
         rand((1, 8, 38401)), 0x5A),
        ("C=16, EC:16+4 (2, 16, 131072) -> R=4",
         et._encode_matrix_bits(16, 4), 4, rand((2, 16, 131072)), None),
        ("C=20, 16 input rows at a time (2, 20, 4097) -> R=4",
         et._encode_matrix_bits(20, 4), 4, rand((2, 20, 4097)), None),
        ("random (800, 128) bit matrix, R=100 (2, 16, 4097)", wide, 100,
         rand((2, 16, 4097)), None),
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
        if baseline is not None and salt is None:
            old = gf_launch(torch, baseline,
                            torch.from_numpy(byte_tables(mat)).to(dev), x,
                            rows)
            if not torch.equal(old, got):
                raise SystemExit(f"baseline gf_matmul disagrees: {name}")

    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    rec = {}
    for name, mat, rows, x, _ in (cases[0], cases[1], cases[6]):
        b, c, s = x.shape
        runs = 30
        ms = time_ms(torch, lambda: ec.gf_matmul_blocks(mat, x, rows), runs,
                     flush)
        bound_ms, bound_by = bound(b, c, rows, s)
        plain = ""
        if not rec:
            plain_ms = time_ms(torch, lambda: et.gf_matmul_blocks_ref(
                mat, x, rows), 20, flush)
            plain = f"; plain version {plain_ms:.4f} ms; library call: none"
        print(f"[kernel] {name}: {ms:.4f} ms median of {runs} "
              f"({(b * c * s + b * rows * s) / ms / 1e9:.3f} TB/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
              f"it){plain}; card {card}")
        if baseline is not None:
            tables = torch.from_numpy(byte_tables(mat)).to(dev)
            times = [time_ms(torch, f, runs, flush) for f in (
                lambda: gf_launch(torch, baseline, tables, x, rows),
                lambda: ec.gf_matmul_blocks(mat, x, rows),
                lambda: ec.gf_matmul_blocks(mat, x, rows),
                lambda: gf_launch(torch, baseline, tables, x, rows))]
            old_ms = (times[0] + times[3]) / 2
            new_ms = (times[1] + times[2]) / 2
            print(f"[gf turns] {name}: baseline, new, new, baseline = "
                  f"{', '.join(f'{t:.4f}' for t in times)} ms; baseline "
                  f"{old_ms:.4f} ms ({bound_ms / old_ms:.1%} of the bound), "
                  f"new {new_ms:.4f} ms ({bound_ms / new_ms:.1%}), "
                  f"{old_ms / new_ms:.2f}x; outputs equal; card {card}")
        if not rec:
            rec = {"name": "gf_matmul", "route": "cuda",
                   "source": "minio_tpu_torch/csrc/gf_matmul.cu",
                   "replaces": "minio_tpu/ops/erasure_pallas.py:58",
                   "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    # What the timing protocol adds at the encode shape: the write flush
    # leaves the L2 full of dirty lines that the kernel's misses write
    # back; a read flush does not; back to back, the L2 holds most of the
    # 48 MiB the kernel touches.  An empty launch gives the protocol's
    # floor.
    name, mat, rows, x, _ = cases[0]
    fns = {"kernel": lambda: ec.gf_matmul_blocks(mat, x, rows)}
    if baseline is not None:
        tables = torch.from_numpy(byte_tables(mat)).to(dev)
        fns["baseline"] = lambda: gf_launch(torch, baseline, tables, x, rows)
    tiny = torch.empty(1, dtype=torch.int32, device=dev)
    floor = time_ms(torch, lambda: tiny.zero_(), 30, flush)
    for who, fn in fns.items():
        wrote = time_ms(torch, fn, 30, flush)
        read = time_ms(torch, fn, 30, flush, read=True)
        warm = back_to_back_ms(torch, fn, 50)
        print(f"[gf protocol] {name}, {who}: L2 flushed by writes "
              f"{wrote:.4f} ms, by reads {read:.4f} ms; 50 launches back to "
              f"back {warm:.4f} ms a launch; an empty launch (a 4-byte "
              f"fill) after the write flush {floor:.4f} ms; card {card}")
    del flush
    return rec


def mxh_bound(n: int, length: int) -> tuple[float, float]:
    """mxh256's bound at (n, length) in ms, (bytes, operations): each
    input byte read once and each digest written once; 256 x 8 int8 MACs
    per 256-byte chunk of every tree level."""
    bytes_ms = (n * length + n * 32) / HBM_BYTES_PER_S * 1e3
    ops = 0
    width = length
    while width > 32:
        chunks = -(-width // 256)
        ops += n * chunks * 256 * 8 * 2
        width = chunks * 32
    return bytes_ms, ops / INT8_OPS_PER_S * 1e3


class MxhShapes:
    """Tallies the (rows, length) shape of every mxh256 call on the card
    made through the digest dispatch (ops/fused.py, its only caller in
    the package) while installed, so that its time can be taken at each
    shape the main paths gave it."""

    def __init__(self, fused, mt):
        self.fused, self.mt = fused, mt
        self.counts: dict[tuple[int, int], int] = {}
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self.counts = {}

    def snapshot(self) -> dict[tuple[int, int], int]:
        with self._lock:
            return dict(self.counts)

    def _call(self, x):
        if x.is_cuda:
            with self._lock:
                key = tuple(x.shape)
                self.counts[key] = self.counts.get(key, 0) + 1
        return self.mt.mxh256_rows(x)

    def __enter__(self):
        self.fused.mxh256_rows = self._call
        return self

    def __exit__(self, *exc) -> None:
        self.fused.mxh256_rows = self.mt.mxh256_rows


def phase_mxh_shapes(torch, mt, gen, card,
                     tally: dict[tuple[int, int], int], calls: int) -> None:
    """mxh256's loss on the main paths as a sum over the shapes they
    called it at: calls x (median time - bound) at each shape, each
    timed here on random rows (the digest's time does not depend on the
    bytes)."""
    if sum(tally.values()) != calls:
        raise SystemExit(f"mxh256 shape tally {sum(tally.values())} != "
                         f"its launch count {calls}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    rows = []
    for (n, length), k in tally.items():
        x = torch.randint(0, 256, (n, length), dtype=torch.uint8,
                          device=dev, generator=gen)
        ms = time_ms(torch, lambda: mt.mxh256_rows(x), 5, flush)
        bound = max(mxh_bound(n, length))
        rows.append((k * (ms - bound), k, n, length, ms, bound))
    del flush
    rows.sort(reverse=True)
    loss = sum(r[0] for r in rows)
    spent = sum(r[1] * r[4] for r in rows)
    small = [r for r in rows if r[3] <= 128 * 1024 // 8]
    print(f"[mxh256] calls on the main paths {calls} at {len(rows)} shapes;"
          f" time at each shape (median of 5) summed over the calls "
          f"{spent:.2f} ms, loss against the bound {loss:.2f} ms; calls "
          f"with rows of at most 16 KiB (inline shards, ragged tails) "
          f"{sum(r[1] for r in small)}, their loss "
          f"{sum(r[0] for r in small):.2f} ms; card {card}")
    for r in rows[:6]:
        print(f"[mxh256]   ({r[2]}, {r[3]}): {r[1]} calls x ({r[4]:.4f} - "
              f"{r[5]:.4f}) ms = {r[0]:.2f} ms; card {card}")


def phase_mxh(torch, mxhash, mt, gen, card) -> dict:
    """mxh256 at one PUT batch's shape against the numpy spec; its time
    beside its bound (each input byte read once, each digest written
    once; its int8 operations are far below), and the time of one tree
    level as PyTorch's int8 matmul (torch._int_mm) where it takes the
    shape, checked equal to that level."""
    dev = torch.device("cuda", 0)
    n, length = 12 * 32, 131072
    x = torch.randint(0, 256, (n, length), dtype=torch.uint8,
                      device=dev, generator=gen)
    got = mt.mxh256_rows(x)
    torch.cuda.synchronize()
    want = mxhash.mxh256_batch(x.cpu().numpy())
    ok = bool((got.cpu().numpy() == want).all())
    err = int(abs(got.cpu().numpy().astype(int) - want.astype(int)).max())
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    ms = time_ms(torch, lambda: mt.mxh256_rows(x), 10, flush)
    bytes_ms, ops_ms = mxh_bound(n, length)
    lib_ms, lib_note = None, ""
    a = x.reshape(-1, 256).view(torch.int8)
    m = torch.from_numpy(mxhash.matrix_a().astype("int8")).to(dev)
    try:
        level = torch._int_mm(a, m)
        torch.cuda.synchronize()
        if not torch.equal(level.view(torch.uint8).reshape(n, -1),
                           mt._level(x)):
            raise SystemExit("torch._int_mm's level differs from mxh256's")
        lib_ms = time_ms(torch, lambda: torch._int_mm(a, m), 10, flush)
    except Exception as e:  # noqa: BLE001 — a library probe, reported
        lib_note = f" (torch._int_mm refused the shape: {e})"
    print(f"[mxh256] (384, 131072) on the card == numpy spec: {ok}; "
          f"float64 tree levels {ms:.4f} ms median of 10 "
          f"({x.numel() / ms / 1e6:.2f} GB/s); bound {max(bytes_ms, ops_ms):.4f}"
          f" ms by {'bytes' if bytes_ms >= ops_ms else 'operations'} "
          f"(operations {ops_ms:.4f} ms); one level as torch._int_mm "
          f"(196608, 256) x (256, 8) int8 -> int32: "
          f"{'not measured' if lib_ms is None else f'{lib_ms:.4f} ms'}"
          f"{lib_note}; card {card}")
    if not ok:
        raise SystemExit("mxh256 on the card disagrees with the spec")
    return {"ms": ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


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


def _tmp_root(prefix: str, need_bytes: int = 0) -> str:
    """A scratch directory for 12 drive directories: in /dev/shm when it
    is there and has `need_bytes` free, else in the temporary directory."""
    base = None
    if os.path.isdir("/dev/shm") and \
            shutil.disk_usage("/dev/shm").free >= need_bytes:
        base = "/dev/shm"
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


def _drive_hashes(root) -> dict:
    """SHA-256 of every file under one drive directory but the staging
    area, the listing cache and the heal tracker, by path."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        if rel_dir.split(os.sep)[:2] in ([".mtpu.sys", "tmp"],
                                         [".mtpu.sys", "metacache"]):
            continue
        for name in files:
            rel = os.path.normpath(os.path.join(rel_dir, name))
            if rel == os.path.join(".mtpu.sys", "healing.bin"):
                continue
            with open(os.path.join(root, rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def _drive_heal_deployment(es, rng):
    """Write the drive-heal deployment; returns {(bucket, name,
    version id): (FileInfo, body seed, size)} of every object version
    (body seed None for the delete marker; for the multipart object, the
    (seed, size) of each part).  Bodies are made again from their seeds
    to check GETs, so the host holds one at a time."""
    from minio_tpu_torch.engine import multipart as mp
    import numpy as np

    def body(seed, n):
        return np.random.default_rng(seed).bytes(n)

    versions = {}
    es.make_bucket("a")
    es.make_bucket("b")
    sizes = ([("a", f"m{i:02d}", "mxh256", DRIVE_HEAL_OBJECT)
              for i in range(16)]
             + [("a", f"h{i}", HH, DRIVE_HEAL_TAIL_OBJECT) for i in range(4)]
             + [("b", f"i{i:02d}", "mxh256", int(n)) for i, n in
                enumerate(rng.integers(1024, 100 * 1024 + 1, 32))])
    for seed, (bucket, name, algo, n) in enumerate(sizes):
        os.environ["MTPU_BITROT_ALGO"] = algo
        fi = es.put_object(bucket, name, body(seed, n))
        versions[bucket, name, fi.version_id] = (fi, seed, n)
    os.environ.pop("MTPU_BITROT_ALGO", None)
    seed = len(sizes)
    uid = mp.new_multipart_upload(es, "b", "mp")
    listed, part_seeds = [], []
    for i, n in enumerate(DRIVE_HEAL_PARTS):
        info = mp.put_object_part(es, "b", "mp", uid, i + 1,
                                  body(seed + i, n))
        listed.append((i + 1, info.etag))
        part_seeds.append((seed + i, n))
    fi = mp.complete_multipart_upload(es, "b", "mp", uid, listed)
    versions["b", "mp", ""] = (fi, part_seeds, sum(DRIVE_HEAL_PARTS))
    seed += len(DRIVE_HEAL_PARTS)
    for n in DRIVE_HEAL_VERSIONS:
        fi = es.put_object("b", "v", body(seed, n), versioned=True)
        versions["b", "v", fi.version_id] = (fi, seed, n)
        seed += 1
    dm = es.delete_object("b", "v", versioned=True)       # a delete marker
    if not dm.deleted:
        raise SystemExit("versioned DELETE wrote no delete marker")
    versions["b", "v", dm.version_id] = (dm, None, 0)
    return versions


def _digest(algo: str) -> str:
    """The launch count a digest of `algo` adds to."""
    return "hh256" if algo == HH else "mxh256"


def _expected_heal_launches(fis, pos) -> dict[str, int]:
    """Launches of each kernel (and mxh256 calls) when every version in
    `fis` is healed onto drive `pos` once, from the sizes alone: per
    batch of up to 32 full frames, and per tail frame, one GF rebuild and
    two digests (of the sources and of the rebuilt rows); an inline
    object is read (a GF rebuild only if `pos` held a data shard) and
    encoded again (one GF encode), one digest each."""
    want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
    for fi in fis:
        if fi.deleted:
            continue
        ec = fi.erasure
        if fi.inline_data is not None or not fi.data_dir:
            want["gf_matmul"] += 1 + (ec.distribution[pos] - 1
                                      < ec.data_blocks)
            want[_digest(ec.bitrot_algo())] += 2
            continue
        for part in fi.parts:
            full, tail = divmod(part.size, MIB)
            batches = -(-full // 32) + (1 if tail else 0)
            want["gf_matmul"] += batches
            want[_digest(ec.bitrot_algo(part.number))] += 2 * batches
    return want


def _check_launches(path: str, got: dict, items: dict, want: dict,
                    held=("gf_matmul", "hh256")) -> None:
    """Fail unless, for each kernel of `held` (both kernels by default,
    with mxh256's calls reported beside them), the work items equal the
    counts the sizes call for and the launches are at least one where
    there was work and at most the items: the coalescer packs items into
    fewer launches; without it (MTPU_COALESCE=0) launches equal items."""
    direct = os.environ.get("MTPU_COALESCE", "1") == "0"
    for k in held:
        if items[k] != want[k] or got[k] > items[k] or \
                (items[k] and not got[k]) or (direct and got[k] != items[k]):
            raise SystemExit(f"{path}: launches {got}, items {items}, "
                             f"expected items {want}")


def phase_drive_heal(args, counts, card):
    """Drive heal: a formatted EC:8+4 set of 12 drives holding about 60
    objects (mxh256 and HighwayHash, inline, multipart, versioned with a
    delete marker); one data-shard drive wiped whole; heal_format, then
    heal_drive with four workers, stopped after about a third of the
    objects and resumed; every file of the drive back to its recorded
    SHA-256; every object version read byte-exact with three other drives
    away.  Then each way of healing (pipelined and serial, the latter
    MTPU_HEAL_PIPELINE=0, with four workers and with one) twice in turns,
    each on a fresh wipe of the drive."""
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.errors import ErrObjectNotFound
    import numpy as np

    root = _tmp_root("chip_smoke-drive-heal-", need_bytes=8 << 30)
    rng = np.random.default_rng(args.seed + 3)
    drives = [LocalDrive(os.path.join(root, f"d{i}")) for i in range(12)]
    fmt.init_format_sets([drives])
    es = ErasureSet(drives, default_parity=4)
    real_heal_object = heal.heal_object
    runs = {}
    try:
        versions = _drive_heal_deployment(es, rng)
        n_objects = len({(b, o) for b, o, _ in versions})
        golden = {p: _drive_hashes(d.root) for p, d in enumerate(es.drives)}
        first = versions["a", "m00", ""][0]
        pos = Q.shuffle_by_distribution(list(range(12)),
                                        first.erasure.distribution)[0]
        want = _expected_heal_launches(
            (fi for fi, _, _ in versions.values()), pos)

        def wipe_and_heal(workers, interrupt):
            _wipe(es, LocalDrive, [pos])
            heal.STAGES.reset()
            counts.reset()                    # the main path starts here
            t0 = time.perf_counter()
            if heal.heal_format(es) != [pos]:
                raise SystemExit("heal_format did not name the wiped drive")
            saved = None
            if interrupt:
                stop = threading.Event()
                started = [0]
                mu = threading.Lock()

                def stopping(*a, **kw):
                    with mu:
                        started[0] += 1
                        if started[0] >= n_objects // 3:
                            stop.set()
                    return real_heal_object(*a, **kw)
                heal.heal_object = stopping
                try:
                    t = heal.heal_drive(es, pos, workers=workers,
                                        checkpoint_every=8, stop=stop)
                finally:
                    heal.heal_object = real_heal_object
                saved = heal.HealingTracker.load(es.drives[pos])
                if t.finished or saved is None or saved.finished or \
                        not saved.resume_object:
                    raise SystemExit(f"interrupted heal_drive: {t}, saved "
                                     f"{saved}")
                for b, o, _ in versions:
                    if (b, o) <= (saved.resume_bucket, saved.resume_object) \
                            and not os.path.exists(os.path.join(
                                es.drives[pos].root, b, o, "xl.meta")):
                        raise SystemExit(f"{b}/{o} is before the saved "
                                         f"resume point but not healed")
            t = heal.heal_drive(es, pos, workers=workers, checkpoint_every=8)
            heal_s = time.perf_counter() - t0
            launches = counts.read()          # the main path ends here
            items = counts.items()
            if not t.finished or t.objects_failed or \
                    t.objects_healed != len(versions):
                raise SystemExit(f"heal_drive: {t}, {len(versions)} object "
                                 "versions on the drive")
            _check_launches(f"heal_drive ({workers} workers)", launches,
                            items, want)
            if _drive_hashes(es.drives[pos].root) != golden[pos]:
                raise SystemExit("a file of the healed drive differs from "
                                 "its recorded SHA-256")
            return {"s": heal_s, "bytes": t.bytes_healed,
                    "launches": launches, "items": items,
                    "shapes": counts.last_shapes,
                    "stages": heal.STAGES.read(),
                    "saved": saved}

        main = wipe_and_heal(4, interrupt=True)
        others = [p for p in range(12) if p != pos][:3]
        saved_drives = list(es.drives)
        for p in others:
            es.drives[p] = None
        for (b, o, vid), (fi, seed, n) in versions.items():
            if fi.deleted:
                try:
                    es.get_object(b, o)
                    raise SystemExit(f"GET {b}/{o}: delete marker missed")
                except ErrObjectNotFound:
                    continue
            got = bytes(es.get_object(b, o, version_id=vid)[1])
            parts = seed if isinstance(seed, list) else [(seed, n)]
            if got != b"".join(np.random.default_rng(s).bytes(k)
                               for s, k in parts):
                raise SystemExit(f"GET {b}/{o}@{vid}: bytes differ")
        es.drives = saved_drives
        # Each way of healing twice, in turns (ABCD DCBA), uninterrupted.
        ways = [("pipelined, 4 workers", "1", 4),
                ("pipelined, 1 worker", "1", 1),
                ("serial, 4 workers", "0", 4), ("serial, 1 worker", "0", 1)]
        for name, pipeline, workers in ways + ways[::-1]:
            os.environ["MTPU_HEAL_PIPELINE"] = pipeline
            runs.setdefault(name, []).append(
                wipe_and_heal(workers, interrupt=False))
    finally:
        heal.heal_object = real_heal_object
        os.environ.pop("MTPU_HEAL_PIPELINE", None)
        os.environ.pop("MTPU_BITROT_ALGO", None)
        es.close()
        shutil.rmtree(root, ignore_errors=True)
    total = sum(n for _, _, n in versions.values())
    print(f"[drive heal] EC:8+4, 12 drives, {n_objects} objects, "
          f"{len(versions)} versions, {total} object bytes; drive {pos} "
          f"wiped whole; heal_format + heal_drive stopped at "
          f"{main['saved'].resume_bucket}/{main['saved'].resume_object} "
          f"(saved, unfinished, contiguous prefix on disk) and resumed to "
          f"finished; every file of the drive equals its recorded SHA-256;"
          f" every version byte-exact with drives {others} away; card "
          f"{card}")
    def line(name, r):
        st = r["stages"]
        print(f"[drive heal] {name}: {r['bytes'] / r['s'] / 1e9:.3f} GB/s "
              f"({r['bytes']} object bytes in {r['s']:.3f} s, host clock); "
              f"launches {r['launches']}, items {r['items']} (expected "
              f"{want}); pipeline "
              f"stages summed over batches: read {st['read']:.3f} s, "
              f"compute {st['compute']:.3f} s, write {st['write']:.3f} s, "
              f"{st['batches']} batches; card {card}")
    line("pipelined, 4 workers, stopped and resumed (the main path)", main)
    for name, rs in runs.items():
        for turn, r in enumerate(rs):
            line(f"{name}, turn {turn + 1} of 2", r)
    # Coalesced launches differ from run to run: the main path's shapes go
    # with its launches.
    counts.last_shapes = main["shapes"]
    return main["launches"]


def _put_calls(size: int) -> int:
    """Device calls (one GF encode and one digest each) of a PUT of
    `size` bytes: one per batch of up to 32 full blocks, one for the
    ragged tail block; an inline object is its tail block alone."""
    full, tail = divmod(size, MIB)
    return -(-full // 32) + (1 if tail else 0)


def _get_calls(fi, offset: int = 0, length: int | None = None) -> int:
    """Device calls (one digest each, and one GF rebuild when a data
    shard is missing) of a GET of [offset, offset + length), the whole
    object by default: per segment of a part, up to the next 32 MiB
    boundary, one for the full blocks it touches and one for the part's
    tail block when it touches that; an inline object is read whole, in
    one call."""
    if length is None:
        length = fi.size - offset
    if length == 0:
        return 0
    if not fi.data_dir:
        return 1                       # inline: one (tail) block
    calls, part_start = 0, 0
    for part in fi.parts:
        full = part.size // MIB
        seg = max(offset, part_start) - part_start
        stop = min(offset + length, part_start + part.size) - part_start
        while seg < stop:
            seg_end = min(stop, (seg // (32 * MIB) + 1) * 32 * MIB)
            b0, b1 = seg // MIB, -(-seg_end // MIB)
            calls += (min(b1, full) > b0) + (b1 > full)
            seg = seg_end
        part_start += part.size
    return calls


def _holds_data(fi, positions) -> bool:
    """Whether any of the drive positions holds a data shard of fi."""
    ec = fi.erasure
    return any(ec.distribution[p] - 1 < ec.data_blocks for p in positions)


def phase_object_layer(args, counts, card):
    """The object layer a server stands on: one ServerPools of one pool,
    LAYER_SETS sets x LAYER_SET_DRIVES drives, EC:8+4 (MinIO's
    MINIO_ERASURE_SET_DRIVE_COUNT=12 with MINIO_STORAGE_CLASS_STANDARD=
    EC:4), a versioned bucket of small, 4 MiB + 1 B and 64 MiB objects.
    PUT (placement checked against SipHash), second versions, delete
    markers, a version deleted by id, metadata updates, paged listings
    cold and warm and after a PUT, version histories, GET of every live
    object by SHA-256, degraded GETs, a heal sequence after one drive of
    every set was wiped (every file back to its SHA-256), GETs with other
    drives away, and a second bucket emptied and deleted.  Both kernels'
    launches must equal the counts the sizes call for.  Beforehand, the
    64 MiB objects go through one ErasureSet alone, to show what the
    layers add."""
    import uuid

    from minio_tpu_torch.background.heal_ops import HealState
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.errors import ErrObjectNotFound
    from minio_tpu_torch.utils.siphash import sip_hash_mod
    import numpy as np

    n_sets, n_drives = LAYER_SETS, LAYER_SET_DRIVES
    rng = np.random.default_rng(args.seed + 4)
    small = rng.integers(LAYER_SMALL_BYTES[0], LAYER_SMALL_BYTES[1] + 1,
                         LAYER_SMALL)
    specs = ([(f"small/{i:04d}", int(n), "mxh256")
              for i, n in enumerate(small)]
             + [(f"mid/{i:03d}", LAYER_MID_BYTES, "mxh256")
                for i in range(LAYER_MID)]
             + [(f"big/{i:02d}", LAYER_BIG_BYTES,
                 HH if i < LAYER_BIG_HH else "mxh256")
                for i in range(LAYER_BIG)])
    total = sum(n for _, n, _ in specs)
    # On the drives: each version's shards (12/8 of its bytes) plus one
    # in ten overwritten; the one-set comparison is gone before that.
    need = int(total * 1.5 * 1.25) + (1 << 30)
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        free = (shutil.disk_usage("/dev/shm").free
                if os.path.isdir("/dev/shm") else 0)
        raise SystemExit(f"object layer: needs {need} bytes free on "
                         f"/dev/shm, has {free}")
    root = tempfile.mkdtemp(prefix="chip_smoke-layer-", dir="/dev/shm")

    def body(seed, n):
        return np.random.default_rng(seed).bytes(n)

    def put_algo(algo):
        os.environ["MTPU_BITROT_ALGO"] = algo

    big = [(name, n, algo, i) for i, (name, n, algo) in enumerate(specs)
           if name.startswith("big/")]
    started = time.perf_counter()
    big_bytes = sum(n for _, n, _, _ in big)
    rates = {}
    pools = None
    try:
        # The 64 MiB objects through one ErasureSet of 12 drives alone.
        with ErasureSet([LocalDrive(os.path.join(root, "one", f"d{i}"))
                         for i in range(n_drives)],
                        default_parity=4) as es:
            es.make_bucket("v")
            put_s = get_s = 0.0
            for name, n, algo, seed in big:
                data = body(seed, n)
                put_algo(algo)
                t0 = time.perf_counter()
                es.put_object("v", name, data, versioned=True)
                put_s += time.perf_counter() - t0
            os.environ.pop("MTPU_BITROT_ALGO", None)
            for name, n, algo, seed in big:
                t0 = time.perf_counter()
                got = es.get_object("v", name)[1]
                get_s += time.perf_counter() - t0
                if hashlib.sha256(got).digest() != \
                        hashlib.sha256(body(seed, n)).digest():
                    raise SystemExit(f"one set: GET {name} differs")
            rates["one set"] = (big_bytes / put_s / 1e9,
                                big_bytes / get_s / 1e9)
        shutil.rmtree(os.path.join(root, "one"))

        drives = [LocalDrive(os.path.join(root, f"d{i:02d}"))
                  for i in range(n_sets * n_drives)]
        pools = ServerPools([ErasureSets(drives, set_drive_count=n_drives,
                                         default_parity=4)])
        sets = pools.pools[0].sets
        dep_key = uuid.UUID(pools.deployment_id).bytes
        pools.make_bucket("v")
        counts.reset()                        # the main path starts here
        want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}

        def expect(calls, algo, gf):
            want["gf_matmul"] += calls * gf
            want[_digest(algo)] += calls

        latest = {}                # name -> (fi, sha256, algo) of latest
        sizes_of = {}              # (name, version id) -> size
        times = {}
        t_small = t_big = 0.0
        for seed, (name, n, algo) in enumerate(specs):
            data = body(seed, n)
            put_algo(algo)
            t0 = time.perf_counter()
            fi = pools.put_object("v", name, data, versioned=True)
            dt = time.perf_counter() - t0
            if name.startswith("small/"):
                t_small += dt
            elif name.startswith("big/"):
                t_big += dt
            latest[name] = (fi, hashlib.sha256(data).digest(), algo)
            sizes_of[name, fi.version_id] = n
            expect(_put_calls(n), algo, 1)
        os.environ.pop("MTPU_BITROT_ALGO", None)
        get_s = 0.0
        for name, _, algo, _ in big:
            fi, digest, _ = latest[name]
            t0 = time.perf_counter()
            got = pools.get_object("v", name)[1]
            get_s += time.perf_counter() - t0
            if hashlib.sha256(got).digest() != digest:
                raise SystemExit(f"pools: GET {name} differs")
            expect(_get_calls(fi), algo, 0)
        rates["pools"] = (big_bytes / t_big / 1e9, big_bytes / get_s / 1e9)
        times["small PUT ops/s"] = LAYER_SMALL / t_small

        # Placement: each name on the set SipHash names, every set used.
        per_set = [0] * n_sets
        for name in latest:
            idx = sip_hash_mod(name, n_sets, dep_key)
            per_set[idx] += 1
            here = [os.path.isfile(os.path.join(
                s.drives[0].root, "v", name, "xl.meta")) for s in sets]
            if here != [i == idx for i in range(n_sets)]:
                raise SystemExit(f"{name} is not (only) on set {idx}")
        if min(per_set) == 0:
            raise SystemExit(f"a set holds no object: {per_set}")

        # Second versions of one object in ten, delete markers on
        # another one in ten, one older version deleted by id.
        names = list(latest)
        overwritten = names[3::10]
        marked = names[7::10]
        history = {name: [latest[name][0].version_id] for name in names}
        for name in overwritten:
            seed = 100_000 + names.index(name)
            n = sizes_of[name, history[name][0]]
            algo = latest[name][2]
            data = body(seed, n)
            put_algo(algo)
            fi = pools.put_object("v", name, data, versioned=True)
            latest[name] = (fi, hashlib.sha256(data).digest(), algo)
            sizes_of[name, fi.version_id] = n
            history[name].insert(0, fi.version_id)
            expect(_put_calls(n), algo, 1)
        os.environ.pop("MTPU_BITROT_ALGO", None)
        for name in marked:
            dm = pools.delete_object("v", name, versioned=True)
            if not dm.deleted:
                raise SystemExit(f"DELETE {name}: no delete marker")
            history[name].insert(0, dm.version_id)
            del latest[name]
        trimmed = overwritten[0]
        pools.delete_object("v", trimmed, version_id=history[trimmed][1])
        history[trimmed].pop(1)

        # Metadata updates, read back.
        for name in overwritten[1:9]:
            fi = pools.head_object("v", name)
            fi.metadata["x-amz-meta-smoke"] = name
            pools.update_object_metadata("v", name, fi)
            if pools.head_object("v", name).metadata.get(
                    "x-amz-meta-smoke") != name:
                raise SystemExit(f"metadata update of {name} not read back")

        # Paged listings, cold (the walk) and warm (the metacache).
        def list_all():
            out, marker, page_ms = [], "", []
            while True:
                t0 = time.perf_counter()
                page = pools.list_objects("v", marker=marker, max_keys=1000)
                page_ms.append((time.perf_counter() - t0) * 1e3)
                if not page:
                    return out, page_ms
                out += [fi.name for fi in page]
                marker = page[-1].name

        live = sorted(latest)
        walks = sum(s.metacache.walks for s in sets)
        cold, cold_ms = list_all()
        walked = sum(s.metacache.walks for s in sets) - walks
        warm, warm_ms = list_all()
        if cold != live or warm != live:
            raise SystemExit("listing differs from the live names")
        if sum(s.metacache.walks for s in sets) != walks + walked:
            raise SystemExit("the warm listing walked the drives again")
        data = body(200_000, 4321)
        fi = pools.put_object("v", "new/after-listing", data,
                              versioned=True)
        latest["new/after-listing"] = (fi, hashlib.sha256(data).digest(),
                                       "mxh256")
        history["new/after-listing"] = [fi.version_id]
        sizes_of["new/after-listing", fi.version_id] = len(data)
        expect(_put_calls(len(data)), "mxh256", 1)
        if list_all()[0] != sorted(latest):
            raise SystemExit("a PUT after the listing is not listed")

        # Version histories of every overwritten or marked object.
        t0 = time.perf_counter()
        for name in overwritten + marked:
            vers = pools.list_object_versions("v", name)
            if [v.version_id for v in vers] != history[name] or \
                    vers[0].deleted != (name in marked):
                raise SystemExit(f"versions of {name}: "
                                 f"{[v.version_id for v in vers]}")
        vers_ms = (time.perf_counter() - t0) * 1e3 / len(overwritten + marked)

        # GET every live object; degraded GETs on set 0 with two of each
        # object's data-shard drives away.
        def get_all(away_of):
            for name, (fi, digest, algo) in latest.items():
                es = pools.pools[0].set_for(name)
                away = away_of(es, fi)
                saved = list(es.drives)
                for p in away:
                    es.drives[p] = None
                try:
                    got = pools.get_object("v", name)[1]
                finally:
                    es.drives = saved
                if hashlib.sha256(got).digest() != digest:
                    raise SystemExit(f"GET {name} (drives {away} away) "
                                     "differs")
                expect(_get_calls(fi), algo, _holds_data(fi, away))

        get_all(lambda es, fi: ())
        set0 = [name for name in latest
                if pools.pools[0].set_for(name) is sets[0]]
        degraded = [n for n in set0 if not n.startswith("small/")] + \
            [n for n in set0 if n.startswith("small/")][:64]
        for name in degraded:
            fi, digest, algo = latest[name]
            order = Q.shuffle_by_distribution(list(range(n_drives)),
                                              fi.erasure.distribution)
            saved = list(sets[0].drives)
            for p in order[:2]:
                sets[0].drives[p] = None
            try:
                got = pools.get_object("v", name)[1]
            finally:
                sets[0].drives = saved
            if hashlib.sha256(got).digest() != digest:
                raise SystemExit(f"degraded GET {name} differs")
            expect(_get_calls(fi), algo, 1)

        # One drive of every set wiped; a full heal sequence.
        wiped = [(5 * i) % n_drives for i in range(n_sets)]
        golden = {i: _drive_hashes(s.drives[wiped[i]].root)
                  for i, s in enumerate(sets)}
        for i, s in enumerate(sets):
            _wipe(s, LocalDrive, [wiped[i]])
        versions = {}              # every version left: (set, FileInfo)
        for name in history:
            s = pools.pools[0].set_for(name)
            for v in pools.list_object_versions("v", name):
                versions[name, v.version_id] = (sets.index(s), v)
        for i in range(n_sets):
            got = _expected_heal_launches(
                (fi for si, fi in versions.values() if si == i), wiped[i])
            for k in want:
                want[k] += got[k]
        heal_bytes = sum(sizes_of[key] for key, (_, fi) in versions.items()
                         if not fi.deleted)
        t0 = time.perf_counter()
        seq = HealState(pools).launch()
        seq.wait()
        heal_s = time.perf_counter() - t0
        st = seq.status()
        if st["state"] != "done" or st["failures"] or \
                st["scanned"] != len(history) or \
                st["healed"] != len(history):
            raise SystemExit(f"heal sequence: {st}, {len(history)} objects")
        for i, s in enumerate(sets):
            if _drive_hashes(s.drives[wiped[i]].root) != golden[i]:
                raise SystemExit(f"set {i} drive {wiped[i]}: a healed file "
                                 "differs from its recorded SHA-256")
        others = {id(s): [(wiped[i] + 1) % n_drives,
                          (wiped[i] + 2) % n_drives]
                  for i, s in enumerate(sets)}
        get_all(lambda es, fi: others[id(es)])

        # A second bucket, emptied and deleted.
        pools.make_bucket("w")
        for i in range(3):
            data = body(300_000 + i, 2000 + i)
            pools.put_object("w", f"t{i}", data)
            expect(_put_calls(len(data)), "mxh256", 1)
        for i in range(3):
            pools.delete_object("w", f"t{i}")
        pools.delete_bucket("w")
        if "w" in pools.list_buckets():
            raise SystemExit("delete_bucket left the bucket")
        try:
            pools.head_object("v", marked[0])
            raise SystemExit("a delete-marked object is still served")
        except ErrObjectNotFound:
            pass
        launches = counts.read()              # the main path ends here
        items = counts.items()
        _check_launches("object layer", launches, items, want)
    finally:
        os.environ.pop("MTPU_BITROT_ALGO", None)
        if pools is not None:
            pools.close()
        shutil.rmtree(root, ignore_errors=True)

    n_pages = len(cold_ms) - 1            # the last call returns no key
    print(f"[object layer] ServerPools, 1 pool, {n_sets} sets x {n_drives} "
          f"drives, EC:8+4, bucket v versioned: {len(specs)} objects "
          f"({LAYER_SMALL} of 1-100 KiB, {LAYER_MID} of {LAYER_MID_BYTES} "
          f"B, {LAYER_BIG} of {LAYER_BIG_BYTES} B, {LAYER_BIG_HH} of them "
          f"{HH}), {total} bytes; per set {per_set} (SipHash placement "
          f"checked); {len(overwritten)} second versions, {len(marked)} "
          f"delete markers, 1 version deleted by id, 8 metadata updates; "
          f"card {card}")
    print(f"[object layer] {LAYER_BIG_BYTES} B objects ({len(big)}, "
          f"{big_bytes} bytes): "
          f"PUT {rates['pools'][0]:.3f} GB/s, GET {rates['pools'][1]:.3f} "
          f"GB/s through ServerPools; PUT {rates['one set'][0]:.3f} GB/s, "
          f"GET {rates['one set'][1]:.3f} GB/s through one ErasureSet "
          f"(host clock); card {card}")
    print(f"[object layer] small-object PUT {times['small PUT ops/s']:.1f} "
          f"operations/s (host clock); card {card}")
    print(f"[object layer] list_objects, {len(live)} live names in "
          f"{n_pages} pages of 1000: cold "
          f"{sum(cold_ms[:n_pages]) / n_pages:.3f} ms a page (first "
          f"{cold_ms[0]:.3f} ms), warm {sum(warm_ms[:n_pages]) / n_pages:.3f}"
          f" ms a page (metacache hit); delete "
          f"markers hidden; a PUT after it listed; card {card}")
    print(f"[object layer] list_object_versions "
          f"{vers_ms:.3f} ms per object over {len(overwritten + marked)} "
          f"objects; card {card}")
    print(f"[object layer] heal sequence after drives {wiped} of sets 0-"
          f"{n_sets - 1} wiped: {heal_bytes / heal_s / 1e9:.3f} GB/s "
          f"({heal_bytes} object bytes of {len(versions)} versions in "
          f"{heal_s:.3f} s, host clock), {st['scanned']} items scanned, "
          f"{st['healed']} healed; every file back to its SHA-256; every "
          f"live object byte-exact with two other drives of each set away; "
          f"card {card}")
    print(f"[object layer] launches {launches}, items {items}, expected "
          f"from the sizes {want}; the phase took {time.perf_counter() - started:.1f} s; "
          f"card {card}")
    return launches


class _Timed:
    """Sums the seconds spent in one method of a class while installed
    (the split of one HTTP PUT; one request in flight)."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.s = cls, name, 0.0
        self.orig = getattr(cls, name)

    def __enter__(self):
        orig, timer = self.orig, self

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                timer.s += time.perf_counter() - t0
        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.cls, self.name, self.orig)


def _in_threads(n: int, fn, items) -> list:
    """fn(item) for every item from `n` client threads; every result."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(fn, items))


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_server(args, counts, card):
    """The S3 server on the card: an in-process S3Server on loopback TCP
    over one ServerPools of one pool, SERVER_SETS sets x 12 drives,
    EC:8+4 (the object-layer deployment of phase 5f), driven by the
    port's S3Client signing SigV4.  A versioned bucket; SERVER_BIG
    objects of 64 MiB by streamed UNSIGNED-PAYLOAD PUT, half from one
    client and half from 4 (SERVER_BIG_HH of them highwayhash256S); one
    of 64 MiB + 300 KiB + 5 B by signed aws-chunked PUT; SERVER_SMALL of
    1-100 KiB by signed-payload PUT from 1 and 8 clients; one multipart
    upload; GETs of every object from 1 and from 4 (small: 8) clients,
    ranged GETs, an If-None-Match 304, HEADs, a presigned GET, paged
    ListObjectsV2 and ListObjectVersions, a versioned DELETE (marker,
    404, GET by version id), and degraded GETs of the large objects with
    two data-shard drives of their set away.  Every body is checked by
    SHA-256 and the three device programs' launches must equal the
    counts the sizes give.  Beforehand, the 64 MiB objects go through
    ServerPools directly (the front door's cost), and afterwards
    `python -m minio_tpu_torch.server` is booted in a subprocess on the
    card, serves a 64 MiB PUT and GET and must exit 0 on SIGTERM."""
    import datetime
    import http.client
    import xml.etree.ElementTree as ET

    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server import sigv4
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.utils import streams
    import numpy as np

    access, secret = "smokeadmin", "smokeadmin-secret"
    n_drives = LAYER_SET_DRIVES
    rng = np.random.default_rng(args.seed + 5)
    big = [(f"big/{i:02d}", SERVER_BIG_BYTES,
            HH if i < SERVER_BIG_HH else "mxh256", 1000 + i)
           for i in range(SERVER_BIG)]
    small = [(f"small/{i:04d}", int(n), "mxh256", 2000 + i)
             for i, n in enumerate(rng.integers(
                 SERVER_SMALL_BYTES[0], SERVER_SMALL_BYTES[1] + 1,
                 SERVER_SMALL))]
    chunked = ("chunked/0", SERVER_CHUNKED_BYTES, "mxh256", 3000)
    total = (sum(n for _, n, _, _ in big + small) + SERVER_CHUNKED_BYTES
             + sum(SERVER_PARTS))
    need = int(total * 1.5 * 1.3) + 2 * SERVER_BIG_BYTES + (1 << 30)
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"server: needs {need} bytes free on /dev/shm")
    root = tempfile.mkdtemp(prefix="chip_smoke-server-", dir="/dev/shm")

    def body(seed, n):
        return np.random.default_rng(seed).bytes(n)

    def put_algo(algo):
        if algo == "mxh256":
            os.environ.pop("MTPU_BITROT_ALGO", None)
        else:
            os.environ["MTPU_BITROT_ALGO"] = algo

    started = time.perf_counter()
    pools = srv = None
    rates, split = {}, {}
    try:
        drives = [LocalDrive(os.path.join(root, f"d{i:02d}"))
                  for i in range(SERVER_SETS * n_drives)]
        pools = ServerPools([ErasureSets(drives, set_drive_count=n_drives,
                                         default_parity=4)])
        srv = S3Server(pools, sigv4.Credentials(access, secret)).start()
        cli = S3Client(srv.endpoint, access, secret, timeout=300)
        digests = {}                 # name -> sha256 of the body
        one, four = big[:SERVER_BIG // 2], big[SERVER_BIG // 2:]

        # The 64 MiB objects through ServerPools directly: the front
        # door's cost is the difference (not counted).  Bodies are made
        # and checked outside the timed loops.
        pools.make_bucket("direct")

        def check(name, pieces):
            h = hashlib.sha256()
            for piece in pieces:
                h.update(piece)
            if h.digest() != digests[name]:
                raise SystemExit(f"GET {name} differs")

        def timed_batch(kind, clients, put, get, specs):
            """PUT then GET `specs` from `clients` threads: (PUT GB/s of
            the mxh256 objects, GET GB/s of all), highwayhash256S
            objects PUT first from this thread, untimed."""
            datas = {name: body(seed, n) for name, n, _, seed in specs}
            for name, data in datas.items():
                digests[name] = hashlib.sha256(data).digest()
            put_algo(HH)
            for name, _, algo, _ in specs:
                if algo == HH:
                    put(name, datas[name])
            put_algo("mxh256")
            rest = [name for name, _, algo, _ in specs if algo != HH]
            t0 = time.perf_counter()
            _in_threads(clients, lambda nm: put(nm, datas[nm]), rest)
            put_rate = (sum(len(datas[nm]) for nm in rest)
                        / (time.perf_counter() - t0) / 1e9)
            del datas
            t0 = time.perf_counter()
            got = _in_threads(clients, get, [name for name, *_ in specs])
            get_rate = (sum(sum(map(len, g)) for g in got)
                        / (time.perf_counter() - t0) / 1e9)
            for (name, *_), pieces in zip(specs, got):
                check(name, pieces)
            return put_rate, get_rate

        def direct_put(name, data):
            pools.put_object("direct", name, data, versioned=True)

        def direct_get(name):
            return [pools.get_object("direct", name)[1]]

        for clients, specs in ((1, one[:-1]), (4, four)):
            rates["direct", clients] = timed_batch("direct", clients,
                                                   direct_put,
                                                   direct_get, specs)
        pools.delete_bucket("direct", force=True)

        counts.reset()                        # the main path starts here
        want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}

        def expect(calls, algo, gf):
            want["gf_matmul"] += calls * gf
            want[_digest(algo)] += calls

        cli.make_bucket("srv")
        cli.set_versioning("srv", True)       # one inline config object
        expect(1, "mxh256", 1)
        versions = {}                         # name -> version id

        def http_put(name, data):
            h = cli.put_object_stream("srv", name, io.BytesIO(data),
                                      len(data))
            versions[name] = h["x-amz-version-id"]

        def http_get(name):
            return list(cli.get_object_stream("srv", name))

        # Streamed UNSIGNED-PAYLOAD PUTs from 1 and from 4 clients (the
        # highwayhash256S objects first); then one more 64 MiB PUT split
        # into its steps.
        for clients, specs in ((1, one[:-1]), (4, four)):
            rates["http", clients] = timed_batch("http", clients,
                                                 http_put,
                                                 http_get, specs)
            for _, n, algo, _ in specs:
                expect(_put_calls(n), algo, 1)
                # a whole GET of one part takes as many calls as its PUT
                expect(_put_calls(n), algo, 0)
        name, n, algo, seed = one[-1]
        data = body(seed, n)
        digests[name] = hashlib.sha256(data).digest()
        with _Timed(streams.LimitedReader, "read") as rd, \
                _Timed(ServerPools, "put_object") as eng:
            t0 = time.perf_counter()
            http_put(name, data)
            split["unsigned"] = (time.perf_counter() - t0, rd.s, 0.0, eng.s)
        expect(_put_calls(n), algo, 1)
        t0 = time.perf_counter()
        hashlib.md5(data)
        split["md5 alone"] = time.perf_counter() - t0
        del data

        # A signed aws-chunked PUT (STREAMING-AWS4-HMAC-SHA256-PAYLOAD),
        # split into socket read, payload SHA-256 and the engine.
        name, n, algo, seed = chunked
        data = body(seed, n)
        digests[name] = hashlib.sha256(data).digest()
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        scope = f"{amz_date[:8]}/{cli.creds.region}/s3/aws4_request"
        headers = {"Host": f"{cli.host}:{cli.port}",
                   "x-amz-decoded-content-length": str(n)}
        auth = sigv4.sign_request(cli.creds, "PUT", f"/srv/{name}", {},
                                  headers, sigv4.STREAMING_PAYLOAD, now=now)
        headers.update(auth)
        wire = sigv4.encode_streaming_body(
            cli.creds, scope, amz_date,
            auth["Authorization"].rsplit("Signature=", 1)[1], data,
            chunk_size=1 << 20)
        headers["Content-Length"] = str(len(wire))
        conn = http.client.HTTPConnection(cli.host, cli.port, timeout=300)
        try:
            with _Timed(streams.LimitedReader, "read") as rd, \
                    _Timed(sigv4.StreamingSigV4Reader,
                           "_verify_frames") as sha, \
                    _Timed(ServerPools, "put_object") as eng:
                t0 = time.perf_counter()
                conn.request("PUT", f"/srv/{name}", body=wire,
                             headers=headers)
                resp = conn.getresponse()
                out = resp.read()
                split["aws-chunked"] = (time.perf_counter() - t0, rd.s,
                                        sha.s, eng.s)
        finally:
            conn.close()
        if resp.status != 200:
            raise SystemExit(f"aws-chunked PUT: {resp.status} {out[:300]}")
        versions[name] = resp.getheader("x-amz-version-id")
        expect(_put_calls(n), algo, 1)
        del wire, data

        # Small objects, signed payload: from 1 client, then from 8.
        def small_put(spec):
            name, n, _, seed = spec
            data = body(seed, n)
            digests[name] = hashlib.sha256(data).digest()
            versions[name] = cli.put_object("srv", name, data)[
                "x-amz-version-id"]

        def small_get(spec):
            name = spec[0]
            if hashlib.sha256(cli.get_object("srv", name)).digest() != \
                    digests[name]:
                raise SystemExit(f"HTTP GET {name} differs")

        ops = {}
        for clients, specs in ((1, small[:SERVER_SMALL_SERIAL]),
                               (8, small[SERVER_SMALL_SERIAL:])):
            t0 = time.perf_counter()
            _in_threads(clients, small_put, specs)
            ops["put", clients] = len(specs) / (time.perf_counter() - t0)
            for _, n, algo, _ in specs:
                expect(_put_calls(n), algo, 1)

        # One multipart upload, signed-payload parts.
        uid = cli.create_multipart("srv", "multipart/0")
        etags, mp = [], hashlib.sha256()
        for i, n in enumerate(SERVER_PARTS):
            data = body(4000 + i, n)
            mp.update(data)
            etags.append((i + 1, cli.upload_part("srv", "multipart/0", uid,
                                                 i + 1, data)))
            expect(_put_calls(n), "mxh256", 1)
        cli.complete_multipart("srv", "multipart/0", uid, etags)
        digests["multipart/0"] = mp.digest()
        del data

        # GETs of every object, whole: the large ones not read yet
        # from 1 and 4 clients (the 64 MiB ones were read after their
        # PUTs), small from 1 and 8.
        large = [sp[0] for sp in big] + [chunked[0], "multipart/0"]
        fis = {name: pools.head_object("srv", name) for name in large}
        for name in (one[-1][0], chunked[0], "multipart/0"):
            for _ in (1, 4):
                check(name, http_get(name))
                expect(_get_calls(fis[name]), fis[name].erasure.bitrot_algo(),
                       0)
        for clients in (1, 8):
            t0 = time.perf_counter()
            _in_threads(clients, small_get, small)
            ops["get", clients] = len(small) / (time.perf_counter() - t0)
            for name, n, algo, _ in small:
                expect(1, algo, 0)

        # A ranged GET per large object, HEADs, a 304 and a presigned GET.
        off, ln = SERVER_RANGE
        for name, fi in fis.items():
            st, h, got = cli.request("GET", f"/srv/{name}",
                                     headers={"Range": f"bytes={off}-"
                                                       f"{off + ln - 1}"})
            data = (body(dict((sp[0], sp[3]) for sp in big + [chunked])
                         [name], fi.size)[off:off + ln]
                    if name != "multipart/0"
                    else body(4000, SERVER_PARTS[0])[off:off + ln])
            if st != 206 or got != data or h.get("Content-Range") != \
                    f"bytes {off}-{off + ln - 1}/{fi.size}":
                raise SystemExit(f"ranged GET {name}: {st} "
                                 f"{h.get('Content-Range')}")
            expect(_get_calls(fi, off, ln), fi.erasure.bitrot_algo(), 0)
            hh = cli.head_object("srv", name)
            if int(hh["Content-Length"]) != fi.size:
                raise SystemExit(f"HEAD {name}: {hh}")
        etag = cli.head_object("srv", big[0][0])["ETag"]
        st, _, got = cli.request("GET", f"/srv/{big[0][0]}",
                                 headers={"If-None-Match": etag})
        if (st, got) != (304, b""):
            raise SystemExit(f"If-None-Match GET: {st}")
        url = sigv4.presign_url(cli.creds, "GET", f"/srv/{big[2][0]}", {},
                                host=f"{cli.host}:{cli.port}")
        path, _, qs = url.partition("?")
        st, _, got = cli.request("GET", path, raw_query=qs)
        if st != 200:
            raise SystemExit(f"presigned GET: {st}")
        check(big[2][0], [got])
        expect(_get_calls(fis[big[2][0]]), "mxh256", 0)
        del got

        # A versioned DELETE: the marker, a 404, the version by id.
        victim = small[0][0]
        h = cli.delete_object("srv", victim)
        if h.get("x-amz-delete-marker") != "true":
            raise SystemExit(f"versioned DELETE: {h}")
        st, _, _ = cli.request("GET", f"/srv/{victim}")
        if st != 404:
            raise SystemExit(f"GET after the delete marker: {st}")
        got = cli.get_object("srv", victim, version_id=versions[victim])
        if hashlib.sha256(got).digest() != digests[victim]:
            raise SystemExit("GET by version id differs")
        expect(1, "mxh256", 0)

        # ListObjectsV2 in pages of 1000, then ListObjectVersions.
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        listed, token, page_ms = [], "", []
        while True:
            q = {"list-type": "2", "max-keys": "1000"}
            if token:
                q["continuation-token"] = token
            t0 = time.perf_counter()
            _, _, x = cli._check(*cli.request("GET", "/srv", query=q))
            page_ms.append((time.perf_counter() - t0) * 1e3)
            root_el = ET.fromstring(x)
            listed += [c.findtext(f"{ns}Key")
                       for c in root_el.iter(f"{ns}Contents")]
            token = root_el.findtext(f"{ns}NextContinuationToken") or ""
            if root_el.findtext(f"{ns}IsTruncated") != "true":
                break
        live = sorted(set(digests) - {victim})
        if listed != live:
            raise SystemExit(f"ListObjectsV2: {len(listed)} keys, "
                             f"{len(live)} live")
        n_versions = n_markers = 0
        q = {"versions": ""}
        t0 = time.perf_counter()
        while True:
            _, _, x = cli._check(*cli.request("GET", "/srv", query=q))
            root_el = ET.fromstring(x)
            n_versions += len(list(root_el.iter(f"{ns}Version")))
            n_markers += len(list(root_el.iter(f"{ns}DeleteMarker")))
            if root_el.findtext(f"{ns}IsTruncated") != "true":
                break
            q = {"versions": "",
                 "key-marker": root_el.findtext(f"{ns}NextKeyMarker"),
                 "version-id-marker":
                     root_el.findtext(f"{ns}NextVersionIdMarker")}
        versions_s = time.perf_counter() - t0
        if (n_versions, n_markers) != (len(digests), 1):
            raise SystemExit(f"ListObjectVersions: {n_versions} versions, "
                             f"{n_markers} markers")

        # Degraded GETs: two data-shard drives of each large object's set
        # away.
        t0 = time.perf_counter()
        for name, fi in fis.items():
            es = pools.pools[0].set_for(name)
            order = Q.shuffle_by_distribution(list(range(n_drives)),
                                              fi.erasure.distribution)
            saved = list(es.drives)
            for p in order[:2]:
                es.drives[p] = None
            try:
                check(name, http_get(name))
            finally:
                es.drives = saved
            expect(_get_calls(fi), fi.erasure.bitrot_algo(), 1)
        degraded_s = time.perf_counter() - t0
        launches = counts.read()              # the main path ends here
        items = counts.items()
        _check_launches("server", launches, items, want,
                        held=("gf_matmul", "hh256", "mxh256"))
    finally:
        os.environ.pop("MTPU_BITROT_ALGO", None)
        if srv is not None:
            srv.shutdown()
        if pools is not None:
            pools.close()
        shutil.rmtree(root, ignore_errors=True)
    served_s = time.perf_counter() - started

    boot = _boot_server(card)
    print(f"[server] S3Server on loopback over ServerPools, 1 pool, "
          f"{SERVER_SETS} sets x {n_drives} drives, EC:8+4, bucket srv "
          f"versioned: {len(big)} objects of {SERVER_BIG_BYTES} B "
          f"({SERVER_BIG_HH} {HH}) by streamed UNSIGNED-PAYLOAD PUT, one of "
          f"{SERVER_CHUNKED_BYTES} B by signed aws-chunked PUT, "
          f"{len(small)} of 1-100 KiB by signed-payload PUT, a multipart "
          f"upload of {'+'.join(map(str, SERVER_PARTS))} B; {total} object "
          f"bytes; every body checked by SHA-256; card {card}")
    print(f"[server] {SERVER_BIG_BYTES} B objects ({len(one) - 1} from 1 "
          f"client, {len(four)} from 4; mxh256 PUTs, all GETs): HTTP PUT "
          f"{rates['http', 1][0]:.3f} GB/s from 1 client, "
          f"{rates['http', 4][0]:.3f} from 4; through ServerPools "
          f"{rates['direct', 1][0]:.3f} and {rates['direct', 4][0]:.3f}; "
          f"HTTP GET {rates['http', 1][1]:.3f} GB/s from 1 client, "
          f"{rates['http', 4][1]:.3f} from 4; through ServerPools "
          f"{rates['direct', 1][1]:.3f} and {rates['direct', 4][1]:.3f} "
          f"(host clock, bodies made and checked outside the timing); "
          f"card {card}")
    print(f"[server] small objects: PUT {ops['put', 1]:.1f} operations/s "
          f"from 1 client, {ops['put', 8]:.1f} from 8; GET "
          f"{ops['get', 1]:.1f} from 1, {ops['get', 8]:.1f} from 8 (host "
          f"clock); card {card}")
    n_pages = len(page_ms)
    print(f"[server] ListObjectsV2: {len(listed)} keys in {n_pages} pages "
          f"of 1000, {sum(page_ms) / n_pages:.3f} ms a page (first "
          f"{page_ms[0]:.3f} ms); ListObjectVersions: {n_versions} versions"
          f" and {n_markers} delete marker in {versions_s * 1e3:.1f} ms; a "
          f"versioned DELETE (marker, 404, GET by version id); ranged, 304,"
          f" HEAD and presigned GETs checked; card {card}")
    for kind, (total_s, read_s, sha_s, eng_s) in (
            (k, v) for k, v in split.items() if k != "md5 alone"):
        engine_s = eng_s - read_s - sha_s
        steps = {"socket read": read_s, "payload SHA-256": sha_s,
                 "engine": engine_s,
                 "HTTP and the client": total_s - eng_s}
        holds = max(steps, key=steps.get)
        print(f"[server] split of one {kind} HTTP PUT "
              f"({SERVER_BIG_BYTES if kind == 'unsigned' else SERVER_CHUNKED_BYTES}"
              f" B): {total_s * 1e3:.1f} ms in all; socket read "
              f"{read_s * 1e3:.1f} ms, payload SHA-256 and chunk signatures "
              f"{sha_s * 1e3:.1f} ms, engine (encode, digests, MD5 waits, "
              f"framing, writes, publish) {engine_s * 1e3:.1f} ms, HTTP "
              f"parsing, the response and the client's send "
              f"{(total_s - eng_s) * 1e3:.1f} ms; MD5 of the "
              f"{SERVER_BIG_BYTES} B body alone "
              f"{split['md5 alone'] * 1e3:.1f} ms (on its own thread, beside"
              f" the engine); {holds} holds it; card {card}")
    print(f"[server] degraded GETs of {len(fis)} large objects (two "
          f"data-shard drives of their set away) in {degraded_s:.3f} s; "
          f"launches {launches}, items {items}, expected from the sizes "
          f"{want}; the "
          f"phase took {served_s:.1f} s, then the boot {boot:.1f} s; "
          f"card {card}")
    return launches


def phase_dispatch(args, counts, card):
    """Concurrent dispatch on the card: the deployment of 5f (4 sets x 12
    drives, EC:8+4) through ServerPools directly and through an
    in-process S3Server, in each of DISPATCH_MODES (the coalescer with
    its pinned, double-buffered copies; MTPU_COALESCE=0; and
    MTPU_H2D_PIPELINE=0).  Per mode and route, a fresh bucket: 16
    clients PUT 8 objects of 1 MiB each, then GET them; 4 clients PUT and
    GET 2 highwayhash256S objects each; four 64 MiB objects PUT from 1
    client and again from 4, then read from 1 and from 4; degraded GETs
    of them from 4 clients with two drives of every set away; one 16 MiB
    object PUT and read twice, the second read a device-cache hit that
    copies 0 bytes to the card by the ledger.  Every GET round starts
    from an empty device cache.  Every body equals what was PUT; the
    part files' SHA-256 are the same in every mode; per mode the work
    items equal the counts the sizes call for and the launches are at
    most the items (equal without the coalescer); the coalesced modes
    make no fallback and no batch fault, and with the pipeline on every
    dispatch of a lane thread was pipelined.  Prints, per step, GB/s,
    operations/s, dispatches and items per dispatch, the lanes' time
    split and the bytes copied to the card per byte served."""
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.ops import coalesce, devcache
    from minio_tpu_torch.server import sigv4
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    access, secret = "smokeadmin", "smokeadmin-secret"
    n_drives = LAYER_SET_DRIVES
    small = [[(f"small/{c:02d}/{i}", DISPATCH_SMALL_BYTES)
              for i in range(DISPATCH_SMALL_PER)]
             for c in range(DISPATCH_SMALL_CLIENTS)]
    hh = [[(f"hh/{c}/{i}", DISPATCH_SMALL_BYTES)
           for i in range(DISPATCH_HH_PER)]
          for c in range(DISPATCH_HH_CLIENTS)]
    big = [[(f"big/{c}", DISPATCH_BIG_BYTES)]
           for c in range(DISPATCH_BIG_CLIENTS)]
    hit = [[("hit/0", DISPATCH_HIT_BYTES)]]
    specs = [sp for group in (small, hh, big, hit) for c in group
             for sp in c]
    bodies = {name: np.random.default_rng(args.seed + 9000 + i).bytes(n)
              for i, (name, n) in enumerate(specs)}
    total = sum(len(b) for b in bodies.values())
    need = int(total * 1.5 * 2.5) + (1 << 30)
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"dispatch: needs {need} bytes free on /dev/shm")
    root = tempfile.mkdtemp(prefix="chip_smoke-dispatch-", dir="/dev/shm")
    started = time.perf_counter()
    pools = srv = None
    rows, hashes = [], {}
    saved_env = {k: os.environ.get(k) for k in
                 ("MTPU_COALESCE", "MTPU_H2D_PIPELINE", "MTPU_BITROT_ALGO")}
    try:
        drives = [LocalDrive(os.path.join(root, f"d{i:02d}"))
                  for i in range(LAYER_SETS * n_drives)]
        pools = ServerPools([ErasureSets(drives, set_drive_count=n_drives,
                                         default_parity=4)])
        sets = pools.pools[0].sets
        srv = S3Server(pools, sigv4.Credentials(access, secret)).start()
        cli = S3Client(srv.endpoint, access, secret, timeout=300)
        routes = {
            "ServerPools": (
                lambda b, nm: pools.put_object(b, nm, bodies[nm]),
                lambda b, nm: bytes(pools.get_object(b, nm)[1])),
            "HTTP": (
                lambda b, nm: cli.put_object_stream(
                    b, nm, io.BytesIO(bodies[nm]), len(bodies[nm])),
                lambda b, nm: b"".join(cli.get_object_stream(b, nm))),
        }
        counts.reset()                        # the main path starts here
        for mi, (mode, env) in enumerate(DISPATCH_MODES):
            os.environ.update(env)
            for ri, (route, (put, get)) in enumerate(routes.items()):
                bucket = f"dispatch{mi}{ri}"
                pools.make_bucket(bucket)
                want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
                l0, i0 = counts.read(), counts.items()
                f0 = coalesce.stats()
                hits0 = devcache.get().stats()["hits"]

                def step(name, groups, kind, algo="mxh256", away=()):
                    """One round: each group of objects from its own
                    client, in turn within the group."""
                    coalesce.reset()          # fresh lanes, fresh stats
                    if kind == "get":
                        devcache.get().clear()
                    devcache.reset_h2d()
                    fn = put if kind == "put" else get
                    got = {}

                    def client(group):
                        for nm, _ in group:
                            got[nm] = fn(bucket, nm)

                    t0 = time.perf_counter()
                    _in_threads(len(groups), client, groups)
                    dt = time.perf_counter() - t0
                    names = [nm for g in groups for nm, _ in g]
                    nbytes = sum(len(bodies[nm]) for nm in names)
                    for nm in names:
                        fi = pools.head_object(bucket, nm)
                        calls = (_put_calls(fi.size) if kind == "put"
                                 else _get_calls(fi))
                        want[_digest(algo)] += calls
                        if kind == "put" or _holds_data(fi, away):
                            want["gf_matmul"] += calls
                        if kind == "get" and got[nm] != bodies[nm]:
                            raise SystemExit(f"dispatch {mode} {route}: "
                                             f"GET {nm} differs")
                    st = coalesce.get().stats()
                    queued = st["dispatches"] - st["inline_dispatches"]
                    piped = (queued if env["MTPU_H2D_PIPELINE"] == "1"
                             else 0)
                    if st["batch_faults"] or \
                            st["pipeline_dispatches"] != piped:
                        raise SystemExit(f"dispatch {mode} {route} {name}: "
                                         f"lanes {st}")
                    rows.append({
                        "mode": mode, "route": route, "step": name,
                        "clients": len(groups), "ops": len(names),
                        "bytes": nbytes, "s": dt, "lanes": st,
                        "h2d": devcache.h2d_stats()["h2d_bytes"]})
                    return rows[-1]

                step("1 MiB PUT", small, "put")
                step("1 MiB GET", small, "get")
                os.environ["MTPU_BITROT_ALGO"] = HH
                try:
                    step(f"1 MiB {HH} PUT", hh, "put", HH)
                finally:
                    os.environ.pop("MTPU_BITROT_ALGO", None)
                step(f"1 MiB {HH} GET", hh, "get", HH)
                step("64 MiB PUT", [sum(big, [])], "put")
                step("64 MiB PUT", big, "put")
                step("64 MiB GET", [sum(big, [])], "get")
                step("64 MiB GET", big, "get")
                saved = [list(es.drives) for es in sets]
                for es in sets:
                    for p in DISPATCH_AWAY:
                        es.drives[p] = None
                try:
                    step("64 MiB degraded GET", big, "get",
                         away=DISPATCH_AWAY)
                finally:
                    for es, drv in zip(sets, saved):
                        es.drives = drv
                step("16 MiB PUT", hit, "put")
                first = step("16 MiB GET, first touch", hit, "get")
                devcache.reset_h2d()
                t0 = time.perf_counter()
                again = get(bucket, hit[0][0][0])
                dt = time.perf_counter() - t0
                if again != bodies[hit[0][0][0]]:
                    raise SystemExit(f"dispatch {mode} {route}: the "
                                     "cached GET differs")
                h2d = devcache.h2d_stats()["h2d_bytes"]
                hits = devcache.get().stats()["hits"] - hits0
                if h2d or hits != 1 or first["h2d"] < DISPATCH_HIT_BYTES:
                    raise SystemExit(f"dispatch {mode} {route}: cache hit "
                                     f"copied {h2d} bytes, {hits} hits, "
                                     f"first touch {first['h2d']}")
                rows.append({"mode": mode, "route": route,
                             "step": "16 MiB GET, device-cache hit",
                             "clients": 1, "ops": 1,
                             "bytes": DISPATCH_HIT_BYTES, "s": dt,
                             "lanes": None, "h2d": h2d})
                launches, items = counts.read(), counts.items()
                got = {k: launches[k] - l0[k] for k in launches}
                made = {k: items[k] - i0[k] for k in items}
                _check_launches(f"dispatch {mode} {route}", got, made, want,
                                held=("gf_matmul", "hh256", "mxh256"))
                f1 = coalesce.stats()
                if f1["co_fallbacks"] != f0["co_fallbacks"] or \
                        f1["co_faults"] != f0["co_faults"]:
                    raise SystemExit(f"dispatch {mode} {route}: fallbacks "
                                     f"or faults {f0} -> {f1}")
                rows.append({"mode": mode, "route": route, "launches": got,
                             "items": made})
                parts = {}
                for nm in bodies:
                    fi = pools.head_object(bucket, nm)
                    es = pools.pools[0].set_for(nm)
                    # By shard: the distribution depends on the bucket.
                    for pos, d in enumerate(es.drives):
                        with open(os.path.join(d.root, bucket, nm,
                                               fi.data_dir, "part.1"),
                                  "rb") as f:
                            parts[sets.index(es),
                                  fi.erasure.distribution[pos], nm] = \
                                hashlib.sha256(f.read()).digest()
                hashes[mode, route] = parts
                pools.delete_bucket(bucket, force=True)
        launches = counts.read()              # the main path ends here
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        coalesce.reset()
        if srv is not None:
            srv.shutdown()
        if pools is not None:
            pools.close()
        shutil.rmtree(root, ignore_errors=True)
    ref = next(iter(hashes.values()))
    for key, parts in hashes.items():
        if parts != ref:
            raise SystemExit(f"dispatch: part files of {key} differ from "
                             f"those of {next(iter(hashes))}")

    print(f"[dispatch] ServerPools, 1 pool, {LAYER_SETS} sets x {n_drives} "
          f"drives, EC:8+4, and the S3 server over it; {len(bodies)} objects"
          f" ({total} bytes) per mode and route, in modes "
          f"{', '.join(m for m, _ in DISPATCH_MODES)}; every body equal, "
          f"part files' SHA-256 equal in every mode ({len(ref)} files); "
          f"card {card}")
    for r in rows:
        if "step" not in r:
            print(f"[dispatch] {r['mode']}, {r['route']}: launches "
                  f"{r['launches']}, items {r['items']} (items as the sizes"
                  f" call for); card {card}")
            continue
        st = r["lanes"]
        lanes = "no lane"
        if st is not None and st["dispatches"]:
            lanes = (f"dispatches {st['dispatches']} (inline "
                     f"{st['inline_dispatches']}, pipelined "
                     f"{st['pipeline_dispatches']}), items per dispatch "
                     f"{st['items'] / st['dispatches']:.2f} mean, "
                     f"{st['max_items']} max; lane seconds: pack "
                     f"{st['pack_s']:.4f}, copy issue {st['h2d_s']:.4f}, "
                     f"resolve {st['resolve_s']:.4f}, overlapped "
                     f"{st['overlap_s']:.4f}")
        elif st is not None:
            lanes = "no lane dispatch"
        print(f"[dispatch] {r['mode']}, {r['route']}, {r['step']}, "
              f"{r['clients']} client(s): {r['bytes'] / r['s'] / 1e9:.3f} "
              f"GB/s, {r['ops'] / r['s']:.1f} operations/s (host clock); "
              f"{lanes}; host-to-card bytes per byte "
              f"{r['h2d'] / r['bytes']:.3f}; card {card}")
    print(f"[dispatch] the phase took {time.perf_counter() - started:.1f} s;"
          f" card {card}")
    return launches


# The front door's identity planes on the card (phase 5i), on one EC:8+4
# set of 12 drives: IAM state of IDENTITY_USERS users (each in one of
# IDENTITY_GROUPS groups), IDENTITY_POLICIES custom policies scoped to a
# bucket and prefix, IDENTITY_SVC service accounts; objects of
# IDENTITY_BIG_BYTES, a POST-policy upload of IDENTITY_POST_BYTES, a
# snowball tar of IDENTITY_SNOW_SMALL members of IDENTITY_SNOW_SMALL_BYTES
# (inline) and IDENTITY_SNOW_BIG of IDENTITY_SNOW_BIG_BYTES, a stored zip
# of IDENTITY_ZIP_MEMBERS members of IDENTITY_ZIP_MEMBER_BYTES read
# IDENTITY_ZIP_GETS times, IDENTITY_AUTH_RUNS requests per auth timing.
IDENTITY_USERS, IDENTITY_GROUPS = 1000, 20
IDENTITY_POLICIES, IDENTITY_SVC = 50, 100
IDENTITY_BIG_BYTES, IDENTITY_POST_BYTES = OBJECT_BYTES, 32 * MIB
IDENTITY_SNOW_SMALL, IDENTITY_SNOW_SMALL_BYTES = 448, 64 * 1024
IDENTITY_SNOW_BIG, IDENTITY_SNOW_BIG_BYTES = 64, MIB
IDENTITY_ZIP_MEMBERS, IDENTITY_ZIP_MEMBER_BYTES = 64, MIB
IDENTITY_ZIP_GETS, IDENTITY_AUTH_RUNS = 4, 200
IDENTITY_CLIENTS = 8


def phase_identity(args, counts, card):
    """The front door's identity planes on the card: an in-process
    S3Server with an IAMSys and an HS256 OIDC provider over one EC:8+4
    set of 12 drives (in /dev/shm).  Root creates the IAM state over the
    admin API (each IAM object an inline PUT through the engine); then,
    over HTTP: a readwrite user's SigV2-header PUT of 64 MiB read back by
    a SigV2 presigned GET and by SigV4; a readonly user's 64 MiB PUT
    refused; a prefix-scoped user's PUT inside its prefix and refused
    outside; service accounts inheriting their parents' rights;
    AssumeRole with an inline GetObject-only policy (GET allowed, PUT
    refused, no session token refused); AssumeRoleWithWebIdentity and a
    GET; a POST-policy upload under content-length-range and starts-with
    and its GET, a form over the range refused; a snowball PUT with every
    member read back; zip-extract GETs; a bucket policy granting
    anonymous GetObject on public/* (anonymous GET served, anonymous PUT
    refused); then a new server with a fresh IAMSys over the same drives
    loads every identity and one user authenticates.  Bodies by SHA-256;
    the three device programs' items must equal the counts the objects
    call for, and every refused request adds no launch and no item and
    leaves no staging entry on the drives."""
    import tarfile
    import zipfile

    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.iam.iam import IAMSys
    from minio_tpu_torch.iam.oidc import OpenIDConfig, make_hs256_token
    from minio_tpu_torch.server import sigv2, sigv4
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage.drive import SYS_VOL, TMP_DIR, LocalDrive
    import numpy as np

    access, secret = "idadmin", "idadmin-secret"
    oidc_secret = b"chip-smoke-oidc-" + str(args.seed).encode()
    need = int(6 * IDENTITY_BIG_BYTES * 1.5) + (1 << 30)
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"identity: needs {need} bytes free on /dev/shm")
    root = tempfile.mkdtemp(prefix="chip_smoke-identity-", dir="/dev/shm")
    paths = [os.path.join(root, f"d{i:02d}") for i in range(12)]

    def body(seed, n):
        return np.random.default_rng(seed).bytes(n)

    def sha(data):
        return hashlib.sha256(data).digest()

    def serve(pools):
        iam = IAMSys(pools)
        oidc = OpenIDConfig(hs256_secret=oidc_secret, audience="mtpu")
        return S3Server(pools, sigv4.Credentials(access, secret), iam=iam,
                        oidc=oidc).start()

    want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}

    def expect(calls, gf):
        want["gf_matmul"] += calls * gf
        want["mxh256"] += calls

    def staged():
        return {(d, e) for d in paths
                for e in os.listdir(os.path.join(d, SYS_VOL, TMP_DIR))}

    refused = []

    def refuse(what, code, call):
        """`call` must answer `code` and add no launch, no item and no
        staging entry."""
        before = (counts.read(), counts.items(), staged())
        st, _, out = call()
        after = (counts.read(), counts.items(), staged())
        if st < 400 or f"<Code>{code}</Code>".encode() not in out:
            raise SystemExit(f"identity: {what}: {st} {out[:300]}")
        if after != before:
            raise SystemExit(f"identity: refused {what} launched or "
                             f"staged: {before} -> {after}")
        refused.append(what)

    def ok(what, resp, status=200):
        st, h, out = resp
        if st != status:
            raise SystemExit(f"identity: {what}: {st} {out[:300]}")
        return h, out

    steps = {}

    def timed(name, nbytes, fn):
        t0 = time.perf_counter()
        out = fn()
        s = time.perf_counter() - t0
        steps[name] = (s, nbytes)
        return out

    users = [f"user{i:04d}" for i in range(IDENTITY_USERS)]
    user_secret = {u: f"{u}-secret-{args.seed}" for u in users}
    rw, ro, scoped = users[0], users[1], users[2]
    started = time.perf_counter()
    pools = srv = None
    try:
        pools = ServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                         set_drive_count=12,
                                         default_parity=4)])
        srv = serve(pools)
        adm = S3Client(srv.endpoint, access, secret, timeout=300)
        for b in ("work", "tenants", "pub"):
            adm.make_bucket(b)

        counts.reset()                        # the main path starts here
        # -- IAM state over the admin API ------------------------------------
        t0 = time.perf_counter()
        for i in range(IDENTITY_POLICIES):
            adm.set_policy(f"tenant-{i:02d}", {
                "Version": "2012-10-17", "Statement": [
                    {"Effect": "Allow",
                     "Action": ["s3:PutObject", "s3:GetObject"],
                     "Resource": [f"arn:aws:s3:::tenants/t{i:02d}/*"]},
                    {"Effect": "Allow", "Action": "s3:ListBucket",
                     "Resource": "arn:aws:s3:::tenants",
                     "Condition": {"StringLike":
                                   {"s3:prefix": [f"t{i:02d}/*"]}}}]})

        def policies_of(i):
            return (["readwrite"] if i == 0 else ["readonly"] if i == 1
                    else [f"tenant-{i % IDENTITY_POLICIES:02d}"])
        _in_threads(IDENTITY_CLIENTS, lambda i: adm.add_user(
            users[i], user_secret[users[i]], policies_of(i)),
            range(IDENTITY_USERS))
        for g in range(IDENTITY_GROUPS):
            adm.add_group(f"group{g:02d}", users[g::IDENTITY_GROUPS],
                          ["readonly"])
        svc = _in_threads(IDENTITY_CLIENTS, adm.add_service_account,
                          users[:IDENTITY_SVC])
        create_s = time.perf_counter() - t0
        # A policy, a user, a service account: one object write each; a
        # group: its own object and each new member's user object again.
        iam_writes = (IDENTITY_POLICIES + IDENTITY_USERS + IDENTITY_SVC
                      + IDENTITY_GROUPS + IDENTITY_USERS)
        expect(iam_writes, 1)                 # one inline PUT each
        create_launches = counts.read()
        if sorted(adm.list_users()) != users:
            raise SystemExit("identity: the admin API lists other users")

        def client(ak, sk, token=""):
            return S3Client(srv.endpoint, ak, sk, timeout=300,
                            session_token=token)
        c_rw, c_ro, c_sc = (client(u, user_secret[u])
                            for u in (rw, ro, scoped))

        # 1. SigV2 header PUT; SigV2 presigned and SigV4 GETs.
        big = body(7000, IDENTITY_BIG_BYTES)
        ok("v2 PUT", timed("SigV2 header PUT", len(big), lambda: c_rw.request(
            "PUT", "/work/big", body=big, auth="v2")))
        expect(_put_calls(len(big)), 1)
        fi_big = pools.head_object("work", "big")
        for name, kw in (("SigV2 presigned GET", {"auth": "v2-presigned"}),
                         ("SigV4 GET", {})):
            _, got = ok(name, timed(name, len(big), lambda: c_rw.request(
                "GET", "/work/big", **kw)))
            if sha(got) != sha(big):
                raise SystemExit(f"identity: {name} differs")
            expect(_get_calls(fi_big), 0)
        # 2. A readonly user's 64 MiB PUT.
        refuse("readonly PUT", "AccessDenied", lambda: c_ro.request(
            "PUT", "/work/ro", body=big))
        # 3. Inside and outside the prefix user's prefix.
        small = body(7001, MIB)
        pre = f"t{2 % IDENTITY_POLICIES:02d}"
        ok("prefix PUT", c_sc.request("PUT", f"/tenants/{pre}/a",
                                      body=small))
        expect(_put_calls(len(small)), 1)
        refuse("PUT outside the prefix", "AccessDenied", lambda: c_sc.request(
            "PUT", "/tenants/t99/a", body=small))
        # 4. Service accounts inherit their parents' rights.
        svc_rw, svc_ro = (client(*svc[0]), client(*svc[1]))
        ok("service account PUT", svc_rw.request("PUT", "/work/svc",
                                                 body=small))
        expect(_put_calls(len(small)), 1)
        _, got = ok("readonly service account GET",
                    svc_ro.request("GET", "/work/svc"))
        if got != small:
            raise SystemExit("identity: service account GET differs")
        expect(1, 0)
        refuse("readonly service account PUT", "AccessDenied",
               lambda: svc_ro.request("PUT", "/work/svc2", body=small))
        # 5. AssumeRole with an inline GetObject-only policy.
        get_only = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": "s3:GetObject",
             "Resource": "arn:aws:s3:::work/*"}]}
        t0 = time.perf_counter()
        for _ in range(IDENTITY_AUTH_RUNS - 1):
            c_rw.assume_role(policy=get_only)
        creds = c_rw.assume_role(policy=get_only)
        sts_ms = (time.perf_counter() - t0) * 1e3 / IDENTITY_AUTH_RUNS
        sts = c_rw.with_credentials(creds)
        _, got = ok("STS GET", timed("STS GET", len(big), lambda: sts.request(
            "GET", "/work/big")))
        if sha(got) != sha(big):
            raise SystemExit("identity: STS GET differs")
        expect(_get_calls(fi_big), 0)
        refuse("STS PUT", "AccessDenied", lambda: sts.request(
            "PUT", "/work/sts", body=small))
        no_token = client(creds["AccessKeyId"], creds["SecretAccessKey"])
        refuse("STS GET without its token", "InvalidAccessKeyId",
               lambda: no_token.request("GET", "/work/big"))
        # 6. AssumeRoleWithWebIdentity.
        token = make_hs256_token(oidc_secret, {
            "sub": "smoke-app", "aud": "mtpu", "policy": "readonly"})
        web = adm.with_credentials(adm.assume_role_with_web_identity(token))
        _, got = ok("web identity GET", web.request("GET", "/work/svc"))
        if got != small:
            raise SystemExit("identity: web identity GET differs")
        expect(1, 0)
        # 7. A POST-policy upload, its GET, a form over the range.
        upload = body(7002, IDENTITY_POST_BYTES)
        fields = c_rw.post_form("work", [
            ["starts-with", "$key", "uploads/"],
            ["content-length-range", 1, IDENTITY_POST_BYTES]])
        ok("POST upload", timed("POST-policy upload", len(upload),
                                lambda: c_rw.post_object(
                                    "work", "uploads/p", upload, fields)),
           204)
        expect(_put_calls(len(upload)), 1)
        fi_post = pools.head_object("work", "uploads/p")
        _, got = ok("POST GET", c_rw.request("GET", "/work/uploads/p"))
        if sha(got) != sha(upload):
            raise SystemExit("identity: POST upload differs")
        expect(_get_calls(fi_post), 0)
        refuse("POST over the range", "EntityTooLarge",
               lambda: c_rw.post_object("work", "uploads/q",
                                        upload + b"x", fields))
        refuse("POST outside starts-with", "AccessDenied",
               lambda: c_rw.post_object("work", "other/q", small, fields))
        del upload
        # 8. A snowball tar, every member read back.
        tar = io.BytesIO()
        members = {}
        with tarfile.open(fileobj=tar, mode="w") as tf:
            for i in range(IDENTITY_SNOW_SMALL + IDENTITY_SNOW_BIG):
                n = (IDENTITY_SNOW_SMALL_BYTES if i < IDENTITY_SNOW_SMALL
                     else IDENTITY_SNOW_BIG_BYTES)
                data = body(8000 + i, n)
                info = tarfile.TarInfo(f"m{i:03d}")
                info.size = n
                tf.addfile(info, io.BytesIO(data))
                members[f"snow/m{i:03d}"] = sha(data)
                expect(_put_calls(n), 1)
        tar = tar.getvalue()
        h, _ = ok("snowball PUT", timed("snowball PUT", len(tar),
                                        lambda: c_rw.request(
            "PUT", "/work/snow", body=tar,
            headers={"x-amz-meta-snowball-auto-extract": "true"})))
        if h.get("x-mtpu-extracted-objects") != str(len(members)):
            raise SystemExit(f"identity: snowball extracted {h}")

        def member_get(name):
            st, _, got = c_rw.request("GET", f"/work/{name}")
            if st != 200 or sha(got) != members[name]:
                raise SystemExit(f"identity: snowball member {name}: {st}")
            return len(got)
        t0 = time.perf_counter()
        got_bytes = sum(_in_threads(IDENTITY_CLIENTS, member_get,
                                    sorted(members)))
        steps["snowball member GETs"] = (time.perf_counter() - t0,
                                         got_bytes)
        expect(len(members), 0)
        del tar
        # 9. Zip-extract GETs of a stored zip.
        zbuf = io.BytesIO()
        zmembers = {}
        with zipfile.ZipFile(zbuf, "w", zipfile.ZIP_STORED) as zf:
            for i in range(IDENTITY_ZIP_MEMBERS):
                data = body(9000 + i, IDENTITY_ZIP_MEMBER_BYTES)
                zf.writestr(f"z/{i:02d}.bin", data)
                zmembers[f"z/{i:02d}.bin"] = sha(data)
        zdata = zbuf.getvalue()
        ok("zip PUT", c_rw.request("PUT", "/work/a.zip", body=zdata))
        expect(_put_calls(len(zdata)), 1)
        fi_zip = pools.head_object("work", "a.zip")
        picks = sorted(zmembers)[::max(1, len(zmembers)
                                       // IDENTITY_ZIP_GETS)]
        picks = picks[:IDENTITY_ZIP_GETS]
        t0 = time.perf_counter()
        for name in picks:
            _, got = ok("zip GET", c_ro.request(
                "GET", f"/work/a.zip/{name}",
                headers={"x-minio-extract": "true"}))
            if sha(got) != zmembers[name]:
                raise SystemExit(f"identity: zip member {name} differs")
            expect(_get_calls(fi_zip), 0)
        steps["zip-extract GETs"] = (time.perf_counter() - t0,
                                     len(picks) * IDENTITY_ZIP_MEMBER_BYTES)
        del zdata
        # 10. A bucket policy: anonymous GET on public/*.
        ok("bucket policy PUT", adm.request("PUT", "/pub", query={
            "policy": ""}, body=json.dumps({
                "Version": "2012-10-17", "Statement": [{
                    "Effect": "Allow", "Principal": {"AWS": ["*"]},
                    "Action": ["s3:GetObject"],
                    "Resource": ["arn:aws:s3:::pub/public/*"]}]}).encode()))
        expect(1, 1)                          # the policy's inline PUT
        ok("public PUT", adm.request("PUT", "/pub/public/big", body=big))
        expect(_put_calls(len(big)), 1)
        anon = S3Client(srv.endpoint, "", "", timeout=300)
        _, got = ok("anonymous GET", timed(
            "anonymous GET", len(big), lambda: anon.request(
                "GET", "/pub/public/big", auth="anonymous")))
        if sha(got) != sha(big):
            raise SystemExit("identity: anonymous GET differs")
        expect(_get_calls(pools.head_object("pub", "public/big")), 0)
        refuse("anonymous PUT", "AccessDenied", lambda: anon.request(
            "PUT", "/pub/public/new", body=big, auth="anonymous"))
        refuse("anonymous GET outside public/", "AccessDenied",
               lambda: anon.request("GET", "/work/big", auth="anonymous"))
        # The per-request cost of SigV2 against SigV4 (HEADs: no device
        # work), and the signature checks alone.
        auth_ms = {}
        for kind in ("v4", "v2", "v2-presigned"):
            t0 = time.perf_counter()
            for _ in range(IDENTITY_AUTH_RUNS):
                ok("HEAD", c_rw.request("HEAD", "/work/svc", auth=kind))
            auth_ms[kind] = ((time.perf_counter() - t0) * 1e3
                             / IDENTITY_AUTH_RUNS)
        lookup = srv._lookup_creds
        hdr = {"Host": f"{srv.host}:{srv.port}"}
        h4 = dict(hdr, **sigv4.sign_request(c_rw.creds, "GET", "/work/svc",
                                            {}, hdr, b""))
        h2 = sigv2.sign_header_v2(c_rw.creds, "GET", "/work/svc", {}, hdr)
        verify_us = {}
        for kind, fn in (("v4", lambda: sigv4.verify_header_signature(
                lookup, "GET", "/work/svc", {}, h4, b"")),
                         ("v2", lambda: sigv2.verify_header_v2(
                             lookup, "GET", "/work/svc", {}, h2))):
            t0 = time.perf_counter()
            for _ in range(IDENTITY_AUTH_RUNS):
                fn()
            verify_us[kind] = ((time.perf_counter() - t0) * 1e6
                               / IDENTITY_AUTH_RUNS)
        served_launches = counts.read()
        srv.shutdown()
        srv = None
        pools.close()
        pools = None

        # 11. A new server, a fresh IAMSys over the same drives.
        before_load = counts.read()
        t0 = time.perf_counter()
        pools = ServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                         set_drive_count=12,
                                         default_parity=4)])
        srv = serve(pools)
        load_s = time.perf_counter() - t0
        load_launches = {k: v - before_load[k]
                         for k, v in counts.read().items()}
        iam_objects = (IDENTITY_USERS + IDENTITY_SVC + IDENTITY_POLICIES
                       + IDENTITY_GROUPS)
        expect(iam_objects, 0)                # one GET each at the load
        if srv.iam.list_users() != users or \
                len(srv.iam.list_service_accounts()) != IDENTITY_SVC:
            raise SystemExit("identity: the reboot did not load every "
                             "identity")
        again = S3Client(srv.endpoint, scoped, user_secret[scoped],
                         timeout=300)
        _, got = ok("GET after the reboot", again.request(
            "GET", f"/tenants/{pre}/a"))
        if got != small:
            raise SystemExit("identity: GET after the reboot differs")
        expect(1, 0)
        launches = counts.read()              # the main path ends here
        items = counts.items()
        _check_launches("identity", launches, items, want,
                        held=("gf_matmul", "hh256", "mxh256"))
    finally:
        if srv is not None:
            srv.shutdown()
        if pools is not None:
            pools.close()
        shutil.rmtree(root, ignore_errors=True)
    took = time.perf_counter() - started
    print(f"[identity] S3Server with IAM and OIDC over one EC:8+4 set of 12 "
          f"drives: {IDENTITY_USERS} users in {IDENTITY_GROUPS} groups, "
          f"{IDENTITY_POLICIES} custom policies, {IDENTITY_SVC} service "
          f"accounts created over the admin API from {IDENTITY_CLIENTS} "
          f"clients in {create_s:.3f} s ({iam_writes} IAM object writes, "
          f"launches {create_launches}); card {card}")
    for name, (s, nbytes) in steps.items():
        print(f"[identity] {name}: {s * 1e3:.1f} ms, {nbytes} B, "
              f"{nbytes / s / 1e9:.3f} GB/s (host clock); card {card}")
    print(f"[identity] per request over HTTP (HEAD, no device work, "
          f"{IDENTITY_AUTH_RUNS} runs): SigV4 {auth_ms['v4']:.3f} ms, SigV2 "
          f"{auth_ms['v2']:.3f} ms, SigV2 presigned "
          f"{auth_ms['v2-presigned']:.3f} ms; the signature check alone: "
          f"SigV4 {verify_us['v4']:.1f} us, SigV2 {verify_us['v2']:.1f} us; "
          f"AssumeRole with an inline policy {sts_ms:.3f} ms a credential; "
          f"card {card}")
    print(f"[identity] refused with no launch, item or staging entry: "
          f"{', '.join(refused)}; card {card}")
    print(f"[identity] reboot: a fresh IAMSys loaded {iam_objects} IAM "
          f"objects ({IDENTITY_USERS} users) in {load_s:.3f} s, launches "
          f"{load_launches}; launches before the reboot {served_launches}, "
          f"in all {launches}, items {items}, expected from the objects "
          f"{want}; the phase took {took:.1f} s; card {card}")
    return launches


class _MD5InFlight:
    """Stands in for utils/streams' hashlib while installed: its md5()
    objects count the updates in flight at once (`peak`), i.e. the ETag
    workers digesting concurrently."""

    def __init__(self, streams):
        self.streams, self.mu = streams, threading.Lock()
        self.now = self.peak = 0
        outer = self

        class MD5:
            def __init__(self, *a):
                self._h = hashlib.md5(*a)

            def update(self, data):
                with outer.mu:
                    outer.now += 1
                    outer.peak = max(outer.peak, outer.now)
                try:
                    self._h.update(data)
                finally:
                    with outer.mu:
                        outer.now -= 1

            def hexdigest(self):
                return self._h.hexdigest()

        self.module = type("hashlib", (), {"md5": MD5,
                                           "sha256": hashlib.sha256})

    def __enter__(self):
        self.orig, self.streams.hashlib = self.streams.hashlib, self.module
        return self

    def __exit__(self, *exc) -> None:
        self.streams.hashlib = self.orig


def phase_host_planes(args, counts, card):
    """The host side of PUT and GET and the engine's boot planes on the
    card, over BASELINE.json config 2's deployment: one EC:8+4 set of 12
    drives on /dev/shm (MINIO_STORAGE_CLASS_STANDARD=EC:4), objects of
    64 MiB in 1 MiB blocks.

    1. `python -m minio_tpu_torch.server` boots on drives seeded with a
       dead process's staging and multipart stage files: self-tests
       (one GF and one mxh256 item and launch per card), the sweep's
       counts equal to what was seeded (_boot_server).
    2. HOST_OBJECTS streamed PUTs (BytesReader, through the ingest ring)
       of 64 MiB, HOST_HH of them highwayhash256S, from 1 client and
       from HOST_CLIENTS, with MTPU_ZEROCOPY on and =0: GB/s each, the
       SHA-256 of every part file equal between the modes, items exact,
       the MD5 updates in flight at once under HOST_CLIENTS clients >= 2
       (one ETag worker per stream).
    3. GET: get_object and get_object_iter of each object, timed; the
       metadata elections of a HEAD followed by a GET, 1 with the
       FileInfo cache and 2 with it bypassed (TTL 0).
    4. Hedged read: the drive of one data shard sleeps HOST_STALL_S in
       every read_file; GET ms with hedging (MTPU_HEDGE_MS pinned to
       HOST_HEDGE_MS: the adaptive delay starts at 50 ms, the stall's
       length) against MTPU_HEDGE=0, bodies equal, the hedged GETs
       rebuilding the stalled shard on the GF kernel; then one HTTP GET
       of it through an in-process S3Server over the same drives with
       every default on (the FileInfo cache, the adaptive hedge delay,
       the stall twice that delay): one metadata election, a hedge
       fired, a GF reconstruct, the body equal.
    5. Breaker and MRF: over health-wrapped drives, one drive raises on
       every call until its circuit opens; a PUT then writes parity 5
       ("1-offline" upgraded in xl.meta) and MRF takes it; the drive is
       restored, the queue drained, and every drive's files equal those
       of a set that never lost the drive (same parity and metadata
       written directly); the heal's items exact.
    Returns the launch counts of steps 2-5."""
    import minio_tpu_torch.engine.erasure_set as es_mod
    from minio_tpu_torch.background.mrf import MRFQueue
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server import sigv4
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage import health_wrap
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.utils import streams
    import numpy as np

    t_phase = time.perf_counter()
    boot_s = _boot_server(card, debris=True)
    need = int(4 * HOST_OBJECTS * HOST_BYTES * 1.5) + (1 << 30)
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"host planes: needs {need} bytes free on /dev/shm")
    root = tempfile.mkdtemp(prefix="chip_smoke-host-", dir="/dev/shm")
    rng = np.random.default_rng(args.seed + 11)
    bodies = {f"o{i}": rng.bytes(HOST_BYTES) for i in range(HOST_OBJECTS)}
    hh = set(list(bodies)[:HOST_HH])
    sets = []

    def new_set(name, wrap=False):
        drives = [LocalDrive(os.path.join(root, name, f"d{i:02d}"))
                  for i in range(12)]
        es = ErasureSet(health_wrap.wrap_drives(drives) if wrap else drives,
                        default_parity=4)
        sets.append(es)
        return es

    def part_hashes(es, bucket, fis):
        """SHA-256 of every part file keyed by (object, shard index):
        the shard order hashes the bucket name."""
        out = {}
        for key, fi in fis.items():
            for pos, d in enumerate(es.drives):
                p = os.path.join(d.root, bucket, key, fi.data_dir, "part.1")
                with open(p, "rb") as f:
                    out[key, fi.erasure.distribution[pos]] = \
                        hashlib.sha256(f.read()).digest()
        return out

    def put(es, bucket, key):
        return key, es.put_object(bucket, key,
                                  streams.BytesReader(bodies[key]))

    def want_for(calls_by_key, gf):
        want = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
        for key, calls in calls_by_key.items():
            want["gf_matmul"] += calls * gf
            want[_digest(HH if key in hh else "mxh256")] += calls
        return want

    def delta(before_l, before_i):
        now_l, now_i = counts.read(), counts.items()
        return ({k: now_l[k] - before_l[k] for k in now_l},
                {k: now_i[k] - before_i[k] for k in now_i})

    launches = None
    try:
        es = new_set("main")
        counts.reset()                        # the main path starts here
        # 2. PUT from 1 and HOST_CLIENTS clients, zero-copy on and =0 in
        # turns (on, =0, =0, on) at each client count.
        hashes, rates, peaks, fis = {}, {}, {}, {}
        for clients, turn, mode in [
                (c, t, m) for c in (1, HOST_CLIENTS)
                for t, m in enumerate(("default", "0", "0", "default"))]:
            if mode == "0":
                os.environ["MTPU_ZEROCOPY"] = "0"
            bucket = f"put-{mode}-{clients}-{turn}"
            es.make_bucket(bucket)
            l0, i0 = counts.read(), counts.items()
            keys = [k for k in bodies if k not in hh]
            with _MD5InFlight(streams) as inflight:
                t0 = time.perf_counter()
                # The HighwayHash objects go on their own, after the
                # others: the algorithm is read from the environment.
                done = dict(_in_threads(clients, lambda k: put(
                    es, bucket, k), keys))
                os.environ["MTPU_BITROT_ALGO"] = HH
                try:
                    done.update(_in_threads(min(clients, len(hh)),
                                            lambda k: put(es, bucket, k),
                                            sorted(hh)))
                finally:
                    os.environ.pop("MTPU_BITROT_ALGO")
                put_s = time.perf_counter() - t0
            got, items = delta(l0, i0)
            _check_launches(f"host planes PUT {mode} x{clients}", got,
                            items, want_for({k: _put_calls(HOST_BYTES)
                                             for k in bodies}, 1),
                            held=("gf_matmul", "hh256", "mxh256"))
            for key, fi in done.items():
                if fi.etag != hashlib.md5(bodies[key]).hexdigest():
                    raise SystemExit(f"host planes: ETag of {key}")
            key3 = (mode, clients, turn)
            hashes[key3] = part_hashes(es, bucket, done)
            rates[key3] = len(bodies) * HOST_BYTES / put_s / 1e9
            peaks[key3] = inflight.peak
            fis[key3] = done
            if key3 != ("default", 1, 0):
                es.delete_bucket(bucket, force=True)
            os.environ.pop("MTPU_ZEROCOPY", None)
        if len({tuple(sorted(h.items())) for h in hashes.values()}) != 1:
            raise SystemExit("host planes: part files differ between "
                             "zero-copy on and MTPU_ZEROCOPY=0")
        if min(p for (_, c, _), p in peaks.items()
               if c == HOST_CLIENTS) < 2:
            raise SystemExit(f"host planes: MD5 updates in flight {peaks}")
        print(f"[host] PUT {HOST_OBJECTS} x {HOST_BYTES} B streamed "
              f"({HOST_HH} {HH}), EC:8+4, 12 drives on tmpfs, in turns: "
              + ", ".join(f"x{c} clients zero-copy {m} {r:.3f} GB/s (MD5 "
                          f"updates in flight at once {peaks[m, c, t]})"
                          for (m, c, t), r in rates.items())
              + f"; part files' SHA-256 equal across modes; card {card}")

        # 3. GET and the FileInfo cache.
        bucket, done = "put-default-1-0", fis["default", 1, 0]
        get_ms, iter_ms = [], []
        l0, i0 = counts.read(), counts.items()
        for key, body in bodies.items():
            t0 = time.perf_counter()
            _, got = es.get_object(bucket, key)
            get_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _, it = es.get_object_iter(bucket, key)
            whole = b"".join(bytes(c) for c in it)
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            if bytes(got) != body or whole != body:
                raise SystemExit(f"host planes: GET {key} differs")
        got_l, items = delta(l0, i0)
        _check_launches("host planes GET", got_l, items, want_for(
            {k: 2 * _get_calls(fi) for k, fi in done.items()}, 0),
            held=("gf_matmul", "hh256", "mxh256"))
        elections = {}
        for label, ttl in (("cache", es._FI_CACHE_TTL), ("bypassed", 0.0)):
            es._FI_CACHE_TTL = ttl
            n0 = es_mod.stats()["meta_read_requests"]
            es.head_object(bucket, "o3")
            es.get_object(bucket, "o3")
            elections[label] = es_mod.stats()["meta_read_requests"] - n0
        del es._FI_CACHE_TTL
        if elections != {"cache": 1, "bypassed": 2}:
            raise SystemExit(f"host planes: elections {elections}")
        print(f"[host] GET of {HOST_OBJECTS} x {HOST_BYTES} B: get_object "
              f"median {statistics.median(get_ms):.1f} ms "
              f"({HOST_BYTES / statistics.median(get_ms) / 1e6:.3f} GB/s), "
              f"get_object_iter median {statistics.median(iter_ms):.1f} ms; "
              f"metadata elections for HEAD + GET: {elections['cache']} with "
              f"the FileInfo cache, {elections['bypassed']} bypassed; "
              f"card {card}")

        # 4. Hedged read over a stalled data-shard drive.
        key = "o5"
        fi = done[key]
        order = Q.shuffle_by_distribution(list(range(12)),
                                          fi.erasure.distribution)
        slow = es.drives[order[0]]
        real_read = slow.read_file

        def stalled(*a, **kw):
            time.sleep(HOST_STALL_S)
            return real_read(*a, **kw)
        slow.read_file = stalled
        hedge = {}
        try:
            hedged_env = {"MTPU_HEDGE_MS": str(HOST_HEDGE_MS)}
            for label, env in (("hedged", hedged_env),
                               ("unhedged", {"MTPU_HEDGE": "0"}),
                               ("unhedged again", {"MTPU_HEDGE": "0"}),
                               ("hedged again", hedged_env)):
                os.environ.update(env)
                l0, i0 = counts.read(), counts.items()
                h0 = es_mod.stats()
                t0 = time.perf_counter()
                _, got = es.get_object(bucket, key)
                ms = (time.perf_counter() - t0) * 1e3
                got_l, items = delta(l0, i0)
                fired = es_mod.stats()["hedge_fired"] - h0["hedge_fired"]
                for k in env:
                    os.environ.pop(k)
                if hashlib.sha256(got).digest() != \
                        hashlib.sha256(bodies[key]).digest():
                    raise SystemExit(f"host planes: {label} GET differs")
                calls = _get_calls(fi)
                _check_launches(f"host planes {label} GET", got_l, items,
                                want_for({key: calls},
                                         0 if "unhedged" in label else 1),
                                held=("gf_matmul", "hh256", "mxh256"))
                segments = len(es._plan_segments(fi, 0, fi.size))
                if "unhedged" not in label and (got_l["gf_matmul"] < 1
                                                or fired != segments):
                    raise SystemExit(f"host planes: {label} GET fired "
                                     f"{fired} hedges, launches {got_l}")
                hedge[label] = (ms, got_l["gf_matmul"], fired)
        finally:
            del slow.read_file
        print(f"[host] GET of {key} with data shard 0's drive stalled "
              f"{HOST_STALL_S * 1e3:.0f} ms a read: " + ", ".join(
                  f"{lb} {ms:.1f} ms (GF reconstruct launches {g}, hedges "
                  f"fired {f})" for lb, (ms, g, f) in hedge.items())
              + f"; bodies' SHA-256 equal; card {card}")

        # 4b. The same stalled drive behind the S3 front door with every
        # default on: the FileInfo cache at its TTL, the adaptive hedge
        # delay.  The stall outlasts twice the delay, so a hedge fires.
        hpools = srv = None
        try:
            hpools = ServerPools([ErasureSets(
                [LocalDrive(d.root) for d in es.drives], set_drive_count=12,
                default_parity=4)])
            hes = hpools.pools[0].sets[0]
            slow = hes.drives[order[0]]
            real_read = slow.read_file
            stall_s = max(HOST_STALL_S, 2 * hes._hedge_delay_s() + 0.02)

            def stalled_http(*a, **kw):
                time.sleep(stall_s)
                return real_read(*a, **kw)
            slow.read_file = stalled_http
            srv = S3Server(hpools, sigv4.Credentials(
                "smokeadmin", "smokeadmin-secret")).start()
            cli = S3Client(srv.endpoint, "smokeadmin", "smokeadmin-secret",
                           timeout=300)
            l0, i0 = counts.read(), counts.items()
            h0 = es_mod.stats()
            t0 = time.perf_counter()
            got = cli.get_object(bucket, key)
            http_ms = (time.perf_counter() - t0) * 1e3
            got_l, items = delta(l0, i0)
            h1 = es_mod.stats()
            http = {k: h1[k] - h0[k] for k in ("meta_read_requests",
                                               "hedge_fired")}
        finally:
            if srv is not None:
                srv.shutdown()
            if hpools is not None:
                hpools.close()
        if hashlib.sha256(got).digest() != \
                hashlib.sha256(bodies[key]).digest():
            raise SystemExit("host planes: HTTP GET over the stalled "
                             "drive differs")
        if http["meta_read_requests"] != 1 or http["hedge_fired"] < 1 or \
                got_l["gf_matmul"] < 1:
            raise SystemExit(f"host planes: HTTP GET with every default "
                             f"on: {http}, launches {got_l}")
        print(f"[host] HTTP GET of {key} with data shard 0's drive stalled "
              f"{stall_s * 1e3:.0f} ms a read, every default on (FileInfo "
              f"cache, adaptive hedge delay): {http_ms:.1f} ms, metadata "
              f"elections {http['meta_read_requests']}, hedges fired "
              f"{http['hedge_fired']}, GF reconstruct launches "
              f"{got_l['gf_matmul']} (items {items['gf_matmul']}); body's "
              f"SHA-256 equal; card {card}")

        # 5. Breaker and MRF over health-wrapped drives.
        fixed = "00000000-0000-4000-8000-00000000c0de"
        ident = dict(version_id="", mod_time_ns=1_700_000_000_000_000_000)
        saved_uuid = es_mod.new_uuid
        es_mod.new_uuid = lambda: fixed
        for k, v in HOST_BREAKER_ENV.items():
            os.environ[k] = v
        try:
            wes = new_set("wrapped", wrap=True)
            twin = new_set("twin")
            for s_ in (wes, twin):
                s_.make_bucket("mrf")
            wes.mrf = MRFQueue(lambda b, o, v: heal.heal_object(wes, b, o, v))
            victim = wes.drives[3]
            inner = victim._drive
            for name in ("read_all", "disk_info"):
                setattr(inner, name, lambda *a, **kw: (_ for _ in ()).throw(
                    OSError(5, "injected")))
            trips = 0
            while victim.health_state() != "offline":
                try:
                    victim.read_all("mrf", "probe")
                except OSError:
                    trips += 1
            for name in ("read_all", "disk_info"):
                delattr(inner, name)
            l0, i0 = counts.read(), counts.items()
            fi = wes.put_object("mrf", "o", streams.BytesReader(
                bodies["o6"]), **ident)
            got_l, items = delta(l0, i0)
            _check_launches("host planes breaker PUT", got_l, items,
                            want_for({"o6": _put_calls(HOST_BYTES)}, 1),
                            held=("gf_matmul", "hh256", "mxh256"))
            upgraded = wes.drives[0].read_version("mrf", "o").metadata.get(
                "x-mtpu-internal-erasure-upgraded")     # from its xl.meta
            if (fi.erasure.parity_blocks, upgraded, wes.mrf.pending()) != \
                    (5, "1-offline", 1):
                raise SystemExit(f"host planes: breaker PUT parity "
                                 f"{fi.erasure.parity_blocks}, upgraded "
                                 f"{upgraded}, MRF {wes.mrf.pending()}")
            twin.put_object("mrf", "o", bodies["o6"], parity=5, metadata={
                "x-mtpu-internal-erasure-upgraded": "1-offline"}, **ident)
            if not victim.probe_now():
                raise SystemExit("host planes: probe of the restored drive")
            l0, i0 = counts.read(), counts.items()
            t0 = time.perf_counter()
            healed = wes.mrf.drain_once()
            heal_s = time.perf_counter() - t0
            got_l, items = delta(l0, i0)
            _check_launches("host planes MRF heal", got_l, items,
                            _expected_heal_launches([fi], 3),
                            held=("gf_matmul", "hh256", "mxh256"))
            same = all(_drive_hashes(os.path.join(a.root, "mrf"))
                       == _drive_hashes(os.path.join(b.root, "mrf"))
                       for a, b in zip(wes.drives, twin.drives))
            if healed != 1 or not same or wes.mrf.pending():
                raise SystemExit(f"host planes: MRF healed {healed}, "
                                 f"drives equal to the twin {same}")
            launches = counts.read()          # the main path ends here
            for d in wes.drives:
                d.close()
        finally:
            es_mod.new_uuid = saved_uuid
            for k in HOST_BREAKER_ENV:
                os.environ.pop(k, None)
        print(f"[host] breaker: drive 3 offline after {trips} failed calls; "
              f"PUT wrote EC:7+5 upgraded 1-offline, MRF pending 1; probe "
              f"closed the circuit, one drain healed it in "
              f"{heal_s * 1e3:.1f} ms (items {items}); every drive's files "
              f"equal a set that never lost the drive; card {card}")
    finally:
        for es_ in sets:
            es_.close()
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("MTPU_ZEROCOPY", None)
    print(f"[host] phase 5j: {time.perf_counter() - t_phase:.1f} s (boot "
          f"{boot_s:.1f} s); launches {launches}; card {card}")
    return launches


def _seed_debris(root: str, n_drives: int) -> tuple[int, int]:
    """A dead process's leftovers on drives root/b1..b<n>: staged PUT
    directories and trash under tmp, multipart stage-* files beside a
    parked part.  Returns (tmp entries, stage files) seeded."""
    tmp_n = mp_n = 0
    for i in range(1, n_drives + 1):
        sys_dir = os.path.join(root, f"b{i}", ".mtpu.sys")
        for j in range(1 + i % 3):
            stage = os.path.join(sys_dir, "tmp", f"put-dead{j}")
            os.makedirs(stage)
            with open(os.path.join(stage, "part.1"), "wb") as f:
                f.write(b"\x00" * 4096)
            tmp_n += 1
        os.makedirs(os.path.join(sys_dir, "tmp", "trash-dead"))
        tmp_n += 1
        up = os.path.join(sys_dir, "multipart", "deadbeef", "upload-0")
        os.makedirs(up)
        for name in ("part.1", "part.1.meta", f"stage-dead{i}.2"):
            with open(os.path.join(up, name), "wb") as f:
                f.write(b"x")
        mp_n += 1
    return tmp_n, mp_n


def _boot_server(card, debris: bool = False) -> float:
    """`python -m minio_tpu_torch.server --drives <shm>/b{1...12}` in a
    subprocess on the card: the self-tests pass with one GF and one
    mxh256 item and launch per card, ready, one signed PUT (storage
    class STANDARD = EC:4 through MTPU_STORAGE_CLASS_STANDARD) and GET
    of 64 MiB checked by SHA-256, then SIGTERM and exit 0 within 30 s.
    With `debris` every drive first gets a dead process's leftovers
    (_seed_debris), and the boot's recovery sweep must count them all
    and leave the parked multipart part.  Returns its seconds."""
    import signal
    import urllib.request

    from minio_tpu_torch.server.client import S3Client
    import numpy as np
    import torch

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke-boot-", dir="/dev/shm")
    seeded = _seed_debris(root, 12) if debris else (0, 0)
    port = _free_port()
    env = dict(os.environ, MTPU_ROOT_USER="bootadmin",
               MTPU_ROOT_PASSWORD="bootadmin-secret",
               MTPU_STORAGE_CLASS_STANDARD="EC:4")
    env.pop("MTPU_BITROT_ALGO", None)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here
    out_path, err_path = (os.path.join(root, "out"),
                          os.path.join(root, "err"))
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", "--drives",
             os.path.join(root, "b{1...12}"), "--port", str(port)],
            cwd=here, env=env, stdout=out, stderr=err)
    try:
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                raise SystemExit(f"boot exited {proc.returncode}: "
                                 f"{open(err_path).read()[-3000:]}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/minio/health/ready",
                        timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise SystemExit("boot: never ready")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t_start
        cli = S3Client(f"http://127.0.0.1:{port}", "bootadmin",
                       "bootadmin-secret", timeout=300)
        data = np.random.default_rng(6000).bytes(OBJECT_BYTES)
        cli.make_bucket("boot")
        t0 = time.perf_counter()
        cli.put_object("boot", "o", data,
                       headers={"x-amz-storage-class": "STANDARD"})
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = cli.get_object("boot", "o")
        get_s = time.perf_counter() - t0
        if hashlib.sha256(got).digest() != hashlib.sha256(data).digest():
            raise SystemExit("boot: GET differs")
        k = sum(1 for d in range(1, 13) if os.path.isdir(
            os.path.join(root, f"b{d}", "boot", "o")))
        proc.send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            raise SystemExit("boot: no exit within 30 s of SIGTERM") \
                from None
        if rc != 0:
            raise SystemExit(f"boot: exit {rc} on SIGTERM: "
                             f"{open(err_path).read()[-3000:]}")
        stop_s = time.perf_counter() - t0
        lines = open(out_path).read().strip().splitlines()
        parked = sorted(os.listdir(os.path.join(
            root, "b1", ".mtpu.sys", "multipart", "deadbeef", "upload-0"))
            ) if debris else []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    cards = torch.cuda.device_count()
    m = re.match(r"minio_tpu_torch: self-tests passed in ([0-9.]+) ms "
                 r"\(items gf_matmul=(\d+) mxh256=(\d+); launches "
                 r"gf_matmul=(\d+) mxh256=(\d+)\)", lines[0] if lines else "")
    if not m or any(int(g) != cards for g in m.groups()[1:]):
        raise SystemExit(f"boot: self-tests line {lines[:1]}, expected one "
                         f"GF and one mxh256 item and launch per card "
                         f"({cards})")
    sweep = (f"minio_tpu_torch: recovery sweep: {seeded[0]} stale tmp "
             f"entries, {seeded[1]} orphaned multipart staging files across "
             f"12 drives")
    if lines[1] != sweep or (debris and parked != ["part.1",
                                                   "part.1.meta"]):
        raise SystemExit(f"boot: sweep {lines[1]!r} (seeded {seeded}), "
                         f"parked upload left {parked}")
    served = next((ln for ln in lines
                   if ln.startswith("minio_tpu_torch server on")), "")
    print(f"[boot] self-tests {float(m.group(1)):.3f} ms on {cards} card(s):"
          f" items gf_matmul {m.group(2)}, mxh256 {m.group(3)}; launches "
          f"gf_matmul {m.group(4)}, mxh256 {m.group(5)}; recovery sweep: "
          f"{seeded[0]} stale tmp entries and {seeded[1]} multipart stage "
          f"files seeded, swept and counted; card {card}")
    print(f"[server] boot: python -m minio_tpu_torch.server over 12 drives "
          f"ready in {ready_s:.1f} s ({served}); signed "
          f"PUT of {OBJECT_BYTES} B with x-amz-storage-class STANDARD (EC:4)"
          f" in {put_s * 1e3:.0f} ms onto {k} drives, GET in "
          f"{get_s * 1e3:.0f} ms, SHA-256 equal; SIGTERM: exit 0 in "
          f"{stop_s:.1f} s; card {card}")
    if k != 12:
        raise SystemExit(f"boot: the object is on {k} drives, not 12")
    return time.perf_counter() - t_start


def phase_layers(torch, card, dev):
    """Where one 32 MiB EC:8+4 PUT batch's and GET batch's time goes,
    step by step (host clock around synchronised work, median of 5),
    one HTTP HEAD's split, and the device's busy share over one 64 MiB
    PUT + GET (torch.profiler)."""
    import minio_tpu_torch.engine.erasure_set as es_mod
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.ops import devices, fused
    from minio_tpu_torch.server import sigv4
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.handlers import S3Handlers
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage import bitrot_io
    from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
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

    stage = [LocalDrive(os.path.join(root, f"w{i}")) for i in range(12)]
    runs = iter(range(1 << 30))

    def write(views):
        # A fresh staging file on each drive, one write_file_batches
        # call each, as a PUT stages a batch.
        run = next(runs)
        for d, v in zip(stage, views):
            d.write_file_batches(SYS_VOL, f"tmp/layers{run}/part.1", [v])

    def append(views):
        run = next(runs)
        for d, v in zip(stage, views):
            d.append_file(SYS_VOL, f"tmp/layers{run}/part.1", v)

    def show(title, rows, nbytes):
        for name, ms in rows.items():
            print(f"[layers] {title}: {name}: {ms:.3f} ms")
        print(f"[layers] {title}: sum {sum(rows.values()):.3f} ms "
              f"({nbytes / sum(rows.values()) / 1e6:.3f} GB/s if serial); "
              f"card {card}")

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
        rows["12 vectored shard writes (write_file_batches), serial"], _ = \
            timed(lambda: write(views))
        appends, _ = timed(lambda: append(views))
        rows["MD5 of the batch"], _ = timed(
            lambda: hashlib.md5(blocks).hexdigest())
        show("32 MiB PUT batch", rows, 32 * MIB)

        # The ingest layer alone: a 64 MiB body read through BytesReader
        # into 32 MiB chunks, by the pooled ring (zero-copy on) over the
        # default 32 MiB buffer pool and over one of 512 MiB (every slot
        # of 4 streams pooled), and by the bytearray chunker
        # (MTPU_ZEROCOPY=0); from 1 and from 4 threads at once, in turns.
        from minio_tpu_torch.ops import bpool
        from minio_tpu_torch.utils import streams
        stream_body = np.random.default_rng(3).bytes(64 * MIB)

        def chunk_all(_=None):
            n = 0
            for c, _ in streams.batched_chunks(
                    b"", streams.BytesReader(stream_body), 32 * MIB):
                n += len(c)
            if n != len(stream_body):
                raise SystemExit("layers: chunked length differs")
        default_pool = bpool.default_pool()
        pools = {"ring, 32 MiB pool": default_pool,
                 "ring, 512 MiB pool": bpool.BufferPool(512 * MIB),
                 "bytearray (MTPU_ZEROCOPY=0)": None}
        ingest = {}
        try:
            for threads in (1, 4):
                for label in (*pools, *reversed(pools)):
                    pool = pools[label]
                    if pool is None:
                        os.environ["MTPU_ZEROCOPY"] = "0"
                    else:
                        bpool._POOL = pool
                    f0 = (pool or default_pool).stats()["fallbacks"]
                    ms, _ = timed(lambda: _in_threads(
                        threads, chunk_all, range(threads)))
                    falls = (pool or default_pool).stats()["fallbacks"] - f0
                    os.environ.pop("MTPU_ZEROCOPY", None)
                    ingest.setdefault((threads, label), []).append(
                        (ms, falls if pool is not None else None))
        finally:
            bpool._POOL = default_pool
            os.environ.pop("MTPU_ZEROCOPY", None)
        for (threads, label), runs_ in ingest.items():
            print(f"[layers] 64 MiB streamed body into 32 MiB chunks, "
                  f"{threads} stream(s) at once, {label}: " + " and ".join(
                      f"{ms:.3f} ms" for ms, _ in runs_)
                  + ("" if runs_[0][1] is None else
                     f" (fallback mappings {runs_[0][1]} and "
                     f"{runs_[1][1]} over 6 runs)") + f"; card {card}")

        # PipelinedMD5 of one 32 MiB chunk: a writable view (a ring
        # slot: copied before it is queued) against bytes (queued as
        # is), in turns.
        md5_rows = {}
        chunk_bytes = stream_body[:32 * MIB]
        chunk_view = memoryview(bytearray(chunk_bytes))
        for label, piece in (("writable view", chunk_view),
                             ("bytes", chunk_bytes),
                             ("bytes", chunk_bytes),
                             ("writable view", chunk_view)):
            def one_md5(piece=piece):
                md5 = streams.PipelinedMD5()
                md5.update(piece)
                return md5.hexdigest()
            ms, digest = timed(one_md5)
            if digest != hashlib.md5(chunk_bytes).hexdigest():
                raise SystemExit("layers: PipelinedMD5 differs")
            md5_rows.setdefault(label, []).append(ms)
        print(f"[layers] PipelinedMD5 of a 32 MiB chunk, in turns: writable "
              f"view (copied) {md5_rows['writable view'][0]:.3f} and "
              f"{md5_rows['writable view'][1]:.3f} ms, bytes "
              f"{md5_rows['bytes'][0]:.3f} and {md5_rows['bytes'][1]:.3f} "
              f"ms; card {card}")
        print(f"[layers] 32 MiB PUT batch: 12 shard appends (append_file, "
              f"MTPU_ZEROCOPY=0), serial, timed after the vectored writes: "
              f"{appends:.3f} ms; card {card}")

        # One 32 MiB GET batch of a healthy object, step by step: the k
        # data shards' frames read, gathered into (nb, k, S), copied to
        # the card, verified, the digests back, the bytes assembled.
        body = np.random.default_rng(2).bytes(64 * MIB)
        with ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                         for i in range(12)], default_parity=4) as es:
            es.make_bucket("prof")
            fi = es.put_object("prof", "warm", body)
            order = Q.shuffle_by_distribution(list(range(12)),
                                              fi.erasure.distribution)
            frame = 32 + fi.erasure.shard_size
            path = f"warm/{fi.data_dir}/part.1"
            rows = {}
            rows["8 shard reads (32 frames each), serial"], raws = timed(
                lambda: [es.drives[order[s]].read_file(
                    "prof", path, 0, 32 * frame) for s in range(8)])
            split = [bitrot_io.split_frames(np.frombuffer(r, np.uint8), 32,
                                            fi.erasure.shard_size)
                     for r in raws]

            def gather():
                x = np.empty((32, 8, fi.erasure.shard_size), np.uint8)
                for i in range(8):
                    x[:, i, :] = split[i][1]
                return x
            rows["host gather into (32, 8, S)"], x = timed(gather)
            rows["host-to-device copy (pageable)"], xg = timed(
                lambda: devices.put(x, dev))
            rows["verify (digests) on the device"], dg = timed(
                lambda: fused.verify_and_transform(xg, 8, 4, tuple(range(8)),
                                                   (), device=dev)[0])
            rows["device-to-host copy of the digests"], dh = timed(
                lambda: dg.cpu().numpy())
            if any(not np.array_equal(dh[:, i], split[i][0])
                   for i in range(8)):
                raise SystemExit("layers: GET batch digests differ")
            out = bytearray(32 * MIB)

            def assemble():
                memoryview(out)[:] = es_mod._assemble(x, None, 0)
            rows["assembly into the response buffer"], _ = timed(assemble)
            if out != body[:32 * MIB]:
                raise SystemExit("layers: GET batch bytes differ")
            show("32 MiB GET batch", rows, 32 * MIB)

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

        # One HTTP HEAD of a 64 MiB object, split: the client's new
        # connection, the handler (of which the metadata election), and
        # the election alone with and without the FileInfo cache.
        pools = ServerPools([ErasureSets(
            [LocalDrive(os.path.join(root, f"h{i}")) for i in range(12)],
            set_drive_count=12, default_parity=4)])
        srv = S3Server(pools, sigv4.Credentials("layers", "layers-secret"))
        srv.start()
        try:
            cli = S3Client(srv.endpoint, "layers", "layers-secret",
                           timeout=60)
            cli.make_bucket("head")
            cli.put_object("head", "obj", body)
            hes = pools.pools[0].sets[0]
            heads = []
            with _Timed(S3Client, "_connect") as conn, \
                    _Timed(S3Handlers, "get_object") as handler, \
                    _Timed(type(hes), "_read_metadata") as elect:
                for _ in range(21):
                    t0 = time.perf_counter()
                    cli.head_object("head", "obj")
                    heads.append((time.perf_counter() - t0) * 1e3)
            n = len(heads)
            uncached, _ = timed(lambda: hes._read_metadata("head", "obj"))
            hes.head_object("head", "obj")
            cached, _ = timed(lambda: hes._read_metadata_cached("head",
                                                                "obj"))
            print(f"[layers] HTTP HEAD of a {64 * MIB} B object ({n} "
                  f"requests): median {statistics.median(heads):.3f} ms; "
                  f"mean new connection {conn.s / n * 1e3:.3f} ms, handler "
                  f"{handler.s / n * 1e3:.3f} ms, of which the metadata "
                  f"election {elect.s / n * 1e3:.3f} ms; the election alone "
                  f"{uncached:.3f} ms, a FileInfo-cache hit {cached:.3f} ms;"
                  f" card {card}")
        finally:
            srv.shutdown()
            pools.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hh256-baseline", metavar="CU",
                    help="another build of csrc/hh256.cu (same hh256_launch)"
                    " to time against the kernel in turns in phase 4")
    ap.add_argument("--gf-baseline", metavar="CU",
                    help="another build of csrc/gf_matmul.cu, of the form "
                    "with (R, C, 32) byte tables (PRs 1-4), to check and "
                    "time against the kernel in turns in phase 2")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from minio_tpu_torch.engine.erasure_set import ErasureSet
        from minio_tpu_torch.ops import coalesce, cuda_build
        from minio_tpu_torch.ops import erasure_cuda as ec
        from minio_tpu_torch.ops import erasure_torch as et
        from minio_tpu_torch.ops import fused
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
        fn = ""
        for line in built[src][1].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[build] {src.name} {fn}: {line.strip()}")
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
    gf_loops = {"kernel": sass_gf_loop(built[ec.LIBRARY.source][0])}
    baseline = gf_baseline = None
    if args.hh256_baseline or args.gf_baseline:
        extra = [Path(p).resolve() for p in (args.hh256_baseline,
                                             args.gf_baseline) if p]
        libs = cuda_build.build(extra)
        print(f"[build] baselines {', '.join(p.name for p in extra)} built "
              "for the turns of phases 2 and 4")
    if args.hh256_baseline:
        lib = libs[Path(args.hh256_baseline).resolve()][0]
        baseline = ctypes.CDLL(str(lib)).hh256_launch
        baseline.argtypes = hc.LIBRARY.argtypes
        baseline.restype = ctypes.c_int
    if args.gf_baseline:
        lib = libs[Path(args.gf_baseline).resolve()][0]
        gf_baseline = ctypes.CDLL(str(lib)).gf_matmul_launch
        gf_baseline.argtypes = ec.LIBRARY.argtypes
        gf_baseline.restype = ctypes.c_int
        gf_loops["baseline"] = sass_gf_loop(lib, baseline=True)
    for who, loops_ in gf_loops.items():
        for variant, loop in loops_.items():
            top = ", ".join(f"{op} {k:g}" for op, k in loop["ops"].items())
            print(f"[build] gf_matmul.cu {who} {variant} lookup loop at "
                  f"C = 8 (cuobjdump -sass), per input byte for four output"
                  f" rows: 32-bit integer instructions by pipe "
                  f"{loop['per_byte']}, {sum(loop['per_byte'].values()):g} "
                  f"in all; LDS {loop['lds']:g}; every instruction "
                  f"{loop['all']:g}; opcodes: {top}; global stores in the "
                  f"function: {', '.join(loop['stores'])}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = [phase_kernel(torch, ec, et, gen, card, gf_baseline)]
    mxh = phase_mxh(torch, mxhash, mt, gen, card)
    records.append(phase_hh_kernel(torch, hc, ht, spec, gen, card, loops,
                                   baseline))

    counts = Launches({"gf_matmul": ec, "hh256": hc, "mxh256": mt}, fused)
    paths = {
        "mxh256 slice": lambda: phase_slice(
            args, counts, card, "mxh256",
            [OBJECT_BYTES] * 2 + [OBJECT_BYTES + 300 * 1024]),
        "highwayhash256S slice": lambda: phase_slice(
            args, counts, card, HH, [OBJECT_BYTES] * 2 + [TAIL_OBJECT_BYTES]),
        "heal": lambda: phase_heal(args, counts, card),
        "multipart": lambda: phase_multipart(args, counts, card),
        "drive heal": lambda: phase_drive_heal(args, counts, card),
        "object layer": lambda: phase_object_layer(args, counts, card),
        "server": lambda: phase_server(args, counts, card),
        "dispatch": lambda: phase_dispatch(args, counts, card),
        "identity": lambda: phase_identity(args, counts, card),
        "host planes": lambda: phase_host_planes(args, counts, card),
    }
    per_path, tally = {}, {}
    faults0 = coalesce.stats()
    fi_ttl = ErasureSet._FI_CACHE_TTL
    with MxhShapes(fused, mt) as counts.shapes:
        for name, run in paths.items():
            # Phases 5a-5g, 5i and 5j count every GET's device work from
            # the sizes (5a and 5b probe reads of corrupted frames): they
            # run without the device shard cache; 5h runs every default.
            # A hedge that fires turns a slow healthy read into a rebuild,
            # and a FileInfo-cache hit serves an inline object's shards
            # from metadata elected before the phase took drives away or
            # wiped them: the counts of 5a-5i allow neither, so they run
            # with MTPU_HEDGE=0 and the cache's TTL at 0; 5j runs both.
            if name == "dispatch":
                os.environ.pop("MTPU_DEVCACHE", None)
            else:
                os.environ["MTPU_DEVCACHE"] = "0"
            if name == "host planes":
                os.environ.pop("MTPU_HEDGE", None)
                ErasureSet._FI_CACHE_TTL = fi_ttl
            else:
                os.environ["MTPU_HEDGE"] = "0"
                ErasureSet._FI_CACHE_TTL = 0.0
            coalesce.reset()
            per_path[name] = run()
            for shape, k in counts.last_shapes.items():
                tally[shape] = tally.get(shape, 0) + k
            st = coalesce.get().stats()
            queued = st["dispatches"] - st["inline_dispatches"]
            if name != "dispatch":
                print(f"[lanes] {name}: dispatches {st['dispatches']} "
                      f"(inline {st['inline_dispatches']}, pipelined "
                      f"{st['pipeline_dispatches']}), items "
                      f"{st['items']}, at most {st['max_items']} a "
                      f"dispatch; card {card}")
                if st["batch_faults"] or \
                        st["pipeline_dispatches"] != queued:
                    raise SystemExit(f"{name}: lanes {st}")
    os.environ.pop("MTPU_DEVCACHE", None)
    os.environ.pop("MTPU_HEDGE", None)
    ErasureSet._FI_CACHE_TTL = fi_ttl
    faults = coalesce.stats()
    if (faults["co_fallbacks"], faults["co_faults"]) != \
            (faults0["co_fallbacks"], faults0["co_faults"]):
        raise SystemExit(f"coalescer fallbacks or faults on the main "
                         f"paths: {faults0} -> {faults}")
    counts.shapes = None
    print(f"[launches] per main path: {per_path}")
    calls = sum(p["mxh256"] for p in per_path.values())
    print(f"[mxh256] at (384, 131072): {mxh['ms']:.4f} ms against a bound "
          f"of {mxh['bound_ms']:.4f} ms; card {card}")
    phase_mxh_shapes(torch, mt, gen, card, tally, calls)
    for rec in records:
        rec["launches"] = sum(p[rec["name"]] for p in per_path.values())
    phase_layers(torch, card, torch.device("cuda", 0))

    # mxh256 is no hand-written kernel and replaces no pallas_call: its
    # row stands beside the kernels, not among them, with route "torch".
    torch_ops = [{
        "name": "mxh256", "route": "torch",
        "source": "minio_tpu_torch/ops/mxhash_torch.py",
        "replaces": "minio_tpu/ops/mxhash_jax.py:47 (XLA, not Pallas)",
        "launches": calls, "max_abs_err": mxh["max_abs_err"],
        "ms": mxh["ms"], "plain_ms": mxh["ms"],
        "bound_ms": mxh["bound_ms"], "bound_by": mxh["bound_by"],
        "library_ms": None}]
    print(card)
    print(json.dumps({"kernels": records, "torch_ops": torch_ops}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
