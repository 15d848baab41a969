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
   e. drive heal: a formatted set holding 2 mxh256 objects of 64 MiB,
      4 HighwayHash objects of 64 MiB + 300 KiB + 5 B, 32 inline
      objects, a multipart object and a versioned object with a delete
      marker (a versioned DELETE); a data-shard drive wiped whole; heal_format, heal_drive
      with four workers stopped after a third of the objects (the saved
      tracker checked) and resumed; every file of the drive back to its
      recorded SHA-256, launches equal to those the sizes call for, and
      every version read byte-exact with three other drives away.  Then
      pipelined and serial (MTPU_HEAL_PIPELINE=0), with four workers and
      with one, uninterrupted, each once on a fresh wipe.
   f. object layer: one ServerPools of 4 EC:8+4 sets x 12 drives
      (MinIO's MINIO_ERASURE_SET_DRIVE_COUNT=12, STANDARD=EC:4), a
      versioned bucket of 256 objects of 1-100 KiB, 24 of 4 MiB + 1 B
      and 4 of 64 MiB (2 HighwayHash), about 0.6 GB (the depth cut for
      phases l, m and t): PUT with SipHash
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
      versioned bucket, 4 objects of 64 MiB by streamed UNSIGNED-PAYLOAD
      PUT from 1 and 4 clients (1 highwayhash256S), one of 64 MiB +
      300 KiB + 5 B by signed aws-chunked PUT, 128 of 1-100 KiB by
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
      MTPU_COALESCE=0 and with MTPU_H2D_PIPELINE=0: 16 clients x 2
      objects of 1 MiB PUT and GET, 4 clients x 2 HighwayHash objects,
      two 64 MiB objects PUT and GET from 1 and from 2 clients and read
      degraded with two drives of every set away, and a 16 MiB object
      read twice, the second read a device-shard-cache hit that copies 0
      bytes to the card by the ledger (ops/devcache.py).  Bodies equal,
      part files' SHA-256 equal in every mode, no fallback or batch
      fault, every lane-thread dispatch pipelined when the pipeline is
      on; per step GB/s, operations/s, dispatches and items per
      dispatch, the lanes' time split, bytes copied per byte served.
   i. the front door's identity planes: an S3Server with an IAMSys and
      an HS256 OIDC provider over one EC:8+4 set of 12 drives; root
      creates 64 users in 5 groups, 12 custom policies scoped to a
      bucket and prefix and 12 service accounts over the admin API
      (each IAM object an inline PUT on the card); a SigV2-header PUT of
      64 MiB read back by a SigV2 presigned GET and by SigV4; a readonly
      user's 64 MiB PUT refused; a prefix-scoped user, service accounts,
      AssumeRole with an inline GetObject-only policy (no session token
      refused), AssumeRoleWithWebIdentity; a 32 MiB POST-policy upload
      under content-length-range and starts-with, and one over the range
      refused; a snowball tar of 256 members read back; zip-extract GETs
      from a 64 MiB stored zip; a bucket policy serving an anonymous
      64 MiB GET and refusing an anonymous PUT; a new server whose fresh
      IAMSys loads every identity from the drives.  Items equal the
      counts the objects call for; every refused request adds no launch,
      no item and no staging entry.  ms and GB/s per step, the IAM
      create and load seconds, SigV2 against SigV4 per request and the
      ms to issue STS credentials.
   j. the host planes (phase_host_planes): the standalone boot on
      drives seeded with a dead process's staging (self-tests' ms and
      launches, the sweep's counts); 4 streamed 64 MiB PUTs (1
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
   k. the pre-fork worker pool (phase_pool): `python -m
      minio_tpu_torch.server` booted as a subprocess with MTPU_WORKERS=4
      (a supervisor, the device owner and 4 SO_REUSEPORT workers) and
      with 0, in turns (0, 4: half the turns it had before phase l
      joined the run), on one EC:8+4 set of 12 drives on
      /dev/shm; client processes that load no torch PUT and GET one
      64 MiB object each from 1 and 8 clients, 8 objects of 1 MiB
      each from 16, and (the turn with workers, highwayhash256S) 1 of
      64 MiB each from 4.  GB/s and operations/s per step; with workers
      the owner's dispatches and items, the arena's waits and timeouts,
      the fallbacks, the lanes' pack ms per MiB (beside one process's)
      and the CUDA contexts (the processes' own reports and nvidia-smi's
      compute apps).  Bodies and ETags exact, part files equal across
      turns, the owner's items exact with no fallback where the batches
      fit the arena, a context in the owner alone; in the last turn the
      owner is SIGKILLed under 4 clients' PUTs (no PUT lost, fallbacks,
      generation + 1, later items the owner's again); SIGTERM exits 0.
      The boots run with the hot tier on (the default): every GET there
      reads its key once (a first miss only plants a ghost) or an object
      over MTPU_HOTCACHE_MAX_OBJ, so no count changes.
   l. the GET side of the serving spine (phase_get_spine): the same
      deployment with the default 64 MiB hot-object tier, booted four
      times over one set of drives (one process, tier on and
      MTPU_HOTCACHE=0; MTPU_WORKERS=4, tier on with new objects written
      highwayhash256S, and MTPU_HOTCACHE=0); client processes read a
      hot set of 32 x 1 MiB + 6 x 4 MiB (two cold rounds, the two-hit
      admission, then from 1 and 16 clients: GB/s and GET/s with the
      tier and without, misses' device items exact, hits' 0), a scan of
      32 distinct keys (no fill, the hot set stays resident), 16
      concurrent cold GETs of one admitted 4 MiB key (one engine read in
      one process), highwayhash256S misses (hh256 exact), a versioned
      key warm in every worker read after a PUT of a new version (the
      new bytes from every worker), and GETs with one drive away (GF
      rebuilds exact, nothing filled); then in this process an EC:1+1
      set of 2 drives behind an S3Server: 2 x 64 MiB whole GETs from 1
      and 4 clients with MTPU_ZEROCOPY=1 (a verified sendfile plan: its
      device items exact, one sendfile per GET) against =0, bodies
      equal.
   m. the metadata plane of the PUT side (phase_meta_plane): the server
      booted as one process on fresh drives with the metadata lanes (the
      default) and with MTPU_METABATCH=0 (every server of the phase
      booted at once), driven in turns; 16 client processes
      PUT 4 inline objects of 4-64 KiB each (the JAX package's
      small-object mix), HEAD every one and GET a quarter, then one
      client 32 the same way: PUT/s, HEAD/s, p50 and p99, publishes per
      journal fsync, keys per metadata read round, trim accepted and
      fallen back, the device items equal across the turns; on /dev/shm
      and, for the 16-client turns with 4 objects a client, on a
      disk-backed directory (not tmpfs) when one has room.  Then a
      SIGKILL under 16 clients' journaled PUTs
      (MTPU_METABATCH_SOLO=1) after 200 acknowledgements, the reboot's
      journal replay, every acknowledged PUT read back exact and no key
      holding bytes never written to it; and in this process, with the
      lanes forced on over 12 NaughtyDrives, a failed write_metadata, a
      failed and a stalled read_version, two drives taken away and a
      breaker tripped by failed laned publishes, each reaching its
      target with exact items.
   n. the admission plane (phase_admission): BASELINE.json config 2's
      deployment as two pools of 2 workers and the device owner booted
      at once (QoS on; MTPU_QOS=0) with the JAX package's overload_bench
      settings (4 slots, a 2 s deadline, a queue of 12, tenants gold
      premium, std standard, beff best-effort), 256 KiB objects, client
      processes half PUT, half GET of 8 warm objects (tier hits), legs
      of 6 s: capacity (1 client a tenant), overload (4, 4, 8) after 6 s
      of decay, collapse (the 16 with MTPU_QOS=0): goodput, overload
      over capacity, premium p99 against 2 x deadline + capacity p99,
      sheds per class and reason, best-effort shed before premium, the
      legs' device items equal to their acknowledged PUTs; a worker
      holding 3 slots with stalled PUTs SIGKILLed (in flight equal to
      the live rows after its respawn, 4 requests admitted at once, no
      GET or HEAD waiting 2 s); a heal of a wiped drive under the
      overload in one process (its workers, its yields, the drive equal
      to itself before the wipe); and a check that phases a-m, QoS on
      at the default budget, shed nothing.
   o. the other bitrot forms (phase_bitrot_forms): sha256 objects of
      64 MiB and 64 MiB + 300 KiB + 5 B on config 2's set, PUT, GET,
      degraded GET and heal of a wiped drive with exact GF items and no
      mxh256 or hh256 item (the digests are hashlib's, on the host);
      legacy xl.json objects of the same sizes (whole-file HighwayHash,
      10 MiB blocks) GET, HEAD, listed and read with a corrupted shard
      (one hh256 item a part, one GF item a chunk size); bodies by
      SHA-256; one 32 MiB batch's encode with sha256 digests against
      mxh256's.
   p. the distributed cluster (phase_cluster): 4 node processes x 4
      drives behind URL endpoints, one set of 16 with STANDARD=EC:4,
      booted at once; one client process a node PUTs 64 MiB objects and
      GETs each through the next node; inline objects listed alike from
      every node; one key PUT through two nodes at once, round after
      round; versioning enabled through node 1 after node 2 read it
      absent, then two PUTs of one key through node 2, both versions
      listed by every node; node 4 SIGKILLed (every GET served, GF rebuilds exact, a
      PUT at write quorum, a dsync lock with 3 of 4 lockers), booted
      again and healed by a heal sequence; then, every node stopped, the
      16 drives in this process: a deep dry-run heal finds every copy
      ok and every object reads from node 4's drives.  Items per step
      from the nodes' metrics; boot s, PUT and GET GB/s beside 5f's,
      ms a dsync lock against the local lock, heal s.
   q. the pool lifecycle and the data scanner (phase_lifecycle): a
      versioned bucket written in this process onto pool 0 (one EC:8+4
      set of 12 drives, STANDARD=EC:4): 6 objects of 64 MiB (2
      highwayhash256S, one of 64 MiB + 300 KiB + 5 B), 128 of 1-100 KiB,
      3 versions and a delete marker of one key, a pending upload of 2
      parts of 16 MiB; the server booted with MTPU_WORKERS=2; admin
      pool/add of pool 1 (12 more drives) through one worker, seen by
      both; pool/decommission of pool 0 with 4 PUTs during it landing
      on pool 1, the mover's worker SIGKILLed after 3 versions moved,
      the drain completed by its respawn, its status equal from both
      workers; pool 0 empty, every version byte-exact with its id, ETag
      and mod time, the upload completed under its old id; a reboot
      with pool 0's drives alone attaching pool 1 from
      pool-topology.json; then in this process a scanner's normal cycle
      (usage exact, a removed xl.meta healed), deep cycle (a corrupted
      frame of a 64 MiB shard found and healed), a PUT counted by the
      next cycle, and the admin's datausage.  Items exact per step, and
      across the SIGKILL within one version's items of the count; drain
      GB/s and versions/s, boot and reboot s, scan s and GB/s.
   r. the data-protection planes (phase_protection): object lock,
      lifecycle expiry through a scanner cycle, and bucket replication
      from two 2-worker sources into an in-process target, across the
      target's death and a worker's SIGKILL between an acknowledged PUT
      and its copy.
   s. bucket notifications (phase_notify): a 2-worker pool with
      notify_webhook and notify_nats from the environment (a loopback
      webhook and a NATS fake in this script); every acknowledged PUT,
      multipart complete and DELETE at both targets with its event
      name, key, size, ETag and version id; a rule changed through one
      worker fired through the other; the webhook down for 16 PUTs and
      again while the worker holding parked events is SIGKILLed (none
      lost, kill-step duplicates counted); per key, a PUT's record
      before its DELETE's at both targets: both while the webhook is
      down, the DELETE after its return but before the retry pass, and
      across the SIGKILL (each pair on one connection, so one worker's
      store holds both); ListenNotification on an in-process server;
      the webhook's ms per PUT against PUTs into a bucket without rules;
      items exact per step, none for a notification.
   t. the tier (phase_tier), as MinIO documents it (`mc admin tier add
      minio WARM`, `mc ilm rule add --transition-days N
      --transition-tier WARM`): the hot side in this process on config
      2's set, a warm port server (`python -m minio_tpu_torch.server`,
      EC:4+2 on 6 drives) reached over loopback by S3TierBackend, the
      tier added through the admin `tier` endpoint (its credentials
      sealed by the KMS), the rule by PUT ?lifecycle on a versioned
      bucket; 2 x 64 MiB, 64 objects of 1-100 KiB and one
      highwayhash256S object of 64 MiB from 4 client threads; one
      scanner cycle with the clock past the rule's days moves them all
      (one source read through the GF decode with two data shards
      away); full and ranged GETs through every stub byte-exact, half
      with a warm drive away; HEADs with the tier's storage class; a
      temporary restore (x-amz-restore) re-expired by a cycle two days
      on; a permanent restore; DELETEs of stubs by version freeing their
      tier objects; a transition in a subprocess dying at
      ilm.post_copy, its orphan reaped by the next TierManager's replay.
      GF, hh256 and mxh256 items exact per step in this process and in
      the warm server (its metrics).
   Phases a-g and i-t run with MTPU_DEVCACHE=0: their counts assume
   every GET reads its shards, and a and b probe a GET of a corrupted
   frame.  Phases a-i and k-t run with MTPU_HEDGE=0 and the FileInfo
   cache's TTL at 0: a hedge that fires turns a slow healthy read into a
   rebuild, and a cache hit serves an inline object from metadata
   elected before drives were taken away or wiped; their counts allow
   neither.  Every booted server runs with MTPU_SCANNER=0 (as the JAX
   crash harness boots its servers): a scanner's cycle reads the drives,
   writes usage and the dirty set and heals, which the booted phases'
   exact counts and drive trees do not allow.  Every phase runs with the metadata lanes on (the default):
   concurrent inline PUTs group-commit, and concurrent elections read
   through the lanes and the K+1 trim, which reads the drives holding
   the key's data shards, so no count changes.
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
MTPU_COALESCE=0).  Phase k reads the counts of the pool's own processes
(the owner and the workers, each from 0 at its start) from the pool's
metrics before and after each step, and its launches join the kernels'
(its mxh256 calls are not in the shape tally).  Each path starts on fresh coalescer lanes; after each
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
# The drive-heal deployment (phase 5e): DRIVE_HEAL_MXH mxh256 objects of
# DRIVE_HEAL_OBJECT and 4 HighwayHash objects of DRIVE_HEAL_TAIL_OBJECT in
# bucket a; 32 inline objects, a multipart object of DRIVE_HEAL_PARTS and
# an object with DRIVE_HEAL_VERSIONS and a delete marker in bucket b.
DRIVE_HEAL_OBJECT = OBJECT_BYTES
# 16 before phases 5o and 5p joined the run, 8 before phase 5q, 4
# before 5t, 2 before 5u.
DRIVE_HEAL_MXH = 1
DRIVE_HEAL_TAIL_OBJECT = TAIL_OBJECT_BYTES
DRIVE_HEAL_PARTS = (OBJECT_BYTES, OBJECT_BYTES, 5 * MIB + 7)
DRIVE_HEAL_VERSIONS = (8 * MIB + 1, 3 * MIB + 17)
# The object-layer deployment (phase 5f): MinIO's
# MINIO_ERASURE_SET_DRIVE_COUNT=12 with MINIO_STORAGE_CLASS_STANDARD=EC:4,
# one pool of LAYER_SETS sets; a versioned bucket of LAYER_SMALL objects
# of LAYER_SMALL_BYTES (inline), LAYER_MID of LAYER_MID_BYTES (a ragged
# tail block) and LAYER_BIG of LAYER_BIG_BYTES, LAYER_BIG_HH of them
# under highwayhash256S.  Cut to half its depth (2048 small and 24 big
# objects, 6 of them highwayhash256S, before phase 5l joined the run),
# its big objects to 8 (12, 3 of them highwayhash256S, before phase 5m
# joined it) and its small ones to 512 (1024 before phase 5n joined it)
# to keep the whole run within its time.
LAYER_SETS, LAYER_SET_DRIVES = 4, 12
# LAYER_SMALL 512 before phase 5q joined the run, 256 before 5t.
LAYER_SMALL, LAYER_SMALL_BYTES = 128, (1024, 100 * 1024)
# LAYER_MID 96 before phases 5o and 5p joined the run, 48 before 5q,
# 24 before 5t.
LAYER_MID, LAYER_MID_BYTES = 12, 4 * MIB + 1
# LAYER_BIG 8 before phase 5r joined the run, 6 before 5t.
LAYER_BIG, LAYER_BIG_HH, LAYER_BIG_BYTES = 4, 2, OBJECT_BYTES
# The S3 server on the card (phase 5g), over the deployment of 5f:
# SERVER_BIG objects of SERVER_BIG_BYTES (SERVER_BIG_HH highwayhash256S),
# one of SERVER_CHUNKED_BYTES by aws-chunked PUT, SERVER_SMALL of
# SERVER_SMALL_BYTES (the first SERVER_SMALL_SERIAL from one client),
# one multipart upload of SERVER_PARTS, a ranged GET of SERVER_RANGE
# (offset, length) per large object.  SERVER_SMALL and SERVER_BIG cut to
# half (1024, 128 of them from one client, and 16, before phase 5m
# joined the run), and SERVER_SMALL to half again (512, 64 from one
# client, before phase 5n joined it) to keep the whole run within its
# time.
SERVER_SETS = LAYER_SETS
# SERVER_BIG 8 before phase 5r joined the run; (6, 2) before 5t.
SERVER_BIG, SERVER_BIG_HH, SERVER_BIG_BYTES = 4, 1, OBJECT_BYTES
SERVER_CHUNKED_BYTES = TAIL_OBJECT_BYTES
# (256, 32) before phase 5q joined the run, (128, 16) before 5t.
SERVER_SMALL, SERVER_SMALL_SERIAL = 64, 16
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
# twice (the second read a device-cache hit).  DISPATCH_SMALL_PER cut to
# half (8 before phase 5m joined the run) to keep the whole run within
# its time.
# DISPATCH_SMALL_PER 4 before phases 5o and 5p joined the run.
# DISPATCH_SMALL_CLIENTS 16 before phase 5t joined the run, 8 before 5u.
DISPATCH_SMALL_CLIENTS, DISPATCH_SMALL_PER, DISPATCH_SMALL_BYTES = 4, 2, MIB
DISPATCH_HH_CLIENTS, DISPATCH_HH_PER = 4, 2
# DISPATCH_BIG_CLIENTS 4 before phase 5t joined the run.
DISPATCH_BIG_CLIENTS, DISPATCH_BIG_BYTES = 2, OBJECT_BYTES
DISPATCH_AWAY = (0, 1)
DISPATCH_HIT_BYTES = 16 * MIB
# The host planes (phase 5j) over BASELINE.json config 2's deployment:
# HOST_OBJECTS streamed PUTs of HOST_BYTES (HOST_HH highwayhash256S) from
# 1 client and HOST_CLIENTS; a data-shard drive stalled HOST_STALL_S a
# read under a hedge delay pinned to HOST_HEDGE_MS; the breaker's
# thresholds of HOST_BREAKER_ENV.  The GET step's reads run under a hedge
# delay pinned to HOST_GET_HEDGE_MS, above any of its reads, so that no
# hedge fires there on a slow machine (its GF items are held at 0).
# HOST_OBJECTS 8 and HOST_HH 2 before phase 5t joined the run.
HOST_OBJECTS, HOST_HH, HOST_BYTES, HOST_CLIENTS = 4, 1, OBJECT_BYTES, 4
HOST_STALL_S, HOST_HEDGE_MS = 0.05, 10
HOST_GET_HEDGE_MS = 10_000
HOST_BREAKER_ENV = {"MTPU_BREAKER_ERRS": "2",
                    "MTPU_BREAKER_OFFLINE_ERRS": "4",
                    "MTPU_BREAKER_PROBE_S": "30"}
# The pre-fork worker pool (phase 5k) over BASELINE.json config 2's
# deployment, booted with MTPU_WORKERS = each of POOL_TURNS in turns:
# client processes (no torch) PUT and GET one POOL_BIG object each from
# each of POOL_BIG_CLIENTS clients and POOL_SMALL_PER objects of
# POOL_SMALL_BYTES each from POOL_SMALL_CLIENTS; in a turn with workers,
# on a pool booted with highwayhash256S, POOL_HH_PER POOL_BIG
# objects each from POOL_HH_CLIENTS; in the last turn POOL_KILL_CLIENTS
# clients PUT POOL_KILL_PER POOL_BIG objects each while the owner is
# SIGKILLed POOL_KILL_AFTER_S seconds in, and as many after its respawn.
POOL_WORKERS = 4
# (POOL_WORKERS, 0, 0, POOL_WORKERS) before phase 5l joined the run: cut to
# one turn each to keep the whole run within its time.
POOL_TURNS = (0, POOL_WORKERS)
POOL_BIG = OBJECT_BYTES
# (1, 4, 16) before phase 5n joined the run, (1, 16) before 5q, (1, 8)
# before 5r, (1, 4) before 5s; POOL_SMALL_PER 8 before 5r, 4 before 5s.
POOL_BIG_CLIENTS = (4,)
# POOL_SMALL_PER 2, POOL_HH_PER 2, POOL_SMALL_CLIENTS 16 and
# POOL_HH_CLIENTS 4 before 5t.
POOL_SMALL_CLIENTS, POOL_SMALL_PER, POOL_SMALL_BYTES = 8, 1, MIB
POOL_HH_CLIENTS, POOL_HH_PER = 2, 1
# POOL_KILL_CLIENTS 4 before phase 5t joined the run.
POOL_KILL_CLIENTS, POOL_KILL_PER, POOL_KILL_AFTER_S = 2, 1, 0.15
# Phase 5l, the GET side of the serving spine, over the same deployment
# with the default 64 MiB hot tier: a hot set of SPINE_HOT (count, size)
# objects that the tier holds, read by each of SPINE_CLIENTS client
# processes; a scan of SPINE_SCAN distinct objects of 1 MiB;
# SPINE_SF_CLIENTS concurrent cold GETs of one admitted 4 MiB object;
# SPINE_HH highwayhash256S objects of 1 MiB; SPINE_DEG objects of 1 MiB
# read with one drive away; SPINE_STALE_ROUNDS rounds of
# SPINE_SF_CLIENTS GETs of a versioned key after a PUT of a new version;
# and SPINE_SENDFILE objects of 64 MiB on an EC:1+1 set of 2 drives read
# from each of SPINE_SENDFILE_CLIENTS clients, sendfile against
# MTPU_ZEROCOPY=0.
# ((32, MIB), (6, 4 * MIB)) before phase 5r joined the run, ((16, MIB),
# (6, 4 * MIB)) before 5t.
SPINE_HOT = ((8, MIB), (3, 4 * MIB))
SPINE_WORKERS = POOL_WORKERS
SPINE_SMALL, SPINE_SF_BYTES = MIB, 4 * MIB
# (1, 4, 16), and SPINE_SCAN 128, before phase 5n joined the run; (1, 16)
# before 5s.
SPINE_CLIENTS = (16,)
# Past SPINE_STRIDE clients, each client reads a SPINE_STRIDE-th of the
# hot set (16 clients read it 4 times over, as 4 clients do).
SPINE_STRIDE = 4
# 64 before phase 5q joined the run, 32 before 5s.
SPINE_SCAN = 16
SPINE_SF_CLIENTS = 16
# SPINE_HH 4, SPINE_DEG 8 and SPINE_SENDFILE_CLIENTS (1, 4) before 5s;
# SPINE_HH 2 and SPINE_DEG 4 before 5t.
SPINE_HH, SPINE_DEG, SPINE_STALE_ROUNDS = 1, 2, 4
# SPINE_SENDFILE 4 before 5t.
SPINE_SENDFILE, SPINE_SENDFILE_CLIENTS = 2, (4,)
# Phase 5m, the metadata plane of the PUT side, over BASELINE.json
# config 2's deployment: META_CLIENTS client processes PUT META_PER
# objects each, of sizes uniform in META_BYTES (inline: under the
# 128 KiB SMALL_FILE_THRESHOLD; the JAX package's small-object mix,
# SMALLOBJ_r19.json so_small_lo_kib, so_small_hi_kib and so_clients),
# then HEAD every object and GET every META_GET_STRIDE-th; one client
# does the same with META_ONE objects; with the lanes (the default) and
# with MTPU_METABATCH=0, in turns, on fresh drives.  Then
# META_KILL_CLIENTS clients PUT up to META_KILL_PER objects each under
# MTPU_METABATCH_SOLO=1, and the server is SIGKILLed once META_KILL_ACKS
# are acknowledged.
# META_PER was 16 before phase 5n joined the run, 8 before 5o and 5p, 4
# before 5r.
META_CLIENTS, META_PER, META_BYTES = 16, 2, (4 * 1024, 64 * 1024)
# META_ONE 32 and META_KILL_ACKS 200 before phase 5r joined the run,
# META_ONE 16 before 5s, 8 before 5t.
META_GET_STRIDE, META_ONE = 4, 4
# META_KILL_ACKS 100 before 5s; (16, 50) before 5t.
META_KILL_CLIENTS, META_KILL_PER, META_KILL_ACKS = 8, 32, 25
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
              for i in range(DRIVE_HEAL_MXH)]
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
    MTPU_HEAL_PIPELINE=0, with four workers and with one) once, each on a
    fresh wipe of the drive."""
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
        # Each way of healing once, uninterrupted (twice, in turns ABCD
        # DCBA, before phase 5n joined the run).
        ways = [("pipelined, 4 workers", "1", 4),
                ("pipelined, 1 worker", "1", 1),
                ("serial, 4 workers", "0", 4), ("serial, 1 worker", "0", 1)]
        for name, pipeline, workers in ways:
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
            line(f"{name}, turn {turn + 1} of {len(rs)}", r)
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
    ONE_PROCESS_GBPS["pools"] = rates["pools"]
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
    clients PUT DISPATCH_SMALL_PER objects of 1 MiB each, then GET them; 4 clients PUT and
    GET 2 highwayhash256S objects each; DISPATCH_BIG_CLIENTS 64 MiB
    objects PUT from 1 client and again from DISPATCH_BIG_CLIENTS, then
    read from 1 and from DISPATCH_BIG_CLIENTS; degraded GETs of them
    from DISPATCH_BIG_CLIENTS clients with two drives of every set away; one 16 MiB
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
# The IAM state cut to half (1000 users, 20 groups, 50 policies and 100
# service accounts before phase 5m joined the run) and the snowball tar
# to half (448 and 64 members before phase 5n joined it) to keep the
# whole run within its time.
# (500, 10, 25, 50) before phases 5o and 5p joined the run.
# 250 users and 25 service accounts before phase 5q joined the run.
# IDENTITY_USERS 125 before phase 5t joined the run.
IDENTITY_USERS, IDENTITY_GROUPS = 64, 5
IDENTITY_POLICIES, IDENTITY_SVC = 12, 12
IDENTITY_BIG_BYTES, IDENTITY_POST_BYTES = OBJECT_BYTES, 32 * MIB
# IDENTITY_SNOW_SMALL 224, IDENTITY_SNOW_BIG 32 and IDENTITY_AUTH_RUNS 200
# before phase 5u joined the run.
IDENTITY_SNOW_SMALL, IDENTITY_SNOW_SMALL_BYTES = 112, 64 * 1024
IDENTITY_SNOW_BIG, IDENTITY_SNOW_BIG_BYTES = 16, MIB
IDENTITY_ZIP_MEMBERS, IDENTITY_ZIP_MEMBER_BYTES = 64, MIB
IDENTITY_ZIP_GETS, IDENTITY_AUTH_RUNS = 4, 100
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
    # Two mxh256 objects the later steps single out (the highwayhash256S
    # ones come first): the hedged read's, and the body of the MRF step.
    hedge_key, mrf_key = (f"o{HOST_OBJECTS - 2}", f"o{HOST_OBJECTS - 1}")
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
        os.environ["MTPU_HEDGE_MS"] = str(HOST_GET_HEDGE_MS)
        try:
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
        finally:
            os.environ.pop("MTPU_HEDGE_MS", None)
        if max(get_ms + iter_ms) >= HOST_GET_HEDGE_MS:
            raise SystemExit(f"host planes: a GET took {max(get_ms + iter_ms)}"
                             f" ms, past the pinned hedge delay")
        got_l, items = delta(l0, i0)
        _check_launches("host planes GET", got_l, items, want_for(
            {k: 2 * _get_calls(fi) for k, fi in done.items()}, 0),
            held=("gf_matmul", "hh256", "mxh256"))
        elections = {}
        for label, ttl in (("cache", es._FI_CACHE_TTL), ("bypassed", 0.0)):
            es._FI_CACHE_TTL = ttl
            n0 = es_mod.stats()["meta_read_requests"]
            es.head_object(bucket, mrf_key)
            es.get_object(bucket, mrf_key)
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
        key = hedge_key
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
            # The admission plane reads the bucket's quota config (its
            # bandwidth budget) once per server, an election of its own:
            # read before the counted GET, whose elections are its own.
            srv._qos_bucket_rate(bucket)
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
                bodies[mrf_key]), **ident)
            got_l, items = delta(l0, i0)
            _check_launches("host planes breaker PUT", got_l, items,
                            want_for({mrf_key: _put_calls(HOST_BYTES)}, 1),
                            held=("gf_matmul", "hh256", "mxh256"))
            upgraded = wes.drives[0].read_version("mrf", "o").metadata.get(
                "x-mtpu-internal-erasure-upgraded")     # from its xl.meta
            if (fi.erasure.parity_blocks, upgraded, wes.mrf.pending()) != \
                    (5, "1-offline", 1):
                raise SystemExit(f"host planes: breaker PUT parity "
                                 f"{fi.erasure.parity_blocks}, upgraded "
                                 f"{upgraded}, MRF {wes.mrf.pending()}")
            twin.put_object("mrf", "o", bodies[mrf_key], parity=5, metadata={
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
             f"12 drives; 0 xl.meta entries replayed from the metadata "
             f"journal")
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


def pool_client(spec: dict) -> int:
    """One client process of phase 5k (`chip_smoke.py --pool-client
    JSON`): makes its bodies from their seeds, says `ready`, then PUTs
    every object on `put` and GETs every one on `get` (every N-th from
    the K-th on `get K N`) from stdin (each as often as it comes, until
    stdin closes), each time printing one
    JSON line with its monotonic start and end, whether every ETag and
    body was right, and whether it loaded torch."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from minio_tpu_torch.server.client import S3Client

    cli = S3Client(f"http://127.0.0.1:{spec['port']}", spec["ak"],
                   spec["sk"], timeout=600)
    # A cluster's client (5p) GETs through another node than it PUTs.
    get_cli = S3Client(f"http://127.0.0.1:{spec.get('get_port', spec['port'])}",
                       spec["ak"], spec["sk"], timeout=600)
    bodies = {key: np.random.default_rng(seed).bytes(size)
              for key, size, seed in spec["objects"]}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in bodies.items()}
    print("ready", flush=True)
    for line in sys.stdin:
        verb, *cut = line.split()
        if verb not in ("put", "get"):
            return 1
        # "get K N": every N-th object from the K-th.
        keys = list(bodies)[int(cut[0])::int(cut[1])] if cut else bodies
        ok, statuses = True, []
        t0 = time.monotonic()
        for key in keys:
            body = bodies[key]
            path = f"/{spec['bucket']}/{key}"
            if verb == "put":
                st, hdrs, _ = cli.request(
                    "PUT", path, body=body,
                    headers={"x-amz-storage-class": "STANDARD"})
                etag = {k.lower(): v for k, v in hdrs.items()}.get(
                    "etag", "").strip('"')
                ok &= st == 200 and etag == hashlib.md5(body).hexdigest()
            else:
                st, _, got = get_cli.request("GET", path)
                ok &= st == 200 and \
                    hashlib.sha256(got).hexdigest() == sha[key]
            statuses.append(st)
        t1 = time.monotonic()
        print(json.dumps({"t0": t0, "t1": t1, "ok": bool(ok),
                          "statuses": statuses,
                          "torch": "torch" in sys.modules}), flush=True)
    return 0


def meta_client(spec: dict) -> int:
    """One client process of phase 5m (`chip_smoke.py --meta-client
    JSON`): makes its bodies from their seeds, says `ready`, then on
    each line of stdin PUTs (`put`), HEADs (`head`) or GETs (`get K N`:
    every N-th object from the K-th) its objects, or GETs each and
    classes the answer (`check`: "exact"; "missing" for a 404; "wrong"
    for other bytes; "error <status>" for another answer, which carries
    no object bytes); each time it prints one JSON line with its monotonic start
    and end, whether every answer was right, each request's ms, the
    classes, the error that stopped it (a server killed under it) and
    whether it loaded torch.  With `acks`, each acknowledged PUT's key
    is appended to that file at once."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import http.client

    import numpy as np

    from minio_tpu_torch.server.client import S3Client

    cli = S3Client(f"http://127.0.0.1:{spec['port']}", spec["ak"],
                   spec["sk"], timeout=120)
    bodies = {key: np.random.default_rng(seed).bytes(size)
              for key, size, seed in spec["objects"]}
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in bodies.items()}
    acks = open(spec["acks"], "a") if spec.get("acks") else None
    print("ready", flush=True)
    for line in sys.stdin:
        verb, *cut = line.split()
        if verb not in ("put", "head", "get", "check"):
            return 1
        keys = list(bodies)[int(cut[0])::int(cut[1])] if cut else \
            list(bodies)
        ok, lat, classes, err = True, [], {}, ""
        t0 = time.monotonic()
        for key in keys:
            path = f"/{spec['bucket']}/{key}"
            t = time.perf_counter()
            try:
                if verb == "put":
                    st, hdrs, _ = cli.request(
                        "PUT", path, body=bodies[key],
                        headers={"x-amz-storage-class": "STANDARD"})
                    h = {k.lower(): v for k, v in hdrs.items()}
                    good = st == 200 and \
                        h.get("etag", "").strip('"') == md5[key]
                    if good and acks is not None:
                        acks.write(key + "\n")
                        acks.flush()
                elif verb == "head":
                    st, hdrs, _ = cli.request("HEAD", path)
                    h = {k.lower(): v for k, v in hdrs.items()}
                    good = (st == 200 and h.get("etag", "").strip('"')
                            == md5[key] and int(h.get("content-length", -1))
                            == len(bodies[key]))
                else:
                    st, _, got = cli.request("GET", path)
                    good = st == 200 and got == bodies[key]
                    if verb == "check":
                        classes[key] = ("exact" if good else "missing"
                                        if st == 404 else "wrong"
                                        if st == 200 else f"error {st}")
                        good = True
            except (OSError, http.client.HTTPException) as e:
                ok, err = False, repr(e)
                break
            lat.append((time.perf_counter() - t) * 1e3)
            ok &= good
        print(json.dumps({"t0": t0, "t1": time.monotonic(), "ok": bool(ok),
                          "lat": lat, "classes": classes, "err": err,
                          "torch": "torch" in sys.modules}), flush=True)
    return 0


class _GetSpans:
    """Host-clock spans, in ms, of the GETs an in-process S3Server answers
    while it is entered: the sendfile plan (election, fds, mmap) and its
    frame verify, the engine read the handler waited on (election, shard
    reads, verify, copy out), the device verify calls inside either, and
    the socket sends (sendfile, sendmsg, or the buffered writer's
    sendall).  Patches module and instance attributes, and puts them
    back on exit."""

    def __init__(self, spools):
        self.spools = spools
        self.ms: dict[str, float] = {}
        self._mu = threading.Lock()

    def _add(self, name: str, t0: float) -> None:
        with self._mu:
            self.ms[name] = self.ms.get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3

    def _timed(self, name: str, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._add(name, t0)
        return run

    def _get_iter(self, real):
        def run(*a, **kw):
            t0 = time.perf_counter()
            fi, it = real(*a, **kw)
            self._add("engine read waited", t0)

            def chunks():
                try:
                    while True:
                        t1 = time.perf_counter()
                        try:
                            chunk = next(it)
                        except StopIteration:
                            return
                        finally:
                            self._add("engine read waited", t1)
                        yield chunk
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
            return fi, chunks()
        return run

    def __enter__(self):
        import socketserver
        from minio_tpu_torch.engine import heal
        from minio_tpu_torch.ops import fused
        from minio_tpu_torch.ops import zerocopy as zc
        self._saved = [(m, a, getattr(m, a)) for m, a in (
            (heal, "_verify_frames"), (fused, "verify_and_transform"),
            (zc, "send_file"), (zc, "send_gather"),
            (socketserver._SocketWriter, "write"))]
        for (m, a, fn), name in zip(self._saved, (
                "plan frame verify", "device verify calls", "sendfile",
                "sendmsg", "buffered writes")):
            setattr(m, a, self._timed(name, fn))
        sp = self.spools
        sp.sendfile_plan = self._timed("sendfile plan", sp.sendfile_plan)
        sp.get_object_iter = self._get_iter(sp.get_object_iter)
        return self

    def __exit__(self, *exc) -> None:
        for m, a, fn in self._saved:
            setattr(m, a, fn)
        del self.spools.sendfile_plan, self.spools.get_object_iter


class _Clients:
    """Client processes of phases 5k-5m, started with subprocess (never a
    fork of this CUDA-initialised process), all ready before any PUT;
    `per_client` lists each client's (key, size, seed) objects; `role`
    is the client's entry (`--pool-client`, or `--meta-client` with
    `acks`, a directory where client c appends the keys of its
    acknowledged PUTs to the file c)."""

    def __init__(self, port: int, bucket: str, per_client: list[list],
                 role: str = "--pool-client", acks: str | None = None,
                 ports: list[int] | None = None):
        here = os.path.abspath(__file__)
        self.procs = []
        self.per_client = per_client
        for c, objs in enumerate(per_client):
            spec = {"port": port, "ak": "pooladmin",
                    "sk": "pooladmin-secret", "bucket": bucket,
                    "objects": objs}
            if ports:
                # One node a client: PUT through node c, GET through the
                # next one.
                spec["port"] = ports[c % len(ports)]
                spec["get_port"] = ports[(c + 1) % len(ports)]
            if acks:
                spec["acks"] = os.path.join(acks, str(c))
            self.procs.append(subprocess.Popen(
                [sys.executable, here, role, json.dumps(spec)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for p in self.procs:
            if p.stdout.readline().strip() != "ready":
                self.close()
                raise SystemExit("pool: a client did not start")

    def run(self, verb: str, during=None, only: int | None = None,
            stride: int | None = None, strict: bool = True) -> dict:
        """Every client's `verb` at once, or the first `only` clients'
        (`during()` runs once they are told); with `stride`, client c
        takes every `stride`-th of its objects from the (c % stride)-th.
        Seconds from the first start to the last end, GB/s and
        operations/s over them, and the clients' answers ("res"); a
        wrong answer fails the run unless not `strict`."""
        procs = self.procs[:only]
        objs = self.per_client[:only]
        if stride:
            objs = [o[c % stride::stride] for c, o in enumerate(objs)]
        for c, p in enumerate(procs):
            p.stdin.write(verb + (f" {c % stride} {stride}" if stride
                                  else "") + "\n")
            p.stdin.flush()
        if during is not None:
            during()
        res = []
        for p in procs:
            line = p.stdout.readline()
            if not line:
                raise SystemExit(f"pool: a client died during {verb}")
            res.append(json.loads(line))
        bad = [r for r in res if (strict and not r["ok"]) or r["torch"]]
        if bad:
            raise SystemExit(f"pool: {verb} wrong or loaded torch: {bad}")
        s = max(r["t1"] for r in res) - min(r["t0"] for r in res)
        return {"s": s,
                "gbps": sum(z for o in objs for _, z, _ in o) / s / 1e9,
                "ops": sum(len(o) for o in objs) / s, "res": res}

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


#: (server log, its admission counters {"admitted", "shed"}, or None
#: where it served no metrics) of every server a phase stopped
POOL_QOS: list = []


class _Pool:
    """`python -m minio_tpu_torch.server` over `drives` (12) drives under
    `root` with MTPU_WORKERS=`workers`, booted as a subprocess (fork and
    exec); `metrics()` reads the pool's families when workers > 0."""

    def __init__(self, root: str, workers: int, algo: str = "mxh256",
                 env: dict | None = None, drives: int = 12):
        self.root, self.workers = root, workers
        self.port = _free_port()
        extra = env or {}
        env = dict(os.environ, MTPU_ROOT_USER="pooladmin",
                   MTPU_ROOT_PASSWORD="pooladmin-secret",
                   MTPU_STORAGE_CLASS_STANDARD="EC:4",
                   MTPU_WORKERS=str(workers))
        env.update(extra)
        env.pop("MTPU_IPC_DISPATCH", None)
        env.pop("MTPU_BITROT_ALGO", None)
        if algo != "mxh256":
            env["MTPU_BITROT_ALGO"] = algo
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here
        self.log = os.path.join(
            root, f"pool-w{workers}-{algo}-{len(os.listdir(root))}.log")
        t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch.server", "--drives",
                 os.path.join(root, f"b{{1...{drives}}}"), "--port",
                 str(self.port)],
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 240
        while not self._ready():
            if self.proc.poll() is not None:
                raise SystemExit(f"pool: boot exited {self.proc.returncode}:"
                                 f" {self.tail()}")
            if time.monotonic() > deadline:
                raise SystemExit(f"pool: never ready: {self.tail()}")
            time.sleep(0.2)
        self.boot_s = time.perf_counter() - t0

    def _ready(self) -> bool:
        import urllib.request
        try:
            if self.workers:
                m = self.metrics()
                return all(m.get(f'mtpu_worker_ready{{worker="{w}"}}') == 1
                           for w in range(self.workers))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/minio/health/ready",
                    timeout=2) as r:
                return r.status == 200
        except OSError:
            return False

    def tail(self) -> str:
        with open(self.log) as f:
            return f.read()[-3000:]

    def metrics(self) -> dict:
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/minio/v2/metrics/node",
                timeout=5) as r:
            text = r.read().decode()
        out = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, v = line.rsplit(" ", 1)
                out[name] = float(v)
        return out

    def settled(self) -> dict:
        """The metrics once every process's 0.1 s heartbeat has published
        the last step."""
        time.sleep(0.15)
        return self.metrics()

    def pids(self) -> dict[int, str]:
        m = self.metrics()
        out = {self.proc.pid: "supervisor",
               int(m["mtpu_owner_pid"]): "owner"}
        out.update({int(m[f'mtpu_worker_pid{{worker="{w}"}}']): f"worker{w}"
                    for w in range(self.workers)})
        return out

    def stop(self) -> float:
        """SIGTERM: the supervisor (or the one process) exits 0 within
        30 s.  First the admission plane's counters, where the server
        serves its metrics, go into POOL_QOS."""
        import signal
        try:
            m = self.metrics()
        except OSError:
            m = None                  # no metrics (one process, no tier)
        POOL_QOS.append((os.path.basename(self.log), None if m is None else {
            what: sum(v for k, v in m.items()
                      if k.startswith(f"mtpu_qos_{what}_total{{"))
            for what in ("admitted", "shed")}))
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            raise SystemExit("pool: no exit within 30 s of SIGTERM") \
                from None
        if rc != 0:
            raise SystemExit(f"pool: exit {rc} on SIGTERM: {self.tail()}")
        return time.perf_counter() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _pool_counts(m: dict, workers: int) -> dict:
    """The pool's counters from one metrics read: the owner's dispatches,
    items and lane packing, the arena's waits and timeouts, per kernel
    the launches and items summed over the owner and the workers, the
    workers' fallbacks, and which processes have a CUDA context."""
    out = {"owner_pid": m["mtpu_owner_pid"],
           "items": m["mtpu_owner_coalesce_items_total"],
           "dispatches": m["mtpu_owner_coalesce_dispatches_total"],
           "pack_s": m["mtpu_owner_lane_pack_seconds_total"],
           "staged": m["mtpu_owner_lane_staged_bytes_total"],
           "waits": m["mtpu_shm_arena_alloc_waits_total"],
           "timeouts": m["mtpu_shm_arena_alloc_timeouts_total"]}
    for k in ("gf_matmul", "hh256", "mxh256"):
        for what in ("launches", "items"):
            out[f"owner_{what}_{k}"] = m[
                f'mtpu_owner_kernel_{what}_total{{kernel="{k}"}}']
            out[f"{what}_{k}"] = out[f"owner_{what}_{k}"] + sum(
                m[f'mtpu_worker_kernel_{what}_total{{worker="{w}",'
                  f'kernel="{k}"}}'] for w in range(workers))
    for what in ("ipc_fallbacks", "co_fallbacks", "remote_submits"):
        out[what] = sum(m[f'mtpu_worker_{what}_total{{worker="{w}"}}']
                        for w in range(workers))
    out["cuda"] = {"owner": int(m["mtpu_owner_cuda_context"]),
                   **{f"worker{w}": int(
                       m[f'mtpu_worker_cuda_context{{worker="{w}"}}'])
                      for w in range(workers)}}
    return out


def _compute_apps() -> list[tuple[int, str]]:
    """(pid, used memory) of every process nvidia-smi lists with a
    context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    rows = []
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            rows.append((int(pid), mem.strip()))
    return rows


def _pool_part_hashes(root: str, bucket: str) -> dict:
    """SHA-256 of every part file under `bucket`, keyed by (object, shard
    index): the shard order hashes the bucket name."""
    from minio_tpu_torch.storage.xlmeta import XLMeta
    out = {}
    for d in range(1, 13):
        base = os.path.join(root, f"b{d}", bucket)
        for key in sorted(os.listdir(base)):
            with open(os.path.join(base, key, "xl.meta"), "rb") as f:
                fi = XLMeta.from_bytes(f.read()).latest(bucket, key)
            with open(os.path.join(base, key, fi.data_dir, "part.1"),
                      "rb") as f:
                out[key, fi.erasure.distribution[d - 1]] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


def _pool_objects(clients: int, per: int, size: int, seed: int,
                  prefix: str) -> list[list]:
    """Each client's (key, size, seed) objects."""
    return [[(f"{prefix}-c{c}-{i}", size, seed + 1000 * c + i)
             for i in range(per)] for c in range(clients)]


def _inprocess_part_hashes(bucket: str, per_client: list[list],
                           algo: str) -> dict:
    """_pool_part_hashes of the same objects PUT by an ErasureSet of 12
    drives in this process (its launches are no main path's)."""
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    root = tempfile.mkdtemp(prefix="chip_smoke-twin-", dir="/dev/shm")
    os.environ["MTPU_BITROT_ALGO"] = algo
    try:
        es = ErasureSet([LocalDrive(os.path.join(root, f"b{i}"))
                         for i in range(1, 13)], default_parity=4)
        es.make_bucket(bucket)
        for objs in per_client:
            for key, size, seed in objs:
                es.put_object(bucket, key,
                              np.random.default_rng(seed).bytes(size))
        es.close()
        return _pool_part_hashes(root, bucket)
    finally:
        os.environ.pop("MTPU_BITROT_ALGO", None)
        shutil.rmtree(root, ignore_errors=True)


def _inprocess_pack_ms_per_mib(card) -> float:
    """The lanes' pack ms per MiB staged in one process, for the owner's
    to stand beside: POOL_KILL_CLIENTS threads each PUT one POOL_BIG
    object on one EC:8+4 set of 12 drives through the in-process
    coalescer (its launches are no main path's and are not counted)."""
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.ops import coalesce
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np

    root = tempfile.mkdtemp(prefix="chip_smoke-pack-", dir="/dev/shm")
    try:
        es = ErasureSet([LocalDrive(os.path.join(root, f"d{i:02d}"))
                         for i in range(12)], default_parity=4)
        es.make_bucket("pack")
        bodies = [np.random.default_rng(i).bytes(POOL_BIG)
                  for i in range(POOL_KILL_CLIENTS)]
        coalesce.reset()
        _in_threads(POOL_KILL_CLIENTS,
                    lambda i: es.put_object("pack", f"o{i}", bodies[i]),
                    range(POOL_KILL_CLIENTS))
        st = coalesce.get().stats()
        es.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    coalesce.reset()
    ms = st["pack_s"] * 1e3 / (st["h2d_bytes"] / MIB) \
        if st["h2d_bytes"] else float("nan")
    print(f"[pool] in one process: {POOL_KILL_CLIENTS} PUTs of {POOL_BIG} B "
          f"at once: lanes pack {ms:.4f} ms/MiB over "
          f"{st['h2d_bytes'] / MIB:.0f} MiB staged in "
          f"{st['pipeline_dispatches']} pipelined dispatches; card {card}")
    return ms


def phase_pool(args, counts, card):
    """The pre-fork worker pool on the card over BASELINE.json config 2's
    deployment: one EC:8+4 set of 12 drives on /dev/shm
    (MINIO_STORAGE_CLASS_STANDARD=EC:4), 64 MiB objects in 1 MiB blocks.

    `python -m minio_tpu_torch.server` boots as a subprocess with
    MTPU_WORKERS=4 (a supervisor, the device owner and 4 SO_REUSEPORT
    workers) and =0 (one process), in the turns of POOL_TURNS, each on
    fresh drives.  Client processes that load no torch PUT, then GET:

    1. one 64 MiB object from each of 1 and of 4 clients, and 8 objects
       of 1 MiB from each of 16 clients: with workers, the owner's items
       exactly what the sizes call for, no fallback, no arena timeout,
       and afterwards a CUDA context in the owner alone (its own and the
       workers' reports, and nvidia-smi's compute apps);
    2. one 64 MiB object from each of 16 clients: the arena's waits and
       timeouts and the fallbacks are findings, not failures;
    3. in the last turn: 4 clients PUT one object of 64 MiB each while
       the owner is SIGKILLed: every PUT 200 with its ETag and every
       body equal, fallbacks > 0, the generation one higher; then 4
       more whose items are the owner's again, exactly;
    4. SIGTERM: exit 0 within 30 s;
    5. in the turn with workers, a pool booted with highwayhash256S over the
       same drives: 2 objects of 64 MiB from each of 4 clients, items
       exact, part files equal to an ErasureSet's in this process.

    Per step GB/s and operations/s; with workers the owner's dispatches,
    items and items per dispatch, the arena's waits and timeouts, the
    fallbacks and the lanes' pack ms per MiB staged (beside one
    process's, _inprocess_pack_ms_per_mib).  The part files of every
    object are equal across the turns.  Returns the kernel launches in
    the pool's processes (owner and workers) over its steps, the
    owner-kill step's left out (the dead owner's last launches are not
    readable)."""
    import signal

    from minio_tpu_torch.server.client import S3Client

    need = (12 * (sum(POOL_BIG_CLIENTS) * POOL_BIG
                  + POOL_SMALL_CLIENTS * POOL_SMALL_PER * POOL_SMALL_BYTES
                  + 2 * POOL_KILL_CLIENTS * POOL_KILL_PER * POOL_BIG
                  + POOL_HH_CLIENTS * POOL_HH_PER * POOL_BIG) // 8
            + (2 << 30))
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"pool: needs {need} bytes free on /dev/shm")
    t_phase = time.perf_counter()
    launches = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
    hashes: dict = {}
    n_small = POOL_SMALL_CLIENTS * POOL_SMALL_PER
    n_kill = POOL_KILL_CLIENTS * POOL_KILL_PER
    n_hh = POOL_HH_CLIENTS * POOL_HH_PER
    calls = _put_calls(POOL_BIG)               # = the GET's for 64 MiB

    def step(pool, bucket, name, per_client, expect=None, during=None,
             owner_dies=False):
        """PUT then GET of `per_client`'s objects; with workers the
        pool's counters around each verb, held to `expect` (PUT, GET
        owner items) when given.  Only a step that kills the owner
        (`owner_dies`) may see it replaced: the dead owner's launches
        since the last read are lost with it and the new one's count its
        self-tests, so that step's launches join no tally."""
        cl = _Clients(pool.port, bucket, per_client)
        out = {}
        try:
            before = (_pool_counts(pool.settled(), pool.workers)
                      if pool.workers else None)
            for verb in ("put", "get"):
                out[verb] = cl.run(verb, during if verb == "put" else None)
                if pool.workers:
                    after = _pool_counts(pool.settled(), pool.workers)
                    d = {k: after[k] - before[k] for k in after
                         if k != "cuda"}
                    d["replaced"] = bool(d["owner_pid"])
                    if d["replaced"] and not owner_dies:
                        raise SystemExit(f"pool: w={pool.workers} {name} "
                                         f"{verb}: the owner was replaced")
                    if not owner_dies:
                        for k in launches:
                            launches[k] += int(d[f"launches_{k}"])
                    out[verb]["d"] = d
                    before = after
        finally:
            cl.close()
        text = []
        for i, verb in enumerate(("put", "get")):
            r = out[verb]
            t = f"{verb.upper()} {r['gbps']:.3f} GB/s {r['ops']:.2f} ops/s"
            d = r.get("d")
            if d is not None:
                disp = int(d["dispatches"])
                pack = (f"{d['pack_s'] * 1e3 / (d['staged'] / MIB):.4f} "
                        f"ms/MiB over {d['staged'] / MIB:.0f} MiB"
                        if d["staged"] else "nothing staged")
                owner = ("owner replaced: its counters not read"
                         if d["replaced"] else
                         f"owner {disp} dispatches, {int(d['items'])} items,"
                         f" {d['items'] / disp if disp else 0:.2f} a dispatch")
                t += (f" ({owner}; arena waits {int(d['waits'])}, timeouts "
                      f"{int(d['timeouts'])}; fallbacks "
                      f"{int(d['ipc_fallbacks'])} routed, "
                      f"{int(d['co_fallbacks'])} recomputed"
                      + ("" if d["replaced"] else f"; pack {pack}") + ")")
                if expect is not None and (
                        int(d["items"]) != expect[i] or d["ipc_fallbacks"]
                        or d["co_fallbacks"] or d["timeouts"]):
                    raise SystemExit(f"pool: w={pool.workers} {name} {verb}:"
                                     f" owner items {int(d['items'])}, want "
                                     f"{expect[i]}, no fallback: {d}")
            text.append(t)
        print(f"[pool] w={pool.workers} {name}: {'; '.join(text)}; "
              f"card {card}")
        return out

    def contexts(pool) -> None:
        import torch
        cuda = _pool_counts(pool.settled(), pool.workers)["cuda"]
        names = pool.pids()
        apps = [(names.get(pid, f"pid {pid}"), mem)
                for pid, mem in _compute_apps()]
        mine = int(torch.cuda.is_initialized())
        print(f"[pool] w={pool.workers} CUDA contexts after the steps that "
              f"fit the arena: by the processes' own reports {cuda}; "
              f"nvidia-smi lists {len(apps)} compute apps {apps} (one is "
              f"this script's: {bool(mine)}; its pids are not the pool's "
              f"namespace's); card {card}")
        strays = [n for n, _ in apps if n.startswith(("worker", "super"))]
        if strays or len(apps) > 1 + mine or not cuda["owner"] or \
                any(v for k, v in cuda.items() if k != "owner"):
            raise SystemExit(f"pool: a CUDA context outside the owner: "
                             f"{cuda}, {apps}")

    def kill_step(pool) -> None:
        m = pool.metrics()
        gen0 = int(m["mtpu_owner_generation"])
        owner = int(m["mtpu_owner_pid"])

        def kill():
            time.sleep(POOL_KILL_AFTER_S)
            os.kill(owner, signal.SIGKILL)
        out = step(pool, "pool", "owner killed",
                   _pool_objects(POOL_KILL_CLIENTS, POOL_KILL_PER, POOL_BIG,
                                 args.seed + 7200, "kill"), during=kill,
                   owner_dies=True)
        d = out["put"]["d"]
        t0 = time.monotonic()
        while True:
            m = pool.metrics()
            if m["mtpu_owner_generation"] == gen0 + 1 and \
                    m["mtpu_owner_up"] == 1:
                break
            if time.monotonic() - t0 > 120:
                raise SystemExit(f"pool: no owner of generation "
                                 f"{gen0 + 1}: {pool.tail()}")
            time.sleep(0.2)
        print(f"[pool] owner SIGKILLed {POOL_KILL_AFTER_S} s into {n_kill} "
              f"PUTs of {POOL_BIG} B: every PUT 200 with its ETag and every"
              f" body equal; fallbacks {int(d['ipc_fallbacks'])} routed, "
              f"{int(d['co_fallbacks'])} recomputed; generation {gen0} -> "
              f"{gen0 + 1}, up {time.monotonic() - t0:.2f} s after the "
              f"GETs; card {card}")
        if not d["ipc_fallbacks"] + d["co_fallbacks"]:
            raise SystemExit("pool: the owner's death caused no fallback")
        step(pool, "pool", "after the respawn",
             _pool_objects(POOL_KILL_CLIENTS, POOL_KILL_PER, POOL_BIG,
                           args.seed + 7300, "again"),
             expect=(n_kill * calls, n_kill * calls))

    for turn, workers in enumerate(POOL_TURNS):
        root = tempfile.mkdtemp(prefix=f"chip_smoke-pool{turn}-",
                                dir="/dev/shm")
        pool = None
        try:
            for algo in ("mxh256", HH) if workers else ("mxh256",):
                pool = _Pool(root, workers, algo)
                owner_line = next((ln for ln in open(pool.log)
                                   if "self-tests" in ln), "").strip()
                print(f"[pool] turn {turn + 1}: MTPU_WORKERS={workers}, "
                      f"{algo}, ready in {pool.boot_s:.2f} s"
                      + (f"; {owner_line}" if workers else "")
                      + f"; card {card}")
                bucket = "pool" if algo == "mxh256" else "poolhh"
                S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                         "pooladmin-secret", timeout=60).make_bucket(bucket)
                fit = bool(workers)
                if algo == HH:
                    step(pool, bucket, f"{POOL_HH_CLIENTS} clients x "
                         f"{POOL_HH_PER} {HH}",
                         _pool_objects(POOL_HH_CLIENTS, POOL_HH_PER,
                                       POOL_BIG, args.seed + 7400, "hh"),
                         expect=(n_hh * calls,) * 2 if fit else None)
                else:
                    # Untimed: the pool's first batches pay its lanes'
                    # pinned staging and the arena's first page faults.
                    warm = _Clients(pool.port, bucket, _pool_objects(
                        1, 1, POOL_BIG, args.seed + 7500, "warm"))
                    try:
                        warm.run("put")
                        warm.run("get")
                    finally:
                        warm.close()
                    for n in POOL_BIG_CLIENTS[:-1]:
                        step(pool, bucket, f"{n} x {POOL_BIG} B",
                             _pool_objects(n, 1, POOL_BIG,
                                           args.seed + 7000 + n, f"big{n}"),
                             expect=(n * calls,) * 2 if fit else None)
                    step(pool, bucket, f"{POOL_SMALL_CLIENTS} x "
                         f"{POOL_SMALL_PER} x {POOL_SMALL_BYTES} B",
                         _pool_objects(POOL_SMALL_CLIENTS, POOL_SMALL_PER,
                                       POOL_SMALL_BYTES, args.seed + 7100,
                                       "small"),
                         expect=(n_small, n_small) if fit else None)
                    if workers:
                        contexts(pool)
                    n = POOL_BIG_CLIENTS[-1]
                    step(pool, bucket, f"{n} x {POOL_BIG} B",
                         _pool_objects(n, 1, POOL_BIG, args.seed + 7000 + n,
                                       f"big{n}"))
                    if workers and turn == len(POOL_TURNS) - 1:
                        kill_step(pool)
                hashes[turn, algo] = _pool_part_hashes(root, bucket)
                if algo == HH:
                    want = _inprocess_part_hashes(
                        bucket, _pool_objects(POOL_HH_CLIENTS, POOL_HH_PER,
                                              POOL_BIG, args.seed + 7400,
                                              "hh"), algo)
                    if want != hashes[turn, algo]:
                        raise SystemExit(f"pool: {HH} part files differ "
                                         "from one process's")
                stop_s = pool.stop()
                print(f"[pool] turn {turn + 1}: SIGTERM, exit 0 in "
                      f"{stop_s:.2f} s")
                pool = None
        finally:
            if pool is not None:
                pool.kill()
            shutil.rmtree(root, ignore_errors=True)

    for (turn, algo), h in hashes.items():
        first, ref = min((t, r) for (t, a), r in hashes.items() if a == algo)
        common = set(h) & set(ref)
        if len(common) < len(ref) or any(h[k] != ref[k] for k in common):
            raise SystemExit(f"pool: part files of turn {turn + 1} ({algo})"
                             f" differ from turn {first + 1}'s")
    pack_in = _inprocess_pack_ms_per_mib(card)
    # The pools' launches are read from their metrics; this process's
    # comparison above is no main path's: nothing of it is tallied.
    counts.reset()
    counts.read()
    print(f"[pool] {len(POOL_TURNS)} turns in "
          f"{time.perf_counter() - t_phase:.1f} s: part files equal across "
          f"turns ({sum(len(h) for h in hashes.values())} compared), "
          f"launches in the pools' processes {launches} (the owner-kill "
          f"step's left out); lanes' pack in one "
          f"process {pack_in:.4f} ms/MiB; card {card}")
    return launches


def _spine_counts(m: dict, workers: int) -> dict:
    """Phase 5l's counters from one metrics read: per kernel the launches
    and items (the owner's and the workers' in a pool, the process's
    own outside one), the shared tier's counts, and per worker its
    requests and tier hits and misses."""
    out = {}
    for k in ("gf_matmul", "hh256", "mxh256"):
        for what in ("launches", "items"):
            if workers:
                v = m[f'mtpu_owner_kernel_{what}_total{{kernel="{k}"}}'] \
                    + sum(m[f'mtpu_worker_kernel_{what}_total{{worker="{w}",'
                            f'kernel="{k}"}}'] for w in range(workers))
            else:
                v = m[f'mtpu_kernel_{what}_total{{kernel="{k}"}}']
            out[f"{what}_{k}"] = int(v)
    # A server without a tier (MTPU_HOTCACHE=0) has no tier families.
    for key in ("hits", "misses", "meta_hits", "fills", "evictions",
                "bypassed", "ghost_defers", "stale_generation"):
        out[key] = int(m.get(f"mtpu_hotcache_{key}_total", 0))
    for w in range(workers):
        for key in ("requests", "hotcache_hits", "hotcache_misses"):
            out[f"w{w}_{key}"] = int(
                m[f'mtpu_worker_{key}_total{{worker="{w}"}}'])
    out["owner_pid"] = int(m.get("mtpu_owner_pid", 0))
    return out


def phase_get_spine(args, counts, card):
    """The GET half of the serving spine over BASELINE.json config 2's
    deployment (one EC:8+4 set of 12 drives on /dev/shm, 1 MiB blocks,
    MINIO_STORAGE_CLASS_STANDARD=EC:4) with the default 64 MiB hot-object
    tier (engine/hotcache.py).  `python -m minio_tpu_torch.server` boots
    four times over the same drives, each a subprocess read through its
    /minio/v2/metrics/node families: A, one process, tier on; B, one
    process, MTPU_HOTCACHE=0; C, MTPU_WORKERS=4, tier on, new objects
    written highwayhash256S; D, MTPU_WORKERS=4, MTPU_HOTCACHE=0.  The
    device shard cache is off (MTPU_DEVCACHE=0, as in every pool
    worker), so every miss reads its shards.  Client processes that load
    no torch PUT and GET:

    1. the hot set (SPINE_HOT, about 56 MiB): two cold rounds from one
       client (the two-hit admission: the first plants ghosts, the
       second fills), then every key from each of SPINE_CLIENTS clients;
       in A and C the misses' device items exact and the hits' 0, in D
       (no tier) every GET's exact; GET GB/s and operations/s with the
       tier and without it, in one process and in the pool; the hit
       ratio, fills and evictions;
    2. (A) a scan: SPINE_SCAN distinct keys of 1 MiB read once each:
       no fill, and the hot set read again is all hits;
    3. single flight: SPINE_SF_CLIENTS concurrent GETs of one admitted
       4 MiB key cost exactly one engine read in A (in C one per worker
       at most: flights are per process);
    4. (C) SPINE_HH highwayhash256S objects: their misses launch hh256
       exactly, their hits nothing;
    5. (C) stale reads in the pool: a versioned key warm in every worker
       (its FileInfo and the tier), a new version PUT through one worker,
       then SPINE_STALE_ROUNDS rounds of SPINE_SF_CLIENTS GETs: the new
       bytes every time, from every worker;
    6. (C) one drive away: SPINE_DEG objects read three times each
       rebuild through GF with exact items and fill nothing;
    7. verified sendfile, in this process: an EC:1+1 set on 2 drives
       behind an S3Server, SPINE_SENDFILE objects of 64 MiB read whole
       from each of SPINE_SENDFILE_CLIENTS clients with MTPU_ZEROCOPY=1
       (os.sendfile after the plan's verify on the card) and =0, in
       turns: bodies equal in both, the plan's device items exact, one
       sendfile per GET.

    Returns the kernel launches of its steps, the subprocess servers'
    (from their metrics) with this process's sendfile part; the
    servers' mxh256 launches are also under "mxh256_elsewhere" (their
    shapes are not in this process's tally)."""
    from minio_tpu_torch.engine import hotcache
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.ops import zerocopy as zc
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.xlmeta import XLMeta

    hot_bytes = sum(n * size for n, size in SPINE_HOT)
    need = (12 * (hot_bytes + (SPINE_SCAN + SPINE_HH + SPINE_DEG + 2)
                  * SPINE_SMALL + 2 * SPINE_SF_BYTES) // 8
            + 2 * SPINE_SENDFILE * OBJECT_BYTES + (2 << 30))
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"spine: needs {need} bytes free on /dev/shm")
    t_phase = time.perf_counter()
    seed = args.seed + 9000
    hot = [(f"hot{j}-{i}", size, seed + 100 * j + i)
           for j, (n, size) in enumerate(SPINE_HOT) for i in range(n)]
    n_hot = len(hot)
    deg = [(f"deg-{i}", SPINE_SMALL, seed + 8000 + i)
           for i in range(SPINE_DEG)]
    launches = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
    elsewhere = 0
    counts.reset()
    gbps: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke-spine-", dir="/dev/shm")

    def settled(pool):
        """The metrics after a step: one process serves its own live;
        a pool's processes publish on a 0.1 s heartbeat."""
        return pool.settled() if pool.workers else pool.metrics()

    def _stride(n):
        """Past SPINE_STRIDE clients each reads a SPINE_STRIDE-th of
        the hot set, so a round holds at most SPINE_STRIDE passes."""
        return n // SPINE_STRIDE if n > SPINE_STRIDE else None

    def run(pool, cl, verbs, what, want_items=None, only=None,
            stride=None):
        """`verbs` from the clients of `cl` (a _Clients; the first
        `only` of them), the server's counters around each; `want_items`
        (per verb: a dict of kernel -> items, or None) holds the device
        items exactly, and the launches to at most the items and at
        least one where there were items.  Returns [(run result, counter
        deltas)]."""
        nonlocal elsewhere
        out = []
        before = _spine_counts(settled(pool), pool.workers)
        for i, verb in enumerate(verbs):
            r = cl.run(verb, only=only, stride=stride)
            after = _spine_counts(settled(pool), pool.workers)
            d = {k: after[k] - before[k] for k in after}
            if d["owner_pid"]:
                raise SystemExit(f"spine: {what}: the owner was "
                                 "replaced")
            for k in launches:
                launches[k] += d[f"launches_{k}"]
            elsewhere += d["launches_mxh256"]
            want = want_items[i] if want_items else None
            if want is not None:
                for k in launches:
                    items, got = d[f"items_{k}"], d[f"launches_{k}"]
                    if items != want.get(k, 0) or got > items or \
                            (items and not got):
                        raise SystemExit(
                            f"spine: {what} {verb} #{i + 1}: items "
                            f"{ {k: d[f'items_{k}'] for k in launches} }"
                            f", launches "
                            f"{ {k: d[f'launches_{k}'] for k in launches} }"
                            f", want items {want}")
            out.append((r, d))
            before = after
        return out

    def line(what, pool, res, i=-1):
        r, d = res[i]
        hits = d["hits"]
        look = hits + d["misses"]
        return (f"[spine] {pool.label} {what}: {r['gbps']:.3f} GB/s, "
                f"{r['ops']:.1f} GET/s; tier hits {hits}/{look}, fills "
                f"{d['fills']}, evictions {d['evictions']}, bypassed "
                f"{d['bypassed']}; items mxh256 {d['items_mxh256']} hh256 "
                f"{d['items_hh256']} gf {d['items_gf_matmul']}, launches "
                f"mxh256 {d['launches_mxh256']} hh256 "
                f"{d['launches_hh256']} gf {d['launches_gf_matmul']}; card "
                f"{card}")

    def hot_rounds(pool, hot_cl, tier: bool, cold: bool):
        """The hot set: (with `cold`) two rounds from one client, then
        each of SPINE_CLIENTS; items exact."""
        if cold:
            res = run(pool, hot_cl, ("get", "get"), "cold rounds",
                      [{"mxh256": n_hot}] * 2, only=1)
            (_, d1), (_, d2) = res
            if tier and (d1["fills"], d1["ghost_defers"], d2["fills"]) != \
                    (0, n_hot, n_hot):
                raise SystemExit(f"spine: {pool.label} cold rounds filled "
                                 f"{d1['fills']}, {d2['fills']} (ghosts "
                                 f"{d1['ghost_defers']})")
            for i, name in enumerate(("cold round 1 (ghosts)",
                                      "cold round 2 (fills)")):
                print(line(name, pool, res, i))
        for n in SPINE_CLIENTS:
            gets = n_hot * min(n, SPINE_STRIDE)
            want = {} if tier else {"mxh256": gets}
            res = run(pool, hot_cl, ("get",), f"{n} clients", [want],
                      only=n, stride=_stride(n))
            _, d = res[0]
            if tier and (d["hits"] != gets or d["fills"]
                         or d["evictions"]):
                raise SystemExit(f"spine: {pool.label} {n} clients: hits "
                                 f"{d['hits']} of {gets}: {d}")
            gbps[pool.label, n] = res[0][0]
            print(line(f"hot set x {n} clients", pool, res))

    def single_flight(pool, key, exact):
        """One admitted 4 MiB key (PUT, one GET plants its ghost), then
        SPINE_SF_CLIENTS clients GET it at once."""
        obj = [(key, SPINE_SF_BYTES, seed + 5000 + len(key))]
        with _Clients(pool.port, "spinesf",
                        [obj] * SPINE_SF_CLIENTS) as cl:
            run(pool, cl, ("put", "get"), f"{key} admit", only=1)
            res = run(pool, cl, ("get",), f"{key} single flight")
        _, d = res[0]
        reads = d["items_mxh256"] + d["items_hh256"]
        if (exact and reads != 1) or not 1 <= reads <= max(pool.workers, 1):
            raise SystemExit(f"spine: {pool.label} single flight read "
                             f"{reads} times: {d}")
        print(f"[spine] {pool.label} single flight: {SPINE_SF_CLIENTS} "
              f"concurrent cold GETs of one admitted 4 MiB key cost {reads}"
              f" engine read(s) (device items), fills {d['fills']}, hits "
              f"{d['hits']}; {res[0][0]['gbps']:.3f} GB/s; card {card}")

    def scan(pool, hot_cl):
        objs = [(f"scan-{i}", SPINE_SMALL, seed + 3000 + i)
                for i in range(SPINE_SCAN)]
        # In a bucket of its own: a PUT bumps its bucket's generation.
        with _Clients(pool.port, "spinescan", [objs]) as cl:
            run(pool, cl, ("put",), "scan put")
            res = run(pool, cl, ("get",), "scan", [{"mxh256": SPINE_SCAN}])
        _, d = res[0]
        again = run(pool, hot_cl, ("get",), "hot set after the scan", [{}],
                    only=1)
        _, d2 = again[0]
        if d["fills"] or d2["hits"] != n_hot:
            raise SystemExit(f"spine: the scan filled {d['fills']}; the "
                             f"hot set then hit {d2['hits']} of {n_hot}")
        print(f"[spine] {pool.label} scan of {SPINE_SCAN} x 1 MiB keys "
              f"read once: {res[0][0]['gbps']:.3f} GB/s, fills 0, ghosts "
              f"{d['ghost_defers']}, evictions {d['evictions']}; the hot "
              f"set after it: {d2['hits']}/{n_hot} hits, 0 device items; "
              f"card {card}")

    def hh_step(pool):
        objs = [(f"hh-{i}", SPINE_SMALL, seed + 4000 + i)
                for i in range(SPINE_HH)]
        with _Clients(pool.port, "spinehh", [objs]) as cl:
            run(pool, cl, ("put",), "hh put")
            res = run(pool, cl, ("get", "get", "get"), "highwayhash256S",
                      [{"hh256": SPINE_HH}, {"hh256": SPINE_HH}, {}])
        fills = [d["fills"] for _, d in res]
        if fills != [0, SPINE_HH, 0]:
            raise SystemExit(f"spine: {HH} fills {fills}")
        print(f"[spine] {pool.label} {SPINE_HH} x {SPINE_SMALL} B {HH}: misses "
              f"{res[0][1]['launches_hh256']} + {res[1][1]['launches_hh256']}"
              f" hh256 launches for {SPINE_HH} + {SPINE_HH} items, hits "
              f"{res[2][1]['hits']} with 0; card {card}")

    def stale_step(pool):
        cli = S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                       "pooladmin-secret", timeout=60)
        cli.make_bucket("stale")
        cli.set_versioning("stale", True)
        v1 = [("k", SPINE_SMALL, seed + 6001)]
        v2 = [("k", SPINE_SMALL, seed + 6002)]
        with _Clients(pool.port, "stale", [v1] * SPINE_SF_CLIENTS) as cl:
            run(pool, cl, ("put",), "stale v1", only=1)
            warm = run(pool, cl, ("get",) * SPINE_STALE_ROUNDS,
                       "stale warm")
        with _Clients(pool.port, "stale", [v2] * SPINE_SF_CLIENTS) as cl:
            run(pool, cl, ("put",), "stale v2", only=1)
            after = run(pool, cl, ("get",) * SPINE_STALE_ROUNDS,
                        "stale after")
        per_w = [sum(d[f"w{w}_requests"] for _, d in res)
                 for res in (warm, after) for w in range(pool.workers)]
        if min(per_w) == 0:
            raise SystemExit(f"spine: a worker served none of the stale "
                             f"GETs: {per_w}")
        print(f"[spine] {pool.label} stale reads: a versioned 1 MiB key "
              f"warm in every worker ({per_w[:pool.workers]} GETs), v2 "
              f"PUT through one, then {SPINE_STALE_ROUNDS} x "
              f"{SPINE_SF_CLIENTS} GETs ({per_w[pool.workers:]} by "
              f"worker): v2 every time; tier fills "
              f"{sum(d['fills'] for _, d in after)}, stale "
              f"{sum(d['stale_generation'] for _, d in after)}; card "
              f"{card}")

    def degraded_step(pool, objs):
        fis = {}
        for key, _, _ in objs:
            with open(os.path.join(root, "b1", "spinedeg", key, "xl.meta"),
                      "rb") as f:
                fis[key] = XLMeta.from_bytes(f.read()).latest("spinedeg",
                                                              key)
        # Away: the drive holding data shard 0 of the first object.
        fi0 = fis[objs[0][0]]
        pos = fi0.erasure.distribution.index(1)
        gf = sum(1 for fi in fis.values() if _holds_data(fi, [pos]))
        away = os.path.join(root, f"b{pos + 1}")
        os.rename(away, away + ".away")
        try:
            with _Clients(pool.port, "spinedeg", [objs]) as cl:
                res = run(pool, cl, ("get",) * 3, "one drive away",
                          [{"mxh256": len(objs), "gf_matmul": gf}] * 3)
        finally:
            os.rename(away + ".away", away)
        fills = sum(d["fills"] for _, d in res)
        bypassed = sum(d["bypassed"] for _, d in res)
        if fills or bypassed != 3 * len(objs):
            raise SystemExit(f"spine: degraded GETs filled {fills}, "
                             f"bypassed {bypassed}")
        print(f"[spine] {pool.label} drive {pos + 1} away: {len(objs)} x "
              f"1 MiB read 3 times: GF items {3 * gf} "
              f"({sum(d['launches_gf_matmul'] for _, d in res)} launches),"
              f" fills 0, bypassed {bypassed}; {res[-1][0]['gbps']:.3f} "
              f"GB/s; card {card}")

    def sendfile_step():
        """An EC:1+1 set on 2 drives behind an in-process S3Server."""
        zroot = os.path.join(root, "zc")
        spools = ServerPools([ErasureSets(
            [LocalDrive(os.path.join(zroot, f"z{i}")) for i in range(2)],
            set_drive_count=2, default_parity=1)])
        hotcache.attach_pools(spools)
        srv = S3Server(spools, Credentials("pooladmin",
                                           "pooladmin-secret")).start()
        objs = [(f"z-{i}", OBJECT_BYTES, seed + 7000 + i)
                for i in range(SPINE_SENDFILE)]
        n_max = max(SPINE_SENDFILE_CLIENTS)
        # Heal's frame batches (32 full frames, then the tail frame): the
        # same count as a GET's segments and as a PUT's batches.
        per_get = _put_calls(OBJECT_BYTES)
        try:
            S3Client(srv.endpoint, "pooladmin", "pooladmin-secret",
                     timeout=60).make_bucket("spinezc")
            # Client c holds objects c, c + n_max, ...: the first n
            # clients read them all between them.
            cl = _Clients(srv.port, "spinezc",
                          [objs[c::n_max] for c in range(n_max)])
            rows, traced = {}, {}
            try:
                cl.run("put")
                for turn, mode in enumerate(("1", "0", "0", "1")):
                    os.environ["MTPU_ZEROCOPY"] = mode
                    for n in SPINE_SENDFILE_CLIENTS:
                        l0, i0, z0 = counts.read(), counts.items(), \
                            zc.stats()
                        r = cl.run("get", only=n)
                        l1, i1, z1 = counts.read(), counts.items(), \
                            zc.stats()
                        rows.setdefault((mode, n), []).append(
                            (r, l0, i0, z0, l1, i1, z1))
                # One 64 MiB GET from one client at a time, in spans,
                # each way in turns: where the sendfile path's time goes
                # against the copying read's.
                for mode in ("1", "0", "0", "1"):
                    os.environ["MTPU_ZEROCOPY"] = mode
                    with _GetSpans(spools) as sp:
                        r = cl.run("get", only=1)
                    traced.setdefault(mode, []).append(
                        {"client GET": r["s"] * 1e3, **sp.ms})
            finally:
                cl.close()
            for (mode, n), runs in rows.items():
                for r, l0, i0, z0, l1, i1, z1 in runs:
                    gets = sum(len(objs[c::n_max]) for c in range(n))
                    got = {k: l1[k] - l0[k] for k in l1}
                    items = {k: i1[k] - i0[k] for k in i1}
                    sent = z1["sendfile"] - z0["sendfile"]
                    if items != {"gf_matmul": 0, "hh256": 0,
                                 "mxh256": gets * per_get} or \
                            sent != (gets if mode == "1" else 0) or \
                            (mode == "1" and got["mxh256"] != items["mxh256"]):
                        raise SystemExit(
                            f"spine: sendfile MTPU_ZEROCOPY={mode} {n} "
                            f"clients: items {items}, launches {got}, "
                            f"sendfiles {sent} of {gets}")
            print("[spine] verified sendfile, EC:1+1 on 2 drives, "
                  f"{SPINE_SENDFILE} x {OBJECT_BYTES} B whole GETs, bodies "
                  "equal in both modes, one sendfile per GET and "
                  f"{per_get} mxh256 verify launches per plan: " + ", ".join(
                      f"MTPU_ZEROCOPY={m} {n} client(s) "
                      + "/".join(f"{x[0]['gbps']:.3f}" for x in v) + " GB/s"
                      for (m, n), v in sorted(rows.items()))
                  + f"; card {card}")
            for mode, runs in sorted(traced.items(), reverse=True):
                print(f"[spine] one {OBJECT_BYTES} B GET from 1 client, "
                      f"MTPU_ZEROCOPY={mode}, host-clock spans in ms (2 "
                      "GETs, in turns): " + "; ".join(
                          f"{k} " + "/".join(f"{x.get(k, 0.0):.2f}"
                                             for x in runs)
                          for k in sorted({k for x in runs for k in x}))
                      + f"; card {card}")
        finally:
            os.environ.pop("MTPU_ZEROCOPY", None)
            srv.shutdown()
            spools.close()

    pool = None
    clients: list = []
    try:
        for label, workers, algo, env in (
                ("A 1 process", 0, "mxh256", {}),
                ("B 1 process MTPU_HOTCACHE=0", 0, "mxh256",
                 {"MTPU_HOTCACHE": "0"}),
                (f"C {SPINE_WORKERS} workers", SPINE_WORKERS, HH, {}),
                (f"D {SPINE_WORKERS} workers MTPU_HOTCACHE=0",
                 SPINE_WORKERS, "mxh256", {"MTPU_HOTCACHE": "0"})):
            tier = "MTPU_HOTCACHE" not in env
            t0 = time.perf_counter()
            pool = _Pool(root, workers, algo, env=env)
            pool.label = label
            print(f"[spine] {label}: ready in {pool.boot_s:.2f} s; card "
                  f"{card}")
            hot_cl = _Clients(pool.port, "spine",
                              [hot] * max(SPINE_CLIENTS))
            clients.append(hot_cl)
            if label.startswith("A"):
                cli = S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                               "pooladmin-secret", timeout=60)
                for b in ("spine", "spinedeg", "spinescan", "spinesf"):
                    cli.make_bucket(b)
                run(pool, hot_cl, ("put",), "hot set put", only=1)
                with _Clients(pool.port, "spinedeg", [deg]) as cl:
                    run(pool, cl, ("put",), "degraded put")
            if label.startswith("B"):
                # Without a tier the one process serves no metrics: its
                # rounds are timed, not counted.
                for n in SPINE_CLIENTS:
                    r = hot_cl.run("get", only=n, stride=_stride(n))
                    gbps[label, n] = r
                    print(f"[spine] {label} hot set x {n} clients: "
                          f"{r['gbps']:.3f} GB/s, {r['ops']:.1f} GET/s "
                          f"(device items not read: no metrics route "
                          f"without a tier or a pool); card {card}")
            else:
                hot_rounds(pool, hot_cl, tier, cold=tier)
            if label.startswith("A"):
                scan(pool, hot_cl)
                single_flight(pool, "sf-one", exact=True)
            if label.startswith("C"):
                cli = S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                               "pooladmin-secret", timeout=60)
                cli.make_bucket("spinehh")
                hh_step(pool)
                single_flight(pool, "sf-pool", exact=False)
                stale_step(pool)
                degraded_step(pool, deg)
            hot_cl.close()
            stop_s = pool.stop()
            pool = None
            print(f"[spine] {label}: SIGTERM, exit 0 in {stop_s:.2f} s; "
                  f"{time.perf_counter() - t0:.1f} s in all")
        sendfile_step()
    finally:
        for cl in clients:
            cl.close()
        if pool is not None:
            pool.kill()
        shutil.rmtree(root, ignore_errors=True)
    ratios = ", ".join(
        f"{n} client(s) {gbps[a, n]['gbps']:.3f} against "
        f"{gbps[b, n]['gbps']:.3f}"
        for a, b in (("A 1 process", "B 1 process MTPU_HOTCACHE=0"),
                     (f"C {SPINE_WORKERS} workers",
                      f"D {SPINE_WORKERS} workers MTPU_HOTCACHE=0"))
        for n in SPINE_CLIENTS)
    print(f"[spine] hot-set GET GB/s, tier on against MTPU_HOTCACHE=0 (one "
          f"process, then {SPINE_WORKERS} workers): {ratios}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}")
    # This process's launches (the sendfile step's PUTs and GETs) join
    # the servers'; its mxh256 calls stay in the shape tally (read, not
    # reset).
    for k, v in counts.read().items():
        launches[k] += v
    return {**launches, "mxh256_elsewhere": elsewhere}


def _fs_type(path: str) -> str:
    return subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True).stdout.strip()


def _disk_dir(need: int) -> str | None:
    """A directory on a disk-backed filesystem (not tmpfs) with `need`
    bytes free: the temp dir or the checkout's ignored build dir."""
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (tempfile.gettempdir(),
                 os.path.join(here, "minio_tpu_torch", "build")):
        try:
            os.makedirs(cand, exist_ok=True)
            if _fs_type(cand) not in ("tmpfs", "ramfs") and \
                    shutil.disk_usage(cand).free >= need:
                return cand
        except OSError:
            continue
    return None


def _meta_counts(m: dict) -> dict:
    """Phase 5m's counters from one metrics read of a one-process
    server: the metadata plane's and the kernels' items and launches."""
    out = {k: m.get(f"mtpu_meta_{k}", 0) for k in (
        "publishes_total", "fsyncs_total", "group_commits_total",
        "group_items_total", "group_items_max", "journal_replays_total",
        "read_requests_total", "read_rounds_total", "read_keys_total",
        "trim_hits_total", "trim_fallbacks_total", "lane_dispatches_total",
        "inline_ops_total")}
    for k in ("gf_matmul", "hh256", "mxh256"):
        for what in ("launches", "items"):
            out[f"{what}_{k}"] = int(
                m[f'mtpu_kernel_{what}_total{{kernel="{k}"}}'])
    return out


def _pct(values: list, q: float) -> float:
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(q * len(vs)))] if vs else 0.0


def phase_meta_plane(args, counts, card):
    """The metadata plane of the PUT side (ops/metalanes.py, the drive's
    group-commit journal and batched reads, the K+1 read trim) over
    BASELINE.json config 2's deployment (one EC:8+4 set of 12 drives,
    MINIO_STORAGE_CLASS_STANDARD=EC:4), `python -m
    minio_tpu_torch.server` as one process, read through its
    /minio/v2/metrics/node families:

    Every server boots at once, each on fresh drives, and waits idle
    while another is driven.

    1. two servers, the lanes (the default) and MTPU_METABATCH=0 (the
       single-op oracle), driven in turns step by step (the first to go
       alternates): META_CLIENTS client processes PUT META_PER inline
       objects each, HEAD every one and GET every META_GET_STRIDE-th
       (SHA-256 exact), then one client the same with META_ONE
       objects.  PUT/s, HEAD/s, p50 and p99 of
       each; publishes per journal fsync (mean and max), keys per
       metadata read round, trim accepted against fallen back; the
       PUTs' and GETs' device items equal across the turns.  On /dev/shm
       (tmpfs, where an fsync is nearly free), and the two 16-client
       turns again, with half the objects, on a disk-backed directory
       (not tmpfs) when one has room;
    2. durability: lanes on with MTPU_METABATCH_SOLO=1 (every publish
       journaled), META_KILL_CLIENTS clients PUT and the server is
       SIGKILLed after META_KILL_ACKS acknowledgements; the reboot on the
       same drives prints the sweep's journal replays; every
       acknowledged PUT reads back exact, and no key returns bytes never
       written to it;
    3. in this process, on the card: the lanes forced on over 12
       NaughtyDrives, each fault reaching its target: a scripted
       write_metadata fault fails its drive's item of the batched
       publish, a failed and a stalled read_version hit their drives'
       items of the laned election, two drives taken away, and a
       health-wrapped drive failing every laned publish trips its
       breaker (the next PUT upgrades its parity); items exact.

    Returns the kernel launches of its steps; the servers' mxh256
    launches also under "mxh256_elsewhere"."""
    import numpy as np

    from minio_tpu_torch.server.client import S3Client

    t_phase = time.perf_counter()
    seed = args.seed + 11000
    lo, hi = META_BYTES

    def objects(prefix, n_clients, per, salt):
        rng = np.random.default_rng(seed + salt)
        return [[(f"{prefix}{c}-{i}", int(rng.integers(lo, hi + 1)),
                  seed + salt * 100000 + c * 1000 + i)
                 for i in range(per)] for c in range(n_clients)]

    need = 3 << 30
    if not os.path.isdir("/dev/shm") or \
            shutil.disk_usage("/dev/shm").free < need:
        raise SystemExit(f"meta: needs {need} bytes free on /dev/shm")
    disk = _disk_dir(need)
    launches = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
    elsewhere = 0
    counts.reset()
    roots: list = []

    def step(pool, cl, verb, what, only=None, stride=None):
        """One verb from the clients, the server's counters around it."""
        nonlocal elsewhere
        before = _meta_counts(pool.metrics())
        r = cl.run(verb, only=only, stride=stride)
        after = _meta_counts(pool.metrics())
        d = {k: after[k] - before[k] for k in after}
        d["group_items_max"] = after["group_items_max"]
        for k in launches:
            launches[k] += d[f"launches_{k}"]
        elsewhere += d["launches_mxh256"]
        lat = [x for res in r["res"] for x in res["lat"]]
        return {"what": what, "ops": r["ops"], "s": r["s"],
                "p50": _pct(lat, 0.50), "p99": _pct(lat, 0.99), **d}

    def report(label, out):
        for (n, verb), r in out.items():
            commits = r["group_commits_total"]
            rounds = r["read_rounds_total"]
            print(f"[meta] {label} {n} client(s) {verb}: {r['ops']:.1f} "
                  f"op/s, p50 {r['p50']:.2f} ms, p99 {r['p99']:.2f} ms; "
                  f"publishes {int(r['publishes_total'])}, fsyncs "
                  f"{int(r['fsyncs_total'])}, group commits {int(commits)} "
                  f"({r['group_items_total'] / commits if commits else 0:.2f}"
                  f" publishes a journal fsync, at most "
                  f"{int(r['group_items_max'])} since boot); metadata reads "
                  f"{int(r['read_requests_total'])} in {int(rounds)} drive "
                  f"rounds ({r['read_keys_total'] / rounds if rounds else 0:.2f}"
                  f" keys a round); trim accepted "
                  f"{int(r['trim_hits_total'])}, fell back "
                  f"{int(r['trim_fallbacks_total'])}; items gf_matmul "
                  f"{r['items_gf_matmul']} mxh256 {r['items_mxh256']}, "
                  f"launches gf_matmul {r['launches_gf_matmul']} mxh256 "
                  f"{r['launches_mxh256']}; card {card}")

    def turns(base, pools, one_client: bool, per: int) -> dict:
        """The lanes' server and the oracle's on `base`, driven step by
        step in turns (the first to go alternates), each by its own
        clients: every verb from 16 clients, then (`one_client`) from
        1."""
        for pool in pools.values():
            S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                     "pooladmin-secret", timeout=60).make_bucket("meta")
        out: dict = {label: {} for label in pools}
        plan = [(META_CLIENTS, per, "m", 1)]
        if one_client:
            plan.append((1, META_ONE, "s", 2))
        for n, per_c, prefix, salt in plan:
            objs = objects(prefix, n, per_c, salt)
            cls = {}
            try:
                for label, pool in pools.items():
                    cls[label] = _Clients(pool.port, "meta", objs,
                                          role="--meta-client")
                for i, verb in enumerate(("put", "head", "get")):
                    order = list(pools) if i % 2 == 0 else \
                        list(pools)[::-1]
                    for label in order:
                        out[label][n, verb] = step(
                            pools[label], cls[label], verb, verb.upper(),
                            stride=META_GET_STRIDE if verb == "get"
                            else None)
            finally:
                for cl in cls.values():
                    cl.close()
        return out

    modes = (("lanes", {}), ("MTPU_METABATCH=0", {"MTPU_METABATCH": "0"}))
    pools: dict = {}
    try:
        fs = {"/dev/shm": _fs_type("/dev/shm")}
        bases = ["/dev/shm"]
        if disk is None:
            print(f"[meta] no disk-backed directory with {need} bytes "
                  f"free: the 16-client turns run on tmpfs only; card "
                  f"{card}")
        else:
            bases.append(disk)
            fs[disk] = _fs_type(disk)
        # Every server of the phase boots at once, each on fresh drives
        # (the durability step's with every publish journaled); a
        # server waits idle while another is driven.
        specs = [((base, label), base, env) for base in bases
                 for label, env in modes]
        specs.append(("solo", "/dev/shm", {"MTPU_METABATCH_SOLO": "1"}))
        t0 = time.perf_counter()
        errors: list = []

        def boot(key, base, env):
            root = tempfile.mkdtemp(prefix="chip_smoke-meta-", dir=base)
            roots.append(root)
            try:
                pools[key] = _Pool(root, 0, env=env)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        threads = [threading.Thread(target=boot, args=sp) for sp in specs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        print(f"[meta] {len(specs)} one-process servers booted at once in "
              f"{time.perf_counter() - t0:.2f} s (each ready in "
              + ", ".join(f"{pools[k].boot_s:.2f}" for k, _, _ in specs)
              + f" s); card {card}")
        for base in bases:
            one = base == "/dev/shm"
            per = META_PER if one else META_PER // 2
            pair = {label: pools.pop((base, label)) for label, _ in modes}
            done = False
            try:
                runs = turns(base, pair, one, per)
                done = True
            finally:
                if not done:
                    for label, pool in pair.items():
                        print(f"[meta] {label}: the server's log ends: "
                              f"{pool.tail()}")
                        pool.kill()
            for label, pool in pair.items():
                report(f"{fs[base]} ({base}) {label}", runs[label])
                print(f"[meta] {fs[base]} ({base}) {label}: ready in "
                      f"{pool.boot_s:.2f} s, SIGTERM exit 0 in "
                      f"{pool.stop():.2f} s")
            lanes, oracle = runs["lanes"], runs["MTPU_METABATCH=0"]
            for key in lanes:
                a, b = lanes[key], oracle[key]
                if any(a[f"items_{k}"] != b[f"items_{k}"]
                       for k in launches):
                    raise SystemExit(f"meta: {base} {key}: device items "
                                     f"differ across the turns: {a} {b}")
                if a["items_gf_matmul"] and not a["launches_gf_matmul"]:
                    raise SystemExit(f"meta: {key}: no GF launch")
            put = lanes[META_CLIENTS, "put"]
            if (put["items_gf_matmul"], put["items_mxh256"]) != \
                    (META_CLIENTS * per,) * 2:
                raise SystemExit(f"meta: {META_CLIENTS * per} inline PUTs "
                                 f"made items {put}")
            if oracle[META_CLIENTS, "put"]["group_commits_total"]:
                raise SystemExit("meta: group commits with "
                                 f"MTPU_METABATCH=0: {oracle}")
            print(f"[meta] {fs[base]} ({base}): {META_CLIENTS}-client "
                  f"PUT/s lanes {put['ops']:.1f} against "
                  f"{oracle[META_CLIENTS, 'put']['ops']:.1f}, HEAD/s "
                  f"{lanes[META_CLIENTS, 'head']['ops']:.1f} against "
                  f"{oracle[META_CLIENTS, 'head']['ops']:.1f}; device items"
                  f" equal across the turns; card {card}")
        _meta_durability(card, objects, pools.pop("solo"))
        _meta_faults(card, counts, launches, seed, roots)
    finally:
        for pool in pools.values():
            pool.kill()
        for r_ in roots:
            shutil.rmtree(r_, ignore_errors=True)
    print(f"[meta] phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return {**launches, "mxh256_elsewhere": elsewhere}


def _meta_durability(card, objects, pool) -> None:
    """Phase 5m, step 2: a SIGKILL under 16 clients' journaled PUTs to
    `pool` (booted with MTPU_METABATCH_SOLO=1 on fresh drives), the
    reboot's journal replay, every acknowledged PUT read back."""
    import signal

    from minio_tpu_torch.server.client import S3Client

    root = pool.root
    acks_dir = os.path.join(root, "acks")
    os.mkdir(acks_dir)
    objs = objects("k", META_KILL_CLIENTS, META_KILL_PER, 3)
    try:
        S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                 "pooladmin-secret", timeout=60).make_bucket("dur")
        m0 = _meta_counts(pool.metrics())

        def acked() -> list[str]:
            out = []
            for c in range(META_KILL_CLIENTS):
                try:
                    with open(os.path.join(acks_dir, str(c))) as f:
                        out += [ln.strip() for ln in f if ln.strip()]
                except FileNotFoundError:
                    pass
            return out

        state = {}

        def kill_after_acks():
            deadline = time.monotonic() + 120
            while len(acked()) < META_KILL_ACKS:
                if time.monotonic() > deadline:
                    raise SystemExit("meta: too few acknowledged PUTs")
                time.sleep(0.005)
            m = _meta_counts(pool.metrics())
            state["commits"] = m["group_commits_total"] - \
                m0["group_commits_total"]
            pool.proc.send_signal(signal.SIGKILL)
            pool.proc.wait()
            state["at"] = len(acked())
        with _Clients(pool.port, "dur", objs, role="--meta-client",
                      acks=acks_dir) as cl:
            r = cl.run("put", during=kill_after_acks, strict=False)
    finally:
        pool.kill()
    keys = acked()
    stopped = sum(1 for res in r["res"] if res["err"])
    pool = _Pool(root, 0)
    try:
        sweep = next((ln for ln in open(pool.log).read().splitlines()
                      if "recovery sweep:" in ln), "")
        m = re.search(r"; (\d+) xl\.meta entries replayed", sweep)
        if not m:
            raise SystemExit(f"meta: no sweep line after the kill: "
                             f"{pool.tail()}")
        with _Clients(pool.port, "dur", objs, role="--meta-client") as cl:
            res = cl.run("check", strict=False)["res"]
        classes = {k: v for x in res for k, v in x["classes"].items()}
        lost = [k for k in keys if classes.get(k) != "exact"]
        wrong = [k for k, v in classes.items() if v == "wrong"]
        errors = sorted(v for v in classes.values()
                        if v.startswith("error"))
        if lost or wrong or len(classes) != sum(len(o) for o in objs):
            raise SystemExit(f"meta: after the SIGKILL {len(lost)} "
                             f"acknowledged PUTs lost ({lost[:5]}), "
                             f"{len(wrong)} keys with bytes never written "
                             f"({wrong[:5]})")
        pool.stop()
        pool = None
    finally:
        if pool is not None:
            pool.kill()
    landed = sum(1 for v in classes.values() if v == "exact")
    missing = sum(1 for v in classes.values() if v == "missing")
    print(f"[meta] durability, MTPU_METABATCH_SOLO=1: SIGKILL after "
          f"{state['at']} acknowledged PUTs ({state['commits']} group "
          f"commits so far; {stopped} of {META_KILL_CLIENTS} clients cut "
          f"off); the reboot's sweep replayed {m.group(1)} xl.meta entries "
          f"from the journal; {len(keys)} acknowledged PUTs all read back "
          f"exact, {landed - len(keys)} unacknowledged ones landed whole, "
          f"{missing} are absent (404), {len(errors)} answer without an "
          f"object ({', '.join(sorted(set(errors))) or 'none'}: PUTs cut "
          f"off mid-publish, short of a read quorum), none holds other "
          f"bytes; card {card}")


def _meta_faults(card, counts, launches, seed, roots) -> None:
    """Phase 5m, step 3: faults reach their targets with the lanes
    forced on, in this process on the card; adds its launches to
    `launches`."""
    import numpy as np

    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.ops import metalanes
    from minio_tpu_torch.storage.health_wrap import HealthWrappedDrive
    from minio_tpu_torch.storage.naughty import NaughtyDrive

    # 3. Faults reach their targets with the lanes engaged.
    froot = tempfile.mkdtemp(prefix="chip_smoke-meta-faults-",
                             dir="/dev/shm")
    roots.append(froot)
    saved = {k: os.environ.get(k) for k in (
        "MTPU_METABATCH_SOLO", "MTPU_BREAKER_ERRS",
        "MTPU_BREAKER_OFFLINE_ERRS", "MTPU_BREAKER_PROBE_S")}
    os.environ.update({"MTPU_METABATCH_SOLO": "1", **HOST_BREAKER_ENV})
    nd = [NaughtyDrive(os.path.join(froot, f"f{i}")) for i in range(12)]
    drives = list(nd)
    drives[9] = HealthWrappedDrive(nd[9])
    es = ErasureSet(drives, default_parity=4)
    mb = metalanes.get()
    try:
        es.make_bucket("f")
        data = {f"k{i}": np.random.default_rng(seed + 50 + i).bytes(
            8 * 1024 + i) for i in range(8)}

        def held(what, fn, want):
            l0, i0 = counts.read(), counts.items()
            out = fn()
            got = {k: v - l0[k] for k, v in counts.read().items()}
            items = {k: v - i0[k] for k, v in counts.items().items()}
            for k in launches:
                launches[k] += got[k]
            if any(items[k] != want.get(k, 0) for k in items) or \
                    any(got[k] > items[k] for k in got):
                raise SystemExit(f"meta faults: {what}: items {items}, "
                                 f"launches {got}, want {want}")
            return out

        put = {"gf_matmul": 1, "mxh256": 1}
        nd[2].fail("write_metadata", on_call=1)
        held("scripted write_metadata fault", lambda: es.put_object(
            "f", "k0", data["k0"]), put)
        if os.path.exists(os.path.join(nd[2].root, "f", "k0")) or \
                nd[2]._on_call or not nd[2].calls.get("write_metadata_many"):
            raise SystemExit("meta faults: the write_metadata fault missed "
                             "its laned publish")
        fi0 = es.head_object("f", "k0")
        got = held("GET past the missing copy", lambda: bytes(
            es.get_object("f", "k0")[1]), {"mxh256": 1, "gf_matmul": int(
                _holds_data(fi0, [2]))})
        if got != data["k0"]:
            raise SystemExit("meta faults: k0 read back wrong")
        held("PUT k1", lambda: es.put_object("f", "k1", data["k1"]), put)
        mb.note_read(2)                   # a hot read plane: lanes, trim
        try:
            dist = Q.hash_order("f/k1", 12)
            first = [p for p in range(12) if dist[p] <= 9 and p != 9]
            nd[first[0]].fail("read_version", on_call=1)
            r0 = nd[first[0]].calls.get("read_version", 0)
            if es.head_object("f", "k1").etag != \
                    hashlib.md5(data["k1"]).hexdigest() or \
                    nd[first[0]]._on_call or \
                    nd[first[0]].calls["read_version"] == r0:
                raise SystemExit("meta faults: the read_version fault "
                                 "missed its laned read")
            nd[first[1]].slow("read_version", 0.3, on_call=1)
            t0 = time.perf_counter()
            es.head_object("f", "k1")
            stall_s = time.perf_counter() - t0
            if stall_s < 0.3 or nd[first[1]]._slow_on:
                raise SystemExit(f"meta faults: the stalled read_version "
                                 f"took {stall_s:.3f} s")
            fi1 = es.head_object("f", "k1")
            away = [p for p in range(12)
                    if fi1.erasure.distribution[p] in (1, 2)]
            for p in away:
                es.drives[p] = None
            got = held("GET with two data-shard drives away", lambda: bytes(
                es.get_object("f", "k1")[1]), {"mxh256": 1, "gf_matmul": 1})
            for p in away:
                es.drives[p] = drives[p]
            if got != data["k1"]:
                raise SystemExit("meta faults: k1 read back wrong")
        finally:
            mb.note_read(-2)
        nd[9].fail_always("write_metadata")
        for i in range(2, 6):
            held(f"PUT k{i}", lambda i=i: es.put_object(
                "f", f"k{i}", data[f"k{i}"]), put)
        trips = drives[9].api_stats()["write_metadata_many"]["errors"]
        fi = held("PUT past the open circuit", lambda: es.put_object(
            "f", "k6", data["k6"]), put)
        if drives[9].health_state() != "offline" or \
                fi.erasure.parity_blocks != 5:
            raise SystemExit(f"meta faults: breaker "
                             f"{drives[9].health_state()} after {trips} "
                             f"failed items, parity "
                             f"{fi.erasure.parity_blocks}")
        print(f"[meta] faults with the lanes forced on (12 NaughtyDrives, "
              f"EC:8+4): a scripted write_metadata fault failed drive 2's "
              f"item of the batched publish (the PUT and GET exact); a "
              f"failed and a {stall_s:.3f} s stalled read_version hit "
              f"their drives' items of the laned election; a GET with two "
              f"data-shard drives away rebuilt on the GF kernel; drive 9 "
              f"failing every laned publish went offline after {trips} "
              f"failed items and the next PUT wrote EC:7+5; items exact; "
              f"card {card}")
    finally:
        drives[9].close()
        es.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: phase 5n: the admission plane (server/qos.py), after the JAX
#: package's overload_bench (bench.py:1193) and its parameters: 4 slots,
#: a 2 s deadline, a queue of 3 x slots, three tenants of three classes,
#: 256 KiB objects (over the 128 KiB inline size: every PUT is one encode
#: and one mxh256 item), half PUT and half GET, legs of 6 s
ADMISSION_WORKERS = 2
ADMISSION_SLOTS = 4
ADMISSION_DEADLINE_MS = 2000
ADMISSION_ENV = {"MTPU_REQUESTS_MAX": str(ADMISSION_SLOTS),
                 "MTPU_REQUESTS_DEADLINE_MS": str(ADMISSION_DEADLINE_MS),
                 "MTPU_QOS_QUEUE": str(3 * ADMISSION_SLOTS),
                 "MTPU_QOS_TENANTS":
                     "gold=premium,std=standard,beff=best-effort"}
ADMISSION_CLASS = {"gold": "premium", "std": "standard",
                   "beff": "best-effort"}
ADMISSION_BYTES = 256 * 1024
# 6.0 before phase 5r joined the run.
# ADMISSION_LEG_S 4.0 before phase 5t joined the run.
ADMISSION_LEG_S = 3.0
#: the pressure EMA's three half-lives between legs on one boot
ADMISSION_DECAY_S = 6.0
#: clients per tenant: the capacity leg, and the overload and collapse
#: legs (4 x the slots, half of them best-effort)
ADMISSION_CAPACITY = {"gold": 1, "std": 1, "beff": 1}
ADMISSION_OVERLOAD = {"gold": ADMISSION_SLOTS, "std": ADMISSION_SLOTS,
                      "beff": 2 * ADMISSION_SLOTS}
#: objects every GET reads (kept in the hot tier), keys each client PUTs
ADMISSION_WARM = 8
ADMISSION_KEYS = 8
#: objects the heal under pressure rebuilds on the wiped drive
# ADMISSION_HEAL_OBJECTS 24 before phase 5t joined the run.
ADMISSION_HEAL_OBJECTS = 12
ADMISSION_STALLED = 3


def _tenant_secret(name: str) -> str:
    return f"{name}-tenant-secret"


def qos_client(spec: dict) -> int:
    """One client process of phase 5n (`chip_smoke.py --qos-client
    JSON`): signs as its tenant, makes its bodies from their seeds, says
    `ready`, then on each `run PORT SECONDS` line from stdin runs a
    closed loop for SECONDS against the server at PORT, half PUTs of its
    own keys (ETag = MD5) and half GETs of the warm objects (SHA-256),
    in a seeded order.  It prints one JSON line: the acknowledged PUTs
    and good GETs, sheds (503 SlowDown), connections reset, other
    errors, wrong answers, the bytes of good requests, each good
    request's ms, its monotonic start and end, and whether it loaded
    torch.  A shed is data, not a failure: the loop goes on."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import http.client

    import numpy as np

    from minio_tpu_torch.server.client import S3Client

    warm = {key: np.random.default_rng(seed).bytes(size)
            for key, size, seed in spec["warm"]}
    warm_sha = {k: hashlib.sha256(v).hexdigest() for k, v in warm.items()}
    puts = {key: np.random.default_rng(seed).bytes(size)
            for key, size, seed in spec["puts"]}
    put_md5 = {k: hashlib.md5(v).hexdigest() for k, v in puts.items()}
    print("ready", flush=True)
    for line in sys.stdin:
        verb, port, seconds = line.split()
        if verb != "run":
            return 1
        cli = S3Client(f"http://127.0.0.1:{port}", spec["ak"], spec["sk"],
                       timeout=120)
        rng = np.random.default_rng(spec["seed"])
        out = {"tenant": spec["tenant"], "put_ok": 0, "get_ok": 0,
               "shed": 0, "resets": 0, "errors": 0, "bad": 0, "bytes": 0,
               "lat": []}
        t0 = time.monotonic()
        end = t0 + float(seconds)
        j = 0
        while time.monotonic() < end:
            is_put = rng.random() < 0.5
            t = time.perf_counter()
            try:
                if is_put:
                    key = list(puts)[j % len(puts)]
                    j += 1
                    st, hdrs, body = cli.request(
                        "PUT", f"/{spec['bucket']}/{key}", body=puts[key])
                    etag = {k.lower(): v for k, v in hdrs.items()}.get(
                        "etag", "").strip('"')
                    good = st == 200 and etag == put_md5[key]
                    moved = len(puts[key])
                else:
                    key = list(warm)[int(rng.integers(len(warm)))]
                    st, _, body = cli.request(
                        "GET", f"/{spec['warm_bucket']}/{key}")
                    good = st == 200 and \
                        hashlib.sha256(body).hexdigest() == warm_sha[key]
                    moved = len(body)
            except (OSError, http.client.HTTPException):
                out["resets"] += 1
                continue
            if st == 503 and b"SlowDown" in body:
                out["shed"] += 1
            elif st != 200:
                out["errors"] += 1
            elif not good:
                out["bad"] += 1
            else:
                out["put_ok" if is_put else "get_ok"] += 1
                out["bytes"] += moved
                out["lat"].append((time.perf_counter() - t) * 1e3)
        out.update({"t0": t0, "t1": time.monotonic(),
                    "torch": "torch" in sys.modules})
        print(json.dumps(out), flush=True)
    return 0


def _admission_objects(seed: int):
    """The warm objects (key, size, seed) and each tenant's clients'
    PUT keys: the same in every deployment of the phase."""
    warm = [(f"w{i}", ADMISSION_BYTES, seed + i)
            for i in range(ADMISSION_WARM)]
    clients = []
    for tenant, n in ADMISSION_OVERLOAD.items():
        for c in range(n):
            cid = len(clients)
            clients.append({
                "tenant": tenant, "ak": tenant,
                "sk": _tenant_secret(tenant), "seed": seed + 100 + cid,
                "bucket": "adm", "warm_bucket": "admw", "warm": warm,
                "puts": [(f"{tenant}{c}-{k}", ADMISSION_BYTES,
                          seed + 1000 + cid * ADMISSION_KEYS + k)
                         for k in range(ADMISSION_KEYS)]})
    return warm, clients


def _admission_prep(root: str, warm, heal_objects: int = 0):
    """In this process, before a server boots over the drives: the
    12-drive EC:8+4 set's format, the tenants' IAM users (each worker of
    a pool loads them at its boot), the buckets and the warm objects,
    and `heal_objects` objects in bucket "heal".  Returns the
    (ServerPools, heal FileInfos); the caller closes the pools."""
    import numpy as np

    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.iam.iam import IAMSys
    from minio_tpu_torch.storage.drive import LocalDrive

    drives = [LocalDrive(os.path.join(root, f"b{i}")) for i in range(1, 13)]
    pools = ServerPools([ErasureSets(drives, set_drive_count=12)])
    iam = IAMSys(pools)
    for tenant in ADMISSION_CLASS:
        iam.add_user(tenant, _tenant_secret(tenant), ["readwrite"])
    for b in ("adm", "admw") + (("heal",) if heal_objects else ()):
        pools.make_bucket(b)
    for key, size, seed in warm:
        pools.put_object("admw", key, np.random.default_rng(seed).bytes(size),
                         parity=4)
    fis = {}
    rng = np.random.default_rng(len(warm) + heal_objects)
    for i in range(heal_objects):
        fis[f"h{i}"] = pools.put_object("heal", f"h{i}",
                                        rng.bytes(ADMISSION_BYTES), parity=4)
    return pools, fis


class _QosClients:
    """The phase's client processes (started with subprocess, never a fork
    of this CUDA-initialised process), all ready before a leg; each
    `leg()` runs a subset against one server's port."""

    def __init__(self, specs: list[dict]):
        here = os.path.abspath(__file__)
        self.specs = specs
        self.procs = [subprocess.Popen(
            [sys.executable, here, "--qos-client", json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for spec in specs]
        for p in self.procs:
            if p.stdout.readline().strip() != "ready":
                self.close()
                raise SystemExit("qos: a client did not start")

    def pick(self, per_tenant: dict) -> list[int]:
        out = []
        for tenant, n in per_tenant.items():
            out += [i for i, s in enumerate(self.specs)
                    if s["tenant"] == tenant][:n]
        return out

    def leg(self, port: int, which: list[int], seconds: float,
            during=None) -> list[dict]:
        for i in which:
            self.procs[i].stdin.write(f"run {port} {seconds}\n")
            self.procs[i].stdin.flush()
        if during is not None:
            during()
        res = []
        for i in which:
            line = self.procs[i].stdout.readline()
            if not line:
                raise SystemExit("qos: a client died during a leg")
            res.append(json.loads(line))
        bad = [r for r in res if r["errors"] or r["bad"] or r["torch"]]
        if bad:
            raise SystemExit(f"qos: errors, wrong answers or torch in the "
                             f"clients: {bad}")
        return res

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def _qos_counts(m: dict) -> dict:
    """The admission plane's counters from one metrics read."""
    out = {k: m.get(f"mtpu_qos_{k}", 0.0) for k in (
        "requests_inflight", "queue_depth", "pressure",
        "queue_wait_seconds_total", "tenant_throttled_total")}
    for c in ADMISSION_CLASS.values():
        out[f"admitted {c}"] = m.get(
            f'mtpu_qos_admitted_total{{tenant_class="{c}"}}', 0.0)
        out[f"shed {c}"] = m.get(
            f'mtpu_qos_shed_total{{tenant_class="{c}"}}', 0.0)
    for r in ("queue", "deadline"):
        out[f"shed {r}"] = m.get(
            f'mtpu_qos_shed_reason_total{{reason="{r}"}}', 0.0)
    return out


def _leg_report(name: str, res: list[dict], m0: dict, m1: dict,
                workers: int) -> dict:
    """One leg's readings: goodput, per tenant the good requests, sheds,
    resets and p50/p99 of the good ones, the plane's sheds per class and
    reason, and the device items against the acknowledged PUTs."""
    wall = max(r["t1"] for r in res) - min(r["t0"] for r in res)
    rows = {}
    for tenant in ADMISSION_CLASS:
        mine = [r for r in res if r["tenant"] == tenant]
        if not mine:
            continue
        lat = [x for r in mine for x in r["lat"]]
        good = sum(r["put_ok"] + r["get_ok"] for r in mine)
        shed = sum(r["shed"] for r in mine)
        rows[tenant] = {
            "clients": len(mine), "good": good, "shed": shed,
            "resets": sum(r["resets"] for r in mine),
            "shed_rate": shed / max(1, good + shed),
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99),
            "gbps": sum(r["bytes"] for r in mine) / wall / 1e9}
    c0, c1 = _pool_counts(m0, workers), _pool_counts(m1, workers)
    q0, q1 = _qos_counts(m0), _qos_counts(m1)
    rep = {"wall_s": wall, "rows": rows,
           "gbps": sum(r["bytes"] for r in res) / wall / 1e9,
           "acked_puts": sum(r["put_ok"] for r in res),
           "shed": sum(r["shed"] for r in res),
           "resets": sum(r["resets"] for r in res),
           "p99_ms": _pct([x for r in res for x in r["lat"]], 0.99),
           "qos": {k: q1[k] - q0[k] for k in q1
                   if k.startswith(("shed", "admitted"))},
           "items": {k: c1[f"items_{k}"] - c0[f"items_{k}"]
                     for k in ("gf_matmul", "hh256", "mxh256")},
           "launches": {k: c1[f"launches_{k}"] - c0[f"launches_{k}"]
                        for k in ("gf_matmul", "hh256", "mxh256")}}
    want = rep["acked_puts"]
    if (rep["items"]["gf_matmul"], rep["items"]["mxh256"],
            rep["items"]["hh256"]) != (want, want, 0):
        raise SystemExit(f"qos {name}: device items {rep['items']} for "
                         f"{want} acknowledged PUTs (GETs are tier hits)")
    if rep["acked_puts"] and not rep["launches"]["gf_matmul"]:
        raise SystemExit(f"qos {name}: no GF launch: {rep['launches']}")
    return rep


def _stalled_put(port: int, key: str) -> socket.socket:
    """A signed PUT whose headers and first 4 KiB are sent and whose body
    then stalls: it holds an admission slot while the handler waits."""
    import socket as _socket

    from minio_tpu_torch.server.sigv4 import (UNSIGNED_PAYLOAD, Credentials,
                                              sign_request)
    s = _socket.create_connection(("127.0.0.1", port), timeout=30)
    path = f"/adm/{key}"
    hdrs = {"Host": f"127.0.0.1:{port}",
            "Content-Length": str(ADMISSION_BYTES)}
    hdrs.update(sign_request(Credentials("pooladmin", "pooladmin-secret"),
                             "PUT", path, {}, hdrs, UNSIGNED_PAYLOAD))
    s.sendall((f"PUT {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode()
        + b"\0" * 4096)
    return s


def _worker_rows(m: dict, workers: int, what: str = "inflight") -> list:
    return [int(m[f'mtpu_qos_worker_{what}{{worker="{w}"}}'])
            for w in range(workers)]


def _admission_kill(pool, card, warm) -> dict:
    """Hold ADMISSION_STALLED slots in one worker with stalled PUTs (a
    connection the kernel gave the other worker is closed and opened
    again), find that worker from the per-worker rows, SIGKILL it; after
    its respawn the pool's in-flight equals its live rows (0), 4
    requests hold all 4 slots at once, and no GET or HEAD waits 2 s."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from minio_tpu_torch.server.client import S3Client

    import http.client

    port, workers = pool.port, pool.workers

    def metrics():
        # A scrape the kernel queued on the killed worker's listening
        # socket is reset with it: scrape again.
        for _ in range(50):
            try:
                return pool.metrics()
            except (OSError, http.client.HTTPException):
                time.sleep(0.1)
        return pool.metrics()

    def wait_inflight(n, timeout=5.0):
        # The total and the rows are read one after the other, without
        # the plane's lock: a scrape counts when both show n.
        deadline = time.monotonic() + timeout
        while True:
            m = metrics()
            if int(m["mtpu_qos_requests_inflight"]) == n == \
                    sum(_worker_rows(m, workers)):
                return m
            if time.monotonic() > deadline:
                raise SystemExit(f"qos kill: in flight "
                                 f"{m['mtpu_qos_requests_inflight']}, "
                                 f"wanted {n}: rows "
                                 f"{_worker_rows(m, workers)}")
            time.sleep(0.02)

    held, holder, tries = [], None, 0
    try:
        wait_inflight(0)
        while len(held) < ADMISSION_STALLED:
            tries += 1
            if tries > 60:
                raise SystemExit("qos kill: the stalled PUTs never met in "
                                 "one worker")
            before = _worker_rows(metrics(), workers)
            s = _stalled_put(port, f"stall{tries}")
            m = wait_inflight(len(held) + 1)
            rows = _worker_rows(m, workers)
            (w,) = [i for i in range(workers) if rows[i] > before[i]]
            if holder in (None, w):
                holder = w
                held.append(s)
            else:
                s.close()             # the other worker: its slot returns
                wait_inflight(len(held))
        m = metrics()
        pid = int(m[f'mtpu_worker_pid{{worker="{holder}"}}'])
        respawns = int(m[f'mtpu_worker_respawns_total{{worker="{holder}"}}'])
        rows_before = _worker_rows(m, workers)
        t0 = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 120
        while True:
            m = metrics()
            if (int(m[f'mtpu_worker_respawns_total{{worker="{holder}"}}'])
                    == respawns + 1 and m[
                        f'mtpu_worker_ready{{worker="{holder}"}}'] == 1):
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"qos kill: worker {holder} never came "
                                 f"back: {pool.tail()}")
            time.sleep(0.1)
        respawn_s = time.perf_counter() - t0
    finally:
        for s in held:
            s.close()
    rows_after = _worker_rows(m, workers)
    inflight = int(m["mtpu_qos_requests_inflight"])
    if inflight != sum(rows_after) or inflight != 0 or rows_after[holder]:
        raise SystemExit(f"qos kill: in flight {inflight} with live rows "
                         f"{rows_after} after the respawn")
    # Four requests take all four slots at once: none queues, none sheds.
    q0 = _qos_counts(m)
    four = [_stalled_put(port, f"four{i}") for i in range(ADMISSION_SLOTS)]
    try:
        m4 = wait_inflight(ADMISSION_SLOTS, timeout=2.0)
        q4 = _qos_counts(m4)
    finally:
        for s in four:
            s.close()
    if q4["queue_depth"] or any(q4[k] != q0[k] for k in q4
                                if k.startswith("shed")):
        raise SystemExit(f"qos kill: the 4 requests queued or shed: {q4}")
    wait_inflight(0)
    # GETs (tier hits) and HEADs from every worker: none waits 2 s on the
    # tier or the arena.
    cli = S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                   "pooladmin-secret", timeout=30)

    def one(i):
        key = warm[i % len(warm)][0]
        t = time.perf_counter()
        st, _, _ = cli.request("GET" if i % 2 else "HEAD", f"/admw/{key}")
        return st, time.perf_counter() - t

    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(one, range(32)))
    slowest = max(s for _, s in got)
    if any(st != 200 for st, _ in got) or slowest >= 2.0:
        raise SystemExit(f"qos kill: GET/HEAD after the respawn: {got}")
    out = {"holder": holder, "rows_before": rows_before,
           "respawn_s": respawn_s, "rows_after": rows_after,
           "slowest_s": slowest, "tries": tries}
    print(f"[qos] kill: {ADMISSION_STALLED} stalled PUTs held worker "
          f"{holder}'s slots (rows {rows_before}, {tries} connections); "
          f"SIGKILL, respawned in {respawn_s:.2f} s; in flight {inflight} "
          f"= live rows {rows_after}; {ADMISSION_SLOTS} requests then held "
          f"all {ADMISSION_SLOTS} slots at once (no queue, no shed); 32 "
          f"GET/HEAD, slowest {slowest * 1e3:.1f} ms; card {card}")
    return out


def _admission_heal(args, counts, card, clients, warm) -> dict:
    """Heal under pressure, in one process (MTPU_WORKERS=0: the heal shares
    the server's plane there; the pool has no heal trigger): an S3Server
    in this process with the phase's admission settings over 12 fresh
    drives, ADMISSION_HEAL_OBJECTS objects in bucket "heal", one drive
    wiped; the overload mix for one leg while heal_bucket and
    heal_bucket_objects (4 workers asked) rebuild the drive.  The heal's
    workers, its yields, and every healed part file against its
    SHA-256 from before the wipe."""
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.iam.iam import IAMSys
    from minio_tpu_torch.server import qos
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive

    root = _tmp_root("chip_smoke-qosheal-")
    saved_env = {k: os.environ.get(k) for k in ADMISSION_ENV}
    os.environ.update(ADMISSION_ENV)
    qos.reset_for_tests()                  # a plane with these knobs
    real_workers = heal._heal_workers
    asked = []
    srv = pools = None
    try:
        pools, fis = _admission_prep(root, warm, ADMISSION_HEAL_OBJECTS)
        es = pools.pools[0].sets[0]
        golden = _part_hashes(es, "heal", fis)
        wiped = 3
        _wipe(es, LocalDrive, [wiped])
        srv = S3Server(pools, Credentials("pooladmin", "pooladmin-secret"),
                       iam=IAMSys(pools)).start()
        plane = srv.qos
        heal._heal_workers = lambda w: asked.append(real_workers(w)) \
            or asked[-1]
        box = {}

        def run_heal():
            try:
                time.sleep(1.0)               # the pressure rises first
                y0 = plane.stats()["bg_yields_by_plane"].get("heal", 0)
                t = time.perf_counter()
                heal.heal_bucket(es, "heal")
                box["res"] = heal.heal_bucket_objects(es, "heal", workers=4)
                box["s"] = time.perf_counter() - t
                box["yields"] = plane.stats()["bg_yields_by_plane"].get(
                    "heal", 0) - y0
                box["pressure"] = plane.pressure()
            except BaseException as e:  # noqa: BLE001 — raised below
                box["err"] = e

        th = threading.Thread(target=run_heal)
        counts.reset()
        res = clients.leg(srv.port, list(range(len(clients.procs))),
                          ADMISSION_LEG_S, during=th.start)
        th.join(120)
        launches = counts.read()
        if "err" in box:
            raise box["err"]
        if th.is_alive() or "res" not in box:
            raise SystemExit("qos heal: the heal did not finish")
        healed = _part_hashes(es, "heal", fis)
        if healed != golden:
            raise SystemExit("qos heal: healed part files differ from the "
                             "drive's before it left")
        if not asked or asked[-1] >= 4 or box["yields"] < len(fis):
            raise SystemExit(f"qos heal: no yield under pressure: workers "
                             f"{asked}, yields {box['yields']}")
        st = plane.stats()
        good = sum(r["put_ok"] + r["get_ok"] for r in res)
        print(f"[qos] heal under pressure (one process, same admission "
              f"settings, {len(res)} clients): drive {wiped} wiped, "
              f"{len(fis)} objects of {ADMISSION_BYTES} B healed in "
              f"{box['s']:.2f} s with {asked[-1]} of 4 workers, "
              f"{box['yields']} yields (pressure {box['pressure']:.3f} at "
              f"the end); every part file equal to its SHA-256 before the "
              f"wipe; clients {good} good, {sum(r['shed'] for r in res)} "
              f"shed; plane admitted {st['admitted']}, shed {st['shed']}; "
              f"launches {launches}; card {card}")
        return {"launches": launches, "workers": asked[-1],
                "yields": box["yields"], "heal_s": box["s"]}
    finally:
        heal._heal_workers = real_workers
        if srv is not None:
            srv.shutdown()
        if pools is not None:
            pools.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        qos.reset_for_tests()
        shutil.rmtree(root, ignore_errors=True)


def _earlier_sheds(card) -> None:
    """The earlier phases ran with QoS on at the default slot budget (32
    x cores x workers): none of them may have shed a request."""
    from minio_tpu_torch.server import qos
    st = qos.get_plane().stats()
    served = [(log, c) for log, c in POOL_QOS if c is not None]
    shed = st["shed"] + sum(c["shed"] for _, c in served)
    print(f"[qos] earlier phases with QoS on (default budget): this "
          f"process's servers admitted {st['admitted']} and shed "
          f"{st['shed']} ({st['max_slots']} slots); {len(served)} booted "
          f"servers admitted {sum(c['admitted'] for _, c in served):g} and "
          f"shed {sum(c['shed'] for _, c in served):g} "
          f"({len(POOL_QOS) - len(served)} served no metrics); card {card}")
    if shed:
        raise SystemExit(f"qos: earlier phases shed {shed} requests: "
                         f"{POOL_QOS}")


def phase_admission(args, counts, card):
    """The admission plane (server/qos.py) on BASELINE.json config 2's
    deployment (one EC:8+4 set of 12 drives on /dev/shm), after the JAX
    package's overload_bench: `python -m minio_tpu_torch.server` as a
    pool of ADMISSION_WORKERS workers and the device owner, with
    MTPU_REQUESTS_MAX=4, a 2 s deadline, a queue of 12 and the tenants
    gold (premium), std (standard) and beff (best-effort).  Client
    processes PUT their own 256 KiB objects and GET 8 warm ones (hot-tier
    hits), half and half, in legs of 6 s:

    1. capacity: 1 client a tenant, QoS on;
    2. overload: 4 gold, 4 std, 8 beff, QoS on (after 6 s for the
       pressure to decay): goodput against capacity, premium p99 against
       2 x deadline + capacity p99, sheds per class and reason, and
       best-effort shed before premium;
    3. a worker killed holding 3 slots (_admission_kill);
    4. collapse: the overload's clients, booted again with MTPU_QOS=0:
       p99, no shed;
    5. heal under pressure in one process (_admission_heal).

    In every leg of the pool the device items (the pool's metrics) equal
    the acknowledged PUTs.  Returns the launches of the pool's processes
    over its legs and of this process's heal leg."""
    import numpy as np  # noqa: F401 — the prep's bodies

    t_phase = time.perf_counter()
    _earlier_sheds(card)
    warm, specs = _admission_objects(args.seed + 9000)
    boots = (("QoS on", ADMISSION_ENV,
              (("capacity", ADMISSION_CAPACITY),
               ("overload", ADMISSION_OVERLOAD))),
             ("MTPU_QOS=0", {**ADMISSION_ENV, "MTPU_QOS": "0"},
              (("collapse", ADMISSION_OVERLOAD),)))
    roots = {label: _tmp_root("chip_smoke-qos-") for label, _, _ in boots}
    clients, pools = None, {}
    legs, launches, elsewhere = {}, {"gf_matmul": 0, "hh256": 0,
                                     "mxh256": 0}, 0
    try:
        for root in roots.values():
            prep, _ = _admission_prep(root, warm)
            prep.close()
        clients = _QosClients(specs)
        # Both pools boot at once (each on its own drives), and are
        # driven one after the other.
        t0, errors = time.perf_counter(), []

        def boot(label, env):
            try:
                pools[label] = _Pool(roots[label], ADMISSION_WORKERS,
                                     env=env)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        threads = [threading.Thread(target=boot, args=(label, env))
                   for label, env, _ in boots]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        print(f"[qos] two pools of {ADMISSION_WORKERS} workers booted at "
              f"once in {time.perf_counter() - t0:.2f} s ("
              + ", ".join(f"{k} ready in {v.boot_s:.2f} s"
                          for k, v in pools.items()) + f"); card {card}")
        from minio_tpu_torch.server.client import S3Client
        for label, _, plan in boots:
            pool = pools[label]
            cli = S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                           "pooladmin-secret", timeout=60)
            for _ in range(3):               # two misses admit, then hits
                for key, _, _ in warm:
                    st, _, _ = cli.request("GET", f"/admw/{key}")
                    if st != 200:
                        raise SystemExit(f"qos: warm GET {key}: {st}")
            # The PUT path warmed up too, so the first leg is not the
            # workers' first writes.
            for i in range(2 * ADMISSION_WORKERS * ADMISSION_SLOTS):
                body = bytes([i]) * ADMISSION_BYTES
                st, _, _ = cli.request("PUT", f"/adm/warmup{i}", body=body)
                if st != 200:
                    raise SystemExit(f"qos: warm-up PUT: {st}")
            m = pool.settled()
            if m["mtpu_hotcache_entries"] < len(warm):
                raise SystemExit("qos: the warm objects are not resident")
            for i, (name, per) in enumerate(plan):
                if i:
                    time.sleep(ADMISSION_DECAY_S)
                m0 = pool.settled()
                res = clients.leg(pool.port, clients.pick(per),
                                  ADMISSION_LEG_S)
                m1 = pool.settled()
                rep = legs[name] = _leg_report(name, res, m0, m1,
                                               ADMISSION_WORKERS)
                for k in launches:
                    launches[k] += rep["launches"][k]
                elsewhere += rep["launches"]["mxh256"]
                rows = "; ".join(
                    f"{t} ({ADMISSION_CLASS[t]}, {r['clients']}) {r['good']}"
                    f" good, {r['shed']} shed, {r['resets']} reset, p50 "
                    f"{r['p50_ms']:.1f} p99 {r['p99_ms']:.1f} ms, "
                    f"{r['gbps']:.4f} GB/s" for t, r in rep["rows"].items())
                print(f"[qos] {name} ({label}): {rep['gbps']:.4f} GB/s "
                      f"goodput over {rep['wall_s']:.2f} s, p99 "
                      f"{rep['p99_ms']:.1f} ms; {rows}; plane sheds "
                      f"{rep['qos']}; items {rep['items']} for "
                      f"{rep['acked_puts']} acknowledged PUTs, launches "
                      f"{rep['launches']}; card {card}")
            if label == "QoS on":
                legs["kill"] = _admission_kill(pool, card, warm)
            print(f"[qos] {label}: SIGTERM, exit 0 in "
                  f"{pools.pop(label).stop():.2f} s")
        heal_rep = _admission_heal(args, counts, card, clients, warm)
        for k in launches:
            launches[k] += heal_rep["launches"][k]
    finally:
        for pool in pools.values():
            print(f"[qos] a pool's log ends: {pool.tail()}")
            pool.kill()
        if clients is not None:
            clients.close()
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
    cap, over, off = legs["capacity"], legs["overload"], legs["collapse"]
    if cap["shed"] or off["shed"] or off["resets"]:
        raise SystemExit(f"qos: capacity sheds {cap['shed']}, collapse "
                         f"sheds {off['shed']} + resets {off['resets']}")
    gold, beff = over["rows"]["gold"], over["rows"]["beff"]
    if not beff["shed"] or beff["shed_rate"] <= gold["shed_rate"]:
        raise SystemExit(f"qos: best-effort did not shed before premium: "
                         f"{over['rows']}")
    bound = 2 * ADMISSION_DEADLINE_MS + cap["p99_ms"]
    ratio = over["gbps"] / cap["gbps"] if cap["gbps"] else 0.0
    print(f"[qos] overload over capacity {ratio:.3f} (the JAX gate is >= "
          f"0.9: {'met' if ratio >= 0.9 else 'missed'}); premium p99 "
          f"{gold['p99_ms']:.1f} ms against 2 x {ADMISSION_DEADLINE_MS} + "
          f"{cap['p99_ms']:.1f} = {bound:.1f} ms "
          f"({'met' if gold['p99_ms'] <= bound else 'missed'}); shed rate "
          f"premium {gold['shed_rate']:.3f}, best-effort "
          f"{beff['shed_rate']:.3f}; collapse p99 {off['p99_ms']:.1f} ms, "
          f"0 shed, {off['gbps']:.4f} GB/s; card {card}")
    print(f"[qos] phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return {**launches, "mxh256_elsewhere": elsewhere}


#: 5o: the sha256 objects (BASELINE.json config 2's object size and a
#: ragged one) and the legacy objects' sizes
FORMS_SIZES = (OBJECT_BYTES, TAIL_OBJECT_BYTES)
#: the legacy (format v1) erasure block: 10 MiB (blockSizeV1)
V1_BLOCK = 10 * MIB


def _v1_write(es, torch_dev, bucket: str, obj: str, data: bytes) -> None:
    """A legacy (xl.json) object as an older MinIO server leaves it on the
    set's drives: each 10 MiB block cut into k chunks of ceil(block / k)
    and encoded (the GF kernel here, before any count is read), the
    unframed shard files back to back, and on each drive an xl.json
    (storage/xlmeta_v1.make_xl_json) holding its shard's whole-file
    HighwayHash-256."""
    import numpy as np
    from minio_tpu_torch.ops import fused
    from minio_tpu_torch.storage import bitrot_io, xlmeta_v1
    from minio_tpu_torch.storage.xlmeta import (ErasureInfo, FileInfo,
                                                ObjectPartInfo)
    n = es.n
    k, m = n - es.default_parity, es.default_parity
    shards = [bytearray() for _ in range(n)]
    buf = np.frombuffer(data, dtype=np.uint8)
    for lo in range(0, len(data), V1_BLOCK):
        cur = min(V1_BLOCK, len(data) - lo)
        chunk = -(-cur // k)
        x = np.zeros((1, k, chunk), dtype=np.uint8)
        x.reshape(-1)[:cur] = buf[lo:lo + cur]
        par = fused.transform(x, k, m, tuple(range(k)),
                              tuple(range(k, n)), device=torch_dev)
        par = par.cpu().numpy()
        for s in range(k):
            shards[s] += x[0, s].tobytes()
        for s in range(m):
            shards[k + s] += par[0, s].tobytes()
    sums = bitrot_io.whole_file_digests([bytes(s) for s in shards],
                                        "highwayhash256", torch_dev)
    dist = list(range(1, n + 1))
    for pos, d in enumerate(es.drives):
        d.create_file(bucket, f"{obj}/part.1", bytes(shards[pos]))
        fi = FileInfo(
            volume=bucket, name=obj, version_id="", data_dir="legacy",
            mod_time_ns=1_600_000_000_000_000_000, size=len(data),
            metadata={"etag": hashlib.md5(data).hexdigest(),
                      "content-type": "application/octet-stream"},
            parts=[ObjectPartInfo(1, len(data), len(data))],
            erasure=ErasureInfo(
                data_blocks=k, parity_blocks=m, block_size=V1_BLOCK,
                index=pos + 1, distribution=dist,
                checksums=[{"part": 1, "name": "part.1",
                            "algo": "highwayhash256", "hash": sums[pos]}]))
        d.write_all(bucket, f"{obj}/{xlmeta_v1.XL_JSON}",
                    xlmeta_v1.make_xl_json(fi))


def phase_bitrot_forms(args, counts, card):
    """Phase 5o, the other bitrot forms, on BASELINE.json config 2's set
    (EC:8+4, 12 drives on /dev/shm) in this process.

    sha256 objects (64 MiB and 64 MiB + 300 KiB + 5 B): PUT, GET,
    degraded GET with two data-shard drives away, heal of a wiped
    data-shard drive; the digests are hashlib's (the host route), so
    each step's GF items are exact and no mxh256 or hh256 item or launch
    is made.  Then legacy xl.json objects (format v1, whole-file
    HighwayHash, 10 MiB blocks) of the same sizes: GET (one hh256 item a
    part: the 12 shard files of a part are one call), HEAD,
    list_object_versions, and GET with one data shard corrupted (one
    hh256 item, and one GF item per chunk size: the 10 MiB blocks and
    the shorter last one).  Bodies by SHA-256.  Beside it, one 32 MiB
    PUT batch's encode with sha256 digests on the host against mxh256's
    on the device."""
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.ops import devices, fused
    from minio_tpu_torch.storage import xlmeta_v1
    from minio_tpu_torch.storage.drive import LocalDrive
    import numpy as np
    import torch

    root = _tmp_root("chip_smoke-forms-", 3 * sum(FORMS_SIZES) * 2)
    rng = np.random.default_rng(args.seed + 15)
    bodies = {f"sha{i}": rng.bytes(n) for i, n in enumerate(FORMS_SIZES)}
    legacy = {f"v1-{i}": rng.bytes(n) for i, n in enumerate(FORMS_SIZES)}
    sha = {k: hashlib.sha256(v).digest()
           for k, v in {**bodies, **legacy}.items()}
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(12)], default_parity=4)
    dev = es.device
    report, t_phase = {}, time.perf_counter()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def check(name, want_gf, want_hh=0, got=None):
        launches, items = counts.read(), counts.items()
        want = {"gf_matmul": want_gf, "hh256": want_hh, "mxh256": 0}
        if items != want or any(launches[k] > items[k] for k in items) \
                or launches["mxh256"] or launches["hh256"] != want_hh:
            raise SystemExit(f"forms {name}: items {items} launches "
                             f"{launches}, want items {want}")
        report[name] = (launches, items)

    def same(name, got):
        if hashlib.sha256(bytes(got)).digest() != sha[name]:
            raise SystemExit(f"forms: {name} bytes differ")

    try:
        es.make_bucket("forms")
        os.environ["MTPU_BITROT_ALGO"] = "sha256"
        counts.reset()
        t0 = time.perf_counter()
        fis = {k: es.put_object("forms", k, v) for k, v in bodies.items()}
        put_s = time.perf_counter() - t0
        if any(fi.erasure.bitrot_algo() != "sha256" for fi in fis.values()):
            raise SystemExit("forms: PUT did not record sha256")
        check("sha256 PUT", sum(_put_calls(n) for n in FORMS_SIZES))

        counts.reset()
        t0 = time.perf_counter()
        for k in bodies:
            same(k, es.get_object("forms", k)[1])
        get_s = time.perf_counter() - t0
        check("sha256 GET", 0)

        counts.reset()
        t0 = time.perf_counter()
        for k, fi in fis.items():
            saved = list(es.drives)
            for pos in _data_positions(Q, fi, 2):
                es.drives[pos] = None
            same(k, es.get_object("forms", k)[1])
            es.drives = saved
        deg_s = time.perf_counter() - t0
        check("sha256 degraded GET", sum(_get_calls(fi)
                                         for fi in fis.values()))

        golden = _part_hashes(es, "forms", fis)
        wiped = _data_positions(Q, fis["sha0"], 1)
        _wipe(es, LocalDrive, wiped)
        counts.reset()
        t0 = time.perf_counter()
        heal.heal_bucket(es, "forms")
        for k in bodies:
            r = heal.heal_object(es, "forms", k)[0]
            if r.healed_drives != wiped:
                raise SystemExit(f"forms heal {k}: {r.healed_drives}")
        heal_s = time.perf_counter() - t0
        check("sha256 heal", sum(
            len(heal._frame_batches(fi.size, fi.erasure, "sha256"))
            for fi in fis.values()))
        if _part_hashes(es, "forms", fis) != golden:
            raise SystemExit("forms: healed sha256 part files differ")
        os.environ.pop("MTPU_BITROT_ALGO", None)

        # Legacy objects, written before any count is read.
        for k, v in legacy.items():
            _v1_write(es, dev, "forms", k, v)
        sync()
        counts.reset()
        t0 = time.perf_counter()
        for k in legacy:
            fi, got = es.get_object("forms", k)
            if not xlmeta_v1.is_v1(fi):
                raise SystemExit(f"forms: {k} not read as format v1")
            same(k, got)
        v1_get_s = time.perf_counter() - t0
        check("xl.json GET", 0, len(legacy))
        counts.reset()
        for k, v in legacy.items():
            fi = es.head_object("forms", k)
            vers = es.list_object_versions("forms", k)
            if fi.size != len(v) or fi.etag != hashlib.md5(v).hexdigest() \
                    or len(vers) != 1 or vers[0].size != len(v):
                raise SystemExit(f"forms: HEAD or versions of {k} wrong")
        check("xl.json HEAD + versions", 0, 0)
        for k in legacy:                      # shard 0 (data) corrupted
            p = os.path.join(es.drives[0].root, "forms", k, "part.1")
            with open(p, "r+b") as f:
                f.seek(os.path.getsize(p) // 2)
                f.write(b"\x5a" * 64)
        counts.reset()
        t0 = time.perf_counter()
        for k in legacy:
            same(k, es.get_object("forms", k)[1])
        v1_deg_s = time.perf_counter() - t0
        check("xl.json corrupted-shard GET", sum(
            1 + (n % V1_BLOCK != 0 and n > V1_BLOCK)
            for n in FORMS_SIZES), len(legacy))
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("MTPU_BITROT_ALGO", None)

    # One 32 MiB PUT batch's encode: sha256 (GF on the card, digests on
    # the host) against mxh256 (both on the card), in turns.
    blocks = np.random.default_rng(1).integers(0, 256, (32, 8, 131072),
                                               dtype=np.uint8)
    xt = devices.put(blocks, dev)
    ms = {"sha256": [], "mxh256": []}
    for algo in ("sha256", "mxh256", "mxh256", "sha256") * 2:
        sync()
        t0 = time.perf_counter()
        p, d = fused.encode_and_hash(xt, 8, 4, algo=algo, device=dev)
        p.cpu(), d.cpu()
        sync()
        ms[algo].append((time.perf_counter() - t0) * 1e3)
    gb = sum(FORMS_SIZES) / 1e9
    print(f"[forms] sha256, EC:8+4, {len(bodies)} objects, "
          f"{sum(FORMS_SIZES)} B: PUT {gb / put_s:.3f} GB/s, GET "
          f"{gb / get_s:.3f} GB/s, degraded GET {gb / deg_s:.3f} GB/s, heal "
          f"of drive {wiped[0]} {heal_s:.2f} s; items and launches per step "
          f"{report}; card {card}")
    print(f"[forms] xl.json (format v1, whole-file HighwayHash, 10 MiB "
          f"blocks), {len(legacy)} objects: GET {gb / v1_get_s:.3f} GB/s, "
          f"GET with shard 0 corrupted {gb / v1_deg_s:.3f} GB/s; card {card}")
    print(f"[forms] one 32 MiB PUT batch's encode + digests "
          f"(encode_and_hash, D2H included, median of 4): sha256 (digests "
          f"on the host) {statistics.median(ms['sha256']):.3f} ms, mxh256 "
          f"(on the device) {statistics.median(ms['mxh256']):.3f} ms; "
          f"card {card}")
    print(f"[forms] phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return {k: sum(l[k] for l, _ in report.values())
            for k in ("gf_matmul", "hh256", "mxh256")}


#: 5p: MinIO's multi-node multi-drive layout on one card: node
#: processes x drives each, one erasure set of all of them, STANDARD=EC:4
CLUSTER_NODES = 4
CLUSTER_DRIVES = 4
#: 64 MiB objects per client process (one client a node)
# 2 before phase 5s joined the run.
CLUSTER_PER_CLIENT = 1
# CLUSTER_INLINE 16 before phase 5t joined the run.
CLUSTER_INLINE = 8
# CLUSTER_RACE_ROUNDS 8 and CLUSTER_LOCKS 50 before phase 5t.
CLUSTER_RACE_ROUNDS = 2
CLUSTER_RACE_BYTES = 4 * MIB + 3
CLUSTER_LOCKS = 25
#: the 5f figures (ServerPools in this process, 64 MiB objects) 5p prints
#: its own beside
ONE_PROCESS_GBPS: dict = {}


class _Node:
    """One cluster node, `python -m minio_tpu_torch.server` over URL
    endpoints, booted as a subprocess; `counts()` reads its kernels'
    launches and items from /minio/v2/metrics/node."""

    def __init__(self, root: str, args: list[str], port: int, idx: int):
        self.root, self.args, self.port, self.idx = root, args, port, idx
        self.log = os.path.join(root, f"node{idx}.log")
        self.proc = None

    def start(self) -> "_Node":
        # MTPU_PEER_PROBE_MAX_S bounds how long a node's RPC client
        # waits between probes of a dead peer: node 4's return is seen
        # within seconds.
        env = dict(os.environ, MTPU_ROOT_USER="pooladmin",
                   MTPU_ROOT_PASSWORD="pooladmin-secret",
                   MTPU_STORAGE_CLASS_STANDARD="EC:4",
                   MTPU_BOOT_TIMEOUT="240", MTPU_PEER_PROBE_MAX_S="2")
        for k in ("MTPU_WORKERS", "MTPU_IPC_DISPATCH", "MTPU_BITROT_ALGO"):
            env.pop(k, None)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here
        with open(self.log, "a") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch.server", "--drives",
                 " ".join(self.args), "--port", str(self.port)],
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
        return self

    def ready(self) -> bool:
        import urllib.request
        if self.proc.poll() is not None:
            raise SystemExit(f"cluster: node {self.idx} exited "
                             f"{self.proc.returncode}: {self.tail()}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/minio/health/ready",
                    timeout=2) as r:
                return r.status == 200
        except OSError:
            return False

    def tail(self) -> str:
        with open(self.log) as f:
            return f.read()[-3000:]

    def counts(self) -> dict:
        out = {}
        for line in _metrics_text(self.port).splitlines():
            for what in ("launches", "items"):
                pre = f'mtpu_kernel_{what}_total{{kernel="'
                if line.startswith(pre):
                    k = line[len(pre):line.index('"', len(pre))]
                    out[f"{what}_{k}"] = int(float(line.rsplit(" ", 1)[1]))
        return out

    def stop(self) -> None:
        import signal
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise SystemExit(f"cluster: node {self.idx} no exit within "
                             "30 s of SIGTERM") from None
        if rc != 0:
            raise SystemExit(f"cluster: node {self.idx} exit {rc} on "
                             f"SIGTERM: {self.tail()}")

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _metrics_text(port: int) -> str:
    import urllib.request
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/minio/v2/metrics/node",
            timeout=10) as r:
        return r.read().decode()


def _boot_nodes(nodes) -> float:
    t0 = time.perf_counter()
    for n in nodes:
        n.start()
    deadline = time.monotonic() + 300
    pending = list(nodes)
    while pending:
        pending = [n for n in pending if not n.ready()]
        if pending and time.monotonic() > deadline:
            raise SystemExit(f"cluster: node {pending[0].idx} never ready:"
                             f" {pending[0].tail()}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def phase_cluster(args, counts, card):
    """Phase 5p, the distributed cluster: CLUSTER_NODES node processes x
    CLUSTER_DRIVES drives on /dev/shm behind URL endpoints
    (`http://127.0.0.1:{port}/.../d{1...4}`), one erasure set of 16 with
    STANDARD=EC:4 (MinIO's documented multi-node multi-drive layout, on
    one card), every node booted at once with its self-tests on the card.

    Client processes (one a node) PUT 64 MiB objects through their node
    and GET each through the next one, byte-exact; 16 inline objects PUT
    round-robin are listed alike from every node; two clients PUT one key
    through two nodes at once, round after round, and every node then
    serves one of the two bodies whole.  Then node 4 is SIGKILLed: every
    object is still served by the other nodes (12 of 16 drives, its data
    rows rebuilt: GF items exact), a 64 MiB PUT meets write quorum and a
    dsync lock is taken with 3 of 4 lockers.  Node 4 boots again and a
    heal sequence restores it; with every node stopped, this process
    opens the 16 drives as one set: a deep dry-run heal finds every
    drive of every object ok, and every object reads byte-exact with
    node 1's drives away (so from node 4's).  Each step's device items
    are the nodes' (their metrics), summed, against the sizes."""
    from minio_tpu_torch.cluster.dsync import DRWMutex
    from minio_tpu_torch.cluster.nslock import NSLockMap
    from minio_tpu_torch.engine import heal
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.rpc.lock_rpc import RemoteLocker
    from minio_tpu_torch.rpc.rest import RPCClient
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.cluster import internode_token
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.xlmeta import XLMeta
    import numpy as np

    n_nodes, per = CLUSTER_NODES, CLUSTER_DRIVES
    n = n_nodes * per
    big = [[(f"c{c}-{i}", OBJECT_BYTES, args.seed * 1000 + 40 + c * 8 + i)
            for i in range(CLUSTER_PER_CLIENT)] for c in range(n_nodes)]
    need = (n * sum(z for o in big for _, z, _ in o) // (n - 4)
            + 4 * CLUSTER_RACE_BYTES * 3 + OBJECT_BYTES * 3)
    root = _tmp_root("chip_smoke-cluster-", need)
    ports = [_free_port() for _ in range(n_nodes)]
    eps = [f"http://127.0.0.1:{p}{root}/n{i}/d{{1...{per}}}"
           for i, p in enumerate(ports, 1)]
    nodes = [_Node(root, eps, p, i + 1) for i, p in enumerate(ports)]
    paths = [os.path.join(root, f"n{i}", f"d{j}")
             for i in range(1, n_nodes + 1) for j in range(1, per + 1)]
    cli = [S3Client(f"http://127.0.0.1:{p}", "pooladmin",
                    "pooladmin-secret", timeout=600) for p in ports]
    t_phase = time.perf_counter()
    steps, lines = {}, []
    node_launches = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}

    def fi_of(key):
        """The key's version as node 1's first drive holds it."""
        with open(os.path.join(paths[0], "clus", key, "xl.meta"), "rb") as f:
            return XLMeta.from_bytes(f.read()).latest("clus", key)

    def node_counts(live):
        return {nd.idx: nd.counts() for nd in live}

    def step(name, live, before, want):
        """The step's items and launches: each live node's counts now
        less before, summed."""
        time.sleep(0.1)
        after = node_counts(live)
        d = {k: sum(after[i][k] - before[i][k] for i in after)
             for k in after[live[0].idx]}
        items = {k: d[f"items_{k}"] for k in node_launches}
        launches = {k: d[f"launches_{k}"] for k in node_launches}
        if want is not None and (items != want or any(
                launches[k] > items[k] for k in items)):
            raise SystemExit(f"cluster {name}: items {items} launches "
                             f"{launches}, want {want}")
        for k in node_launches:
            node_launches[k] += launches[k]
        steps[name] = items
        return after

    def rebuilt(fi) -> bool:
        """Whether a read without node 4's drives rebuilds data rows."""
        order = Q.shuffle_by_distribution(list(range(n)),
                                          fi.erasure.distribution)
        return any(order[s] >= n - per
                   for s in range(fi.erasure.data_blocks))

    clients = None
    try:
        boot_s = _boot_nodes(nodes)
        cli[0].make_bucket("clus")
        m0 = node_counts(nodes)

        # dsync against the local lock: CLUSTER_LOCKS acquire + release.
        token = internode_token("pooladmin-secret")
        lockers = [RemoteLocker(RPCClient(f"127.0.0.1:{p}", token))
                   for p in ports]

        def lock_ms(lks) -> float:
            t0 = time.perf_counter()
            for i in range(CLUSTER_LOCKS):
                m = DRWMutex(f"clus/lock{i}", lks)
                if not m.get_lock(timeout=5):
                    raise SystemExit(f"cluster: dsync lock with "
                                     f"{len(lks)} lockers not taken")
                m.unlock()
            return (time.perf_counter() - t0) * 1e3 / CLUSTER_LOCKS

        dsync_ms = lock_ms(lockers)
        ns = NSLockMap()
        t0 = time.perf_counter()
        for i in range(1000):
            with ns.write_locked("clus", f"lock{i}"):
                pass
        local_ms = (time.perf_counter() - t0) * 1e3 / 1000

        clients = _Clients(ports[0], "clus", big, ports=ports)
        put = clients.run("put")
        m1 = step("PUT", nodes, m0, {
            "gf_matmul": sum(_put_calls(z) for o in big for _, z, _ in o),
            "hh256": 0,
            "mxh256": sum(_put_calls(z) for o in big for _, z, _ in o)})
        get = clients.run("get")
        fis = {k: fi_of(k) for o in big for k, _, _ in o}
        m1 = step("GET", nodes, m1, {
            "gf_matmul": 0, "hh256": 0,
            "mxh256": sum(_get_calls(fi) for fi in fis.values())})

        rng = np.random.default_rng(args.seed + 16)
        inline = {f"small/{i:03d}": rng.bytes(int(rng.integers(1, 100))
                                              * 1024)
                  for i in range(CLUSTER_INLINE)}
        for i, (k, v) in enumerate(inline.items()):
            cli[i % n_nodes].put_object("clus", k, v)
        for i, (k, v) in enumerate(inline.items()):
            if cli[(i + 1) % n_nodes].get_object("clus", k) != v:
                raise SystemExit(f"cluster: inline {k} differs")
        want_keys = sorted(list(inline) + list(fis))
        listed = [c.list_objects("clus")[0] for c in cli]
        if any(lst != want_keys for lst in listed):
            raise SystemExit(f"cluster: listings differ: "
                             f"{[len(x) for x in listed]}")
        m1 = step("inline PUT + GET", nodes, m1, {
            "gf_matmul": len(inline), "hh256": 0,
            "mxh256": 2 * len(inline)})

        race = {c: np.random.default_rng(900 + c).bytes(CLUSTER_RACE_BYTES)
                for c in (0, 1)}

        def racer(c):
            for _ in range(CLUSTER_RACE_ROUNDS):
                cli[c].put_object("clus", "race", race[c])
        _in_threads(2, racer, [0, 1])
        got = {hashlib.sha256(c.get_object("clus", "race")).digest()
               for c in cli}
        if len(got) != 1 or got.pop() not in {
                hashlib.sha256(v).digest() for v in race.values()}:
            raise SystemExit("cluster: the raced key is not one whole body "
                             "on every node")
        m1 = step("same-key PUTs through two nodes", nodes, m1, {
            "gf_matmul": 2 * CLUSTER_RACE_ROUNDS * _put_calls(
                CLUSTER_RACE_BYTES), "hh256": 0,
            "mxh256": 2 * CLUSTER_RACE_ROUNDS * _put_calls(
                CLUSTER_RACE_BYTES) + n_nodes * _get_calls(fi_of("race"))})

        # Versioning enabled through node 1 after node 2 read it absent:
        # node 2's next PUTs of one key add versions, every node lists
        # both (the bucket-metadata reload node 1 broadcasts before it
        # answers; without it node 2 kept its cached absence and
        # replaced the null version).
        cli[0].make_bucket("clusv")
        cli[1]._check(*cli[1].request("GET", "/clusv",
                                      query={"versioning": ""}))
        cli[0]._check(*cli[0].request(
            "PUT", "/clusv", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>"))
        vids = [cli[1].put_object("clusv", "k", np.random.default_rng(
            args.seed + 18 + i).bytes(4096 + i)).get("x-amz-version-id")
            for i in range(2)]
        for c in cli:
            _, _, out = c.request("GET", "/clusv", query={"versions": ""})
            listed = sorted(v.decode() for v in re.findall(
                rb"<VersionId>([^<]+)</VersionId>", out))
            if not all(vids) or listed != sorted(vids):
                raise SystemExit(f"cluster: versions {listed}, PUT as "
                                 f"{vids}")
        # The config and two PUTs, inline; node 2 reads the config again.
        m1 = step("versioning through node 1, PUTs through node 2", nodes,
                  m1, {"gf_matmul": 3, "hh256": 0, "mxh256": 4})

        # Node 4 SIGKILLed.
        nodes[-1].kill()
        live = nodes[:-1]
        t0 = time.perf_counter()
        for i, (k, fi) in enumerate(fis.items()):
            c = cli[i % (n_nodes - 1)]
            body = np.random.default_rng(
                next(s for o in big for kk, _, s in o if kk == k)).bytes(
                    OBJECT_BYTES)
            if c.get_object("clus", k) != body:
                raise SystemExit(f"cluster: {k} with node 4 down differs")
        deg_s = time.perf_counter() - t0
        m1 = step("GET with node 4 down", live, m1, {
            "gf_matmul": sum(_get_calls(fi) for fi in fis.values()
                             if rebuilt(fi)),
            "hh256": 0,
            "mxh256": sum(_get_calls(fi) for fi in fis.values())})
        late = np.random.default_rng(args.seed + 17).bytes(OBJECT_BYTES)
        cli[0].put_object("clus", "late", late)
        if cli[1].get_object("clus", "late") != late:
            raise SystemExit("cluster: the PUT with node 4 down differs")
        fi_late = fi_of("late")
        m1 = step("PUT + GET with node 4 down", live, m1, {
            "gf_matmul": _put_calls(OBJECT_BYTES) + (
                _get_calls(fi_late) if rebuilt(fi_late) else 0),
            "hh256": 0,
            "mxh256": _put_calls(OBJECT_BYTES) + _get_calls(fi_late)})
        dsync3_ms = lock_ms(lockers)

        # Node 4 again, then a heal sequence from node 1 once node 1's
        # client sees it (and its drives' breakers have probed it).
        reboot_s = _boot_nodes([nodes[-1]])
        peer = f'mtpu_peer_online{{peer="127.0.0.1:{ports[-1]}"}} 1'
        deadline = time.monotonic() + 60
        while peer not in _metrics_text(ports[0]):
            if time.monotonic() > deadline:
                raise SystemExit("cluster: node 1 never saw node 4 again")
            time.sleep(0.2)
        time.sleep(2.0)
        h0 = node_counts(nodes)
        t0 = time.perf_counter()
        st, _, body = cli[0].request("POST", "/minio/admin/v3/heal/",
                                     query={})
        if st != 200:
            raise SystemExit(f"cluster: heal start {st} {body[:200]}")
        deadline = time.monotonic() + 300
        while True:
            _, _, body = cli[0].request("GET", "/minio/admin/v3/heal/",
                                        query={})
            seq = json.loads(body)["sequences"][-1]
            if seq["state"] in ("done", "failed"):
                break
            if time.monotonic() > deadline:
                raise SystemExit("cluster: heal sequence never ended")
            time.sleep(0.2)
        heal_s = time.perf_counter() - t0
        if seq["state"] != "done" or seq["failures"]:
            raise SystemExit(f"cluster: heal sequence {seq}")
        # MRF heals of node 1's late PUT may race the sequence: the
        # heal's items are printed, not held to a count.
        step("heal", nodes, h0, None)
        for nd in nodes:
            nd.stop()
    finally:
        if clients is not None:
            clients.close()
        for nd in nodes:
            nd.kill()

    # This process: the 16 drives as one set, every object's copies ok
    # under a deep dry-run heal, every object read from node 4's drives.
    counts.reset()
    es = ErasureSet([LocalDrive(p) for p in paths], default_parity=4)
    try:
        keys = list(fis) + ["late", "race"] + list(inline)
        for k in keys:
            for r in heal.heal_object(es, "clus", k, deep=True,
                                      dry_run=True):
                if any(s != heal.DRIVE_OK for s in r.before):
                    raise SystemExit(f"cluster: {k} after heal {r.before}")
        for pos in range(per):
            es.drives[pos] = None
        for k in fis:
            body = np.random.default_rng(
                next(s for o in big for kk, _, s in o if kk == k)).bytes(
                    OBJECT_BYTES)
            if bytes(es.get_object("clus", k)[1]) != body:
                raise SystemExit(f"cluster: {k} from node 4's drives "
                                 "differs")
        if bytes(es.get_object("clus", "late")[1]) != late:
            raise SystemExit("cluster: the late PUT from node 4's drives "
                             "differs")
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
    here = counts.read()
    launches = {k: node_launches[k] + here[k] for k in node_launches}
    launches["mxh256_elsewhere"] = node_launches["mxh256"]
    one = ONE_PROCESS_GBPS.get("pools", (float("nan"), float("nan")))
    print(f"[cluster] {n_nodes} nodes x {per} drives (one set of {n}, "
          f"STANDARD=EC:4), booted at once in {boot_s:.2f} s; node 4 "
          f"booted again in {reboot_s:.2f} s; card {card}")
    print(f"[cluster] {n_nodes} clients x {CLUSTER_PER_CLIENT} x "
          f"{OBJECT_BYTES} B across nodes: PUT {put['gbps']:.3f} GB/s, GET "
          f"{get['gbps']:.3f} GB/s (each through the next node), GET with "
          f"node 4 down {len(fis) * OBJECT_BYTES / deg_s / 1e9:.3f} GB/s; "
          f"one process (5f, ServerPools): PUT {one[0]:.3f} GB/s, GET "
          f"{one[1]:.3f} GB/s (host clock); card {card}")
    print(f"[cluster] dsync write lock + unlock: {dsync_ms:.3f} ms over 4 "
          f"lockers, {dsync3_ms:.3f} ms over 3 of 4 (node 4 down); the "
          f"local namespace lock {local_ms:.4f} ms; card {card}")
    print(f"[cluster] heal sequence after node 4's return: {heal_s:.2f} s, "
          f"{seq['scanned']} scanned, {seq['healed']} healed; every drive "
          f"of every object ok under a deep dry-run heal, every object "
          f"byte-exact from node 4's drives; card {card}")
    print(f"[cluster] items per step (the nodes' metrics, summed): {steps}; "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} "
          f"s; card {card}")
    return launches


# Phase 5q, the pool lifecycle and the data scanner, over BASELINE.json
# config 2's deployment per pool (one EC:8+4 set of 12 drives, STANDARD=
# EC:4, on /dev/shm): a versioned bucket of LIFE_BIG objects of
# OBJECT_BYTES (LIFE_HH of them highwayhash256S, the last of
# TAIL_OBJECT_BYTES), LIFE_SMALL of LIFE_SMALL_BYTES, one key with
# LIFE_HISTORY versions and a delete marker, and a pending multipart
# upload of LIFE_PARTS, written in this process; the pool booted with
# LIFE_WORKERS workers; pool 1 added live; pool 0 drained with
# LIFE_DURING PUTs of LIFE_DURING_BYTES during the drain and its mover's
# worker SIGKILLed once LIFE_KILL_AFTER versions moved.
# LIFE_BIG 6 before phase 5u joined the run.
LIFE_BIG, LIFE_HH = 4, 2
# LIFE_SMALL 128 before phase 5r joined the run, 64 before 5s, 32
# before 5t.
LIFE_SMALL, LIFE_SMALL_BYTES = 16, (1024, 100 * 1024)
LIFE_HISTORY = 3
LIFE_PARTS = (16 * MIB, 16 * MIB)
# LIFE_DURING 4 before phase 5t joined the run.
LIFE_DURING, LIFE_DURING_BYTES = 2, 2 * MIB + 3
LIFE_WORKERS = 2
LIFE_KILL_AFTER = 3
LIFE_CLOCKS = ("bytes_per_sec", "eta_seconds", "started_at")
_KERNELS = ("gf_matmul", "hh256", "mxh256")


def _batches(fi) -> int:
    """Device calls of one drive's frames of `fi` (a deep verify reads
    each live drive's in these): per part one per 32 full blocks and one
    for the tail block; an inline object is one."""
    if not fi.data_dir:
        return 1
    return sum(-(-(p.size // MIB) // 32) + (1 if p.size % MIB else 0)
               for p in fi.parts)


def _version_items(fi) -> dict[str, int]:
    """The items the mover spends on one data version `fi` of pool 0: the
    source's GET (its digest), the destination's PUT (a GF encode and an
    mxh256 digest per call) and the verify GET of the copy (mxh256)."""
    n = _get_calls(fi)
    want = dict.fromkeys(_KERNELS, 0)
    want[_digest(fi.erasure.bitrot_algo())] += n
    want["gf_matmul"] += _put_calls(fi.size)
    want["mxh256"] += _put_calls(fi.size) + n
    return want


def _pool0_versions(root: str) -> list:
    """Every version the drain of pool 0 moves, read off drive b1's
    xl.meta files (read only: the pool is serving): bucket `life`'s and
    the system volume's objects (the bucket's versioning config)."""
    from minio_tpu_torch.background.decom import META_PREFIXES
    from minio_tpu_torch.storage.drive import SYS_VOL
    from minio_tpu_torch.storage.xlmeta import XLMeta
    tops = [("life", os.path.join(root, "b1", "life"))]
    tops += [(SYS_VOL, os.path.join(root, "b1", SYS_VOL, p))
             for p in META_PREFIXES]
    out = []
    for bucket, top in tops:
        base = os.path.join(root, "b1", bucket)
        for d, _, files in os.walk(top):
            if "xl.meta" in files:
                name = os.path.relpath(d, base)
                with open(os.path.join(d, "xl.meta"), "rb") as f:
                    out.extend(XLMeta.from_bytes(f.read()).list_versions(
                        bucket, name))
    return out


def _life_status(port: int) -> dict:
    """The drain's status through a fresh connection (a connection queued
    on a worker as it is killed is reset: try again)."""
    from minio_tpu_torch.server.client import S3Client
    for _ in range(50):
        try:
            st, doc = S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                               "pooladmin-secret", timeout=60).admin(
                "GET", "pool/decommission", {"pool": "0"})
        except OSError:
            time.sleep(0.1)
            continue
        if st != 200:
            raise SystemExit(f"lifecycle: status {st} {doc}")
        return doc
    raise SystemExit("lifecycle: no worker answered the drain's status")


def phase_lifecycle(args, counts, card):
    """Phase 5q, the pool lifecycle and the data scanner.  This process
    writes the versioned bucket onto pool 0's 12 drives (items exact);
    `python -m minio_tpu_torch.server` boots over them with LIFE_WORKERS
    workers (MTPU_HOTCACHE=0); admin pool/add of pool 1 through one
    worker (its self-test's items exact; every fresh connection then
    lists 2 pools); pool/decommission start of pool 0, PUTs through both
    workers landing on pool 1, the mover's process (worker 0) SIGKILLed
    after LIFE_KILL_AFTER versions moved, the drain completed by its
    respawn, its status equal through 16 fresh connections served by
    both workers.  Then pool 0 holds no object; every version reads back
    by SHA-256 with its id, ETag and Last-Modified; the pending upload
    completes under its old id; SIGTERM exits 0.  A reboot as one process
    with --drives naming pool 0 only attaches pool 1 from
    pool-topology.json and keeps pool 0 out of placement.  Then in this
    process (pool-topology.json adopted, the drains resumed) a
    DataScanner: a normal cycle's usage equals the sizes written and it
    heals an xl.meta removed from one drive, a deep cycle finds a
    corrupted frame of a 64 MiB shard and rewrites the part file to its
    SHA-256, a PUT after a scan is in the next cycle, and the admin's
    datausage equals the scanner's.  Items per step: the pool's (its
    metrics: the owner's and the workers'), this process's; exact, or,
    across the SIGKILL, between the count and that plus one version's."""
    import email.utils
    import signal
    from types import SimpleNamespace

    import numpy as np

    from minio_tpu_torch.background import decom
    from minio_tpu_torch.background.scanner import DataScanner
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server import topology
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.handlers import S3Handlers
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive

    big_sizes = [OBJECT_BYTES] * (LIFE_BIG - 1) + [TAIL_OBJECT_BYTES]
    need = 3 * (sum(big_sizes) + sum(LIFE_PARTS)) + (2 << 30)
    root = _tmp_root("chip_smoke-life-", need)
    rng = np.random.default_rng(args.seed * 1000 + 900)
    url_cli = None
    t_phase = time.perf_counter()
    steps: dict[str, dict] = {}
    pool_launches = dict.fromkeys(_KERNELS, 0)
    counts.reset()

    def body(seed, n):
        return np.random.default_rng(seed).bytes(n)

    def here_items(before):
        now = counts.items()
        return {k: now[k] - before[k] for k in _KERNELS}

    def hold(name, got, want, launches=None):
        steps[name] = got
        if got != want or (launches is not None and any(
                launches[k] > got[k] or (got[k] and not launches[k])
                for k in _KERNELS)):
            raise SystemExit(f"lifecycle {name}: items {got}, launches "
                             f"{launches}, want {want}")

    def add(into, more, times=1):
        for k in _KERNELS:
            into[k] += times * more[k]
        return into

    def drives(prefix):
        return [LocalDrive(os.path.join(root, f"{prefix}{i}"))
                for i in range(1, 13)]

    # -- the load, in this process --------------------------------------
    records = {}                       # (key, vid) -> (size, sha, etag, mt)
    pools = ServerPools([ErasureSets(drives("b"), set_drive_count=12)])
    try:
        h = S3Handlers(pools)
        pools.make_bucket("life")
        h.put_bucket_versioning(
            "life", b"<VersioningConfiguration><Status>Enabled</Status>"
                    b"</VersioningConfiguration>")
        i0 = counts.items()
        want = dict.fromkeys(_KERNELS, 0)
        seed = args.seed * 1000 + 901
        plan = [(f"big{i}", n, HH if i < LIFE_HH else "mxh256")
                for i, n in enumerate(big_sizes)]
        plan += [(f"small/{i:03d}", int(rng.integers(*LIFE_SMALL_BYTES)),
                  "mxh256") for i in range(LIFE_SMALL)]
        plan += [("hist", 300 * 1024 + i, "mxh256")
                 for i in range(LIFE_HISTORY)]
        t0 = time.perf_counter()
        for key, n, algo in plan:
            if algo == HH:
                os.environ["MTPU_BITROT_ALGO"] = HH
            try:
                data = body(seed, n)
                fi = pools.put_object("life", key, data, versioned=True,
                                      parity=4)
            finally:
                os.environ.pop("MTPU_BITROT_ALGO", None)
            records[key, fi.version_id] = (
                n, hashlib.sha256(data).hexdigest(),
                fi.metadata.get("etag", ""), fi.mod_time_ns, seed)
            want["gf_matmul"] += _put_calls(n)
            want[_digest(algo)] += _put_calls(n)
            seed += 1
        marker = pools.delete_object("life", "hist", versioned=True)
        uid = pools.new_multipart_upload("life", "mp", parity=4)
        parts, mp_body = [], b""
        for pn, n in enumerate(LIFE_PARTS, 1):
            data = body(seed, n)
            seed += 1
            parts.append((pn, pools.put_object_part("life", "mp", uid, pn,
                                                    data).etag))
            mp_body += data
            add(want, {"gf_matmul": _put_calls(n), "hh256": 0,
                       "mxh256": _put_calls(n)})
        load_s = time.perf_counter() - t0
        hold("load", here_items(i0), want)
    finally:
        pools.close()
    old_uid = uid                     # "0.<id>": pool 0 carries it
    loaded = sum(n for n, *_ in records.values()) + sum(LIFE_PARTS)

    # -- the pool: boot, pool/add, the drain ------------------------------
    pool = _Pool(root, LIFE_WORKERS, env={"MTPU_HOTCACHE": "0"})
    boot_s = pool.boot_s
    port = pool.port

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=600)

    def pool_step(name, before, want, within=None):
        after = _pool_counts(pool.settled(), LIFE_WORKERS)
        got = {k: int(after[f"items_{k}"] - before[f"items_{k}"])
               for k in _KERNELS}
        launches = {k: int(after[f"launches_{k}"] - before[f"launches_{k}"])
                    for k in _KERNELS}
        for k in _KERNELS:
            pool_launches[k] += launches[k]
        if within is None:
            hold(name, got, want, launches)
        else:
            steps[name] = got
            if any(not want[k] <= got[k] <= want[k] + within[k]
                   for k in _KERNELS) or any(launches[k] > got[k]
                                             for k in _KERNELS):
                raise SystemExit(f"lifecycle {name}: items {got}, launches "
                                 f"{launches}, want {want} + at most "
                                 f"{within}")
        if after["ipc_fallbacks"] or after["co_fallbacks"]:
            raise SystemExit(f"lifecycle {name}: fallbacks {after}")
        return after

    def warm():
        """Each worker reads the bucket's versioning config from the meta
        bucket once and keeps it (an inline GET, one mxh256 item): 16
        fresh connections reach every worker before a step is counted."""
        for _ in range(16):
            st, _, _ = fresh().request("GET", "/life",
                                       query={"versioning": ""})
            if st != 200:
                raise SystemExit(f"lifecycle: GET ?versioning {st}")

    try:
        warm()
        c0 = _pool_counts(pool.settled(), LIFE_WORKERS)
        t0 = time.perf_counter()
        st, doc = fresh().admin("POST", "pool/add", doc={
            "drives": os.path.join(root, "c{1...12}")})
        add_s = time.perf_counter() - t0
        if (st, doc) != (200, {"pool": 1, "placement": [0, 1]}):
            raise SystemExit(f"lifecycle: pool/add {st} {doc}")
        # Its self-test: one inline PUT (a GF encode, an mxh256 digest)
        # and its GET (a digest).
        c1 = pool_step("pool/add", c0,
                       {"gf_matmul": 1, "hh256": 0, "mxh256": 2})
        deadline = time.monotonic() + 30
        while not all(len(fresh().admin("GET", "pools")[1]["pools"]) == 2
                      for _ in range(8)):
            if time.monotonic() > deadline:
                raise SystemExit("lifecycle: a worker never saw pool 1")
            time.sleep(0.2)
        versions = _pool0_versions(root)
        exact = dict.fromkeys(_KERNELS, 0)
        worst = dict.fromkeys(_KERNELS, 0)
        for fi in versions:
            if fi.deleted:
                continue
            one = _version_items(fi)
            add(exact, one)
            worst = {k: max(worst[k], one[k]) for k in _KERNELS}
        # The pending upload's parts: each read (mxh256) and PUT again
        # on pool 1.
        for n in LIFE_PARTS:
            reads = _get_calls(SimpleNamespace(
                size=n, data_dir="d", parts=[SimpleNamespace(size=n)]))
            add(exact, {"gf_matmul": _put_calls(n), "hh256": 0,
                        "mxh256": reads + _put_calls(n)})
        add(exact, {"gf_matmul": _put_calls(LIFE_DURING_BYTES), "hh256": 0,
                    "mxh256": _put_calls(LIFE_DURING_BYTES)}, LIFE_DURING)
        moved_bytes = sum(fi.size for fi in versions if not fi.deleted)

        t0 = time.perf_counter()
        st, doc = fresh().admin("POST", "pool/decommission",
                                {"pool": "0", "action": "start"})
        if st != 200 or doc["state"] != "draining":
            raise SystemExit(f"lifecycle: decommission start {st} {doc}")
        deadline = time.monotonic() + 30
        while not all(fresh().admin("GET", "pools")[1]["placement"] == [1]
                      for _ in range(8)):
            if time.monotonic() > deadline:
                raise SystemExit("lifecycle: pool 0 still in placement")
            time.sleep(0.1)
        during = {}
        for i in range(LIFE_DURING):
            key = f"during{i}"
            data = body(seed, LIFE_DURING_BYTES)
            h = fresh().put_object("life", key, data)
            during[key] = (data, h["x-amz-version-id"])
            seed += 1
            if not os.path.isdir(os.path.join(root, "c1", "life", key)) or \
                    os.path.exists(os.path.join(root, "b1", "life", key)):
                raise SystemExit(f"lifecycle: {key} not on pool 1 alone")
        while _life_status(port)["versions_moved"] < LIFE_KILL_AFTER:
            if time.perf_counter() - t0 > 300:
                raise SystemExit("lifecycle: the drain stalled")
            time.sleep(0.05)
        m = pool.metrics()
        w0 = int(m['mtpu_worker_pid{worker="0"}'])
        killed_at = _life_status(port)
        os.kill(w0, signal.SIGKILL)
        t_kill = time.perf_counter()
        if killed_at["state"] != "draining":
            raise SystemExit(f"lifecycle: killed after the drain "
                             f"{killed_at}")
        deadline = time.monotonic() + 240
        while True:
            try:
                m = pool.metrics()
                if m.get('mtpu_worker_respawns_total{worker="0"}') == 1 \
                        and m.get('mtpu_worker_ready{worker="0"}') == 1 \
                        and int(m['mtpu_worker_pid{worker="0"}']) != w0:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise SystemExit(f"lifecycle: worker 0 never came back: "
                                 f"{pool.tail()}")
            time.sleep(0.1)
        respawn_s = time.perf_counter() - t_kill
        while _life_status(port)["state"] != "complete":
            if time.perf_counter() - t0 > 600:
                raise SystemExit(f"lifecycle: drain never completed: "
                                 f"{_life_status(port)}")
            time.sleep(0.1)
        drain_s = time.perf_counter() - t0
        r0 = pool.metrics()
        seen = []
        for _ in range(16):
            doc = _life_status(port)
            seen.append({k: v for k, v in doc.items()
                         if k not in LIFE_CLOCKS})
        r1 = pool.metrics()
        by_worker = [r1[f'mtpu_worker_requests_total{{worker="{w}"}}']
                     - r0[f'mtpu_worker_requests_total{{worker="{w}"}}']
                     for w in range(LIFE_WORKERS)]
        if any(s != seen[0] for s in seen) or min(by_worker) < 2:
            raise SystemExit(f"lifecycle: statuses {seen}, requests by "
                             f"worker {by_worker}")
        status = seen[0]
        data_versions = sum(1 for fi in versions if not fi.deleted)
        if not (len(versions) - 1 <= status["versions_moved"]
                <= len(versions)) or status["objects_remaining"] or \
                status["uploads_relocated"] != 1:
            raise SystemExit(f"lifecycle: status {status}, {len(versions)} "
                             f"versions on pool 0")
        # The respawned worker 0 reads the versioning config again.
        warm()
        c2 = pool_step("drain", c1, exact,
                       within={**worst, "mxh256": worst["mxh256"] + 1})
        # -- after the drain: pool 0 empty, every version, the upload -----
        left = [os.path.join(d, f) for p in range(1, 13)
                for d, _, files in os.walk(os.path.join(root, f"b{p}",
                                                        "life"))
                for f in files]
        if left:
            raise SystemExit(f"lifecycle: pool 0 still holds {left[:4]}")
        want = dict.fromkeys(_KERNELS, 0)
        t_check = time.perf_counter()
        cli = fresh()
        for (key, vid), (n, sha, etag, mt, _) in records.items():
            st, hdrs, got = cli.request("GET", f"/life/{key}",
                                        query={"versionId": vid})
            lm = email.utils.parsedate_to_datetime(hdrs["Last-Modified"])
            if st != 200 or hashlib.sha256(got).hexdigest() != sha or \
                    hdrs.get("ETag", "").strip('"') != etag or \
                    hdrs.get("x-amz-version-id") != vid or \
                    int(lm.timestamp()) != mt // 10**9:
                raise SystemExit(f"lifecycle: {key}@{vid} after the drain: "
                                 f"{st} {hdrs}")
            want["mxh256"] += _get_calls(SimpleNamespace(
                size=n, data_dir="" if n <= 128 * 1024 else "d",
                parts=[SimpleNamespace(size=n)]))
        st, _, _ = cli.request("GET", "/life/hist")
        if st != 404:
            raise SystemExit(f"lifecycle: hist's tip is {st}, not its "
                             "delete marker")
        cli.complete_multipart("life", "mp", old_uid, parts)
        got = cli.get_object("life", "mp")
        if hashlib.sha256(got).digest() != hashlib.sha256(mp_body).digest():
            raise SystemExit("lifecycle: the completed upload differs")
        want["mxh256"] += _get_calls(SimpleNamespace(
            size=sum(LIFE_PARTS), data_dir="d",
            parts=[SimpleNamespace(size=n) for n in LIFE_PARTS]))
        for key, (data, vid) in during.items():
            st, hdrs, got = cli.request("GET", f"/life/{key}")
            if st != 200 or got != data or hdrs["x-amz-version-id"] != vid:
                raise SystemExit(f"lifecycle: {key} reads {st}")
            want["mxh256"] += _get_calls(SimpleNamespace(
                size=LIFE_DURING_BYTES, data_dir="d",
                parts=[SimpleNamespace(size=LIFE_DURING_BYTES)]))
        check_s = time.perf_counter() - t_check
        c3 = pool_step("after the drain", c2, want)
        cuda = c3["cuda"]
        if cuda != {"owner": 1, **{f"worker{w}": 0
                                   for w in range(LIFE_WORKERS)}}:
            raise SystemExit(f"lifecycle: CUDA contexts {cuda}")
        pool.stop()
    finally:
        pool.kill()

    # -- the reboot with pool 0's drives alone ----------------------------
    pool = _Pool(root, 0)
    reboot_s = pool.boot_s
    try:
        cli = S3Client(f"http://127.0.0.1:{pool.port}", "pooladmin",
                       "pooladmin-secret", timeout=600)
        st, doc = cli.admin("GET", "pools")
        rows = [(r["pool"], r["decommissioning"],
                 r.get("decommission", {}).get("state"))
                for r in doc["pools"]]
        if doc["placement"] != [1] or rows != [(0, True, "complete"),
                                                (1, False, None)]:
            raise SystemExit(f"lifecycle: the reboot's pools {doc}")
        r0 = _spine_counts(pool.metrics(), 0)
        key, vid = next(k for k in records if k[0] == "big0")
        got = cli.get_object("life", key)
        if hashlib.sha256(got).hexdigest() != records[key, vid][1]:
            raise SystemExit("lifecycle: a GET after the reboot differs")
        r1 = _spine_counts(pool.metrics(), 0)
        hold("reboot GET", {k: r1[f"items_{k}"] - r0[f"items_{k}"]
                            for k in _KERNELS},
             {"gf_matmul": 0, "hh256": 0,
              "mxh256": _get_calls(SimpleNamespace(
                  size=OBJECT_BYTES, data_dir="d",
                  parts=[SimpleNamespace(size=OBJECT_BYTES)]))})
        for k in _KERNELS:
            pool_launches[k] += r1[f"launches_{k}"] - r0[f"launches_{k}"]
        lines = open(pool.log).read()
        if "topology: 2 pools (1 from pool-topology.json), draining [0]; " \
                "decommissions: pool 0 complete" not in lines:
            raise SystemExit(f"lifecycle: the reboot's topology: {lines}")
        pool.stop()
    finally:
        pool.kill()

    # -- the data scanner, in this process --------------------------------
    pools = ServerPools([ErasureSets(drives("b"), set_drive_count=12)])
    sc = srv = None
    try:
        if topology.adopt_topology(pools) != 1 or \
                [d.state for d in decom.resume_decommissions(
                    pools, autostart=False)] != ["complete"] or \
                pools.placement_pools() != [1]:
            raise SystemExit("lifecycle: this process's topology "
                             f"{len(pools.pools)} pools, draining "
                             f"{pools.draining}")
        es = pools.pools[1].sets[0]
        live = {fi.name: fi for fi in es.list_objects("life",
                                                      max_keys=1000000)}
        want_usage = (len(live), sum(fi.size for fi in live.values()))
        # A drive's xl.meta removed (a 64 MiB object's): a normal cycle
        # heals it.
        victim = live["big3"]
        pos = 4
        meta_path = os.path.join(root, f"c{pos + 1}", "life", "big3",
                                 "xl.meta")
        with open(meta_path, "rb") as f:
            meta_sha = hashlib.sha256(f.read()).digest()
        os.unlink(meta_path)
        sc = DataScanner(pools)
        i0 = counts.items()
        t0 = time.perf_counter()
        u = sc.scan_cycle()
        normal_s = time.perf_counter() - t0
        bu = u.buckets.get("life")
        if bu is None or (bu.objects, bu.bytes) != want_usage:
            raise SystemExit(f"lifecycle: usage {bu and bu.to_obj()}, "
                             f"want {want_usage}")
        with open(meta_path, "rb") as f:
            if hashlib.sha256(f.read()).digest() != meta_sha:
                raise SystemExit("lifecycle: the healed xl.meta differs")
        hold("normal scan", here_items(i0),
             _expected_heal_launches([victim], pos))
        # A corrupted frame of a 64 MiB shard: a deep cycle finds it.
        victim = live[f"big{LIFE_BIG - 2}"]
        pos = 6
        part = os.path.join(root, f"c{pos + 1}", "life",
                            f"big{LIFE_BIG - 2}",
                            victim.data_dir, "part.1")
        with open(part, "rb") as f:
            part_sha = hashlib.sha256(f.read()).digest()
        with open(part, "r+b") as f:
            f.seek(100)
            f.write(b"\xa5" * 16)
        want = dict.fromkeys(_KERNELS, 0)
        shard_bytes = 0
        for b in pools.list_buckets():
            for name in (fi.name for fi in es.list_objects(
                    b, max_keys=1000000)):
                for v in es.list_object_versions(b, name):
                    if v.deleted:
                        continue
                    want[_digest(v.erasure.bitrot_algo())] += \
                        es.n * _batches(v)
                    shard_bytes += v.erasure.shard_file_size(v.size) * es.n
        # The corrupted drive stops at its first (bad) batch, then the
        # rebuild: a GF call and two digests a batch.
        nb = _batches(victim)
        want["mxh256"] += 1 - nb + 2 * nb
        want["gf_matmul"] += nb
        i0 = counts.items()
        t0 = time.perf_counter()
        sc.scan_cycle(deep=True)
        deep_s = time.perf_counter() - t0
        with open(part, "rb") as f:
            if hashlib.sha256(f.read()).digest() != part_sha:
                raise SystemExit("lifecycle: the deep cycle left the part "
                                 "file corrupted")
        if sc.stats.corruption_found != 1:
            raise SystemExit(f"lifecycle: deep cycle found "
                             f"{sc.stats.corruption_found} corruptions")
        hold("deep scan", here_items(i0), want)
        # A PUT into the scanned bucket is in the next cycle.
        i0 = counts.items()
        pools.put_object("life", "after-scan", body(seed, 3 * MIB + 1))
        u = sc.scan_cycle()
        if u.buckets["life"].objects != want_usage[0] + 1:
            raise SystemExit(f"lifecycle: the PUT after a scan is not in "
                             f"the next cycle: {u.buckets['life'].to_obj()}")
        hold("PUT then scan", here_items(i0),
             {"gf_matmul": _put_calls(3 * MIB + 1), "hh256": 0,
              "mxh256": _put_calls(3 * MIB + 1)})
        srv = S3Server(pools, Credentials("pooladmin", "pooladmin-secret"),
                       scanner=sc).start()
        st, doc = S3Client(srv.endpoint, "pooladmin", "pooladmin-secret",
                           timeout=60).admin("GET", "datausage")
        if st != 200 or doc["buckets"] != {
                b: x.to_obj() for b, x in u.buckets.items()}:
            raise SystemExit(f"lifecycle: datausage {st} {doc}")
    finally:
        if srv is not None:
            srv.shutdown()
        if sc is not None:
            sc.stop()
        pools.close()
        shutil.rmtree(root, ignore_errors=True)
    here = counts.read()
    launches = {k: pool_launches[k] + here[k] for k in _KERNELS}
    launches["mxh256_elsewhere"] = pool_launches["mxh256"]
    gb = moved_bytes / 1e9
    print(f"[lifecycle] pool 0 loaded in this process: {len(records)} "
          f"versions ({LIFE_BIG} of {OBJECT_BYTES} B, {LIFE_HH} of them "
          f"{HH}, the last {TAIL_OBJECT_BYTES} B; {LIFE_SMALL} of 1-100 KiB;"
          f" {LIFE_HISTORY} versions and a delete marker of one key), a "
          f"pending upload of {len(LIFE_PARTS)} x {LIFE_PARTS[0]} B, "
          f"{loaded} B in {load_s:.2f} s; card {card}")
    print(f"[lifecycle] python -m minio_tpu_torch.server, {LIFE_WORKERS} "
          f"workers, ready in {boot_s:.2f} s; pool/add of pool 1 (12 "
          f"drives, self-test through the owner's lanes) in {add_s:.2f} s;"
          f" card {card}")
    print(f"[lifecycle] drain of pool 0: {len(versions)} versions, "
          f"{moved_bytes} B, {drain_s:.2f} s in all: {gb / drain_s:.3f} "
          f"GB/s, {len(versions) / drain_s:.2f} versions/s, worker 0 (the "
          f"mover's) SIGKILLed at {killed_at['versions_moved']} moved and "
          f"back in {respawn_s:.2f} s; {LIFE_DURING} PUTs of "
          f"{LIFE_DURING_BYTES} B during it on pool 1 alone; status equal "
          f"through 16 connections (by worker {by_worker}): {status}; "
          f"card {card}")
    print(f"[lifecycle] after the drain: pool 0 holds no object; "
          f"{len(records)} versions byte-exact with their ids, ETags and "
          f"Last-Modified, the upload completed under its old id "
          f"{old_uid[:12]}..., in {check_s:.2f} s; CUDA contexts {cuda}; "
          f"reboot with pool 0's --drives alone in {reboot_s:.2f} s: "
          f"placement [1], pool 0 excluded; card {card}")
    print(f"[lifecycle] scanner in this process: normal cycle "
          f"{normal_s:.3f} s ({want_usage[1] / normal_s / 1e9:.3f} GB/s "
          f"of objects accounted; {want_usage[0]} objects; one xl.meta "
          f"healed), deep cycle {deep_s:.3f} s "
          f"({shard_bytes / deep_s / 1e9:.3f} GB/s of shards verified on "
          f"the card; one corrupted frame "
          f"found, its part file back to its SHA-256); card {card}")
    print(f"[lifecycle] items per step: {steps}; launches {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


#: Phase 5r's traffic: 64 MiB objects beside the highwayhash256S one, the
#: small objects, one key's versions, the PUTs while the target is down,
#: the client threads, the pool's workers, the kill step's objects and
#: which copy of a process dies (MTPU_CRASH=repl.pre_copy:N).
# REPL_BIG 3 before phase 5t joined the run.
REPL_BIG = 2
# REPL_SMALL 128 before phase 5s joined the run.
# REPL_SMALL 64 before 5t.
REPL_SMALL, REPL_SMALL_BYTES = 16, (1024, 100 * 1024)
REPL_HISTORY = 3
# REPL_DEAD 16 before 5t.
REPL_DEAD, REPL_DEAD_BYTES = 8, 256 * 1024
REPL_CLIENTS = 4
REPL_WORKERS = 2
REPL_KILL_BYTES, REPL_KILL_MAX = 2 * MIB + 3, 6
REPL_CRASH_NTH = 2
#: The pool's replication knobs: retries and breaker holds short enough
#: that a target back up is caught up within a second.
REPL_ENV = {"MTPU_HOTCACHE": "0", "MTPU_REPL_RETRY_INTERVAL": "0.05",
            "MTPU_REPL_MAX_INTERVAL": "1", "MTPU_REPL_BREAKER_MAX": "1"}
REPL_LOCK = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
             b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE"
             b"</Mode><Days>1</Days></DefaultRetention></Rule>"
             b"</ObjectLockConfiguration>")


def _repl_by_worker(port: int, workers: int) -> dict:
    """Every worker's replication counters (admin GET replication through
    fresh connections until each worker has answered)."""
    from minio_tpu_torch.server.client import S3Client
    got: dict = {}
    for _ in range(400):
        try:
            st, doc = S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                               "pooladmin-secret", timeout=60).admin(
                "GET", "replication")
        except OSError:
            time.sleep(0.05)
            continue
        if st != 200:
            raise SystemExit(f"protection: admin replication {st} {doc}")
        got[doc["worker"]] = doc
        if len(got) == workers:
            return got
    raise SystemExit(f"protection: workers {sorted(got)} answered of "
                     f"{workers}")


def _repl_settled(port: int, workers: int, completed: int,
                  timeout: float = 300) -> dict:
    """Wait until the workers' pools hold no task and have completed
    `completed` copies in all; their counters then."""
    deadline = time.monotonic() + timeout
    while True:
        by = _repl_by_worker(port, workers)
        done = sum(d["completed"] for d in by.values())
        if done == completed and not any(d["queued"] for d in by.values()):
            return by
        if done > completed or time.monotonic() > deadline:
            raise SystemExit(f"protection: {done} copies completed, want "
                             f"{completed}: {by}")
        time.sleep(0.05)


def _resync_file(root: str, bucket: str, state: dict | None = None):
    """The bucket's resync state on the source's drives (the home pool's
    first set: b1..b12): read it, or write `state`."""
    from minio_tpu_torch.storage.drive import SYS_VOL
    paths = [os.path.join(root, f"b{i}", SYS_VOL, "replication",
                          f"resync-{bucket}.json") for i in range(1, 13)]
    if state is None:
        with open(paths[0]) as f:
            return json.load(f)
    for p in paths:
        with open(p, "w") as f:
            json.dump(state, f)
    return state


def phase_protection(args, counts, card):
    """Phase 5r, the data-protection planes.  The source is `python -m
    minio_tpu_torch.server` over config 2's 12 drives on /dev/shm with
    REPL_WORKERS workers (MTPU_HOTCACHE=0); the target an in-process
    S3Server over 12 drives of its own (its hot tier attached, so its
    /minio/v2/metrics/node serves this process's kernel items).  The
    versioned bucket and one highwayhash256S 64 MiB object are written
    through an in-process server over the source's drives before the pool
    boots; the target's registration (admin bucket-remote) and the
    replication config go through the pool, each on a fresh connection,
    and every worker reloads them (the pool's config generation) before
    the traffic.  A second source of the same shape, for the kill step,
    registered before its boot, boots at the same time.
    Then, through the pool: a resync copies the highwayhash256S object;
    REPL_CLIENTS threads PUT REPL_BIG 64 MiB and REPL_SMALL small
    objects, one key's REPL_HISTORY versions and its delete marker; the
    target goes down for REPL_DEAD PUTs (the breaker opens, its probe
    closes it once the target is back); a GET of a key only the target
    holds is proxied while a resync is marked running; an object-lock
    bucket with default GOVERNANCE retention refuses a DELETE, takes the
    bypass, and refuses even the bypass under a legal hold.  The second
    source, booted with MTPU_CRASH=repl.pre_copy:REPL_CRASH_NTH: PUTs one
    at a time until a worker dies between an acknowledged PUT and its
    copy; its respawn replays the task.  Then in this process: every version
    on the target byte-exact (SHA-256) with the source's id, ETag and mod
    time, none twice, the source COMPLETED; a lifecycle rule with a past
    Date on tmp/ and a NoncurrentVersionExpiration, applied by one
    scanner cycle, skips the version under a legal hold.  Items per
    step exact from both servers' metrics (the pool's owner and workers,
    the target's process)."""
    import email.utils
    import signal
    from types import SimpleNamespace

    import numpy as np

    from minio_tpu_torch.background.scanner import DataScanner
    from minio_tpu_torch.engine.hotcache import attach_pools
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.handlers import S3Handlers
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive

    ak, sk = "pooladmin", "pooladmin-secret"
    big_bytes = (REPL_BIG + 1) * OBJECT_BYTES
    root = _tmp_root("chip_smoke-repl-", 5 * big_bytes + (2 << 30))
    kroot = _tmp_root("chip_smoke-replk-", 1 << 30)
    rng = np.random.default_rng(args.seed * 1000 + 950)
    seed = args.seed * 1000 + 951
    t_phase = time.perf_counter()
    steps: dict[str, dict] = {}
    pool_launches = dict.fromkeys(_KERNELS, 0)
    counts.reset()
    versioning = (b"<VersioningConfiguration><Status>Enabled</Status>"
                  b"</VersioningConfiguration>")

    def body(s, n):
        return np.random.default_rng(s).bytes(n)

    def zero():
        return dict.fromkeys(_KERNELS, 0)

    def add(into, more, times=1):
        for k in _KERNELS:
            into[k] += times * more[k]
        return into

    def put_items(n, algo="mxh256"):
        out = zero()
        out["gf_matmul"] += _put_calls(n)
        out[_digest(algo)] += _put_calls(n)
        return out

    def get_items(n, algo="mxh256"):
        out = zero()
        out[_digest(algo)] += _get_calls(SimpleNamespace(
            size=n, data_dir="" if n <= 128 * 1024 else "d",
            parts=[SimpleNamespace(size=n)]))
        return out

    def drives(prefix, top=None):
        return [LocalDrive(os.path.join(top or root, f"{prefix}{i}"))
                for i in range(1, 13)]

    def hold(name, got, want, launches=None):
        steps[name] = got
        if got != want or (launches is not None and any(
                launches[k] > got[k] or (got[k] and not launches[k])
                for k in _KERNELS)):
            raise SystemExit(f"protection {name}: items {got}, launches "
                             f"{launches}, want {want}")

    def here_items(before):
        now = counts.items()
        return {k: now[k] - before[k] for k in _KERNELS}

    # -- the target, in this process ---------------------------------------
    tpools = ServerPools([ErasureSets(drives("t"), set_drive_count=12)])
    if attach_pools(tpools) is None:
        raise SystemExit("protection: the target's hot tier did not attach")
    tport = _free_port()
    tsrv = S3Server(tpools, Credentials(ak, sk), port=tport).start()
    tcli = S3Client(tsrv.endpoint, ak, sk, timeout=600)
    pool = kpool = None
    records: dict = {}          # (key, vid) -> (size, sha, etag)

    def wire(clients, bucket):
        """The bucket's target registered through admin bucket-remote and
        its replication config, each through clients(); the ARN."""
        st, doc = clients().admin("POST", "bucket-remote",
                                  {"bucket": bucket},
                                  doc={"endpoint": tsrv.endpoint,
                                       "accessKey": ak, "secretKey": sk,
                                       "targetBucket": "rdst"})
        if st != 200:
            raise SystemExit(f"protection: bucket-remote {st} {doc}")
        cli = clients()
        cli._check(*cli.request(
            "PUT", f"/{bucket}", query={"replication": ""},
            body=b"<ReplicationConfiguration><Rule><Status>Enabled"
                 b"</Status><Filter><Prefix></Prefix></Filter>"
                 b"<DeleteMarkerReplication><Status>Enabled</Status>"
                 b"</DeleteMarkerReplication><Destination><Bucket>"
                 b"arn:aws:s3:::rdst</Bucket></Destination></Rule>"
                 b"</ReplicationConfiguration>"))
        return doc["arn"]

    def register(spools, bucket, wired=True):
        """The bucket, versioned, and (`wired`) its target and replication
        config, through an in-process server over the source's drives."""
        ssrv = S3Server(spools, Credentials(ak, sk)).start()
        try:
            scli = S3Client(ssrv.endpoint, ak, sk, timeout=600)
            scli.make_bucket(bucket)
            scli._check(*scli.request("PUT", f"/{bucket}",
                                      query={"versioning": ""},
                                      body=versioning))
            if wired:
                wire(lambda: scli, bucket)
        finally:
            ssrv.shutdown()

    def reloaded(p):
        """Wait until every worker of `p` has reloaded the latest bucket
        configs (its idle loop looks every 0.25 s)."""
        deadline = time.monotonic() + 30
        while True:
            m = p.metrics()
            if all(m[f'mtpu_worker_config_generation{{worker="{w}"}}']
                   == m["mtpu_config_generation"]
                   for w in range(REPL_WORKERS)):
                return
            if time.monotonic() > deadline:
                raise SystemExit(f"protection: the workers' config "
                                 f"reload: {p.tail()}")
            time.sleep(0.05)

    def target_counts():
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{tport}/minio/v2/metrics/node",
                timeout=5) as r:
            m = {}
            for line in r.read().decode().splitlines():
                if line and not line.startswith("#"):
                    name, v = line.rsplit(" ", 1)
                    m[name] = float(v)
        return _spine_counts(m, 0)

    try:
        tcli.make_bucket("rdst")
        tcli._check(*tcli.request("PUT", "/rdst", query={"versioning": ""},
                                  body=versioning))
        # The target's handlers read the bucket's versioning once.
        tcli._check(*tcli.request("GET", "/rdst", query={"versioning": ""}))

        # -- the source's bucket, HH object and registration ---------------
        i0 = counts.items()
        kpools = ServerPools([ErasureSets(drives("b", kroot),
                                          set_drive_count=12)])
        try:
            register(kpools, "rkill")
        finally:
            kpools.close()
        spools = ServerPools([ErasureSets(drives("b"), set_drive_count=12)])
        try:
            register(spools, "rsrc", wired=False)
            os.environ["MTPU_BITROT_ALGO"] = HH
            try:
                data = body(seed, OBJECT_BYTES)
                fi = spools.put_object("rsrc", "big-hh", data,
                                       versioned=True, parity=4)
            finally:
                os.environ.pop("MTPU_BITROT_ALGO", None)
            records["big-hh", fi.version_id] = (
                OBJECT_BYTES, hashlib.sha256(data).hexdigest(),
                fi.metadata.get("etag", ""))
            seed += 1
        finally:
            spools.close()
        # Three inline config objects of the kill step's source
        # (versioning, bucket-targets.json, replication.xml), the main
        # source's versioning; the HH object.
        hold("setup", here_items(i0),
             add(put_items(OBJECT_BYTES, HH), put_items(1), 4))
        del data

        # -- both sources booted at once --------------------------------------
        booted: dict = {}

        def boot(name, top, env):
            try:
                booted[name] = _Pool(top, REPL_WORKERS, env=env)
            except BaseException as e:  # noqa: BLE001 — raised below
                booted[name] = e
        t0 = time.perf_counter()
        threads = [threading.Thread(target=boot, args=a) for a in (
            ("main", root, REPL_ENV),
            ("kill", kroot, {**REPL_ENV, "MTPU_CRASH":
                             f"repl.pre_copy:{REPL_CRASH_NTH}"}))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        boots_s = time.perf_counter() - t0
        pool, kpool = (got if isinstance(got, _Pool) else None
                       for got in (booted.get("main"), booted.get("kill")))
        for name, got in booted.items():
            if not isinstance(got, _Pool):
                raise SystemExit(f"protection: the {name} source's boot: "
                                 f"{got}")
        boot_s, boot_b_s = pool.boot_s, kpool.boot_s
        port = pool.port

        def fresh():
            return S3Client(f"http://127.0.0.1:{port}", ak, sk, timeout=600)

        def warm(query):
            """Each worker reads a config once and keeps it: 16 fresh
            connections reach every worker before a step is counted."""
            for _ in range(16):
                st, _, _ = fresh().request("GET", query[0],
                                           query={query[1]: ""})
                if st != 200:
                    raise SystemExit(f"protection: GET {query} {st}")

        def step(name, before_pool, before_target, want_pool, want_target,
                 on=None):
            after = _pool_counts((on or pool).settled(), REPL_WORKERS)
            got = {k: int(after[f"items_{k}"] - before_pool[f"items_{k}"])
                   for k in _KERNELS}
            launches = {k: int(after[f"launches_{k}"]
                               - before_pool[f"launches_{k}"])
                        for k in _KERNELS}
            for k in _KERNELS:
                pool_launches[k] += launches[k]
            hold(f"{name} (source)", got, want_pool, launches)
            tafter = target_counts()
            tgot = {k: tafter[f"items_{k}"] - before_target[f"items_{k}"]
                    for k in _KERNELS}
            tl = {k: tafter[f"launches_{k}"] - before_target[f"launches_{k}"]
                  for k in _KERNELS}
            hold(f"{name} (target)", tgot, want_target, tl)
            if after["ipc_fallbacks"] or after["co_fallbacks"]:
                raise SystemExit(f"protection {name}: fallbacks {after}")
            return after, tafter

        # The registration and the config through the pool: each worker
        # wires the bucket when it reloads.
        arn = wire(fresh, "rsrc")
        reloaded(pool)
        warm(("/rsrc", "versioning"))
        c0, t0c = _pool_counts(pool.settled(), REPL_WORKERS), target_counts()
        # The resync copies the object written before the boot (its
        # replica PUT written highwayhash256S too).
        os.environ["MTPU_BITROT_ALGO"] = HH
        try:
            t0 = time.perf_counter()
            st, doc = fresh().admin("POST", "replication",
                                    doc={"op": "resync", "bucket": "rsrc"})
            if st != 200 or doc["status"] != "running":
                raise SystemExit(f"protection: resync {st} {doc}")
            _repl_settled(port, REPL_WORKERS, 1)
            resync_s = time.perf_counter() - t0
        finally:
            os.environ.pop("MTPU_BITROT_ALGO", None)
        if _resync_file(root, "rsrc")["status"] != "done":
            raise SystemExit("protection: the resync is not done")
        c1, t1c = step("resync", c0, t0c, get_items(OBJECT_BYTES, HH),
                       put_items(OBJECT_BYTES, HH))

        # -- the traffic: 4 client threads ------------------------------------
        plan = [(f"big{i}", OBJECT_BYTES) for i in range(REPL_BIG)]
        plan += [(f"small/{i:03d}", int(rng.integers(*REPL_SMALL_BYTES)))
                 for i in range(REPL_SMALL)]
        seeds = {key: seed + i for i, (key, _) in enumerate(plan)}
        seed += len(plan)
        mu = threading.Lock()
        errors: list = []

        def client(part):
            try:
                for key, n in part:
                    data = body(seeds[key], n)
                    h = fresh().put_object("rsrc", key, data)
                    with mu:
                        records[key, h["x-amz-version-id"]] = (
                            n, hashlib.sha256(data).hexdigest(),
                            h["ETag"].strip('"'))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(plan[i::REPL_CLIENTS],))
                   for i in range(REPL_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise SystemExit(f"protection: client errors {errors[:3]}")
        done = 1 + len(plan)
        want_src, want_tgt = zero(), zero()
        for _, n in plan:
            add(want_src, put_items(n))
            add(want_src, get_items(n))
            add(want_tgt, put_items(n))
        # One key's versions back to back, then its delete marker: each
        # version is a task of its own, copied under its id.
        for i in range(REPL_HISTORY):
            n = 300 * 1024 + i
            data = body(seed, n)
            seed += 1
            h = fresh().put_object("rsrc", "hist", data)
            records["hist", h["x-amz-version-id"]] = (
                n, hashlib.sha256(data).hexdigest(), h["ETag"].strip('"'))
            done += 1
            add(want_src, put_items(n))
            add(want_src, get_items(n))
            add(want_tgt, put_items(n))
        h = fresh().delete_object("rsrc", "hist")
        marker = h.get("x-amz-version-id")
        t_ack = time.perf_counter()
        done += 1
        by = _repl_settled(port, REPL_WORKERS, done)
        t_done = time.perf_counter()
        lag_s = t_done - t_ack
        traffic_s = t_done - t_start
        moved = sum(n for (k, _), (n, *_) in records.items()
                    if k != "big-hh")
        c2, t2c = step("traffic", c1, t1c, want_src, want_tgt)

        # -- the target down --------------------------------------------------
        before = _repl_by_worker(port, REPL_WORKERS)
        tsrv.shutdown()
        t_down = time.perf_counter()
        for i in range(REPL_DEAD):
            data = body(seed, REPL_DEAD_BYTES)
            seed += 1
            h = fresh().put_object("rsrc", f"dead/{i:02d}", data)
            records[f"dead/{i:02d}", h["x-amz-version-id"]] = (
                REPL_DEAD_BYTES, hashlib.sha256(data).hexdigest(),
                h["ETag"].strip('"'))
        # Every worker that holds a copy for the dead target opens its
        # breaker.
        deadline = time.monotonic() + 60
        while True:
            by = _repl_by_worker(port, REPL_WORKERS)
            holding = [w for w, d in by.items() if d["queued"]]
            if holding and all(by[w]["breakersOpen"] for w in holding):
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"protection: no breaker opened: {by}")
            time.sleep(0.05)
        opened = {w: dict(by[w]["breakersOpen"]) for w in holding}
        # The target back, on its port, with its handlers (their config
        # cache warm).
        handlers = tsrv.handlers
        tsrv = S3Server(tpools, Credentials(ak, sk), port=tport)
        tsrv.handlers = handlers
        tsrv.start()
        down_s = time.perf_counter() - t_down
        t_up = time.perf_counter()
        done += REPL_DEAD
        by = _repl_settled(port, REPL_WORKERS, done)
        catchup_s = time.perf_counter() - t_up
        attempts = sum(by[w]["failed"] + by[w]["retries"]
                       - before[w]["failed"] - before[w]["retries"]
                       for w in by)
        trips = {w: by[w]["breakerTrips"] for w in by}
        if any(not trips[w].get("rsrc->rdst", {}).get("probes")
               for w in holding):
            raise SystemExit(f"protection: no probe closed a breaker "
                             f"{trips}")
        want_src, want_tgt = zero(), zero()
        add(want_src, put_items(REPL_DEAD_BYTES), REPL_DEAD)
        add(want_src, get_items(REPL_DEAD_BYTES), REPL_DEAD + attempts)
        add(want_tgt, put_items(REPL_DEAD_BYTES), REPL_DEAD)
        c3, t3c = step("target down", c2, t2c, want_src, want_tgt)

        # -- the proxy GET -----------------------------------------------------
        only = body(seed, MIB + 7)
        seed += 1
        tpools.put_object("rdst", "only-remote", only, versioned=True)
        saved = _resync_file(root, "rsrc")
        _resync_file(root, "rsrc", {**saved, "status": "running"})
        st, _, got = fresh().request("GET", "/rsrc/only-remote")
        st2, _, _ = fresh().request("GET", "/rsrc/nowhere")
        _resync_file(root, "rsrc", saved)
        st3, _, _ = fresh().request("GET", "/rsrc/only-remote")
        if (st, st2, st3) != (200, 404, 404) or got != only:
            raise SystemExit(f"protection: proxy GETs {st} {st2} {st3}")
        c4, t4c = step("proxy", c3, t3c, zero(),
                       add(put_items(MIB + 7), get_items(MIB + 7)))

        # -- object lock ----------------------------------------------------------
        cli = fresh()
        cli.make_bucket("lockb")
        cli._check(*cli.request("PUT", "/lockb", query={"object-lock": ""},
                                body=REPL_LOCK))
        reloaded(pool)
        warm(("/lockb", "object-lock"))
        c4 = _pool_counts(pool.settled(), REPL_WORKERS)
        cli.put_object("lockb", "doc", b"governed")
        refusals = []
        st, _, _ = fresh().request("DELETE", "/lockb/doc")
        refusals.append(st)
        bypass = {"x-amz-bypass-governance-retention": "true"}
        st, _, _ = fresh().request("DELETE", "/lockb/doc", headers=bypass)
        refusals.append(st)
        fresh().put_object("lockb", "held", b"held")
        fresh()._check(*fresh().request(
            "PUT", "/lockb/held", query={"legal-hold": ""},
            body=b"<LegalHold><Status>ON</Status></LegalHold>"))
        st, _, _ = fresh().request("DELETE", "/lockb/held", headers=bypass)
        refusals.append(st)
        st, _, ret = fresh().request("GET", "/lockb/held",
                                     query={"retention": ""})
        if refusals != [400, 204, 400] or st != 200 or \
                b"GOVERNANCE" not in ret:
            raise SystemExit(f"protection: lock answers {refusals}, "
                             f"retention {st} {ret[:200]}")
        c5, t5c = step("object lock", c4, t4c,
                       add(put_items(8), put_items(4)), zero())
        cuda_a = c5["cuda"]
        pool.stop()
        pool = None

        # -- the second source: a worker dies between an acknowledged PUT
        # and its copy
        port = kpool.port
        warm(("/rkill", "versioning"))
        c6, t6c = _pool_counts(kpool.settled(), REPL_WORKERS), \
            target_counts()
        m = kpool.metrics()
        pids = {w: int(m[f'mtpu_worker_pid{{worker="{w}"}}'])
                for w in range(REPL_WORKERS)}
        killed = None
        kill_keys, unacked = [], []
        for i in range(REPL_KILL_MAX):
            key = f"kill/{i}"
            data = body(seed, REPL_KILL_BYTES)
            seed += 1
            try:
                h = fresh().put_object("rkill", key, data)
            except OSError as e:
                # The worker can die at repl.pre_copy before this PUT's
                # answer leaves (its copy task runs as the response is
                # written): the version stands if the engine published
                # it, which a HEAD after the respawn tells.  That PUT,
                # the one in flight at the death, is the only one that
                # may go unanswered.
                if unacked:
                    raise SystemExit(f"protection: a second PUT went "
                                     f"unanswered: {key}: {e!r}")
                unacked.append((key, hashlib.sha256(data).hexdigest()))
            else:
                records[key, h["x-amz-version-id"]] = (
                    REPL_KILL_BYTES, hashlib.sha256(data).hexdigest(),
                    h["ETag"].strip('"'))
                kill_keys.append(key)
            deadline = time.monotonic() + 60
            while killed is None:
                try:
                    m = kpool.metrics()
                except OSError:
                    # A scrape queued on the dying worker's socket is
                    # reset: ask again.
                    time.sleep(0.02)
                    continue
                gone = [w for w in range(REPL_WORKERS) if m.get(
                    f'mtpu_worker_respawns_total{{worker="{w}"}}')]
                if gone:
                    killed = gone[0]
                    t_kill = time.perf_counter()
                    break
                try:
                    tpools.head_object("rdst", key)
                    break
                except Exception:  # noqa: BLE001 — not there yet
                    pass
                if time.monotonic() > deadline:
                    raise SystemExit(f"protection: {key} neither copied "
                                     f"nor fatal")
                time.sleep(0.02)
            if killed is not None:
                break
            if unacked:
                raise SystemExit(f"protection: {unacked[0][0]}'s PUT went "
                                 f"unanswered and no worker died")
        if killed is None:
            raise SystemExit("protection: no worker died at repl.pre_copy")
        deadline = time.monotonic() + 240
        while True:
            try:
                m = kpool.metrics()
                if m.get(f'mtpu_worker_ready{{worker="{killed}"}}') == 1 \
                        and int(m[f'mtpu_worker_pid{{worker="{killed}"}}']) \
                        != pids[killed]:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise SystemExit(f"protection: worker {killed} never came "
                                 f"back: {kpool.tail()}")
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        for key, sha in unacked:
            st, hd, _ = fresh().request("HEAD", f"/rkill/{key}")
            if st == 200:
                records[key, hd["x-amz-version-id"]] = (
                    REPL_KILL_BYTES, sha, hd["ETag"].strip('"'))
                kill_keys.append(key)
            elif st != 404:
                raise SystemExit(f"protection: HEAD {key} {st}")
            print(f"[protection] the PUT in flight at the death, {key}, "
                  f"went unanswered; HEAD after the respawn: {st} (the "
                  f"version {'stands' if st == 200 else 'was not published'})")
        if not unacked:
            print("[protection] every PUT to the dying worker was answered")
        for key in kill_keys:
            deadline = time.monotonic() + 60
            while True:
                try:
                    tpools.head_object("rdst", key)
                    break
                except Exception:  # noqa: BLE001 — not there yet
                    if time.monotonic() > deadline:
                        raise SystemExit(f"protection: {key} never "
                                         "replicated after the respawn")
                    time.sleep(0.05)
        by = _repl_by_worker(port, REPL_WORKERS)
        if by[killed]["replayed"] != 1:
            raise SystemExit(f"protection: the respawn replayed "
                             f"{by[killed]['replayed']} tasks: {by}")
        warm(("/rkill", "versioning"))
        if "MTPU_CRASH: dying at repl.pre_copy" not in \
                open(kpool.log).read():
            raise SystemExit(f"protection: no crash point in "
                             f"{kpool.tail()}")
        n_kill = len(kill_keys)
        want_src = zero()
        add(want_src, put_items(REPL_KILL_BYTES), n_kill)
        add(want_src, get_items(REPL_KILL_BYTES), n_kill)
        # The respawned worker wires the bucket (its replication config
        # and targets, two inline GETs) and reads its versioning again.
        want_src["mxh256"] += 3
        c7, _ = step("kill", c6, t6c, want_src,
                     add(zero(), put_items(REPL_KILL_BYTES), n_kill),
                     on=kpool)
        cuda_b = c7["cuda"]
        for cuda in (cuda_a, cuda_b):
            if cuda != {"owner": 1, **{f"worker{w}": 0
                                       for w in range(REPL_WORKERS)}}:
                raise SystemExit(f"protection: CUDA contexts {cuda}")
        kpool.stop()
        kpool = None

        # -- every version on the target, once --------------------------------
        t_check = time.perf_counter()
        spools = ServerPools([ErasureSets(drives("b"), set_drive_count=12)])
        kpools = ServerPools([ErasureSets(drives("b", kroot),
                                          set_drive_count=12)])
        try:
            keys = sorted({k for k, _ in records})
            completed = 0
            for key in keys:
                src = (kpools.list_object_versions("rkill", key)
                       if key.startswith("kill/") else
                       spools.list_object_versions("rsrc", key))
                dst = tpools.list_object_versions("rdst", key)
                sv = [(v.version_id, v.mod_time_ns, v.metadata.get("etag"),
                       v.size) for v in src if not v.deleted]
                dv = [(v.version_id, v.mod_time_ns, v.metadata.get("etag"),
                       v.size) for v in dst if not v.deleted]
                if sv != dv or [v.deleted for v in src] != \
                        [v.deleted for v in dst]:
                    raise SystemExit(f"protection: {key}: source {sv}, "
                                     f"target {dv}")
                if not src[0].deleted:
                    if src[0].metadata.get("x-amz-replication-status") != \
                            "COMPLETED" or dst[0].metadata.get(
                                "x-amz-replication-status") != "REPLICA":
                        raise SystemExit(f"protection: {key}'s statuses")
                    completed += 1
            for (key, vid), (n, sha, etag) in records.items():
                fi, got = tpools.get_object("rdst", key, version_id=vid)
                if hashlib.sha256(got).hexdigest() != sha or \
                        fi.metadata.get("etag") != etag or fi.size != n:
                    raise SystemExit(f"protection: {key}@{vid} differs")
            if tpools.list_object_versions("rdst", "hist")[0].deleted \
                    is not True or marker is None:
                raise SystemExit("protection: hist's marker not on top")
            check_s = time.perf_counter() - t_check

            # -- lifecycle expiry through one scanner cycle -------------------
            h = S3Handlers(spools)
            h.make_bucket("lifeb")
            now_ns = time.time_ns()
            day = 86400 * 10**9
            i0 = counts.items()
            want = zero()
            for key, n in (("tmp/a", 2000), ("tmp/b", 200_000),
                           ("tmp/held", 3000)):
                spools.put_object("lifeb", key, body(seed, n))
                seed += 1
                add(want, put_items(n))
            h.put_object_legal_hold("lifeb", "tmp/held", {},
                                    b"<LegalHold><Status>ON</Status>"
                                    b"</LegalHold>")
            for age, n in ((30, 5000), (20, 6000), (0, 7000)):
                spools.put_object("lifeb", "keep/v", body(seed, n),
                                  versioned=True,
                                  mod_time_ns=now_ns - age * day)
                seed += 1
                add(want, put_items(n))
            h.put_bucket_config("lifeb", "lifecycle", (
                b"<LifecycleConfiguration><Rule><ID>tmp</ID><Status>Enabled"
                b"</Status><Filter><Prefix>tmp/</Prefix></Filter>"
                b"<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration>"
                b"</Rule><Rule><ID>nc</ID><Status>Enabled</Status><Filter/>"
                b"<NoncurrentVersionExpiration><NoncurrentDays>7"
                b"</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
                b"</LifecycleConfiguration>"))
            add(want, put_items(1))              # the config, inline
            sc = DataScanner(spools).attach_config(h.meta)
            try:
                t0 = time.perf_counter()
                sc.scan_cycle()
                scan_s = time.perf_counter() - t0
                life = dict(sc.stats.lifecycle)
            finally:
                sc.stop()
            left = sorted(fi.name for fi in spools.list_objects("lifeb"))
            kept = len(spools.list_object_versions("lifeb", "keep/v"))
            if life != {"expired": 2, "expired_noncurrent": 2,
                        "transitioned": 0, "skipped_locked": 1} or \
                    left != ["keep/v", "tmp/held"] or kept != 1:
                raise SystemExit(f"protection: the scanner's lifecycle "
                                 f"{life}, left {left}, {kept} versions")
            hold("lifecycle (this process)", here_items(i0), want)
        finally:
            spools.close()
            kpools.close()
    finally:
        for p in (pool, kpool):
            if p is not None:
                p.kill()
        tsrv.shutdown()
        tpools.close()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(kroot, ignore_errors=True)
    here = counts.read()
    launches = {k: pool_launches[k] + here[k] for k in _KERNELS}
    launches["mxh256_elsewhere"] = pool_launches["mxh256"]
    n_versions = len([k for k in records if k[0] != "big-hh"])
    print(f"[protection] two sources: python -m minio_tpu_torch.server, "
          f"{REPL_WORKERS} workers each, booted at once in {boots_s:.2f} s "
          f"({boot_s:.2f} s and, MTPU_CRASH armed, {boot_b_s:.2f} s); "
          f"target: an in-process S3Server on 12 drives; registered through"
          f" admin bucket-remote ({arn}); card {card}")
    print(f"[protection] resync of the {HH} object ({OBJECT_BYTES} B) in "
          f"{resync_s:.2f} s; {REPL_CLIENTS} clients: {len(plan)} objects "
          f"and {REPL_HISTORY} versions and a delete marker of one key, "
          f"{moved} B (the PUTs below included); replication lag from the "
          f"last ack to every version COMPLETED {lag_s:.3f} s; "
          f"{sum(n for _, n in plan) / traffic_s / 1e9:.4f} GB/s and "
          f"{(len(plan) + REPL_HISTORY + 1) / traffic_s:.2f} versions/s "
          f"from the first PUT to the last copy; card {card}")
    print(f"[protection] target down {down_s:.2f} s for {REPL_DEAD} PUTs "
          f"of {REPL_DEAD_BYTES} B: breakers open {opened}, "
          f"{attempts} failed attempts, caught up {catchup_s:.3f} s after "
          f"the target came back; breaker trips and probes {trips}; "
          f"card {card}")
    print(f"[protection] a proxied GET of a key only the target holds "
          f"while a resync runs, 404 once it is done; object lock: DELETE "
          f"refused, the bypass taken, a legal hold refusing even the "
          f"bypass ({refusals}); card {card}")
    print(f"[protection] MTPU_CRASH=repl.pre_copy:{REPL_CRASH_NTH}: worker "
          f"{killed} died after {n_kill} acknowledged PUTs, back in "
          f"{respawn_s:.2f} s, its journal's task replayed and copied once;"
          f" CUDA contexts {cuda_a} and {cuda_b}; card {card}")
    print(f"[protection] {n_versions + 1} versions on the target "
          f"byte-exact (SHA-256) with the source's ids, ETags and mod "
          f"times, none twice, {completed} keys COMPLETED, in "
          f"{check_s:.2f} s; scanner cycle {scan_s:.3f} s: expired "
          f"{life['expired']}, expired_noncurrent "
          f"{life['expired_noncurrent']}, skipped_locked "
          f"{life['skipped_locked']}; card {card}")
    print(f"[protection] items per step: {steps}; launches {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


# Phase 5s, bucket notifications, over BASELINE.json config 2's set (one
# EC:8+4 set of 12 drives on /dev/shm, STANDARD=EC:4): the pool booted
# with NOTIFY_WORKERS workers (MTPU_HOTCACHE=0) and two notification
# targets from the environment, a loopback webhook and a NATS fake, both
# in this process; NOTIFY_CLIENTS client threads PUT NOTIFY_BIG objects
# of OBJECT_BYTES and NOTIFY_SMALL of NOTIFY_SMALL_BYTES, complete one
# multipart upload of NOTIFY_PARTS and DELETE NOTIFY_DELETES keys
# (NOTIFY_MARKERS of them making delete markers); a rule changed through
# one worker fires through the other (at most NOTIFY_FIRE_MAX PUTs); the
# webhook stops for NOTIFY_OUTAGE PUTs of NOTIFY_EVENT_BYTES, and again
# for NOTIFY_KILL while the worker holding parked events is SIGKILLed;
# NOTIFY_LISTEN PUTs of NOTIFY_LISTEN_BYTES reach a ListenNotification
# stream of an in-process server; NOTIFY_COST PUTs of NOTIFY_EVENT_BYTES
# into a bucket with a webhook rule and as many into one without, in
# turns.
NOTIFY_WORKERS, NOTIFY_CLIENTS = 2, 4
NOTIFY_BIG = 3
# NOTIFY_SMALL 64 and NOTIFY_COST 32 before phase 5t joined the run.
NOTIFY_SMALL, NOTIFY_SMALL_BYTES = 32, (1024, 100 * 1024)
NOTIFY_PARTS = (5 * MIB, 5 * MIB, 5 * MIB)
NOTIFY_DELETES, NOTIFY_MARKERS = 16, 8
NOTIFY_FIRE_MAX = 16
NOTIFY_OUTAGE, NOTIFY_KILL, NOTIFY_EVENT_BYTES = 16, 8, 256 * 1024
NOTIFY_LISTEN, NOTIFY_LISTEN_BYTES, NOTIFY_LISTEN_S = 8, 64 * 1024, 3.0
NOTIFY_COST = 16
#: requests that tell which worker a kept-alive connection reaches
NOTIFY_PROBES = 8
NOTIFY_WEBHOOK, NOTIFY_NATS = ("arn:minio:sqs::1:webhook",
                               "arn:minio:sqs::1:nats")


class _HookReceiver:
    """A loopback webhook: each record with its receipt time.  stop()
    closes the listening socket (connections are refused: an outage),
    start() listens on the same port again."""

    def __init__(self):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}/events"
        self.events: list = []
        self._mu = threading.Lock()
        self._srv = None
        self.start()

    def start(self) -> None:
        import http.server
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                data = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                t = time.monotonic()
                with outer._mu:
                    outer.events.extend(
                        (t, r) for r in json.loads(data)["Records"])
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()
        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", self.port),
                                                    Handler)
        threading.Thread(target=self._srv.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def records(self) -> list:
        with self._mu:
            return list(self.events)


class _NatsFake:
    """The server side of NATS's text protocol on the publish path:
    INFO, CONNECT answered +OK, each PUB's payload answered +OK, PING
    answered PONG."""

    def __init__(self):
        import socket
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self.port = self._lsock.getsockname()[1]
        self.events: list = []
        self._mu = threading.Lock()
        self._conns: list = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        try:
            f = conn.makefile("rb")
            conn.sendall(b'INFO {"server_id":"chip_smoke"}\r\n')
            if not f.readline().startswith(b"CONNECT "):
                return
            conn.sendall(b"+OK\r\n")
            while True:
                line = f.readline()
                if not line:
                    return
                if line.startswith(b"PUB "):
                    n = int(line.split()[-1])
                    payload = f.read(n + 2)[:n]
                    t = time.monotonic()
                    with self._mu:
                        self.events.extend(
                            (t, r) for r in json.loads(payload)["Records"])
                    conn.sendall(b"+OK\r\n")
                elif line.startswith(b"PING"):
                    conn.sendall(b"PONG\r\n")
        except OSError:
            pass
        finally:
            conn.close()

    def records(self) -> list:
        with self._mu:
            return list(self.events)

    def close(self) -> None:
        self._lsock.close()
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass


def _rules_xml(arns, events, prefix: str = "") -> bytes:
    filt = (f"<Filter><S3Key><FilterRule><Name>prefix</Name><Value>{prefix}"
            f"</Value></FilterRule></S3Key></Filter>" if prefix else "")
    return ("<NotificationConfiguration>" + "".join(
        f"<QueueConfiguration><Id>r{i}</Id><Queue>{arn}</Queue>"
        + "".join(f"<Event>{e}</Event>" for e in events) + filt
        + "</QueueConfiguration>" for i, arn in enumerate(arns))
        + "</NotificationConfiguration>").encode()


def _pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def phase_notify(args, counts, card):
    """Phase 5s, bucket notifications, as MinIO documents their setup
    (`mc admin config set notify_webhook ...`, `mc event add`): `python -m
    minio_tpu_torch.server` with NOTIFY_WORKERS workers over config 2's
    12 drives on /dev/shm, `notify_webhook` and `notify_nats` turned on
    through the environment, pointing at a loopback webhook and a NATS
    fake in this process, the queue stores under MTPU_NOTIFY_STORE_DIR on
    /dev/shm.  The rules of every bucket go through the pool.

    Steps, each with its device items exact from the pool's metrics: the
    traffic (every acknowledged mutation's record at both targets, with
    its event name, key, size, ETag and version id); a rule changed
    through one worker and fired through the other; the webhook down for
    NOTIFY_OUTAGE PUTs, then back (the parked events delivered by the
    pool's store's one sender, none lost, none twice); one key's PUT
    parked by one worker and its DELETE served by the other after the
    webhook's return (the PUT's record first); down again while the
    worker that parked a key's pair is SIGKILLed, then back (nothing
    lost; duplicates counted); ListenNotification on an
    in-process server (items from this process); the webhook's cost on
    the request path, PUTs with a matching rule against PUTs without, in
    turns (a notification adds no device item).  No CUDA context in a
    worker."""
    import signal

    import numpy as np

    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive

    ak, sk = "pooladmin", "pooladmin-secret"
    root = _tmp_root("chip_smoke-notify-", 8 * OBJECT_BYTES + (1 << 30))
    store = os.path.join(root, "store")
    rng = np.random.default_rng(args.seed * 1000 + 970)
    seed = args.seed * 1000 + 971
    t_phase = time.perf_counter()
    steps: dict[str, dict] = {}
    pool_launches = dict.fromkeys(_KERNELS, 0)
    counts.reset()
    created, removed = "s3:ObjectCreated:*", "s3:ObjectRemoved:*"
    versioning = (b"<VersioningConfiguration><Status>Enabled</Status>"
                  b"</VersioningConfiguration>")
    # (bucket, key, event name, version id) -> (size, ETag, ack time,
    # step, targets)
    want: dict = {}
    both = (NOTIFY_WEBHOOK, NOTIFY_NATS)

    def body(s, n):
        return np.random.default_rng(s).bytes(n)

    def zero():
        return dict.fromkeys(_KERNELS, 0)

    def put_items(n, times=1):
        out = zero()
        out["gf_matmul"] = out["mxh256"] = times * _put_calls(n)
        return out

    def hold(name, got, wanted, launches=None):
        steps[name] = got
        if got != wanted or (launches is not None and any(
                launches[k] > got[k] or (got[k] and not launches[k])
                for k in _KERNELS)):
            raise SystemExit(f"notify {name}: items {got}, launches "
                             f"{launches}, want {wanted}")

    recv, nats = _HookReceiver(), _NatsFake()
    pool = srv = lpools = None
    env = {"MTPU_HOTCACHE": "0",
           "MTPU_NOTIFY_WEBHOOK_ENABLE": "on",
           "MTPU_NOTIFY_WEBHOOK_ENDPOINT": recv.url,
           "MTPU_NOTIFY_NATS_ENABLE": "on",
           "MTPU_NOTIFY_NATS_ADDRESS": f"127.0.0.1:{nats.port}",
           "MTPU_NOTIFY_NATS_SUBJECT": "minio.events",
           "MTPU_NOTIFY_STORE_DIR": store}
    try:
        pool = _Pool(root, NOTIFY_WORKERS, env=env)
        port, pool_boot = pool.port, pool.boot_s

        def fresh():
            return S3Client(f"http://127.0.0.1:{port}", ak, sk, timeout=600)

        def metrics():
            for _ in range(100):
                try:
                    return pool.settled()
                except OSError:
                    time.sleep(0.05)      # a scrape on a dying worker
            raise SystemExit(f"notify: no metrics: {pool.tail()}")

        def per_worker(m, name):
            return {w: int(m.get(f'{name}{{worker="{w}"}}', 0))
                    for w in range(NOTIFY_WORKERS)}

        def reloaded():
            deadline = time.monotonic() + 30
            while True:
                m = metrics()
                if all(m[f'mtpu_worker_config_generation{{worker="{w}"}}']
                       == m["mtpu_config_generation"]
                       for w in range(NOTIFY_WORKERS)):
                    return m
                if time.monotonic() > deadline:
                    raise SystemExit(f"notify: the workers' config reload:"
                                     f" {pool.tail()}")
                time.sleep(0.05)

        def warm():
            """16 fresh connections: every worker caches evt's versioning
            and the other buckets' absent configs before a step counts."""
            for b in ("evt", "evrule", "evhook", "evbare"):
                for _ in range(16 if b == "evt" else 4):
                    fresh()._check(*fresh().request(
                        "GET", f"/{b}", query={"versioning": ""}))

        def step(name, before, wanted):
            after = _pool_counts(metrics(), NOTIFY_WORKERS)
            got = {k: int(after[f"items_{k}"] - before[f"items_{k}"])
                   for k in _KERNELS}
            launches = {k: int(after[f"launches_{k}"]
                               - before[f"launches_{k}"]) for k in _KERNELS}
            for k in _KERNELS:
                pool_launches[k] += launches[k]
            hold(name, got, wanted, launches)
            if after["ipc_fallbacks"] or after["co_fallbacks"]:
                raise SystemExit(f"notify {name}: fallbacks {after}")
            return after

        def expect(bucket, key, name, vid, size, etag, t_ack, step_name,
                   targets=both):
            want[bucket, key, name, vid] = (size, etag, t_ack, step_name,
                                            targets)

        def put(bucket, key, n, step_name, targets=both):
            nonlocal seed
            data = body(seed, n)
            seed += 1
            h = fresh().put_object(bucket, key, data)
            expect(bucket, key, "s3:ObjectCreated:Put",
                   h.get("x-amz-version-id", ""), n, h["ETag"].strip('"'),
                   time.monotonic(), step_name, targets)
            return h

        def sticky():
            """A client whose requests share one keep-alive connection,
            so one worker serves them all."""
            import http.client
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=600)
            real_close, conn.close = conn.close, lambda: None
            c = fresh()
            c._connect = lambda: conn
            return c, real_close

        def put_then_delete(key, step_name, between=None):
            """PUT then DELETE (a delete marker) of `key` on one
            connection; `between()` runs in between."""
            nonlocal seed
            c, close = sticky()
            try:
                data = body(seed, NOTIFY_EVENT_BYTES)
                seed += 1
                st, h, _ = c.request("PUT", f"/evt/{key}", body=data)
                if st != 200:
                    raise SystemExit(f"notify: PUT {key} {st}")
                expect("evt", key, "s3:ObjectCreated:Put",
                       h.get("x-amz-version-id", ""), NOTIFY_EVENT_BYTES,
                       h["ETag"].strip('"'), time.monotonic(), step_name)
                if between is not None:
                    between()
                st, _, _ = c.request("DELETE", f"/evt/{key}")
                if st != 204:
                    raise SystemExit(f"notify: DELETE {key} {st}")
                expect("evt", key, "s3:ObjectRemoved:DeleteMarkerCreated",
                       "", 0, "", time.monotonic(), step_name)
            finally:
                close()

        def wait_pairs(keys, what, timeout=120):
            """Both records of each PUT-then-DELETE key at both targets."""
            t0 = time.monotonic()
            for who in (recv, nats):
                while any(delivered(who, "evt", {k}).get(k, 0) < 2
                          for k in keys):
                    if time.monotonic() - t0 > timeout:
                        raise SystemExit(f"notify: {what}")
                    time.sleep(0.02)

        def delivered(who, bucket, keys):
            got = {}
            for _, r in who.records():
                o = r["s3"]["object"]
                if r["s3"]["bucket"]["name"] == bucket and o["key"] in keys:
                    got[o["key"]] = got.get(o["key"], 0) + 1
            return got

        def wait_for(who, bucket, keys, what, timeout=120):
            t0 = time.monotonic()
            while len(delivered(who, bucket, keys)) < len(keys):
                if time.monotonic() - t0 > timeout:
                    raise SystemExit(f"notify: {what}: "
                                     f"{len(delivered(who, bucket, keys))}"
                                     f" of {len(keys)} delivered")
                time.sleep(0.02)
            return time.monotonic() - t0

        # -- setup through the pool (`mc mb`, `mc version enable`,
        # `mc event add`) --------------------------------------------------
        cli = fresh()
        for b in ("evt", "evrule", "evhook", "evbare"):
            cli.make_bucket(b)
        cli._check(*cli.request("PUT", "/evt", query={"versioning": ""},
                                body=versioning))
        for b, xml in (("evt", _rules_xml(both, (created, removed))),
                       ("evrule", _rules_xml((NOTIFY_WEBHOOK,),
                                          ("s3:ObjectCreated:Put",), "a/")),
                       ("evhook", _rules_xml((NOTIFY_WEBHOOK,),
                                          ("s3:ObjectCreated:Put",)))):
            fresh()._check(*fresh().request(
                "PUT", f"/{b}", query={"notification": ""}, body=xml))
        reloaded()
        warm()
        st, _, got = fresh().request("GET", "/evt",
                                     query={"notification": ""})
        if st != 200 or b"arn:minio:sqs::1:nats" not in got:
            raise SystemExit(f"notify: ?notification GET {st} {got[:200]}")
        targets = [ln for ln in open(pool.log).read().splitlines()
                   if "notification targets:" in ln]
        if len(targets) != NOTIFY_WORKERS or any(
                NOTIFY_WEBHOOK not in ln or NOTIFY_NATS not in ln
                for ln in targets):
            raise SystemExit(f"notify: the workers' targets {targets}")
        c0 = _pool_counts(metrics(), NOTIFY_WORKERS)

        # -- the traffic: 4 client threads ---------------------------------
        plan = [("put", f"big{i}", OBJECT_BYTES) for i in range(NOTIFY_BIG)]
        plan += [("put", f"small/{i:03d}",
                  int(rng.integers(*NOTIFY_SMALL_BYTES)))
                 for i in range(NOTIFY_SMALL)]
        plan.append(("multipart", "mp", sum(NOTIFY_PARTS)))
        seeds = {key: seed + i for i, (_, key, _) in enumerate(plan)}
        seed += len(plan)
        mu = threading.Lock()
        errors: list = []
        vids: dict = {}

        def multipart(key):
            c = fresh()
            st, _, out = c.request("POST", f"/evt/{key}",
                                   query={"uploads": ""})
            upload = re.search(rb"<UploadId>([^<]+)</UploadId>",
                               out).group(1).decode()
            parts = []
            for i, n in enumerate(NOTIFY_PARTS, 1):
                st, h, _ = fresh().request(
                    "PUT", f"/evt/{key}", query={"partNumber": str(i),
                                                "uploadId": upload},
                    body=body(seeds[key] * 7 + i, n))
                if st != 200:
                    raise SystemExit(f"notify: part {i} {st}")
                parts.append(f"<Part><PartNumber>{i}</PartNumber><ETag>"
                             f"{h['ETag']}</ETag></Part>")
            st, _, out = fresh().request(
                "POST", f"/evt/{key}", query={"uploadId": upload},
                body=("<CompleteMultipartUpload>" + "".join(parts)
                      + "</CompleteMultipartUpload>").encode())
            t_ack = time.monotonic()
            if st != 200:
                raise SystemExit(f"notify: complete {st} {out[:200]}")
            etag = re.search(rb"<ETag>([^<]+)</ETag>",
                             out).group(1).decode().strip('"')
            vid = fresh().head_object("evt", key).get("x-amz-version-id", "")
            return ("s3:ObjectCreated:CompleteMultipartUpload", vid, etag,
                    t_ack)

        def client(part):
            try:
                for kind, key, n in part:
                    if kind == "multipart":
                        name, vid, etag, t_ack = multipart(key)
                    else:
                        h = fresh().put_object("evt", key,
                                               body(seeds[key], n))
                        t_ack = time.monotonic()
                        name, vid, etag = ("s3:ObjectCreated:Put",
                                           h.get("x-amz-version-id", ""),
                                           h["ETag"].strip('"'))
                    with mu:
                        vids[key] = vid
                        expect("evt", key, name, vid, n, etag, t_ack,
                               "traffic")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        t_start = time.perf_counter()
        t_mono = time.monotonic()
        _in_threads(NOTIFY_CLIENTS, client,
                    [plan[i::NOTIFY_CLIENTS] for i in range(NOTIFY_CLIENTS)])
        # The deletes: NOTIFY_MARKERS make delete markers, the others
        # remove one version by its id.
        gone = [f"small/{i:03d}" for i in range(NOTIFY_DELETES)]

        def delete(key):
            try:
                marker = int(key[-3:]) < NOTIFY_MARKERS
                query = {} if marker else {"versionId": vids[key]}
                st, h, _ = fresh().request("DELETE", f"/evt/{key}",
                                           query=query)
                t_ack = time.monotonic()
                if st != 204:
                    raise SystemExit(f"notify: DELETE {key} {st}")
                with mu:
                    expect("evt", key, "s3:ObjectRemoved:DeleteMarkerCreated"
                           if marker else "s3:ObjectRemoved:Delete",
                           query.get("versionId", ""), 0, "", t_ack,
                           "traffic")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        _in_threads(NOTIFY_CLIENTS, delete, gone)
        if errors:
            raise SystemExit(f"notify: client errors {errors[:3]}")
        n_events = len(plan) + len(gone)
        keys = {k for (b, k, _, _), v in want.items() if v[3] == "traffic"}
        wait_for(recv, "evt", keys, "the traffic's webhook records")
        wait_for(nats, "evt", keys, "the traffic's NATS records")
        traffic_s = time.perf_counter() - t_start
        last = max(t for who in (recv, nats) for t, _ in who.records())
        events_per_s = 2 * n_events / (last - t_mono)
        hook_lat = []
        for t, r in recv.records():
            o = r["s3"]["object"]
            w = want.get(("evt", o["key"], r["eventName"], o["versionId"]))
            if w is not None and w[3] == "traffic":
                hook_lat.append((t - w[2]) * 1e3)
        want_items = zero()
        for kind, key, n in plan:
            if kind == "multipart":
                for p in NOTIFY_PARTS:
                    for k, v in put_items(p).items():
                        want_items[k] += v
            else:
                for k, v in put_items(n).items():
                    want_items[k] += v
        c1 = step("traffic", c0, want_items)

        # -- a rule changed through one worker, fired through the other ---
        m = metrics()
        writes0 = per_worker(m, "mtpu_worker_config_writes_total")
        xml = _rules_xml((NOTIFY_WEBHOOK,), ("s3:ObjectCreated:Put",), "b/")
        fresh()._check(*fresh().request("PUT", "/evrule",
                                        query={"notification": ""},
                                        body=xml))
        m = reloaded()
        writes = per_worker(m, "mtpu_worker_config_writes_total")
        writer = next(w for w in writes if writes[w] != writes0[w])
        other = 1 - writer
        put("evrule", "a/old-prefix", 1024, "rule", targets=())
        fired = 0
        sent0 = per_worker(m, "mtpu_worker_notify_events_sent_total")
        for i in range(NOTIFY_FIRE_MAX):
            put("evrule", f"b/k{i}", 1024, "rule", targets=(NOTIFY_WEBHOOK,))
            fired += 1
            sent = per_worker(metrics(),
                              "mtpu_worker_notify_events_sent_total")
            if sent[other] > sent0[other]:
                break
        else:
            raise SystemExit(f"notify: no fire PUT reached worker {other}")
        wait_for(recv, "evrule", {f"b/k{i}" for i in range(fired)},
                 "the changed rule's records")
        # The rule's PUT; each worker's reload reads the three buckets'
        # rules (inline objects); the PUTs.
        want_items = put_items(len(xml))
        want_items["mxh256"] += NOTIFY_WORKERS * 3
        for k, v in put_items(1024, fired + 1).items():
            want_items[k] += v
        step("rule through the other worker", c1, want_items)
        # The reload dropped every worker's cached configs.
        warm()
        c2 = _pool_counts(metrics(), NOTIFY_WORKERS)

        # -- the webhook down for NOTIFY_OUTAGE PUTs ------------------------
        recv.stop()
        outage = [f"out/{i:02d}" for i in range(NOTIFY_OUTAGE)]
        for key in outage:
            put("evt", key, NOTIFY_EVENT_BYTES, "outage")
        wait_for(nats, "evt", set(outage), "NATS during the outage")
        m = metrics()
        # The pool's one store: every worker sees all that is parked.
        parked = per_worker(m, "mtpu_worker_notify_backlog_events")
        if set(parked.values()) != {NOTIFY_OUTAGE}:
            raise SystemExit(f"notify: parked {parked} of {NOTIFY_OUTAGE}")
        # The per-key order across the outage: a PUT and a DELETE of one
        # key while the webhook is down, and a PUT parked before its
        # return whose DELETE comes after it, before the retry pass.
        put_then_delete("ord/down", "outage")
        put_then_delete("ord/back", "outage", between=recv.start)
        drain_s = wait_for(recv, "evt", set(outage), "the outage's drain")
        wait_pairs(("ord/down", "ord/back"), "the outage's ordered keys")
        c3 = step("webhook outage", c2,
                  put_items(NOTIFY_EVENT_BYTES, NOTIFY_OUTAGE + 2))

        # -- one key's PUT and DELETE on two workers ------------------------
        # The PUT parks on one worker while the webhook is down; the
        # webhook comes back; the DELETE is served by the other worker
        # before any retry pass: it parks behind the pool's one store, and
        # the store's one sender delivers the PUT first.
        recv.stop()
        split_s = time.perf_counter()
        a, close_a = sticky()
        b = close_b = None
        try:
            p0 = per_worker(metrics(), "mtpu_worker_notify_events_parked_"
                                       "total")
            data = body(seed, NOTIFY_EVENT_BYTES)
            seed += 1
            st, h, _ = a.request("PUT", "/evt/ord/split", body=data)
            if st != 200:
                raise SystemExit(f"notify: PUT ord/split {st}")
            expect("evt", "ord/split", "s3:ObjectCreated:Put",
                   h.get("x-amz-version-id", ""), NOTIFY_EVENT_BYTES,
                   h["ETag"].strip('"'), time.monotonic(), "split")
            p1 = per_worker(metrics(), "mtpu_worker_notify_events_parked_"
                                       "total")
            w_put = next(w for w in p1 if p1[w] - p0[w] == 1)
            for _ in range(32):
                b, close_b = sticky()
                r0 = per_worker(metrics(), "mtpu_worker_requests_total")
                for _ in range(NOTIFY_PROBES):
                    b.request("GET", "/evt", query={"location": ""})
                r1 = per_worker(metrics(), "mtpu_worker_requests_total")
                if r1[1 - w_put] - r0[1 - w_put] >= NOTIFY_PROBES:
                    break
                close_b()
                b = close_b = None
            else:
                raise SystemExit("notify: no connection reached the "
                                 "other worker")
            recv.start()
            st, _, _ = b.request("DELETE", "/evt/ord/split")
            if st != 204:
                raise SystemExit(f"notify: DELETE ord/split {st}")
            expect("evt", "ord/split", "s3:ObjectRemoved:DeleteMarkerCreated",
                   "", 0, "", time.monotonic(), "split")
        finally:
            close_a()
            if close_b is not None:
                close_b()
        wait_pairs(("ord/split",), "the split key's records")
        split_s = time.perf_counter() - split_s
        c3 = step("split across workers", c3,
                  put_items(NOTIFY_EVENT_BYTES))

        # -- down again, and the worker holding parked events SIGKILLed ----
        recv.stop()
        kill = [f"kill/{i:02d}" for i in range(NOTIFY_KILL)]
        for key in kill:
            put("evt", key, NOTIFY_EVENT_BYTES, "kill")
        wait_for(nats, "evt", set(kill), "NATS before the kill")
        m = metrics()
        before_ord = per_worker(m, "mtpu_worker_notify_events_parked_total")
        # The key whose order the SIGKILL must keep: the worker that
        # parked its pair is the one killed.
        put_then_delete("ord/kill", "kill")
        m = metrics()
        parked_kill = per_worker(m, "mtpu_worker_notify_events_parked_total")
        victim = next(w for w in parked_kill
                      if parked_kill[w] - before_ord[w] == 2)
        parked_kill = per_worker(m, "mtpu_worker_notify_backlog_events")
        pid = int(m[f'mtpu_worker_pid{{worker="{victim}"}}'])
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        deadline = time.monotonic() + 240
        while True:
            try:
                m = pool.metrics()
                if m.get(f'mtpu_worker_ready{{worker="{victim}"}}') == 1 \
                        and int(m[f'mtpu_worker_pid{{worker="{victim}"}}']) \
                        != pid:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise SystemExit(f"notify: worker {victim} never came "
                                 f"back: {pool.tail()}")
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        recv.start()
        drain_kill_s = wait_for(recv, "evt", set(kill), "the kill's drain")
        wait_pairs(("ord/kill",), "the kill's ordered key")
        time.sleep(1.5)                   # a second copy would come now
        # The respawned worker reads the three buckets' rules at boot.
        want_items = put_items(NOTIFY_EVENT_BYTES, NOTIFY_KILL + 1)
        want_items["mxh256"] += 3
        step("kill", c3, want_items)
        warm()
        c4 = _pool_counts(metrics(), NOTIFY_WORKERS)
        left = per_worker(metrics(), "mtpu_worker_notify_backlog_events")
        if any(left.values()) or any(n.endswith(".json") for n in
                                     os.listdir(os.path.join(store,
                                                             "webhook"))):
            raise SystemExit(f"notify: events left parked {left}")

        # -- the webhook's cost on the request path ------------------------
        cost = {"evhook": [], "evbare": []}
        for i in range(NOTIFY_COST):
            for b in ("evhook", "evbare"):
                t0 = time.perf_counter()
                put(b, f"c{i:02d}", NOTIFY_EVENT_BYTES, "cost",
                    targets=(NOTIFY_WEBHOOK,) if b == "evhook" else ())
                cost[b].append((time.perf_counter() - t0) * 1e3)
        wait_for(recv, "evhook", {f"c{i:02d}" for i in range(NOTIFY_COST)},
                 "the cost leg's records")
        c5 = step("cost", c4, put_items(NOTIFY_EVENT_BYTES, 2 * NOTIFY_COST))
        cuda = c5["cuda"]
        if cuda != {"owner": 1, **{f"worker{w}": 0
                                   for w in range(NOTIFY_WORKERS)}}:
            raise SystemExit(f"notify: CUDA contexts {cuda}")
        counters = {k: per_worker(metrics(), f"mtpu_worker_notify_{k}")
                    for k in ("events_sent_total", "events_delivered_total",
                              "events_parked_total", "events_retried_total",
                              "backlog_events")}
        pool.stop()
        pool = None

        # -- every record at its targets -----------------------------------
        dups = {"kill": 0}
        for who, arn in ((recv, NOTIFY_WEBHOOK), (nats, NOTIFY_NATS)):
            seen: dict = {}
            for _, r in who.records():
                o = r["s3"]["object"]
                ident = (r["s3"]["bucket"]["name"], o["key"],
                         r["eventName"], o["versionId"])
                w = want.get(ident)
                if w is None or arn not in w[4]:
                    raise SystemExit(f"notify: unexpected {arn} record "
                                     f"{ident}")
                if (o["size"], o["eTag"]) != (w[0], w[1]):
                    raise SystemExit(f"notify: {arn} record {ident}: size "
                                     f"{o['size']}, ETag {o['eTag']}, want "
                                     f"{w[:2]}")
                seen[ident] = seen.get(ident, 0) + 1
            for ident, w in want.items():
                n = seen.get(ident, 0)
                if arn not in w[4]:
                    continue
                if n == 0:
                    raise SystemExit(f"notify: {arn} lost {ident}")
                if n > 1:
                    if w[3] != "kill":
                        raise SystemExit(f"notify: {arn} got {ident} "
                                         f"{n} times")
                    dups["kill"] += n - 1
            # Per key, the PUT's record arrives before the DELETE's.
            for key in ("ord/down", "ord/back", "ord/split", "ord/kill"):
                names = [r["eventName"] for _, r in who.records()
                         if r["s3"]["bucket"]["name"] == "evt"
                         and r["s3"]["object"]["key"] == key]
                first = [n for i, n in enumerate(names)
                         if n not in names[:i]]
                if first != ["s3:ObjectCreated:Put",
                             "s3:ObjectRemoved:DeleteMarkerCreated"]:
                    raise SystemExit(f"notify: {arn} got {key}'s records "
                                     f"in the order {names}")

        # -- ListenNotification on an in-process server --------------------
        lpools = ServerPools([ErasureSets(
            [LocalDrive(os.path.join(root, f"l{i}")) for i in range(1, 13)],
            set_drive_count=12)])
        srv = S3Server(lpools, Credentials(ak, sk)).start()
        lcli = S3Client(srv.endpoint, ak, sk, timeout=600)
        lcli.make_bucket("lbk")
        stream: dict = {}

        def listen():
            stream["out"] = S3Client(srv.endpoint, ak, sk,
                                     timeout=600).request(
                "GET", "/lbk", query={"events": "s3:ObjectCreated:*",
                                     "duration": str(NOTIFY_LISTEN_S)})
        th = threading.Thread(target=listen)
        i0 = counts.items()
        th.start()
        deadline = time.monotonic() + 30
        while srv.notify.pubsub.num_subscribers != 1:
            if time.monotonic() > deadline:
                raise SystemExit("notify: the listen stream never "
                                 "subscribed")
            time.sleep(0.01)
        lkeys = []
        for i in range(NOTIFY_LISTEN):
            lkeys.append(f"l/{i}")
            lcli.put_object("lbk", lkeys[-1],
                            body(seed + i, NOTIFY_LISTEN_BYTES))
        th.join(timeout=NOTIFY_LISTEN_S + 30)
        st, _, out = stream["out"]
        recs = [json.loads(ln)["Records"][0] for ln in out.split(b"\n")
                if ln.strip()]
        if st != 200 or [r["s3"]["object"]["key"] for r in recs] != lkeys:
            raise SystemExit(f"notify: listen {st}: "
                             f"{[r['s3']['object']['key'] for r in recs]}")
        now = counts.items()
        hold("listen (this process)", {k: now[k] - i0[k] for k in _KERNELS},
             put_items(NOTIFY_LISTEN_BYTES, NOTIFY_LISTEN))
        srv.shutdown()
        srv = None
    finally:
        if pool is not None:
            pool.kill()
        if srv is not None:
            srv.shutdown()
        if lpools is not None:
            lpools.close()
        recv.stop()
        nats.close()
        shutil.rmtree(root, ignore_errors=True)
    here = counts.read()
    launches = {k: pool_launches[k] + here[k] for k in _KERNELS}
    launches["mxh256_elsewhere"] = pool_launches["mxh256"]
    rule = statistics.mean(cost["evhook"])
    bare = statistics.mean(cost["evbare"])
    print(f"[notify] python -m minio_tpu_torch.server, {NOTIFY_WORKERS} "
          f"workers, booted in {pool_boot:.2f} s with notify_webhook and "
          f"notify_nats from the environment (a loopback webhook and a "
          f"NATS fake in this process); card {card}")
    print(f"[notify] traffic from {NOTIFY_CLIENTS} clients: {NOTIFY_BIG} x "
          f"{OBJECT_BYTES} B, {NOTIFY_SMALL} small, a multipart of "
          f"{len(NOTIFY_PARTS)} x {NOTIFY_PARTS[0]} B, {NOTIFY_DELETES} "
          f"DELETEs ({NOTIFY_MARKERS} markers): {n_events} events at each "
          f"target in {traffic_s:.2f} s, {events_per_s:.1f} events/s; the "
          f"webhook's receipt minus the client's ack, p50 "
          f"{_pctl(hook_lat, 0.5):.3f} ms, p99 {_pctl(hook_lat, 0.99):.3f} "
          f"ms (negative: delivered before the response); card {card}")
    print(f"[notify] a rule changed through worker {writer}, fired through "
          f"worker {other} after {fired} PUT(s); card {card}")
    print(f"[notify] webhook down for {NOTIFY_OUTAGE} PUTs: {parked} parked "
          f"in the pool's store (seen by each worker), delivered "
          f"{drain_s:.3f} s after its return; one key's PUT parked by worker"
          f" {w_put} and its DELETE served by worker {1 - w_put} after the "
          f"return, both delivered in order in {split_s:.3f} s; down "
          f"again for {NOTIFY_KILL} PUTs, {parked_kill} parked, worker "
          f"{victim} SIGKILLed and back in {respawn_s:.2f} s, delivered "
          f"{drain_kill_s:.3f} s after the webhook's return; duplicates in "
          f"the kill step {dups['kill']}, none elsewhere, none lost; the "
          f"PUT before the DELETE of each of 4 keys at both targets (down, "
          f"back before the retry, split across workers, across the kill);"
          f" card {card}")
    print(f"[notify] per worker {counters}; card {card}")
    print(f"[notify] cost on the request path, {NOTIFY_COST} PUTs of "
          f"{NOTIFY_EVENT_BYTES} B each way in turns: with a webhook rule "
          f"{rule:.3f} ms a PUT (median {statistics.median(cost['evhook']):.3f})"
          f", without {bare:.3f} (median "
          f"{statistics.median(cost['evbare']):.3f}), {rule - bare:+.3f} ms; "
          f"card {card}")
    print(f"[notify] ListenNotification in process: {NOTIFY_LISTEN} PUTs, "
          f"{len(recs)} records, the stream ended at its "
          f"{NOTIFY_LISTEN_S} s duration; card {card}")
    print(f"[notify] items per step: {steps}; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


# Phase 5t, the tier: MinIO's documented tiering (`mc admin tier add
# minio WARM ...`, `mc ilm rule add --transition-days N
# --transition-tier WARM`) with the hot side in this process (config 2's
# EC:8+4 set of 12 drives) and the warm tier a port server booted through
# its entry point (EC:4+2 on TIER_WARM_DRIVES drives), reached over
# loopback through S3TierBackend.  TIER_CLIENTS client threads PUT
# TIER_BIG objects of OBJECT_BYTES and TIER_SMALL of TIER_SMALL_BYTES, then
# one highwayhash256S object of OBJECT_BYTES; TIER_TEMP objects restored
# for a day and TIER_PERM for good; TIER_DELETE stubs deleted by version;
# one transition of a TIER_CRASH_BYTES object in a subprocess dies at
# ilm.post_copy.
TIER_CLIENTS, TIER_BIG, TIER_SMALL = 4, 2, 64
TIER_SMALL_BYTES = (1024, 100 * 1024)
TIER_WARM_DRIVES = 6
TIER_DAYS = 30
TIER_TEMP, TIER_PERM, TIER_DELETE = 4, 4, 8
TIER_CRASH_BYTES = 16 * MIB + 7
TIER_KMS_KEY = "5a" * 32
#: the crash subprocess's device (None: the card)
TIER_CRASH_DEVICE = None
TIER_INLINE = 128 * 1024


class _Clock:
    """A `time` module stand-in `shift` seconds ahead of the real one
    (the scanner's clock past a rule's days, as the JAX tier tests age
    objects)."""

    def __init__(self, shift: float):
        self.shift = shift

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self) -> float:
        return time.time() + self.shift


def tier_crash(spec: dict) -> int:
    """`chip_smoke.py --tier-crash JSON`: one transition on the card over
    the hot drives, armed by MTPU_CRASH to die at ilm.post_copy."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from minio_tpu_torch.bucket.tier import TierManager
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.storage.drive import LocalDrive
    pools = ServerPools([ErasureSets([LocalDrive(d) for d in spec["drives"]],
                                     set_drive_count=len(spec["drives"]),
                                     device=spec.get("device"))])
    tm = TierManager(pools)
    tm.transition_object(spec["bucket"], spec["key"], spec["tier"])
    print("survived", flush=True)
    return 0


def _warm_counts(m: dict) -> tuple[dict, dict]:
    """(items, launches) per kernel of one booted server process from
    its metrics."""
    return ({k: int(m[f'mtpu_kernel_items_total{{kernel="{k}"}}'])
             for k in _KERNELS},
            {k: int(m[f'mtpu_kernel_launches_total{{kernel="{k}"}}'])
             for k in _KERNELS})


def _warm_get_items(size: int, offset: int = 0, length: int | None = None
                    ) -> int:
    """mxh256 items of the warm server's reads of one tier object of
    `size` bytes through S3TierBackend.get_stream: a HEAD, then ranged
    GETs of MTPU_ILM_CHUNK_MB (8 MiB); an inline object is read whole
    per GET."""
    from types import SimpleNamespace
    length = size - offset if length is None else length
    chunk = 8 * MIB
    fi = SimpleNamespace(size=size, data_dir="d",
                         parts=[SimpleNamespace(size=size)])
    calls, pos, end = 0, offset, offset + length
    while pos < end:
        n = min(chunk, end - pos)
        calls += 1 if size <= TIER_INLINE else _get_calls(fi, pos, n)
        pos += n
    return calls


def phase_tier(args, counts, card):
    """Phase 5t, the tier.  Setup: the hot S3Server in this process over
    config 2's set (a TierManager with the KMS that seals the tier's
    credentials, a DataScanner bound and driven by hand), the warm server
    (`python -m minio_tpu_torch.server`, one process, STANDARD=EC:2 over
    TIER_WARM_DRIVES drives on /dev/shm) booted meanwhile; the tier added
    through the admin `tier` endpoint, the Transition rule by `PUT
    ?lifecycle` on a versioned bucket.

    Steps, each with the hot side's GF, hh256 and mxh256 items exact
    (launches at most the items, some when there are items) and the warm
    server's from its metrics, exact too: the traffic; two data-shard
    drives' part files of one 64 MiB source removed; one scanner cycle
    with the clock TIER_DAYS + 1 days on, which moves every object (the
    degraded source through the GF decode, the highwayhash256S one
    through hh256); full and ranged GETs through every stub byte-exact,
    the second half with one warm drive away; HEADs with the tier's
    storage class; a temporary restore (Days=1) checked for x-amz-restore
    and re-expired by a scanner cycle with the clock two days on; a
    permanent restore; DELETEs of stubs by version, their tier objects
    gone from the warm bucket; a transition in a subprocess dying at
    ilm.post_copy, whose orphan the next TierManager boot reaps, the hot
    version byte-exact."""
    import numpy as np

    import minio_tpu_torch.bucket.lifecycle as lc_mod
    import minio_tpu_torch.bucket.tier as tier_mod
    from minio_tpu_torch.background.scanner import DataScanner
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.xlmeta import XLMeta

    ak, sk = "pooladmin", "pooladmin-secret"
    root = _tmp_root("chip_smoke-tier-", 12 * OBJECT_BYTES + (1 << 30))
    wroot = os.path.join(root, "warm")
    os.makedirs(wroot)
    rng = np.random.default_rng(args.seed * 1000 + 980)
    seed = args.seed * 1000 + 981
    t_phase = time.perf_counter()
    counts.reset()
    steps: dict[str, dict] = {}
    warm_launches = dict.fromkeys(_KERNELS, 0)
    times: dict[str, float] = {}
    kms0 = os.environ.get("MTPU_KMS_SECRET_KEY")
    os.environ["MTPU_KMS_SECRET_KEY"] = TIER_KMS_KEY
    clocks = (lc_mod.time, tier_mod.time)

    def zero():
        return dict.fromkeys(_KERNELS, 0)

    def add(d, other):
        for k, v in other.items():
            d[k] += v
        return d

    def put_items(n, algo="mxh256"):
        out = zero()
        out["gf_matmul"] = out[_digest(algo)] = _put_calls(n)
        return out

    def body(s, n):
        return np.random.default_rng(s).bytes(n)

    booted: dict = {}

    def boot_warm():
        try:
            # The hot-object cache stays on for the metrics route but
            # admits nothing: every read reaches the engine.
            booted["pool"] = _Pool(wroot, 0, env={
                "MTPU_STORAGE_CLASS_STANDARD": "EC:2",
                "MTPU_HOTCACHE_MAX_OBJ": "1"}, drives=TIER_WARM_DRIVES)
        except BaseException as e:  # noqa: BLE001 — reported below
            booted["error"] = e
    warm_thread = threading.Thread(target=boot_warm)
    warm_thread.start()
    warm = srv = hpools = sc = None
    try:
        drives = [os.path.join(root, f"h{i}") for i in range(1, 13)]
        hpools = ServerPools([ErasureSets([LocalDrive(d) for d in drives],
                                          set_drive_count=12)])
        es = hpools.pools[0].sets[0]
        tm = tier_mod.TierManager(hpools)
        sc = DataScanner(hpools)
        srv = S3Server(hpools, Credentials(ak, sk), tier_mgr=tm,
                       scanner=sc).start()

        def fresh():
            return S3Client(srv.endpoint, ak, sk, timeout=600)
        cli = fresh()
        for b in ("tierb", "crashb"):
            cli.make_bucket(b)
        cli._check(*cli.request(
            "PUT", "/tierb", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>"))
        warm_thread.join(timeout=300)
        if "pool" not in booted:
            raise SystemExit(f"tier: the warm server: {booted.get('error')}")
        warm = booted["pool"]
        times["warm boot"] = warm.boot_s
        wurl = f"http://127.0.0.1:{warm.port}"
        wcli = S3Client(wurl, ak, sk, timeout=600)
        wcli.make_bucket("warm")
        st, doc = cli.admin("POST", "tier", doc={
            "name": "WARM", "type": "s3", "endpoint": wurl,
            "accessKey": ak, "secretKey": sk, "bucket": "warm"})
        if st != 200:
            raise SystemExit(f"tier: admin tier add {st} {doc}")
        st, doc = cli.admin("GET", "tier")
        if st != 200 or doc["tiers"] != ["WARM"]:
            raise SystemExit(f"tier: admin tier list {st} {doc}")
        raw = open(os.path.join(drives[0], ".mtpu.sys", "tier",
                                "config.json"), "rb").read()
        if sk.encode() in raw or b'"v": 2' not in raw:
            raise SystemExit("tier: the tier config is not sealed")
        rule = (b"<LifecycleConfiguration><Rule><ID>warm</ID><Status>"
                b"Enabled</Status><Filter/><Transition><Days>%d</Days>"
                b"<StorageClass>WARM</StorageClass></Transition></Rule>"
                b"</LifecycleConfiguration>" % TIER_DAYS)
        cli._check(*cli.request("PUT", "/tierb", query={"lifecycle": ""},
                                body=rule))

        def warm_items():
            return _warm_counts(warm.metrics())

        mark = {"hot": counts.items(), "hot_l": counts.read(),
                "warm": warm_items()}

        def step(name, want_hot, want_warm):
            hot, hot_l = counts.items(), counts.read()
            got = {k: hot[k] - mark["hot"][k] for k in _KERNELS}
            launches = {k: hot_l[k] - mark["hot_l"][k] for k in _KERNELS}
            w_items, w_launch = warm_items()
            wgot = {k: w_items[k] - mark["warm"][0][k] for k in _KERNELS}
            wl = {k: w_launch[k] - mark["warm"][1][k] for k in _KERNELS}
            for k in _KERNELS:
                warm_launches[k] += wl[k]
            steps[name] = {"hot": got, "warm": wgot}
            bad = any(launches[k] > got[k] or (got[k] and not launches[k])
                      or wl[k] > wgot[k] or (wgot[k] and not wl[k])
                      for k in _KERNELS)
            if got != want_hot or wgot != want_warm or bad:
                raise SystemExit(
                    f"tier {name}: hot items {got} (launches {launches}), "
                    f"want {want_hot}; warm items {wgot} (launches {wl}), "
                    f"want {want_warm}")
            mark.update(hot=hot, hot_l=hot_l, warm=(w_items, w_launch))

        # -- the traffic: TIER_CLIENTS client threads -----------------------
        plan = [(f"big{i}", OBJECT_BYTES) for i in range(TIER_BIG)]
        plan += [(f"small/{i:03d}", int(rng.integers(*TIER_SMALL_BYTES)))
                 for i in range(TIER_SMALL)]
        data: dict[str, bytes] = {}
        for key, n in plan:
            data[key] = body(seed, n)
            seed += 1
        vids: dict[str, str] = {}
        mu = threading.Lock()

        def client(part):
            for key, _ in part:
                h = fresh().put_object("tierb", key, data[key])
                with mu:
                    vids[key] = h["x-amz-version-id"]
        t0 = time.perf_counter()
        _in_threads(TIER_CLIENTS, client,
                    [plan[i::TIER_CLIENTS] for i in range(TIER_CLIENTS)])
        os.environ["MTPU_BITROT_ALGO"] = HH
        try:
            data["hh"] = body(seed, OBJECT_BYTES)
            seed += 1
            vids["hh"] = fresh().put_object(
                "tierb", "hh", data["hh"])["x-amz-version-id"]
        finally:
            os.environ.pop("MTPU_BITROT_ALGO", None)
        crash_data = body(seed, TIER_CRASH_BYTES)
        seed += 1
        fresh().put_object("crashb", "obj", crash_data)
        times["traffic"] = time.perf_counter() - t0
        want = zero()
        for key, n in plan:
            add(want, put_items(n))
        add(want, put_items(OBJECT_BYTES, HH))
        add(want, put_items(TIER_CRASH_BYTES))
        step("traffic", want, zero())
        keys = [k for k, _ in plan] + ["hh"]
        moved = sum(len(data[k]) for k in keys)

        # -- two data shards of big0 away, one scanner cycle past the days -
        fis = {k: hpools.head_object("tierb", k) for k in keys}
        gone = _data_positions(Q, fis["big0"], 2)
        for pos in gone:
            os.unlink(os.path.join(drives[pos], "tierb", "big0",
                                   fis["big0"].data_dir, "part.1"))
        lc_mod.time = _Clock((TIER_DAYS + 1) * 86400.0)
        t0 = time.perf_counter()
        try:
            sc.scan_cycle()
        finally:
            lc_mod.time = clocks[0]
        times["transition cycle"] = time.perf_counter() - t0
        st = tm.stats()
        if st["transitioned"] != len(keys) or st["transition_errors"] or \
                st["journal_pending"]:
            raise SystemExit(f"tier: the cycle moved {st}")
        want, wwant = zero(), zero()
        for k in keys:
            fi = fis[k]
            calls = _get_calls(fi)
            want[_digest(fi.erasure.bitrot_algo())] += calls
            if k == "big0":
                want["gf_matmul"] += calls
            add(wwant, put_items(fi.size))
            wwant["mxh256"] += _warm_get_items(fi.size)
        step("transition", want, wwant)
        stubs = {k: hpools.head_object("tierb", k) for k in keys}
        tkeys = {k: fi.metadata[tier_mod.TIER_OBJ_KEY]
                 for k, fi in stubs.items()}
        if any(fi.size or not tm.is_transitioned(fi)
               for fi in stubs.values()):
            raise SystemExit("tier: a version was not left a stub")

        # -- GETs through every stub, half with a warm drive away ---------
        def warm_fi(k):
            path = os.path.join(wroot, "b2", "warm", "tier", tkeys[k],
                                "xl.meta")
            with open(path, "rb") as f:
                return XLMeta.from_bytes(f.read()).latest()
        wfis = {k: warm_fi(k) for k in keys}
        half = keys[::2]
        t0 = time.perf_counter()
        want_w = zero()
        got_bytes = 0

        def get_checks(k):
            n = len(data[k])
            st_, h, got = fresh().request("GET", f"/tierb/{k}")
            if st_ != 200 or got != data[k]:
                raise SystemExit(f"tier: GET {k} through its stub: {st_}")
            a, b = n // 3, n // 3 + max(1, n // 5)
            st_, h, got = fresh().request(
                "GET", f"/tierb/{k}", headers={"Range": f"bytes={a}-{b - 1}"})
            if st_ != 206 or got != data[k][a:b]:
                raise SystemExit(f"tier: ranged GET {k}: {st_}")
            return n + (b - a), ((0, None), (a, b - a))
        for k in keys:
            if k not in half:
                continue
            n, ranges = get_checks(k)
            got_bytes += n
            for off, ln in ranges:
                want_w["mxh256"] += _warm_get_items(len(data[k]), off, ln)
        times["stub GETs"] = time.perf_counter() - t0
        away = os.path.join(wroot, "b1")
        os.rename(away, away + ".away")
        t0 = time.perf_counter()
        try:
            for k in keys:
                if k in half:
                    continue
                n, ranges = get_checks(k)
                got_bytes += n
                for off, ln in ranges:
                    calls = _warm_get_items(len(data[k]), off, ln)
                    want_w["mxh256"] += calls
                    if _holds_data(wfis[k], [0]):
                        want_w["gf_matmul"] += calls
        finally:
            os.rename(away + ".away", away)
        times["degraded stub GETs"] = time.perf_counter() - t0
        for k in keys:
            st_, h, _ = fresh().request("HEAD", f"/tierb/{k}")
            if st_ != 200 or h.get("x-amz-storage-class") != "WARM" or \
                    int(h["Content-Length"]) != len(data[k]):
                raise SystemExit(f"tier: HEAD {k} {st_} {h}")
        step("GETs through the stubs", zero(), want_w)

        # -- a temporary restore, re-expired two days on -------------------
        small = [k for k in keys if k.startswith("small/")]
        temp = ["big1", "hh"] + small[:TIER_TEMP - 2]
        perm = ["big0"] + small[TIER_TEMP - 2:TIER_TEMP + TIER_PERM - 3]
        dels = small[TIER_TEMP + TIER_PERM - 3:
                     TIER_TEMP + TIER_PERM - 3 + TIER_DELETE]
        t0 = time.perf_counter()
        want, wwant = zero(), zero()
        for k in temp:
            st_, _, out = fresh().request(
                "POST", f"/tierb/{k}", query={"restore": ""},
                body=b"<RestoreRequest><Days>1</Days></RestoreRequest>")
            if st_ != 202:
                raise SystemExit(f"tier: restore {k} {st_} {out[:200]}")
            add(want, put_items(len(data[k])))
            wwant["mxh256"] += _warm_get_items(len(data[k]))
        times["temporary restore"] = time.perf_counter() - t0
        for k in temp:
            st_, h, got = fresh().request("GET", f"/tierb/{k}")
            if st_ != 200 or got != data[k] or not h.get(
                    "x-amz-restore", "").startswith(
                        'ongoing-request="false", expiry-date="'):
                raise SystemExit(f"tier: restored GET {k} {st_} {h}")
            want["mxh256"] += _get_calls(hpools.head_object("tierb", k))
        tier_mod.time = _Clock(2 * 86400.0)
        try:
            sc.scan_cycle()
        finally:
            tier_mod.time = clocks[1]
        if tm.stats()["restore_expired"] != len(temp):
            raise SystemExit(f"tier: re-expired {tm.stats()}")
        for k in temp:
            fi = hpools.head_object("tierb", k)
            st_, h, got = fresh().request("GET", f"/tierb/{k}")
            if fi.size or "x-amz-restore" in h or got != data[k]:
                raise SystemExit(f"tier: {k} after its window")
            wwant["mxh256"] += _warm_get_items(len(data[k]))
        step("temporary restore", want, wwant)

        # -- a permanent restore --------------------------------------------
        t0 = time.perf_counter()
        want, wwant = zero(), zero()
        for k in perm:
            st_, _, out = fresh().request("POST", f"/tierb/{k}",
                                          query={"restore": ""})
            if st_ != 202:
                raise SystemExit(f"tier: restore {k} {st_} {out[:200]}")
            add(want, put_items(len(data[k])))
            wwant["mxh256"] += _warm_get_items(len(data[k]))
        times["permanent restore"] = time.perf_counter() - t0
        for k in perm:
            st_, h, got = fresh().request("GET", f"/tierb/{k}")
            if st_ != 200 or got != data[k] or "x-amz-storage-class" in h:
                raise SystemExit(f"tier: permanently restored {k}: {st_}")
            want["mxh256"] += _get_calls(hpools.head_object("tierb", k))
        step("permanent restore", want, wwant)

        # -- DELETE of stubs by version --------------------------------------
        for k in dels:
            st_, _, _ = fresh().request("DELETE", f"/tierb/{k}",
                                        query={"versionId": vids[k]})
            if st_ != 204:
                raise SystemExit(f"tier: DELETE {k} {st_}")
        step("stub deletes", zero(), zero())
        st_, _, out = wcli.request("GET", "/warm",
                                   query={"list-type": "2",
                                          "prefix": "tier/"})
        left = set(re.findall(rb"<Key>tier/([^<]+)</Key>", out))
        freed = {tkeys[k].encode() for k in perm + dels}
        if st_ != 200 or left & freed or len(left) != len(keys) - len(
                freed):
            raise SystemExit(f"tier: the warm bucket holds {len(left)} "
                             f"keys, {len(left & freed)} freed ones")
        st = tm.stats()
        if st["freed"] != len(freed) or st["journal_pending"]:
            raise SystemExit(f"tier: frees {st}")

        # -- a transition dying at ilm.post_copy in a subprocess ----------
        env = dict(os.environ, MTPU_CRASH="ilm.post_copy:1",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tier-crash",
             json.dumps({"drives": drives, "bucket": "crashb",
                         "key": "obj", "tier": "WARM",
                         "device": TIER_CRASH_DEVICE})],
            env=env, capture_output=True, text=True, timeout=300)
        times["crash subprocess"] = time.perf_counter() - t0
        if proc.returncode != 137 or "survived" in proc.stdout or \
                "dying at ilm.post_copy" not in proc.stderr:
            raise SystemExit(f"tier: the crash run {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
        st_, _, out = wcli.request("GET", "/warm",
                                   query={"list-type": "2",
                                          "prefix": "tier/crashb/"})
        if out.count(b"<Key>") != 1:
            raise SystemExit("tier: no orphan copy after the crash")
        t0 = time.perf_counter()
        tm2 = tier_mod.TierManager(hpools)
        times["replay boot"] = time.perf_counter() - t0
        st = tm2.stats()
        if (st["orphans_reaped"], st["journal_pending"]) != (1, 0):
            raise SystemExit(f"tier: the replay {st}")
        st_, _, out = wcli.request("GET", "/warm",
                                   query={"list-type": "2",
                                          "prefix": "tier/crashb/"})
        fi, got = hpools.get_object("crashb", "obj")
        if b"<Key>" in out or bytes(got) != crash_data or \
                tm2.is_transitioned(fi):
            raise SystemExit("tier: the crash's orphan or hot version")
        want = zero()
        want["mxh256"] = _get_calls(fi)
        # The subprocess's reads ran in its own process; its tier copy,
        # a warm PUT, and its verify were the warm server's.
        wwant = put_items(TIER_CRASH_BYTES)
        wwant["mxh256"] += _warm_get_items(TIER_CRASH_BYTES)
        step("crash and replay", want, wwant)
        tm2.close()
        srv.shutdown()
        srv = None
        warm.stop()
    finally:
        lc_mod.time, tier_mod.time = clocks
        if kms0 is None:
            os.environ.pop("MTPU_KMS_SECRET_KEY", None)
        else:
            os.environ["MTPU_KMS_SECRET_KEY"] = kms0
        warm_thread.join(timeout=300)
        if warm is None:
            warm = booted.get("pool")     # None after its clean stop too
        if warm is not None and warm.proc.poll() is None:
            warm.kill()
        if srv is not None:
            srv.shutdown()
        if sc is not None:
            sc.stop()
        if hpools is not None:
            hpools.close()
        shutil.rmtree(root, ignore_errors=True)
    here = counts.read()
    launches = {k: warm_launches[k] + here[k] for k in _KERNELS}
    launches["mxh256_elsewhere"] = warm_launches["mxh256"]
    tr = times["transition cycle"]
    print(f"[tier] hot: config 2's set in this process; warm: python -m "
          f"minio_tpu_torch.server, EC:4+2 on {TIER_WARM_DRIVES} drives, "
          f"booted in {times['warm boot']:.2f} s; the tier added through "
          f"the admin API (S3 backend, sealed credentials); card {card}")
    print(f"[tier] traffic from {TIER_CLIENTS} clients: {TIER_BIG} x "
          f"{OBJECT_BYTES} B, {TIER_SMALL} of 1-100 KiB, one "
          f"highwayhash256S of {OBJECT_BYTES} B in {times['traffic']:.2f} s;"
          f" one scanner cycle moved {len(keys)} versions ({moved} B, one "
          f"source with 2 data shards away) in {tr:.2f} s, "
          f"{moved / tr / 1e9:.3f} GB/s; card {card}")
    print(f"[tier] GETs through the stubs (full + ranged, {got_bytes} B): "
          f"{times['stub GETs']:.2f} s healthy, "
          f"{times['degraded stub GETs']:.2f} s with a warm drive away; "
          f"temporary restore of {len(temp)} {times['temporary restore']:.2f}"
          f" s, permanent of {len(perm)} {times['permanent restore']:.2f} s;"
          f" {len(dels)} stubs deleted, {len(freed)} tier objects freed; "
          f"card {card}")
    print(f"[tier] crash at ilm.post_copy: the subprocess "
          f"{times['crash subprocess']:.2f} s, the replay boot "
          f"{times['replay boot']:.3f} s reaped its orphan; card {card}")
    print(f"[tier] items per step: {steps}; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


# Phase 5u, the object transforms, as AWS and MinIO document them: SSE-S3
# (`x-amz-server-side-encryption: AES256`) and SSE-C (the
# `-customer-algorithm`, `-customer-key` and `-customer-key-md5` headers)
# of AWS's "Protecting data with server-side encryption", MinIO's
# compression of text, CSV and JSON objects (`compression.enable`, its
# default extensions), S3 Select over CSV and JSON lines.  Config 2's
# set (EC:8+4, 12 drives) in one in-process S3Server with a StaticKMS
# from SSE_KMS_KEY and compression on; SSE_CLIENTS client threads.
SSE_CLIENTS = 4
SSE_BIG = 2                    # SSE-S3 objects of OBJECT_BYTES
SSE_SMALL, SSE_SMALL_BYTES = 16, (1024, 100 * 1024)
SSE_CSV_ROWS = 200_000         # about 16 MiB of CSV
SSE_CSV_NOTE = 46              # the note column's letters
SSE_NDJSON_BYTES = 4 * MIB
SSE_PART_BYTES = 5 * MIB + 7   # the UploadPartCopy's range
SSE_KMS_KEY = "6b" * 32


def _sse_headers(key: bytes, prefix: str = "x-amz-") -> dict:
    import base64
    import hashlib
    return {f"{prefix}server-side-encryption-customer-algorithm": "AES256",
            f"{prefix}server-side-encryption-customer-key":
                base64.b64encode(key).decode(),
            f"{prefix}server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(key).digest()).decode()}


def _csv_table(rng, rows: int) -> bytes:
    import numpy as np
    depts = ("eng", "sales", "ops", "legal", "finance")
    cities = ("Berlin", "Lagos", "Lima", "Osaka", "Perth", "Quebec")
    uid = rng.integers(0, 10**6, rows)
    dept = rng.integers(0, len(depts), rows)
    sal = rng.integers(30_000, 250_000, rows)
    city = rng.integers(0, len(cities), rows)
    note = rng.integers(0, 26, (rows, SSE_CSV_NOTE)) + ord("a")
    notes = note.astype(np.uint8).tobytes()
    lines = [b"id,user,dept,salary,city,note"]
    for i in range(rows):
        lines.append(b"%d,user%06d,%s,%d,%s,%s" % (
            i, uid[i], depts[dept[i]].encode(), sal[i],
            cities[city[i]].encode(),
            notes[SSE_CSV_NOTE * i:SSE_CSV_NOTE * (i + 1)]))
    return b"\n".join(lines) + b"\n"


def _ndjson_lines(rng, nbytes: int) -> bytes:
    out, n, i = [], 0, 0
    while n < nbytes:
        line = json.dumps({"id": i, "dept": ("eng", "ops")[i % 2],
                           "v": int(rng.integers(0, 1000)),
                           "tags": ["t%d" % (i % 7), "x"]}).encode()
        out.append(line)
        n += len(line) + 1
        i += 1
    return b"\n".join(out) + b"\n"


def phase_transforms(args, counts, card):
    """Phase 5u, the object transforms.  Setup: config 2's set in one
    in-process S3Server over loopback with a StaticKMS and compression
    on (`compress_enabled`), a TierManager with a directory tier.

    Steps, each with the GF, hh256 and mxh256 items exact from the STORED
    sizes (launches at most the items, some when there are items): the
    traffic from SSE_CLIENTS threads (SSE_BIG SSE-S3 and one SSE-C object
    of OBJECT_BYTES, random: the probe leaves them raw; a CSV of
    SSE_CSV_ROWS rows and a JSON-lines file, compressed and then sealed;
    SSE_SMALL SSE-C objects of 1-100 KiB), then one SSE-S3 object of
    OBJECT_BYTES with highwayhash256S; full and ranged GETs of each,
    byte-exact by SHA-256; HEADs with and without the SSE-C key, a wrong
    key (403s that read nothing); a copy SSE-C -> SSE-S3 and an
    UploadPartCopy from a sealed source; a degraded GET with two data
    shards away; Selects (a WHERE projection and count(*) on the CSV,
    one on the JSON lines) equal to their plain reference; the sealed,
    compressed CSV transitioned to the tier and read through its stub.
    Then PUT and GET of OBJECT_BYTES from one client, plain and SSE-S3 in
    turns, and the host costs: seal and unseal of OBJECT_BYTES, zlib of
    the CSV."""
    import numpy as np

    from minio_tpu_torch.bucket import tier as tier_mod
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.crypto.kms import StaticKMS
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.s3select import engine as sel
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.utils import compress as cz

    ak, sk = "sseadmin", "sseadmin-secret"
    root = _tmp_root("chip_smoke-sse-", 16 * OBJECT_BYTES + (1 << 30))
    rng = np.random.default_rng(args.seed * 1000 + 990)
    seed = args.seed * 1000 + 991
    t_phase = time.perf_counter()
    counts.reset()
    steps: dict[str, dict] = {}
    times: dict[str, float] = {}
    key_c, key_small, wrong = b"\x31" * 32, b"\x32" * 32, b"\x33" * 32
    s3h = {"x-amz-server-side-encryption": "AES256"}

    def zero():
        return dict.fromkeys(_KERNELS, 0)

    def body(n):
        nonlocal seed
        seed += 1
        return np.random.default_rng(seed).bytes(n)

    srv = pools = None
    try:
        drives = [os.path.join(root, f"d{i}") for i in range(1, 13)]
        pools = ServerPools([ErasureSets([LocalDrive(d) for d in drives],
                                         set_drive_count=12)])
        es = pools.pools[0].sets[0]
        kms = StaticKMS(bytes.fromhex(SSE_KMS_KEY))
        tm = tier_mod.TierManager(pools, kms=kms)
        tm.add_tier("WARM", tier_mod.DirTierBackend(
            os.path.join(root, "warm")))
        srv = S3Server(pools, Credentials(ak, sk), kms=kms,
                       compress_enabled=True, tier_mgr=tm).start()

        def fresh():
            return S3Client(srv.endpoint, ak, sk, timeout=600)
        fresh().make_bucket("sseb")
        mark = {"items": counts.items(), "launches": counts.read()}

        def step(name, want):
            items, launches = counts.items(), counts.read()
            got = {k: items[k] - mark["items"][k] for k in _KERNELS}
            lc = {k: launches[k] - mark["launches"][k] for k in _KERNELS}
            steps[name] = got
            if got != want or any(lc[k] > got[k] or (got[k] and not lc[k])
                                  for k in _KERNELS):
                raise SystemExit(f"transforms {name}: items {got} "
                                 f"(launches {lc}), want {want}")
            mark.update(items=items, launches=launches)

        def stored(key):
            return pools.head_object("sseb", key)

        def put_want(want, fi):
            calls = _put_calls(fi.size)
            want["gf_matmul"] += calls
            want[_digest(fi.erasure.bitrot_algo())] += calls

        def get_want(want, fi, degraded=False):
            calls = _get_calls(fi)
            want[_digest(fi.erasure.bitrot_algo())] += calls
            if degraded:
                want["gf_matmul"] += calls

        def request(method, key, want_status, headers=None, body_=b"",
                    query=None):
            st, h, out = fresh().request(method, f"/sseb/{key}",
                                         headers=headers, body=body_,
                                         query=query)
            if st != want_status:
                raise SystemExit(f"transforms: {method} {key} {st}: "
                                 f"{out[:300]!r}")
            return h, out

        # -- the traffic -----------------------------------------------------
        csv = _csv_table(rng, SSE_CSV_ROWS)
        ndjson = _ndjson_lines(rng, SSE_NDJSON_BYTES)
        data = {f"big{i}.bin": (body(OBJECT_BYTES), s3h)
                for i in range(SSE_BIG)}
        data["ssec.bin"] = (body(OBJECT_BYTES), _sse_headers(key_c))
        data["table.csv"] = (csv, dict(s3h, **{"Content-Type": "text/csv"}))
        data["events.json"] = (ndjson, dict(
            s3h, **{"Content-Type": "application/json"}))
        for i in range(SSE_SMALL):
            data[f"small/{i:02d}.bin"] = (
                body(int(rng.integers(*SSE_SMALL_BYTES))),
                _sse_headers(key_small))
        plan = list(data)

        def client(part):
            for key in part:
                request("PUT", key, 200, dict(data[key][1]), data[key][0])
        t0 = time.perf_counter()
        _in_threads(SSE_CLIENTS, client,
                    [plan[i::SSE_CLIENTS] for i in range(SSE_CLIENTS)])
        os.environ["MTPU_BITROT_ALGO"] = HH
        try:
            data["hh.bin"] = (body(OBJECT_BYTES), s3h)
            request("PUT", "hh.bin", 200, dict(s3h), data["hh.bin"][0])
        finally:
            os.environ.pop("MTPU_BITROT_ALGO", None)
        times["traffic"] = time.perf_counter() - t0
        plan.append("hh.bin")
        fis = {k: stored(k) for k in plan}
        sealed_big = OBJECT_BYTES + 8 + 20 * -(-OBJECT_BYTES
                                               // sse.PACKET_SIZE)
        for k in [f"big{i}.bin" for i in range(SSE_BIG)] + ["ssec.bin",
                                                           "hh.bin"]:
            if fis[k].size != sealed_big or \
                    cz.is_compressed(fis[k].metadata):
                raise SystemExit(f"transforms: {k} stored {fis[k].size} B "
                                 f"{fis[k].metadata}, want {sealed_big} "
                                 f"sealed, uncompressed")
        for k in ("table.csv", "events.json"):
            m = fis[k].metadata
            if m.get(cz.META_COMPRESSION) != "deflate" or \
                    m.get(sse.META_ALGO) != "SSE-S3":
                raise SystemExit(f"transforms: {k} not compressed and "
                                 f"sealed: {m}")
        want = zero()
        for k in plan:
            put_want(want, fis[k])
        step("traffic", want)
        put_bytes = sum(len(data[k][0]) for k in plan)

        # -- GETs, full and ranged; HEADs; refused keys ----------------------
        def key_headers(k):
            return {h: v for h, v in data[k][1].items() if "customer" in h}

        def check(k, out, lo=0, hi=None):
            want_b = data[k][0][lo:hi]
            if hashlib.sha256(out).digest() != \
                    hashlib.sha256(want_b).digest():
                raise SystemExit(f"transforms: {k} [{lo}:{hi}] differs")

        t0 = time.perf_counter()
        want = zero()
        got_bytes = 0

        def reader(part):
            for k in part:
                _, out = request("GET", k, 200, key_headers(k))
                check(k, out)
                n = len(data[k][0])
                lo, hi = n // 3, n // 3 + max(1, n // 5)
                _, out = request("GET", k, 206, dict(
                    key_headers(k), Range=f"bytes={lo}-{hi - 1}"))
                check(k, out, lo, hi)
        _in_threads(SSE_CLIENTS, reader,
                    [plan[i::SSE_CLIENTS] for i in range(SSE_CLIENTS)])
        times["GETs"] = time.perf_counter() - t0
        for k in plan:
            get_want(want, fis[k])
            get_want(want, fis[k])
            got_bytes += len(data[k][0]) + max(1, len(data[k][0]) // 5)
        step("GETs full and ranged", want)
        h, _ = request("HEAD", "ssec.bin", 200, key_headers("ssec.bin"))
        if h.get("x-amz-server-side-encryption-customer-algorithm") != \
                "AES256" or int(h["Content-Length"]) != OBJECT_BYTES:
            raise SystemExit(f"transforms: SSE-C HEAD {h}")
        h, _ = request("HEAD", "big0.bin", 200)
        if h.get("x-amz-server-side-encryption") != "AES256":
            raise SystemExit(f"transforms: SSE-S3 HEAD {h}")
        request("HEAD", "ssec.bin", 403)
        request("GET", "ssec.bin", 403, _sse_headers(wrong))
        request("GET", "small/00.bin", 403)
        step("HEADs and refused keys", zero())

        # -- a copy SSE-C -> SSE-S3, an UploadPartCopy from a sealed source -
        t0 = time.perf_counter()
        request("PUT", "copy.bin", 200, dict(
            _sse_headers(key_c, "x-amz-copy-source-"), **s3h,
            **{"x-amz-copy-source": "/sseb/ssec.bin"}))
        data["copy.bin"] = (data["ssec.bin"][0], s3h)
        fis["copy.bin"] = stored("copy.bin")
        want = zero()
        get_want(want, fis["ssec.bin"])
        put_want(want, fis["copy.bin"])
        _, out = request("GET", "copy.bin", 200)
        check("copy.bin", out)
        get_want(want, fis["copy.bin"])
        _, x = request("POST", "mp.bin", 200, query={"uploads": ""})
        uid = x.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
        _, x = request("PUT", "mp.bin", 200, dict(
            **{"x-amz-copy-source": "/sseb/big0.bin",
               "x-amz-copy-source-range": f"bytes=0-{SSE_PART_BYTES - 1}"}),
            query={"partNumber": "1", "uploadId": uid})
        etag = x.split(b"<ETag>")[1].split(b"</ETag>")[0].decode()
        request("POST", "mp.bin", 200, body_=(
            f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>"
        ).encode(), query={"uploadId": uid})
        get_want(want, fis["big0.bin"])
        want["gf_matmul"] += _put_calls(SSE_PART_BYTES)
        want["mxh256"] += _put_calls(SSE_PART_BYTES)
        _, out = request("GET", "mp.bin", 200)
        if out != data["big0.bin"][0][:SSE_PART_BYTES]:
            raise SystemExit("transforms: the UploadPartCopy's object "
                             "differs")
        get_want(want, stored("mp.bin"))
        times["copies"] = time.perf_counter() - t0
        step("copy and UploadPartCopy", want)

        # -- a degraded GET: two data shards of big1 away --------------------
        fi = fis["big1.bin"]
        for pos in _data_positions(Q, fi, 2):
            os.unlink(os.path.join(drives[pos], "sseb", "big1.bin",
                                   fi.data_dir, "part.1"))
        t0 = time.perf_counter()
        _, out = request("GET", "big1.bin", 200)
        times["degraded GET"] = time.perf_counter() - t0
        check("big1.bin", out)
        want = zero()
        get_want(want, fi, degraded=True)
        step("degraded GET", want)

        # -- Selects ------------------------------------------------------------
        def select(k, expr, json_in=False):
            inp = (b"<JSON><Type>LINES</Type></JSON>" if json_in else
                   b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>")
            req = (b"<SelectObjectContentRequest><Expression>%s"
                   b"</Expression><ExpressionType>SQL</ExpressionType>"
                   b"<InputSerialization>%s</InputSerialization>"
                   b"<OutputSerialization><CSV/></OutputSerialization>"
                   b"</SelectObjectContentRequest>" % (expr, inp))
            t = time.perf_counter()
            _, out = request("POST", k, 200, body_=req,
                             query={"select": "", "select-type": "2"})
            t = time.perf_counter() - t
            ref = sel.execute_select(data[k][0],
                                     sel.parse_select_request(req))
            if out != ref:
                raise SystemExit(f"transforms: Select {expr!r} differs "
                                 f"from its plain reference")
            return t, out
        sel_where, out = select(
            "table.csv", b"SELECT id, salary FROM S3Object WHERE "
            b"dept = 'eng' AND salary > 200000")
        recs = sel.decode_event_stream(out)
        sel_count, out = select("table.csv", b"SELECT count(*) FROM S3Object")
        counted = int(b"".join(p for t, p in sel.decode_event_stream(out)
                               if t == "Records").strip())
        if counted != SSE_CSV_ROWS:
            raise SystemExit(f"transforms: count(*) {counted}")
        sel_json, _ = select("events.json", b"SELECT s.id FROM S3Object s "
                             b"WHERE s.v > 989", json_in=True)
        want = zero()
        for k in ("table.csv", "table.csv", "events.json"):
            get_want(want, fis[k])
        step("Selects", want)

        # -- the sealed, compressed CSV to the tier, read through its stub ---
        t0 = time.perf_counter()
        if not tm.transition_object("sseb", "table.csv", "WARM"):
            raise SystemExit("transforms: the transition moved nothing")
        times["transition"] = time.perf_counter() - t0
        stub = stored("table.csv")
        if stub.size or not tm.is_transitioned(stub):
            raise SystemExit("transforms: no stub left")
        _, out = request("GET", "table.csv", 200)
        check("table.csv", out)
        lo = len(csv) // 2
        _, out = request("GET", "table.csv", 206,
                         {"Range": f"bytes={lo}-{lo + 99_999}"})
        check("table.csv", out, lo, lo + 100_000)
        want = zero()
        get_want(want, fis["table.csv"])
        step("transition and stub GETs", want)

        # -- PUT and GET from one client, plain and SSE-S3 in turns ---------
        turn = {"plain": {"put": [], "get": []}, "sse": {"put": [], "get": []}}
        want = zero()
        tb = body(OBJECT_BYTES)
        for i, mode in enumerate(("plain", "sse", "sse", "plain")):
            # .zip: the compression filter passes both turns by, so the
            # plain turn streams and the sealed one drains only to seal.
            k = f"turn/{i}-{mode}.zip"
            h = s3h if mode == "sse" else {}
            t0 = time.perf_counter()
            request("PUT", k, 200, dict(h), tb)
            turn[mode]["put"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            _, out = request("GET", k, 200)
            turn[mode]["get"].append(time.perf_counter() - t0)
            if out != tb:
                raise SystemExit(f"transforms: {k} differs")
            fi = stored(k)
            put_want(want, fi)
            get_want(want, fi)
        step("turns", want)

        # -- the host costs -----------------------------------------------------
        dk = bytes(32)[:31] + b"\x01"
        t0 = time.perf_counter()
        blob = sse.seal(tb, dk)
        seal_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if sse.unseal(blob, dk) != tb:
            raise SystemExit("transforms: unseal differs")
        unseal_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        zcsv, _ = cz.compress(csv)
        zlib_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if srv is not None:
            srv.shutdown()
        if pools is not None:
            pools.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = counts.read()

    def gbs(n, secs):
        return n / sum(secs) / 1e9 * len(secs)
    print(f"[transforms] config 2's set in process, a StaticKMS, compression"
          f" on; {SSE_CLIENTS} clients PUT {put_bytes} B ({SSE_BIG + 1} "
          f"SSE-S3 and 1 SSE-C of {OBJECT_BYTES} B stored {sealed_big} B "
          f"each, a {len(csv)} B CSV stored {fis['table.csv'].size} B and a "
          f"{len(ndjson)} B JSON-lines file stored "
          f"{fis['events.json'].size} B compressed then sealed, "
          f"{SSE_SMALL} SSE-C of 1-100 KiB) in {times['traffic']:.2f} s; "
          f"GETs full and ranged of {got_bytes} B in {times['GETs']:.2f} s;"
          f" card {card}")
    print(f"[transforms] one client, {OBJECT_BYTES} B in turns: PUT "
          f"{gbs(OBJECT_BYTES, turn['plain']['put']):.3f} GB/s plain, "
          f"{gbs(OBJECT_BYTES, turn['sse']['put']):.3f} SSE-S3; GET "
          f"{gbs(OBJECT_BYTES, turn['plain']['get']):.3f} plain, "
          f"{gbs(OBJECT_BYTES, turn['sse']['get']):.3f} SSE-S3; seal "
          f"{seal_ms:.2f} ms and unseal {unseal_ms:.2f} ms per "
          f"{OBJECT_BYTES} B; zlib level 1 {zlib_ms:.2f} ms per {len(csv)} "
          f"B CSV ({len(zcsv)} B); card {card}")
    print(f"[transforms] Select over the sealed, compressed CSV "
          f"({SSE_CSV_ROWS} rows): WHERE projection {sel_where:.3f} s "
          f"({SSE_CSV_ROWS / sel_where:.0f} rows/s, {len(recs)} events), "
          f"count(*) {sel_count:.3f} s ({SSE_CSV_ROWS / sel_count:.0f} "
          f"rows/s); over the JSON lines {sel_json:.3f} s; copy and "
          f"UploadPartCopy {times['copies']:.2f} s, degraded GET "
          f"{times['degraded GET']:.2f} s, transition "
          f"{times['transition']:.2f} s; card {card}")
    print(f"[transforms] items per step: {steps}; launches {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


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
        "worker pool": lambda: phase_pool(args, counts, card),
        "serving spine": lambda: phase_get_spine(args, counts, card),
        "metadata plane": lambda: phase_meta_plane(args, counts, card),
        "admission plane": lambda: phase_admission(args, counts, card),
        "bitrot forms": lambda: phase_bitrot_forms(args, counts, card),
        "cluster": lambda: phase_cluster(args, counts, card),
        "lifecycle": lambda: phase_lifecycle(args, counts, card),
        "data protection": lambda: phase_protection(args, counts, card),
        "notifications": lambda: phase_notify(args, counts, card),
        "tier": lambda: phase_tier(args, counts, card),
        "transforms": lambda: phase_transforms(args, counts, card),
    }
    per_path, tally = {}, {}
    faults0 = coalesce.stats()
    fi_ttl = ErasureSet._FI_CACHE_TTL
    # No booted server runs the data scanner: its cycles read drives,
    # write usage and heal, which the exact counts and drive trees of the
    # booted phases (5g's subprocess, 5j-5q) do not allow.  Phase 5q
    # drives a scanner of its own in this process.
    os.environ["MTPU_SCANNER"] = "0"
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
            t_path = time.perf_counter()
            per_path[name] = run()
            print(f"[time] {name}: {time.perf_counter() - t_path:.1f} s")
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
    os.environ.pop("MTPU_SCANNER", None)
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
    # The worker pool's calls, and the serving spine's, the metadata
    # plane's and the admission plane's servers', ran in their own
    # processes, untallied.
    phase_mxh_shapes(torch, mt, gen, card, tally,
                     calls - per_path["worker pool"]["mxh256"]
                     - per_path["serving spine"]["mxh256_elsewhere"]
                     - per_path["metadata plane"]["mxh256_elsewhere"]
                     - per_path["admission plane"]["mxh256_elsewhere"]
                     - per_path["cluster"]["mxh256_elsewhere"]
                     - per_path["lifecycle"]["mxh256_elsewhere"]
                     - per_path["data protection"]["mxh256_elsewhere"]
                     - per_path["notifications"]["mxh256_elsewhere"]
                     - per_path["tier"]["mxh256_elsewhere"])
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
    if sys.argv[1:2] == ["--pool-client"]:
        sys.exit(pool_client(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--meta-client"]:
        sys.exit(meta_client(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--qos-client"]:
        sys.exit(qos_client(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--tier-crash"]:
        sys.exit(tier_crash(json.loads(sys.argv[2])))
    sys.exit(main())
