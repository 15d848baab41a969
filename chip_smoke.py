#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (minio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure exits non-zero:

1. The card (nvidia-smi name and power limit) and the kernel build, timed.
2. The hand-written GF(2^8) kernel against its plain PyTorch version on
   the card, bit-exact (torch.equal), at the shapes the main path gives
   it; its time (CUDA events, median, L2 flushed between runs) beside
   its bound and the plain version's time.
3. mxh256 on the card against the numpy spec at one PUT batch's shape.
4. The slice: an EC:8+4 ErasureSet over 12 drive directories (in
   /dev/shm when present) takes 4 objects of 64 MiB and one of
   64 MiB + 300 KiB, then GET (checked against MD5 and ETag), HEAD,
   degraded GET with two data-shard drives taken away, GET with a
   corrupted shard frame, and DELETE.  The kernel's launch count is set
   to 0 before this phase and must rise on the PUTs and on the degraded
   GETs.
5. Where one 32 MiB PUT batch's time goes, layer by layer, and the
   device's busy share over one 64 MiB PUT + GET (torch.profiler).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
MIB = 1 << 20
OBJECT_BYTES = 64 * MIB        # BASELINE.json config 2's object size


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


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
          f"{ms:.4f} ms median of 10 ({x.numel() / ms / 1e6:.2f} GB/s); "
          f"card {card}")
    if not ok:
        raise SystemExit("mxh256 on the card disagrees with the spec")


def phase_slice(args, ec, card):
    from minio_tpu_torch.engine import quorum as Q
    from minio_tpu_torch.engine.erasure_set import ErasureSet
    from minio_tpu_torch.storage.drive import LocalDrive
    from minio_tpu_torch.storage.errors import ErrObjectNotFound
    import numpy as np

    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="chip_smoke-", dir=base)
    rng = np.random.default_rng(args.seed)
    sizes = [OBJECT_BYTES] * 4 + [OBJECT_BYTES + 300 * 1024]
    bodies = {f"obj{i}": rng.bytes(n) for i, n in enumerate(sizes)}
    total = sum(sizes)
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(12)], default_parity=4)
    steps = {}
    try:
        es.make_bucket("smoke")
        ec.LAUNCHES = 0                       # the main path starts here

        t0 = time.perf_counter()
        fis = {k: es.put_object("smoke", k, v) for k, v in bodies.items()}
        put_s = time.perf_counter() - t0
        steps["put"] = ec.LAUNCHES
        if steps["put"] == 0:
            raise SystemExit("PUT did not launch the GF kernel")

        get_s = 0.0
        for key, body in bodies.items():
            t0 = time.perf_counter()
            fi, got = es.get_object("smoke", key)
            get_s += time.perf_counter() - t0
            if hashlib.md5(got).hexdigest() != fi.etag or bytes(got) != body:
                raise SystemExit(f"GET {key}: bytes or ETag differ")
        steps["get"] = ec.LAUNCHES - steps["put"]

        for key, body in bodies.items():
            fi = es.head_object("smoke", key)
            if fi.size != len(body) or fi.etag != hashlib.md5(
                    body).hexdigest():
                raise SystemExit(f"HEAD {key}: size or ETag differ")

        before = ec.LAUNCHES
        deg_s = 0.0
        for key, body in bodies.items():
            order = Q.shuffle_by_distribution(
                list(range(12)), fis[key].erasure.distribution)
            saved = list(es.drives)
            for s in (0, 1):                  # two data-shard drives away
                es.drives[order[s]] = None
            t0 = time.perf_counter()
            _, got = es.get_object("smoke", key)
            deg_s += time.perf_counter() - t0
            es.drives = saved
            if bytes(got) != body:
                raise SystemExit(f"degraded GET {key}: bytes differ")
        steps["degraded_get"] = ec.LAUNCHES - before
        if steps["degraded_get"] == 0:
            raise SystemExit("degraded GET did not launch the GF kernel")

        key = "obj1"
        fi = fis[key]
        order = Q.shuffle_by_distribution(list(range(12)),
                                          fi.erasure.distribution)
        part = os.path.join(es.drives[order[2]].root, "smoke", key,
                            fi.data_dir, "part.1")
        with open(part, "r+b") as f:          # a frame mid-file
            f.seek(fi.size // MIB // 2 * (32 + fi.erasure.shard_size) + 1000)
            f.write(b"\xff" * 16)
        before = ec.LAUNCHES
        _, got = es.get_object("smoke", key)
        if bytes(got) != bodies[key]:
            raise SystemExit("GET with a corrupted frame: bytes differ")
        steps["corrupt_get"] = ec.LAUNCHES - before
        if steps["corrupt_get"] == 0:
            raise SystemExit("the corrupted frame was not rebuilt")
        launches = ec.LAUNCHES                # the main path ends here

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

    gb = total / 1e9
    print(f"[slice] EC:8+4, 12 drives, {len(sizes)} objects, {total} bytes: "
          f"PUT {gb / put_s:.3f} GB/s, GET {gb / get_s:.3f} GB/s, "
          f"degraded GET {gb / deg_s:.3f} GB/s (host clock); card {card}")
    print(f"[slice] GF kernel launches: {steps} (total {launches}); "
          "GET, HEAD, degraded GET, corrupted-frame GET byte-exact; "
          "DELETE done")
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
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from minio_tpu_torch.ops import erasure_cuda as ec
        from minio_tpu_torch.ops import erasure_torch as et
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
    path, log = ec.build(verbose=True)
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    record = phase_kernel(torch, ec, et, gen, card)
    phase_mxh(torch, mxhash, mt, gen, card)
    record["launches"] = phase_slice(args, ec, card)
    phase_layers(torch, card, torch.device("cuda", 0))

    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
