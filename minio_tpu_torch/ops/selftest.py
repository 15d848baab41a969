"""Startup self-tests: a build that computes wrong bytes refuses to serve.

Counterpart of minio_tpu/ops/selftest.py.  The reference hard-fails
server boot if the erasure codec or the bitrot hash produce unexpected
bytes (erasureSelfTest, cmd/erasure-coding.go:158; bitrotSelfTest,
cmd/bitrot.go:214).  Same contract here, over the port's own specs and
its device programs:

- `erasure_self_test`: the host GF(2^8) spec (ops/gf256.py) encodes,
  loses m shards and rebuilds them at four geometries;
- `bitrot_self_test`, `mxhash_self_test`: the scalar HighwayHash and
  mxh256 specs against the JAX package's golden SHA-256 chains;
- `device_lane_self_test`: `fused.encode_and_hash` with mxh256 on every
  card, held to the host spec, so each card launches the GF kernel and
  mxh256 once; a mismatch or a failed launch raises SelfTestError
  naming the card.  It never skips.

- `metrics_registry_self_test`: every family of the metrics registry
  (observe/metrics.py) has a help string, lives in the mtpu_ namespace
  and is named in the README: a family added without docs refuses to
  serve.

The JAX module's `digest_self_test` checks the native MD5/SHA-256
lanes; the port loads no native digest, so it has nothing to test.
"""

from __future__ import annotations

import hashlib

import numpy as np


class SelfTestError(RuntimeError):
    pass


def erasure_self_test() -> None:
    from . import gf256

    rng = np.random.default_rng(0xEC)
    for (k, m) in ((2, 2), (4, 2), (8, 4), (12, 4)):
        data = rng.integers(0, 256, size=(k, 64), dtype=np.uint8)
        full = gf256.build_matrix(k, k + m)
        shards = gf256.gf_matmul(full, data)
        # Knock out `m` shards, rebuild them from the first k survivors.
        gone = list(range(0, 2 * m, 2))[:m]
        have = [i for i in range(k + m) if i not in gone][:k]
        decode = gf256.gf_mat_invert(full[have])
        rebuilt = gf256.gf_matmul(full[gone], gf256.gf_matmul(
            decode, shards[have]))
        for j, i in enumerate(gone):
            if not np.array_equal(rebuilt[j], shards[i]):
                raise SelfTestError(f"erasure self-test EC:{k}+{m} "
                                    f"reconstruct mismatch row {i}")


# Golden chain from the published HighwayHash algorithm with the magic
# bitrot key: digest of b"" then iterated digest-of-digest (the JAX
# package's constant, pinned from its scalar implementation).
_HH_CHAIN_SHA256 = \
    "48883e06e9e249f4681c369484fc12a4f5f6891fde90a1a7be5a33288d46f3f2"


def bitrot_self_test() -> None:
    from .highwayhash import HighwayHash256

    h = b""
    for _ in range(8):
        hh = HighwayHash256()
        hh.update(h)
        h = hh.digest()
    if hashlib.sha256(h).hexdigest() != _HH_CHAIN_SHA256:
        raise SelfTestError("bitrot (HighwayHash256) self-test mismatch")


# Golden chain for mxh256 (the default write algorithm, ops/mxhash.py):
# digest of b"" then iterated digest-of-digest.
_MXH_CHAIN_SHA256 = \
    "d6373d19d83d8c7d0a34aa26414e76ea7ba722c0b0895b23e971fa4912566bc7"


def mxhash_self_test() -> None:
    from .mxhash import mxh256

    h = b""
    for _ in range(8):
        h = mxh256(h)
    if hashlib.sha256(h).hexdigest() != _MXH_CHAIN_SHA256:
        raise SelfTestError("bitrot (mxh256) self-test mismatch")


def _cards(device) -> list:
    """The devices the lane self-test runs on: every CUDA card for
    None (raising without CUDA, as every entry point does), else the
    one device named."""
    import torch

    from . import devices
    if device is not None:
        return [devices.resolve(device)]
    devices.resolve(None)                     # raises without CUDA
    return [torch.device("cuda", i) for i in range(devices.n_devices())]


def device_lane_self_test(device=None) -> None:
    """Encode + hash a golden batch on every card (`device=None`) or on
    the one device named, held to the host specs: a card whose kernels
    or memory produce wrong bytes refuses to boot, named, rather than
    corrupt the sets affine to it."""
    from . import fused, gf256
    from .mxhash import mxh256

    k, m, s = 2, 2, 128
    rng = np.random.default_rng(0xD0D)
    x = rng.integers(0, 256, size=(1, k, s), dtype=np.uint8)
    want_parity = gf256.gf_matmul(gf256.parity_matrix(k, m), x[0])
    rows = np.concatenate([x[0], want_parity], axis=0)
    want_digests = [mxh256(rows[i].tobytes()) for i in range(k + m)]
    for dev in _cards(device):
        try:
            parity, digests = fused.encode_and_hash(
                x, k, m, algo="mxh256", device=dev)
            parity = parity.cpu().numpy()[0]
            digests = digests.cpu().numpy()[:, 0]
        except Exception as e:  # noqa: BLE001 — name the device
            raise SelfTestError(
                f"device lane self-test launch failed on {dev}: "
                f"{e}") from e
        if not np.array_equal(parity, want_parity):
            raise SelfTestError(
                f"device lane self-test encode mismatch on {dev}")
        if [d.tobytes() for d in digests] != want_digests:
            raise SelfTestError(
                f"device lane self-test digest mismatch on {dev}")


def metrics_registry_self_test() -> None:
    """Every exported metric family must carry a help string, live in
    the mtpu_ namespace, and appear in the README's Observability
    section: a boot-time drift guard.  The README may name families by
    brace groups (mtpu_api_last_minute_{p50,p99}) or trailing-*
    wildcards (mtpu_worker_*); an absent README (a stripped install)
    skips the doc check, never the help and namespace checks."""
    import re
    from pathlib import Path

    from ..observe.metrics import MetricsRegistry

    fams = MetricsRegistry().families()
    if not fams:
        raise SelfTestError("metrics registry exports no families")
    names = []
    for m in fams:
        if not getattr(m, "help", ""):
            raise SelfTestError(
                f"metric family {m.name} has no help string")
        if not m.name.startswith("mtpu_"):
            raise SelfTestError(
                f"metric family {m.name} outside the mtpu_ namespace")
        names.append(m.name)
    readme = Path(__file__).resolve().parents[2] / "README.md"
    try:
        text = readme.read_text(encoding="utf-8")
    except OSError:
        return
    documented: set[str] = set()
    prefixes: list[str] = []
    for tok in re.findall(r"mtpu_[\w{},*]+", text):
        if "{" in tok and "}" in tok:
            base, rest = tok.split("{", 1)
            inner, tail = rest.split("}", 1)
            for alt in inner.split(","):
                documented.add(base + alt + tail)
        elif tok.endswith("*"):
            prefixes.append(tok[:-1])
        else:
            documented.add(tok)
    missing = [n for n in names
               if n not in documented
               and not any(n.startswith(p) for p in prefixes)]
    if missing:
        raise SelfTestError(
            "metric families missing from the README metrics table: "
            + ", ".join(sorted(missing)))


def run_startup_self_tests(device=None) -> None:
    erasure_self_test()
    bitrot_self_test()
    mxhash_self_test()
    device_lane_self_test(device)
    metrics_registry_self_test()
    # Fail boot on a misconfigured bitrot write algorithm (a clear
    # config error now, not a confusing per-request failure later).
    from ..storage.bitrot_io import write_algo
    write_algo()
