"""Run some of chip_smoke.py's phases from one checkout on the CUDA card,
and print each phase's time, its launches and their sum.

    python3 tools/chip_phases.py CHECKOUT PHASE...

PHASE is one of "worker pool" (5k), "serving spine" (5l), "cluster" (5p),
"observability" (5v) and "layers" (6, where a batch's and a HEAD's time
goes).  CHECKOUT is a tree holding chip_smoke.py and
minio_tpu_torch/ (this repo, or an unpacked `git archive` of another
commit): to compare two commits, run both on the same machine, one
after the other, in alternating order (parent, change, change,
parent).  The phases run with chip_smoke.py's own settings (the
scanner, the device shard cache and hedging off, the FileInfo cache's
TTL at 0; "layers" with every default, as the script runs phase 6),
after building both CUDA kernels."""
import os
import sys
import time
import types

checkout = os.path.abspath(sys.argv[1])
sys.path.insert(0, checkout)
os.chdir(checkout)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from minio_tpu_torch.engine.erasure_set import ErasureSet  # noqa: E402
from minio_tpu_torch.ops import coalesce, cuda_build, fused  # noqa: E402
from minio_tpu_torch.ops import erasure_cuda as ec  # noqa: E402
from minio_tpu_torch.ops import highwayhash_cuda as hc  # noqa: E402
from minio_tpu_torch.ops import mxhash_torch as mt  # noqa: E402

card = cs.card_line()
print(card, flush=True)
t0 = time.perf_counter()
cuda_build.build([ec.LIBRARY.source, hc.LIBRARY.source])
print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
counts = cs.Launches({"gf_matmul": ec, "hh256": hc, "mxh256": mt}, fused)
args = types.SimpleNamespace(seed=0)
os.environ["MTPU_SCANNER"] = "0"
os.environ["MTPU_DEVCACHE"] = "0"
os.environ["MTPU_HEDGE"] = "0"
fi_ttl, ErasureSet._FI_CACHE_TTL = ErasureSet._FI_CACHE_TTL, 0.0


def layers(args, counts, card):
    """Phase 6 with every default on, as chip_smoke.py runs it last."""
    saved = {k: os.environ.pop(k) for k in ("MTPU_SCANNER", "MTPU_DEVCACHE",
                                            "MTPU_HEDGE")}
    ErasureSet._FI_CACHE_TTL = fi_ttl
    try:
        return cs.phase_layers(torch, card, torch.device("cuda", 0))
    finally:
        os.environ.update(saved)
        ErasureSet._FI_CACHE_TTL = 0.0


table = {"worker pool": cs.phase_pool, "serving spine": cs.phase_get_spine,
         "cluster": cs.phase_cluster,
         "observability": getattr(cs, "phase_observe", None),
         "layers": layers}
total = 0.0
for name in sys.argv[2:]:
    coalesce.reset()
    t = time.perf_counter()
    out = table[name](args, counts, card)
    dt = time.perf_counter() - t
    total += dt
    print(f"[time] {name}: {dt:.1f} s; launches {out}", flush=True)
shared = getattr(cs, "POOL_SHARED", None)
if shared and "serving spine" in sys.argv[2:]:
    # 5k's turns run on 5l's boots: their launches gather there.
    print(f"[launches] worker pool's turns: {shared['launches']}",
          flush=True)
print(f"[sum] {checkout}: {total:.1f} s over {sys.argv[2:]}; card {card}",
      flush=True)
