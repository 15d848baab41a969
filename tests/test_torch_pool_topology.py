"""The port's pool topology (minio_tpu_torch/server/topology.py) and the
admin API's pool lifecycle (server/server.py: `pools`, `pool/add`,
`pool/decommission`, `datausage`, `info`), device="cpu", held to the JAX
package.

- pool-topology.json: each package reads the other's, the port's
  adopt_topology attaches the pools a JAX boot added, adopts the
  draining set and the relocation maps.
- A live pool/add over HTTP, a drain to completion, then a real boot
  (`python -m minio_tpu_torch.server --device cpu`) with --drives naming
  pool 0 only: the file attaches pool 1, pool 0 stays out of placement,
  every version reads back.
"""

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np

import minio_tpu.background.decom as jax_decom
import minio_tpu.server.topology as jax_topo
import minio_tpu_torch.engine.erasure_set as port_es_mod
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background.scanner import DataScanner
from minio_tpu_torch.background.usage import DirtyTracker
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.server import topology as topo
from minio_tpu_torch.server.client import S3Client
from minio_tpu_torch.server.server import S3Server
from minio_tpu_torch.server.sigv4 import Credentials
from minio_tpu_torch.storage.drive import LocalDrive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "topoadmin", "topoadmin-secret"
PortSets = functools.partial(ErasureSets, device="cpu")


def close(obj):
    for p in getattr(obj, "pools", [obj]):
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


def jax_two_pools(root):
    p0 = JaxErasureSets([JaxLocalDrive(f"{root}/a{i}") for i in range(4)],
                        set_drive_count=4)
    p1 = JaxErasureSets([JaxLocalDrive(f"{root}/b{i}") for i in range(4)],
                        set_drive_count=4, deployment_id=p0.deployment_id)
    return JaxServerPools([p0, p1])


def port_pool(root, name="a"):
    return PortSets([LocalDrive(f"{root}/{name}{i}") for i in range(4)],
                    set_drive_count=4)


def test_each_package_reads_the_others_topology(tmp_path):
    jp = jax_two_pools(tmp_path)
    try:
        jp.draining.add(0)
        jax_topo.save_topology(jp)
    finally:
        close(jp)
    pools = ServerPools([port_pool(tmp_path)])
    try:
        doc = topo.load_topology_from_root(str(tmp_path / "a0"))
        assert doc == jax_topo.load_topology_from_root(str(tmp_path / "a0"))
        assert topo.adopt_topology(pools) == 1
        assert len(pools.pools) == 2 and pools.draining == {0}
        assert topo.pool_paths_of(pools.pools[1]) == [
            str(tmp_path / f"b{i}") for i in range(4)]
        assert pools.pools[1].sets[0].device.type == "cpu"
        assert topo.adopt_topology(pools) == 0          # nothing new
        raw = (tmp_path / "a0" / ".mtpu.sys" /
               "pool-topology.json").read_bytes()
        topo.save_topology(pools)
        assert json.loads((tmp_path / "a0" / ".mtpu.sys" /
                           "pool-topology.json").read_bytes()) \
            == json.loads(raw)
    finally:
        pools.close()


def test_adopt_reads_relocations_and_undrains_a_cancel(tmp_path):
    """A JAX drain relocated an upload; the port's adopt resolves the old
    id, and a draining pool the file no longer names comes back."""
    jp = jax_two_pools(tmp_path)
    try:
        for p, f in zip(jp.pools, (1000, 10)):
            p.disk_usage = (lambda f: lambda: {"total": 1 << 40,
                                               "free": f})(f)
        jp.make_bucket("b")
        uid = jp.new_multipart_upload("b", "mp")
        jp.put_object_part("b", "mp", uid, 1, b"x" * (5 << 20))
        jp.pools[0].disk_usage = lambda: {"total": 1 << 40, "free": 1}
        jp.pools[1].disk_usage = lambda: {"total": 1 << 40, "free": 10**9}
        jax_decom.Decommissioner(jp, 0).run_sync()
        jax_topo.save_topology(jp)
    finally:
        close(jp)
    pools = ServerPools([port_pool(tmp_path), port_pool(tmp_path, "b")])
    try:
        pools.draining.add(0)
        assert topo.adopt_topology(pools) == 0
        assert pools.draining == {0}
        assert pools._split_upload_id(uid)[0] == 1
        doc = topo.load_topology_from_root(str(tmp_path / "a0"))
        doc["draining"] = []
        with open(topo.topology_path(pools), "w") as f:
            json.dump(doc, f)
        topo.adopt_topology(pools)
        assert pools.draining == set()
    finally:
        pools.close()


def test_a_lost_topology_save_does_not_undrain_the_requester(tmp_path):
    """Two object layers over the same drives play two workers.  The one
    that records a drain request writes pool-topology.json best effort;
    when that write is lost (a full disk), its next look at the topology
    keeps the pool out of placement, and the other worker adopts the
    drain from the fsynced journal; a cancel recorded later brings the
    pool back in both.  Before, the requester took the pool back into
    placement from the stale file (the worker-pool lifecycle test lost a
    placement so under load)."""
    from minio_tpu_torch.background import decom
    a = ServerPools([port_pool(tmp_path), port_pool(tmp_path, "b")])
    b = ServerPools([port_pool(tmp_path), port_pool(tmp_path, "b")])
    try:
        topo.save_topology(a)                       # draining []
        st = decom.request(b, 0, "start")           # its save is lost
        assert st["state"] == "draining" and b.placement_pools() == [1]
        topo.adopt_topology(b)
        assert b.draining == {0} and b.placement_pools() == [1]
        topo.adopt_topology(a)
        assert a.draining == {0} and a.placement_pools() == [1]
        decom.request(b, 0, "cancel")
        assert b.draining == set()
        topo.adopt_topology(a)
        assert a.draining == set() and a.placement_pools() == [0, 1]
    finally:
        a.close()
        b.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, what, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_live_add_drain_and_a_reboot_from_the_file(tmp_path):
    data = {f"o{i}": np.random.default_rng(i).bytes(60_000 + i)
            for i in range(6)}
    pools = ServerPools([port_pool(tmp_path)])
    sc = DataScanner(pools)
    srv = S3Server(pools, Credentials(AK, SK), scanner=sc).start()
    try:
        cli = S3Client(srv.endpoint, AK, SK, timeout=60)
        cli.make_bucket("lbk")
        st, _, _ = cli.request("PUT", "/lbk", query={"versioning": ""},
                               body=b"<VersioningConfiguration><Status>"
                                    b"Enabled</Status>"
                                    b"</VersioningConfiguration>")
        assert st == 200
        ids = {k: cli.put_object("lbk", k, v)["x-amz-version-id"]
               for k, v in data.items()}
        st, doc = cli.admin("POST", "pool/add",
                            doc={"drives": str(tmp_path / "b{0...3}")})
        assert (st, doc) == (200, {"pool": 1, "placement": [0, 1]})
        st, doc = cli.admin("GET", "pools")
        assert [(r["pool"], r["drivesTotal"], r["decommissioning"])
                for r in doc["pools"]] == [(0, 4, False), (1, 4, False)]
        st, doc = cli.admin("POST", "pool/decommission",
                            query={"pool": "1", "action": "pause"})
        assert st == 404
        st, doc = cli.admin("POST", "pool/decommission",
                            query={"pool": "0", "action": "start"})
        assert st == 200 and doc["state"] in ("draining", "complete")
        _wait(lambda: cli.admin("GET", "pool/decommission",
                                query={"pool": "0"})[1]["state"]
              == "complete", "the drain")
        st, doc = cli.admin("GET", "pool/decommission", query={"pool": "0"})
        # The six objects and the bucket's versioning config, an object
        # of the system volume, which the drain carries.
        assert (doc["versions_moved"], doc["objects_moved"]) == (7, 7)
        st, doc = cli.admin("GET", "datausage")
        assert st == 200 and doc["buckets"]["lbk"]["o"] == 6
        st, doc = cli.admin("GET", "info")
        assert (doc["objects"]["count"], doc["usage"]["size"]) == (
            6, sum(map(len, data.values())))
        assert len(doc["servers"][0]["drives"]) == 8
    finally:
        srv.shutdown()
        sc.stop()
        pools.close()
        DirtyTracker.shared().bind(None)
    # The reboot names pool 0 only: the file attaches pool 1, and pool
    # 0, drained, stays out of placement.
    port = _free_port()
    env = dict(os.environ, MTPU_ROOT_USER=AK, MTPU_ROOT_PASSWORD=SK,
               MTPU_SCANNER="0", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--drives", str(tmp_path / "a{0...3}"), "--port", str(port)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _wait(lambda: urllib.request.urlopen(
            f"http://127.0.0.1:{port}/minio/health/ready",
            timeout=1).status == 200, "the reboot", timeout=90)
        cli = S3Client(f"http://127.0.0.1:{port}", AK, SK, timeout=60)
        st, doc = cli.admin("GET", "pools")
        assert doc["placement"] == [1]
        assert [r["decommissioning"] for r in doc["pools"]] == [True, False]
        assert doc["pools"][0]["decommission"]["state"] == "complete"
        for k, v in data.items():
            st, hdrs, got = cli.request("GET", f"/lbk/{k}")
            assert st == 200 and got == v
            assert hdrs.get("x-amz-version-id") == ids[k]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert ("topology: 2 pools (1 from pool-topology.json), draining [0]; "
            "decommissions: pool 0 complete") in out, out
