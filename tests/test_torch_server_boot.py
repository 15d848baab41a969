"""The port's standalone boot, `python -m minio_tpu_torch.server`, in a
subprocess: with `--device cpu` it serves a signed PUT and GET and
exits 0 on SIGTERM; without it, on a host without CUDA, it refuses to
start; and the ellipsis syntax of --drives expands as the JAX package's
does."""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from minio_tpu.topology import endpoints as jax_endpoints
from minio_tpu_torch.server.__main__ import parse_pool_paths
from minio_tpu_torch.server.client import S3Client
from minio_tpu_torch.topology import endpoints

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, MTPU_ROOT_USER="bootadmin",
               MTPU_ROOT_PASSWORD="bootadmin-secret", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _wait_ready(proc, port, deadline_s=60):
    url = f"http://127.0.0.1:{port}/minio/health/ready"
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if proc.poll() is not None:
            raise AssertionError(f"boot exited {proc.returncode}: "
                                 f"{proc.stderr.read()}")
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("the server never became ready")


def test_boot_serves_and_exits_on_sigterm(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--drives", str(tmp_path / "d{1...4}"), "--port", str(port)],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _wait_ready(proc, port)
        cli = S3Client(f"http://127.0.0.1:{port}", "bootadmin",
                       "bootadmin-secret", timeout=30)
        data = np.random.default_rng(5).bytes(1_500_000)
        cli.make_bucket("boot")
        h = cli.put_object("boot", "obj", data)
        assert h["ETag"].strip('"')
        assert cli.get_object("boot", "obj") == data
        assert sorted(p.name for p in tmp_path.iterdir()
                      if p.name.startswith("d")) == ["d1", "d2", "d3", "d4"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "4 drives set=4" in out and "sets on cpu" in out, out
    assert "not started:" in out


def test_boot_without_device_raises_without_cuda(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.server",
         "--drives", str(tmp_path / "d{1...4}"), "--port",
         str(_free_port())],
        cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("arg", ["/data{1...4}", "/d{01...12}/x{1...2}",
                                 "/plain", "/x{3...3}"])
def test_ellipses_expand_as_jax(arg):
    assert endpoints.has_ellipses(arg) == jax_endpoints.has_ellipses(arg)
    assert endpoints.expand_one(arg) == jax_endpoints.expand_one(arg)
    assert endpoints.expand_endpoints([arg, arg]) == \
        jax_endpoints.expand_endpoints([arg, arg])


def test_pool_paths():
    assert parse_pool_paths([["/a{1...2}"], ["/b{1...2}", "/c{1...2}"]]) \
        == [["/a1", "/a2"], ["/b1", "/b2"], ["/c1", "/c2"]]
    assert parse_pool_paths([["/p", "/q"]]) == [["/p", "/q"]]
    assert parse_pool_paths([["/a{1...2}", "/plain"]]) is None
    with pytest.raises(endpoints.TopologyError):
        endpoints.expand_one("/d{4...1}")
