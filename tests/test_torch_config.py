"""The port's server configuration held to the JAX package's (device="cpu").
Tolerance: exact.

- ConfigSys: `get`, `get_subsys`, `help`, `set` and `unset` give the JAX
  class's answers under the same environment, subsystem by subsystem.
- config.json: what one package stores the other reads, in the same
  bytes, the environment winning over both.
- The admin API's `config` and `config-help` through both servers: the
  same statuses and JSON bodies.
- A setting that would turn on a plane the port does not run
  (compression, KMS) is refused, over the admin API as NotImplemented
  with its item; the boot names such an environment setting.
- A `config set storage_class` through the admin API governs the next
  PUT's parity without a restart.
"""

import json

import pytest

import minio_tpu.config.config as jax_config
import minio_tpu_torch.config.config as port_config
from minio_tpu_torch.server import __main__ as port_main
from minio_tpu_torch.server.client import S3Client
from test_torch_server import JAX, PORT, TIMEOUT, close_pools

ACCESS, SECRET = "cfgadmin", "cfgadmin-secret"

#: every builtin subsystem of the JAX class
SUBSYSTEMS = sorted(jax_config.ConfigSys(None, env={})._defaults)

#: an environment both classes read: one override per kind of key
ENV = {"MTPU_STORAGE_CLASS_STANDARD": "EC:3",
       "MTPU_NOTIFY_WEBHOOK_ENDPOINT": "http://127.0.0.1:9/hook",
       "MTPU_REGION_NAME": "eu-west-1",
       "MTPU_API_REQUESTS_MAX": "64"}


def _both(env=None, jax_pools=None, port_pools=None):
    return (jax_config.ConfigSys(jax_pools, env=dict(env or {})),
            port_config.ConfigSys(port_pools, env=dict(env or {})))


def test_every_builtin_subsystem_is_registered():
    assert SUBSYSTEMS == sorted(port_config.ConfigSys(None, env={})
                                ._defaults)
    assert len(SUBSYSTEMS) == 20


@pytest.mark.parametrize("subsys", SUBSYSTEMS)
def test_reads_match_jax(subsys):
    j, p = _both(ENV)
    assert p.get_subsys(subsys) == j.get_subsys(subsys)
    for key in j.get_subsys(subsys):
        assert p.get(subsys, key) == j.get(subsys, key), key
    assert p.help(subsys) == j.help(subsys)
    assert p.get(subsys, "no_such_key") == j.get(subsys, "no_such_key")


def test_help_lists_the_same_subsystems():
    j, p = _both()
    assert p.help() == j.help()
    assert p.help("nosuch") == j.help("nosuch")


@pytest.mark.parametrize("subsys", SUBSYSTEMS)
def test_set_and_unset_match_jax(subsys):
    """Every key of the subsystem set, read back, then unset, under an
    environment that overrides some of them; the port refuses only the
    settings of the planes it lacks (test below)."""
    j, p = _both(ENV)
    for key in j.get_subsys(subsys):
        value = f"v-{subsys}-{key}"
        j.set(subsys, key, value)
        p.set(subsys, key, value)
        assert p.get(subsys, key) == j.get(subsys, key)
        assert p.get_subsys(subsys) == j.get_subsys(subsys)
    for key in j.get_subsys(subsys):
        j.unset(subsys, key)
        p.unset(subsys, key)
        assert p.get_subsys(subsys) == j.get_subsys(subsys)
    for cls in (j, p):
        with pytest.raises(KeyError):
            cls.set(subsys, "no_such_key", "x")
        with pytest.raises(KeyError):
            cls.set("no_such_subsys", "enable", "x")


def test_listeners_and_on_write():
    seen, writes = [], []
    _, p = _both()
    p.on_change("heal", lambda *a: seen.append(a))
    p.on_write = lambda: writes.append(1)
    p.set("heal", "bitrotscan", "on")
    p.unset("heal", "bitrotscan")
    assert seen == [("heal", "bitrotscan", "on")]
    assert writes == [1, 1]


@pytest.mark.parametrize("subsys,key", [("compression", "enable"),
                                        ("kms", "enable")])
def test_unported_planes_are_refused(subsys, key):
    """The planes these settings turn on are served now: both classes
    store `enable=on` and `off` alike, the environment wins over the
    stored value, and compression's setting reads through
    `compression_enabled` (the handlers' switch)."""
    j, p = _both()
    for value in ("on", "off", "on"):
        j.set(subsys, key, value)
        p.set(subsys, key, value)
        assert p.get(subsys, key) == j.get(subsys, key) == value
    assert p.compression_enabled() == j.compression_enabled() == (
        subsys == "compression")
    env = {f"MTPU_{subsys.upper()}_{key.upper()}": "on"}
    _, pe = _both(env)
    assert pe.get(subsys, key) == "on"
    assert pe.compression_enabled() == (subsys == "compression")


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-to-jax", "jax-to-port"])
def test_config_json_crosses_packages(tmp_path, writer, reader):
    """The stored config.json is the same bytes from either package, and
    each reads what the other stored; the environment wins over both."""
    def cls(pkg):
        return jax_config.ConfigSys if pkg is JAX else \
            port_config.ConfigSys
    wpools = writer.pools(tmp_path, "d")
    try:
        w = cls(writer)(wpools, env={})
        w.set("storage_class", "standard", "EC:1")
        w.set("notify_webhook", "enable", "on")
        w.set("notify_webhook", "endpoint", "http://127.0.0.1:9/x")
        w.set("heal", "max_io", "7")
        w.unset("heal", "max_io")
        _, data = wpools.get_object(".mtpu.sys", port_config.CONFIG_PATH)
        stored = bytes(data)
    finally:
        close_pools(wpools)
    assert stored == json.dumps(
        {"heal": {}, "notify_webhook": {"enable": "on", "endpoint":
                                        "http://127.0.0.1:9/x"},
         "storage_class": {"standard": "EC:1"}}, sort_keys=True).encode()
    rpools = reader.pools(tmp_path, "d")
    try:
        r = cls(reader)(rpools, env={})
        assert r.get("storage_class", "standard") == "EC:1"
        assert r.parity_for_class("standard") == 1
        assert r.get_subsys("notify_webhook") == {
            "enable": "on", "endpoint": "http://127.0.0.1:9/x"}
        assert r.get("heal", "max_io") == "100"
        env = cls(reader)(rpools, env={
            "MTPU_STORAGE_CLASS_STANDARD": "EC:2"})
        assert env.parity_for_class("standard") == 2
    finally:
        close_pools(rpools)


def _admin_script(cli):
    out = []

    def do(method, endpoint, query=None, doc=None):
        st, body = cli.admin(method, endpoint, query, doc)
        if isinstance(body, bytes):
            import re
            code = re.search(rb"<Code>([^<]*)</Code>", body)
            body = code.group(1) if code else body
        out.append((method, endpoint, query, st, body))

    do("GET", "config")
    do("GET", "config", {"subsys": "storage_class"})
    do("GET", "config", {"subsys": "notify_nats"})
    do("GET", "config-help")
    do("GET", "config-help", {"subsys": "heal"})
    do("GET", "config-help", {"subsys": "nosuch"})
    do("POST", "config", doc={"subsys": "storage_class", "key": "rrs",
                              "value": "EC:1"})
    do("GET", "config", {"subsys": "storage_class"})
    do("POST", "config", doc={"subsys": "notify_webhook", "key": "endpoint",
                              "value": "http://127.0.0.1:9/hook"})
    do("GET", "config", {"subsys": "notify_webhook"})
    do("POST", "config", doc={"subsys": "nosuch", "key": "a", "value": "b"})
    do("POST", "config", doc={"subsys": "heal", "key": "nosuch",
                              "value": "b"})
    return out


def test_admin_config_api_matches_jax(tmp_path):
    records = {}
    for pkg in (JAX, PORT):
        pools = pkg.pools(tmp_path / pkg.name, "d")
        srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)
                           ).start()
        try:
            records[pkg.name] = _admin_script(
                S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT))
        finally:
            srv.shutdown()
            close_pools(pools)
    assert len(records["port"]) == 12
    assert records["port"] == records["jax"]
    statuses = [r[3] for r in records["port"]]
    assert statuses.count(400) == 2 and statuses.count(200) == 10


def test_admin_config_set_governs_the_next_put(tmp_path):
    """`config set storage_class standard EC:1` through the admin API:
    the next STANDARD PUT is written at parity 1 (and the K+1 read trim
    follows; a PUT without the header takes the set's default parity, in
    both packages),
    `unset` returns to the default; compression answers NotImplemented
    with its item and stores nothing."""
    from minio_tpu_torch.storage.xlmeta import XLMeta
    pools = PORT.pools(tmp_path, "d")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET)
                        ).start()
    try:
        cli = S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        cli.make_bucket("cfgb")

        def parity(key):
            st, _, _ = cli.request(
                "PUT", f"/cfgb/{key}", body=b"z" * 300_000,
                headers={"x-amz-storage-class": "STANDARD"})
            assert st == 200
            raw = (tmp_path / "d0" / "cfgb" / key / "xl.meta").read_bytes()
            return XLMeta.from_bytes(raw).latest().erasure.parity_blocks
        assert parity("a") == 2
        assert cli.admin("POST", "config", doc={
            "subsys": "storage_class", "key": "standard",
            "value": "EC:1"}) == (200, {"ok": True})
        assert parity("b") == 1
        es = pools.pools[0].sets[0]
        assert es.trim_parity == 1
        assert cli.admin("POST", "config", doc={
            "subsys": "storage_class", "key": "standard",
            "value": "EC:2"})[0] == 200
        assert parity("c") == 2
        assert cli.admin("POST", "config", doc={
            "subsys": "compression", "key": "enable", "value": "on"}) == (
            200, {"ok": True})
        assert cli.admin("GET", "config", {"subsys": "compression"})[1][
            "compression"]["enable"] == "on"
        # The setting takes effect at the next PUT: a text body is
        # stored compressed and read back whole.
        text = b"compressible line of text\n" * 20_000
        assert cli.request("PUT", "/cfgb/c.txt", body=text)[0] == 200
        raw = (tmp_path / "d0" / "cfgb" / "c.txt" / "xl.meta").read_bytes()
        meta = XLMeta.from_bytes(raw).latest().metadata
        assert meta["x-mtpu-internal-compression"] == "deflate"
        assert cli.get_object("cfgb", "c.txt") == text
    finally:
        srv.shutdown()
        close_pools(pools)


def test_boot_line_names_the_unported_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_COMPRESSION_ENABLE", "on")
    pools = PORT.pools(tmp_path, "d")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET)
                        ).start()
    try:
        line = port_main.config_line(srv)
        assert "notification targets: none" in line
        assert "compression: on" in line and "not applied" not in line
    finally:
        srv.shutdown()
        close_pools(pools)
