"""Layered configuration: defaults -> persisted KVS -> environment.

The port's copy of minio_tpu/config/config.py (the internal/config
role): subsystems register their default KVS and help text
(RegisterDefaultKVS, internal/config/config.go:182), values persist
under the meta bucket at the JAX package's path and in its bytes, so
either package reads what the other stored, and `MTPU_<SUBSYS>_<KEY>`
environment variables win over both (the reference's env-over-stored
merge, internal/config/config.go:261).  The admin API's `config` and
`config-help` endpoints (server/server.py) read and write it.

Beyond the JAX class, `on_write`, where set, runs after every stored
`set` or `unset`: a worker of the pool bumps the pool's config generation
there, and a cluster node broadcasts a `config` reload to its peers; each
other process then `load`s the stored values again.  `compression.enable`
takes effect at the next PUT (server/handlers.py reads
`compression_enabled`), where the JAX server stores it and compresses
only when booted with `compress_enabled`.
"""

from __future__ import annotations

import json
import os
import threading

from ..bucket.metadata import META_BUCKET
from ..storage.errors import StorageError

CONFIG_PATH = "config/config.json"
ENV_PREFIX = "MTPU"

def _truthy(value: str) -> bool:
    return value.lower() in ("on", "true", "1")


class HelpKV:
    def __init__(self, key: str, description: str, optional: bool = True,
                 type_: str = "string"):
        self.key = key
        self.description = description
        self.optional = optional
        self.type = type_


class ConfigSys:
    def __init__(self, pools=None, meta_bucket: str = META_BUCKET,
                 env: dict | None = None):
        self.pools = pools
        self.meta_bucket = meta_bucket
        self._env = env if env is not None else os.environ
        self._mu = threading.RLock()
        self._defaults: dict[str, dict[str, str]] = {}
        self._help: dict[str, list[HelpKV]] = {}
        self._stored: dict[str, dict[str, str]] = {}
        self._listeners: dict[str, list] = {}
        self.on_write = None
        self._register_builtin()
        self.load()

    # -- registry ------------------------------------------------------------

    def register(self, subsys: str, defaults: dict[str, str],
                 help_: list[HelpKV] | None = None) -> None:
        with self._mu:
            self._defaults[subsys] = dict(defaults)
            self._help[subsys] = list(help_ or [])

    def _register_builtin(self) -> None:
        self.register("api", {
            "requests_max": "0", "cors_allow_origin": "*",
            "delete_cleanup_interval": "5m"},
            [HelpKV("requests_max", "max concurrent requests (0=auto)")])
        self.register("storage_class", {
            "standard": "EC:2", "rrs": "EC:1"},
            [HelpKV("standard", "default parity, e.g. EC:4")])
        self.register("compression", {
            "enable": "off", "extensions": "", "mime_types": ""},
            [HelpKV("enable", "transparent compression on/off")])
        self.register("scanner", {
            "speed": "default", "idle_speed": ""},
            [HelpKV("speed", "scanner aggressiveness")])
        self.register("heal", {
            "bitrotscan": "off", "max_sleep": "250ms", "max_io": "100"},
            [HelpKV("bitrotscan", "deep bitrot verify during heal")])
        self.register("logger_webhook", {"enable": "off", "endpoint": ""})
        self.register("audit_webhook", {"enable": "off", "endpoint": ""})
        # Event-target subsystems (cf. internal/config/notify): one per
        # wire target; enable=on + connection keys -> a live target with
        # ARN arn:minio:sqs::<id>:<kind> at server boot.
        self.register("notify_webhook", {"enable": "off", "endpoint": ""})
        self.register("notify_kafka", {"enable": "off", "brokers": "",
                                       "topic": ""})
        self.register("notify_amqp", {"enable": "off", "url": "",
                                      "exchange": "",
                                      "routing_key": ""})
        self.register("notify_nats", {"enable": "off", "address": "",
                                      "subject": ""})
        self.register("notify_mqtt", {"enable": "off", "broker": "",
                                      "topic": ""})
        self.register("notify_redis", {"enable": "off", "address": "",
                                       "key": "", "format": "access"})
        self.register("notify_postgres", {"enable": "off", "address": "",
                                          "table": "",
                                          "format": "access",
                                          "user": "minio",
                                          "database": "minio"})
        self.register("notify_mysql", {"enable": "off", "address": "",
                                       "table": "", "format": "access",
                                       "user": "minio",
                                       "database": "minio"})
        self.register("notify_elasticsearch", {"enable": "off",
                                               "address": "",
                                               "index": "",
                                               "format": "access"})
        self.register("notify_nsq", {"enable": "off",
                                     "nsqd_address": "", "topic": ""})
        self.register("identity_openid", {"enable": "off",
                                          "config_url": ""})
        self.register("kms", {"enable": "off", "key_id": ""})
        self.register("region", {"name": "us-east-1"})

    # -- resolution: env > stored > default ----------------------------------

    def get(self, subsys: str, key: str) -> str:
        env_name = f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}"
        if env_name in self._env:
            return self._env[env_name]
        with self._mu:
            if key in self._stored.get(subsys, {}):
                return self._stored[subsys][key]
            return self._defaults.get(subsys, {}).get(key, "")

    def get_subsys(self, subsys: str) -> dict[str, str]:
        with self._mu:
            out = dict(self._defaults.get(subsys, {}))
            out.update(self._stored.get(subsys, {}))
        for key in list(out):
            env_name = f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}"
            if env_name in self._env:
                out[key] = self._env[env_name]
        return out

    def set(self, subsys: str, key: str, value: str) -> None:
        with self._mu:
            if subsys not in self._defaults:
                raise KeyError(f"unknown config subsystem {subsys!r}")
            if key not in self._defaults[subsys]:
                raise KeyError(f"unknown key {subsys}.{key}")
            self._stored.setdefault(subsys, {})[key] = value
        self.save()
        self._written()
        for fn in self._listeners.get(subsys, []):
            fn(subsys, key, value)

    def unset(self, subsys: str, key: str) -> None:
        with self._mu:
            self._stored.get(subsys, {}).pop(key, None)
        self.save()
        self._written()

    def _written(self) -> None:
        if self.on_write is not None:
            self.on_write()

    def on_change(self, subsys: str, fn) -> None:
        """Dynamic-config listener (cf. dynamic keys applying without
        restart, internal/config/config.go:343)."""
        self._listeners.setdefault(subsys, []).append(fn)

    # -- persistence ---------------------------------------------------------

    def save(self) -> None:
        if self.pools is None:
            return
        with self._mu:
            data = json.dumps(self._stored, sort_keys=True).encode()
        self.pools.put_object(self.meta_bucket, CONFIG_PATH, data)

    def load(self) -> None:
        """Read the stored values again (another process wrote them)."""
        if self.pools is None:
            return
        try:
            _, data = self.pools.get_object(self.meta_bucket, CONFIG_PATH)
            stored = json.loads(bytes(data))
        except (StorageError, ValueError):
            return
        with self._mu:
            self._stored = {s: dict(kv) for s, kv in stored.items()
                            if isinstance(kv, dict)}

    # -- help (self-documenting, cf. initHelp cmd/config-current.go) --------

    def help(self, subsys: str = "") -> dict:
        with self._mu:
            if subsys:
                return {subsys: [
                    {"key": h.key, "description": h.description}
                    for h in self._help.get(subsys, [])]}
            return {"subsystems": sorted(self._defaults)}

    # -- typed accessors -----------------------------------------------------

    def parity_for_class(self, storage_class: str = "standard") -> int | None:
        v = self.get("storage_class", storage_class.lower())
        if v.upper().startswith("EC:"):
            try:
                return int(v[3:])
            except ValueError:
                return None
        return None

    def compression_enabled(self) -> bool:
        return _truthy(self.get("compression", "enable"))
