"""Server configuration: defaults -> persisted KVS -> environment.

The part of minio_tpu/config/config.py the S3 front door reads: the
`storage_class` subsystem, which maps x-amz-storage-class to a parity
count (cf. GetParityForSC, cmd/erasure-object.go:761).  Stored values
persist under the meta bucket at the JAX package's path, so either
package reads what the other stored; `MTPU_<SUBSYS>_<KEY>` environment
variables win over both (the reference's env-over-stored merge,
internal/config/config.go:261).  The admin config API that writes it
waits for ROADMAP.md Queue A item 10.
"""

from __future__ import annotations

import json
import os
import threading

from ..bucket.metadata import META_BUCKET
from ..storage.errors import StorageError

CONFIG_PATH = "config/config.json"
ENV_PREFIX = "MTPU"
DEFAULTS = {"storage_class": {"standard": "EC:2", "rrs": "EC:1"}}


class ConfigSys:
    def __init__(self, pools):
        self.pools = pools
        self._mu = threading.Lock()
        self._stored: dict[str, dict[str, str]] = {}
        self.load()

    def get(self, subsys: str, key: str) -> str:
        """env > stored > default."""
        env_name = f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}"
        if env_name in os.environ:
            return os.environ[env_name]
        with self._mu:
            if key in self._stored.get(subsys, {}):
                return self._stored[subsys][key]
        return DEFAULTS.get(subsys, {}).get(key, "")

    def load(self) -> None:
        try:
            _, data = self.pools.get_object(META_BUCKET, CONFIG_PATH)
            stored = json.loads(bytes(data))
        except (StorageError, ValueError):
            return
        with self._mu:
            self._stored = {s: dict(kv) for s, kv in stored.items()
                            if isinstance(kv, dict)}

    def parity_for_class(self, storage_class: str = "standard") -> int | None:
        v = self.get("storage_class", storage_class.lower())
        if v.upper().startswith("EC:"):
            try:
                return int(v[3:])
            except ValueError:
                return None
        return None
