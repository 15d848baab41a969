"""The MTPU_ZEROCOPY switch (the gate of minio_tpu/ops/zerocopy.py).

Zero-copy IO on the host: the pooled PUT ingest ring
(utils/streams.batched_chunks) and the vectored staged-shard writes
(storage/drive.LocalDrive.write_file_batches).  Default on;
MTPU_ZEROCOPY=0 is the byte-identical oracle, under which every caller
keeps its copying path.

The send half of the JAX module (`send_gather`, `send_file`,
`FilePlan`, with the drive's `open_read_fd` and `read_file_view` and
the engine's `sendfile_plan`) waits for the serving-spine planes
(ROADMAP Queue A item 7).
"""

from __future__ import annotations

import os


def zerocopy_enabled() -> bool:
    """Default ON; =0 is the byte-identical copying oracle.  Read per
    call, so tests flip it live."""
    return os.environ.get("MTPU_ZEROCOPY", "1") != "0"
