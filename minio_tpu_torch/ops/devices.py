"""Device resolution and erasure-set -> device affinity (torch).

Counterpart of minio_tpu/ops/devices.py.  The port decides its device
explicitly: every entry point takes `device=None`, which means the CUDA
card (the set's affine card, `set_index % n_devices()`), and runs on the
host CPU only when the caller passes `device="cpu"`, as the tests do.
Without CUDA and without that explicit request it raises; it never
carries on silently on the CPU.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import devcache


def n_devices() -> int:
    """Number of CUDA cards the sets are spread over (at least 1)."""
    return max(1, torch.cuda.device_count())


def device_for_set(set_index: int) -> int:
    """Card index of an erasure set: the same modulo-of-deterministic-
    index scheme as its placement among sets, one layer down."""
    return int(set_index) % n_devices()


def resolve(device=None, set_index: int = 0) -> torch.device:
    """The torch.device an entry point runs on.

    None -> `cuda:<device_for_set(set_index)>`; a string, int or
    torch.device is taken as given.  A CUDA device without CUDA raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: minio_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the host")
        return torch.device("cuda", device_for_set(set_index))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def put(x, device) -> torch.Tensor:
    """Host bytes -> a contiguous uint8 tensor on `device` (one copy to
    the card; a tensor already there passes through).  Bytes that come
    from the host are counted in the ledger of ops/devcache.py."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        if x.device.type == "cpu" and dev.type != "cpu":
            devcache.note_h2d(x.nbytes, devcache.card_index(dev))
        return x.to(dev).contiguous()
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint8))
    devcache.note_h2d(arr.nbytes, devcache.card_index(dev))
    with warnings.catch_warnings():
        # Views of immutable bytes are read-only; nothing writes them.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if dev.type == "cpu":
        return t
    return t.to(dev)
