"""Reed-Solomon codec on torch tensors: GF(2^8) shard math on the card.

Counterpart of minio_tpu/ops/erasure_jax.py.  Multiplying by a constant
in GF(2^8) is linear over GF(2), so any codec step (encode, decode,
reconstruct, heal) is one small host-built matrix applied to a batch of
shards: (B, C, S) uint8 -> (B, R, S) uint8.  The matrix travels as the
JAX package's (8R, 8C) plane-major GF(2) bit matrix, built here by the
same host code, so both packages apply the same "weights" bit for bit.

- `gf_matmul_blocks_ref` is the plain PyTorch version: unpack bit-planes,
  a float32 0/1 matmul (exact: sums <= 128), mod 2, pack.  The CPU tests
  run it and `chip_smoke.py` holds the CUDA kernel against it.
- `ReedSolomon` has the seam of `ReedSolomonTPU`; every matrix product
  goes through `erasure_cuda.gf_matmul_blocks`, which launches the
  hand-written Hopper kernel for a CUDA tensor and runs the plain version
  for a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import devices, erasure_cuda, gf256

# ---------------------------------------------------------------------------
# Host-side matrix preparation (same code as erasure_jax.py:41-79).
# ---------------------------------------------------------------------------


def _plane_major_bits(gf_matrix: np.ndarray) -> np.ndarray:
    """Expand an (R, C) GF(2^8) matrix to plane-major (8R, 8C) GF(2) bits.

    out[i*R + r, j*C + c] = bit i of (gf_matrix[r, c] * 2^j).
    """
    gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
    r, c = gf_matrix.shape
    bits = gf256.expand_matrix_to_bits(gf_matrix)  # byte-major (8r, 8c)
    row_src = (np.arange(r)[None, :] * 8 + np.arange(8)[:, None]).ravel()
    col_src = (np.arange(c)[None, :] * 8 + np.arange(8)[:, None]).ravel()
    return bits[row_src][:, col_src]


@functools.lru_cache(maxsize=256)
def _encode_matrix_bits(data_shards: int, parity_shards: int) -> np.ndarray:
    return _plane_major_bits(gf256.parity_matrix(data_shards, parity_shards))


@functools.lru_cache(maxsize=4096)
def _transform_matrix_bits(data_shards: int, parity_shards: int,
                           sources: tuple[int, ...],
                           targets: tuple[int, ...]) -> np.ndarray:
    """Bit matrix mapping `sources` shard rows -> `targets` shard rows.

    sources: indices of >= data_shards available shards (first K used);
    targets: any shard indices to (re)compute.
    """
    k = data_shards
    full = gf256.build_matrix(k, k + parity_shards)
    use = list(sources)[:k]
    inv = gf256.gf_mat_invert(full[use, :])
    target_rows = full[list(targets), :]
    return _plane_major_bits(gf256.gf_matmul(target_rows, inv))


# ---------------------------------------------------------------------------
# The plain PyTorch version (erasure_jax.py:86-113).
# ---------------------------------------------------------------------------


def gf_matmul_blocks_ref(mat_bits, x: torch.Tensor, rows: int,
                         salt: int | None = None) -> torch.Tensor:
    """Batched GF(2^8) matmul via bit-planes, in plain torch ops.

    mat_bits: (8R, 8C) plane-major 0/1 matrix (numpy or tensor);
    x: (B, C, S) uint8 tensor; salt: optional int whose low byte is XORed
    into every input byte first.  Returns (B, R, S) uint8 on x's device.
    """
    if isinstance(mat_bits, torch.Tensor):
        mat = mat_bits.to(device=x.device, dtype=torch.float32)
    else:
        mat = torch.from_numpy(
            np.asarray(mat_bits, dtype=np.float32)).to(x.device)
    if salt is not None:
        x = x ^ (int(salt) & 0xFF)
    b, c, s = x.shape
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=x.device).view(1, 8, 1, 1)
    planes = ((x.unsqueeze(1) >> shifts) & 1).reshape(b, 8 * c, s)
    y = torch.einsum("rc,bcs->brs", mat, planes.to(torch.float32))
    bits = (y.to(torch.int32) & 1).reshape(b, 8, rows, s)
    weights = (torch.ones(8, dtype=torch.int32, device=x.device)
               << torch.arange(8, dtype=torch.int32, device=x.device))
    return (bits * weights.view(1, 8, 1, 1)).sum(dim=1).to(torch.uint8)


class ReedSolomon:
    """Device codec with the narrow seam of `ReedSolomonTPU`.

    Inputs are (B, K, S) uint8 arrays or tensors; they are placed on the
    codec's device once and every result stays there.  `salt` is the
    benchmark protocol's per-call input XOR (production passes None).
    """

    def __init__(self, data_shards: int, parity_shards: int, device=None):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.device = devices.resolve(device)

    def _apply(self, mat_bits: np.ndarray, x, rows: int,
               salt: int | None = None) -> torch.Tensor:
        x = devices.put(x, self.device)
        return erasure_cuda.gf_matmul_blocks(mat_bits, x, rows, salt=salt)

    def encode_blocks(self, data, salt: int | None = None) -> torch.Tensor:
        """(B, K, S) data shards -> (B, M, S) parity shards."""
        mat = _encode_matrix_bits(self.data_shards, self.parity_shards)
        return self._apply(mat, data, self.parity_shards, salt=salt)

    def transform_blocks(self, shards, sources: tuple[int, ...],
                         targets: tuple[int, ...],
                         salt: int | None = None) -> torch.Tensor:
        """(B, K, S) shards at rows `sources[:K]` -> (B, T, S) rows
        `targets`: the one decode/heal primitive."""
        mat = _transform_matrix_bits(self.data_shards, self.parity_shards,
                                     tuple(sources), tuple(targets))
        return self._apply(mat, shards, len(targets), salt=salt)

    def reconstruct_blocks(self, shards: list, data_only: bool = False
                           ) -> list:
        """Fill missing (None) entries of a total_shards-list of (B, S)
        arrays or tensors; filled entries are tensors on the device."""
        available = [i for i, s in enumerate(shards) if s is not None]
        if len(available) < self.data_shards:
            raise ValueError("too few shards to reconstruct")
        limit = self.data_shards if data_only else self.total_shards
        missing = [i for i in range(limit)
                   if i < len(shards) and shards[i] is None]
        if not missing:
            return list(shards)
        use = available[:self.data_shards]
        x = torch.stack([devices.put(shards[i], self.device) for i in use],
                        dim=1)                                  # (B, K, S)
        out = self.transform_blocks(x, tuple(use), tuple(missing))
        result = list(shards)
        for j, idx in enumerate(missing):
            result[idx] = out[:, j, :]
        return result
