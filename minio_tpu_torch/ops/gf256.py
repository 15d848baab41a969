"""Copy of minio_tpu/ops/gf256.py: the port keeps its own, so that it imports
nothing of the JAX package.

GF(2^8) arithmetic for Reed-Solomon erasure coding.

Field: GF(2^8) with generator polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D)
and generator element 2 — the same field as klauspost/reedsolomon (the codec
behind the reference's `Erasure` struct, reference cmd/erasure-coding.go:63),
so shard bytes produced here are interoperable with the reference on-disk format.

Two representations are maintained:

1. Byte-level log/exp and full 256x256 multiplication tables (numpy, host side)
   — used for matrix construction/inversion and the CPU oracle codec.
2. Bit-matrix decomposition: multiplication by a constant c is GF(2)-linear on
   the 8 bit-planes of the operand, i.e. y = M_c @ x (mod 2) for an 8x8 binary
   matrix M_c. This turns the entire (parity x data) GF(2^8) coding matmul into
   a ((8*parity) x (8*data)) binary matmul over bit-planes — which is exactly
   the shape the TPU MXU wants (the JAX package's ops/erasure_pallas.py; here ops/erasure_cuda.py).
"""

from __future__ import annotations

import functools

import numpy as np

# Generator polynomial for GF(2^8): x^8+x^4+x^3+x^2+1.
POLY = 0x11D


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build exp/log tables for GF(2^8) with generator 2."""
    exp = np.zeros(512, dtype=np.uint8)  # doubled to avoid mod in hot paths
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = -1  # log(0) undefined; sentinel
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Multiply two field elements."""
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]])


def gf_div(a: int, b: int) -> int:
    """Divide a by b in the field. b must be nonzero."""
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_inv(a: int) -> int:
    """Multiplicative inverse."""
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_exp(a: int, n: int) -> int:
    """a ** n in the field; matches klauspost galExp (a=0,n=0 -> 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


@functools.cache
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table, MUL[a, b] = a*b in GF(2^8)."""
    la = LOG_TABLE.copy()
    la[0] = 0
    s = la[:, None] + la[None, :]
    t = EXP_TABLE[s]
    t[0, :] = 0
    t[:, 0] = 0
    return t.astype(np.uint8)


# ---------------------------------------------------------------------------
# Vectorized numpy field ops on uint8 arrays.
# ---------------------------------------------------------------------------

def gf_mul_vec(c: int, x: np.ndarray) -> np.ndarray:
    """Multiply every byte of x by constant c."""
    if c == 0:
        return np.zeros_like(x)
    if c == 1:
        return x.copy()
    return mul_table()[c][x]


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix multiply: a (m,k) uint8 @ b (k,n) uint8 -> (m,n) uint8.

    Host-side reference path (small m,k; n can be large). XOR-accumulates
    table-lookup rows; used by the CPU oracle codec and matrix algebra.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    mt = mul_table()
    out = np.zeros((m, n), dtype=np.uint8)
    for i in range(m):
        acc = out[i]
        row = a[i]
        for j in range(k):
            c = row[j]
            if c == 0:
                continue
            acc ^= mt[c][b[j]]
        out[i] = acc
    return out


# ---------------------------------------------------------------------------
# Matrix algebra over GF(2^8) (small matrices, host side).
# ---------------------------------------------------------------------------

def gf_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def gf_mat_invert(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix via Gauss-Jordan elimination.

    Raises ValueError if singular (matches klauspost errSingular behavior).
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    mt = mul_table()
    # Augmented [m | I] as int work array.
    work = np.concatenate([m.copy(), gf_identity(n)], axis=1)
    for r in range(n):
        if work[r, r] == 0:
            # Find a pivot row below.
            below = np.nonzero(work[r + 1:, r])[0]
            if below.size == 0:
                raise ValueError("singular matrix")
            swap = r + 1 + below[0]
            work[[r, swap]] = work[[swap, r]]
        # Scale pivot row to 1.
        pivot = int(work[r, r])
        if pivot != 1:
            inv = gf_inv(pivot)
            work[r] = mt[inv][work[r]]
        # Eliminate all other rows.
        for rr in range(n):
            if rr != r and work[rr, r] != 0:
                work[rr] ^= mt[int(work[rr, r])][work[r]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """Vandermonde matrix m[r, c] = r^c in GF(2^8) (klauspost `vandermonde`)."""
    m = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            m[r, c] = gf_exp(r, c)
    return m


@functools.cache
def build_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic coding matrix identical to klauspost/reedsolomon's default.

    Extended Vandermonde times the inverse of its top square: the top
    data_shards rows become the identity, the remaining rows are the parity
    coding rows. Any data_shards x data_shards submatrix is invertible.
    """
    vm = vandermonde(total_shards, data_shards)
    top = vm[:data_shards, :data_shards]
    top_inv = gf_mat_invert(top)
    return gf_matmul(vm, top_inv)


@functools.cache
def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (parity x data) rows of the systematic coding matrix."""
    full = build_matrix(data_shards, data_shards + parity_shards)
    return full[data_shards:, :].copy()


# ---------------------------------------------------------------------------
# Bit-matrix decomposition (the TPU-enabling transform).
# ---------------------------------------------------------------------------

@functools.cache
def _const_mul_bit_matrices() -> np.ndarray:
    """B[c] is the 8x8 GF(2) matrix of multiplication by c.

    Column j of B[c] is the byte c * 2^j as bits (LSB-first), because
    y = c*x = XOR_j x_j * (c * 2^j).
    Returned shape: (256, 8, 8) uint8 with B[c, i, j] = bit i of (c * 2^j).
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for j in range(8):
            v = gf_mul(c, 1 << j)
            for i in range(8):
                out[c, i, j] = (v >> i) & 1
    return out


def expand_matrix_to_bits(gf_matrix: np.ndarray) -> np.ndarray:
    """Expand an (m, k) GF(2^8) matrix to the (8m, 8k) GF(2) bit matrix.

    With data bytes unpacked to bit-planes (row k*8+j = bit j of shard k),
    `bits_out = (expanded @ bits_in) mod 2` computes the GF(2^8) matmul.
    """
    gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gf_matrix.shape
    b = _const_mul_bit_matrices()
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = b[gf_matrix[i, j]]
    return out


def unpack_bits(x: np.ndarray) -> np.ndarray:
    """(k, n) uint8 -> (8k, n) bit-planes, row k*8+j = bit j (LSB-first)."""
    k, n = x.shape
    planes = ((x[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1)
    return planes.reshape(8 * k, n)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(8m, n) bit-planes -> (m, n) uint8 (inverse of unpack_bits)."""
    m8, n = bits.shape
    assert m8 % 8 == 0
    b = bits.reshape(m8 // 8, 8, n).astype(np.uint8)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    return (b.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)
