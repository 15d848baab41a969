"""The port's GF(2^8) codec (minio_tpu_torch.ops.erasure_torch and the
CPU side of erasure_cuda) against the JAX package: the XLA bit-plane path
and the Pallas kernel in interpret mode.  Integer arithmetic throughout,
so every comparison is byte-exact (tolerance 0).

The CUDA kernel itself needs the card; chip_smoke.py holds it against
the plain version there.  Here its arithmetic is checked through a numpy
emulation of its nibble-table lookups."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import erasure_jax, erasure_pallas
from minio_tpu.ops.erasure_cpu import ReedSolomonCPU
from minio_tpu_torch.ops import erasure_cuda, erasure_torch
from minio_tpu_torch.ops.erasure_torch import ReedSolomon

GRID = [(2, 2), (8, 4), (5, 3), (14, 2)]
LOST = [
    (8, 4, (0, 3, 9, 11)),   # 2 data + 2 parity lost
    (8, 4, (0, 1, 2, 3)),    # worst case: 4 data lost
    (2, 2, (1, 2)),
    (4, 2, (5,)),            # parity-only loss
]


def _blocks(b, k, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, k, s),
                                                dtype=np.uint8)


def _jax_xla(mat, x, rows):
    return np.asarray(erasure_jax._gf_matmul_blocks(
        jnp.asarray(mat, dtype=jnp.bfloat16), jnp.asarray(x), rows))


def _jax_pallas_interpret(mat, x, rows, salt=None):
    erasure_pallas.FORCE_INTERPRET = True
    try:
        return np.asarray(erasure_pallas.gf_matmul_blocks(
            mat, jnp.asarray(x), rows,
            salt=None if salt is None else jnp.asarray([salt], jnp.int32)))
    finally:
        erasure_pallas.FORCE_INTERPRET = False


def _emulate_kernel(mat, x, rows):
    """The CUDA kernel's arithmetic in numpy: out[b, r] = XOR_c
    LO[r, c][x & 15] ^ HI[r, c][x >> 4] with the wrapper's tables."""
    t = erasure_cuda.nibble_tables(mat)
    out = np.zeros((x.shape[0], rows, x.shape[2]), dtype=np.uint8)
    for r in range(rows):
        for c in range(x.shape[1]):
            out[:, r] ^= t[r, c][x[:, c] & 15] ^ t[r, c][16 + (x[:, c] >> 4)]
    return out


@pytest.mark.parametrize("k,m", GRID)
def test_encode_matrix_bits_equal(k, m):
    assert np.array_equal(erasure_torch._encode_matrix_bits(k, m),
                          erasure_jax._encode_matrix_bits(k, m))


@pytest.mark.parametrize("k,m,lost", LOST)
def test_transform_matrix_bits_equal(k, m, lost):
    sources = tuple(i for i in range(k + m) if i not in lost)
    targets = tuple(i for i in lost if i < k + m)
    assert np.array_equal(
        erasure_torch._transform_matrix_bits(k, m, sources, targets),
        erasure_jax._transform_matrix_bits(k, m, sources, targets))


@pytest.mark.parametrize("s", [256, 100])
@pytest.mark.parametrize("k,m", GRID)
def test_encode_matches_jax(k, m, s):
    x = _blocks(3, k, s, seed=k * 100 + m + s)
    got = ReedSolomon(k, m, device="cpu").encode_blocks(x).numpy()
    mat = erasure_jax._encode_matrix_bits(k, m)
    assert np.array_equal(got, _jax_xla(mat, x, m))
    assert np.array_equal(got, _jax_pallas_interpret(mat, x, m))
    cpu = ReedSolomonCPU(k, m)
    for b in range(x.shape[0]):
        assert np.array_equal(got[b], np.stack(cpu.encode(list(x[b]))[k:]))


@pytest.mark.parametrize("k,m,lost", LOST)
def test_reconstruct_matches_jax(k, m, lost):
    x = _blocks(3, k, 128, seed=42)
    rs = ReedSolomon(k, m, device="cpu")
    full = np.concatenate([x, rs.encode_blocks(x).numpy()], axis=1)
    shards = [None if i in lost else full[:, i, :] for i in range(k + m)]
    out = rs.reconstruct_blocks(shards)
    for i in range(k + m):
        assert np.array_equal(np.asarray(out[i]), full[:, i, :]), i
    sources = tuple(i for i in range(k + m) if i not in lost)[:k]
    targets = tuple(lost)
    mat = erasure_jax._transform_matrix_bits(k, m, sources, targets)
    got = rs.transform_blocks(full[:, list(sources), :], sources,
                              targets).numpy()
    assert np.array_equal(got, _jax_pallas_interpret(
        mat, full[:, list(sources), :], len(targets)))


def test_heal_style_transform_subset():
    k, m = 6, 3
    x = _blocks(2, k, 192, seed=9)
    rs = ReedSolomon(k, m, device="cpu")
    full = np.concatenate([x, rs.encode_blocks(x).numpy()], axis=1)
    sources = (1, 2, 3, 5, 6, 8)   # 4 data rows + 2 parity rows
    targets = (0, 7)               # one data, one parity
    got = rs.transform_blocks(full[:, list(sources), :], sources,
                              targets).numpy()
    assert np.array_equal(got[:, 0], full[:, 0])
    assert np.array_equal(got[:, 1], full[:, 7])
    ref = erasure_jax.ReedSolomonTPU(k, m, use_pallas=False).transform_blocks(
        full[:, list(sources), :], sources, targets)
    assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("s", [1, 17, 100, 4097, 43691])
def test_odd_shard_sizes(s):
    k, m = 8, 4
    x = _blocks(2, k, s, seed=s)
    mat = erasure_jax._encode_matrix_bits(k, m)
    got = ReedSolomon(k, m, device="cpu").encode_blocks(x).numpy()
    assert np.array_equal(got, _jax_xla(mat, x, m))
    assert np.array_equal(got, _emulate_kernel(mat, x, m))


@pytest.mark.parametrize("salt", [0x5A, 0x1FF])
def test_salted_matches_pallas_interpret(salt):
    k, m = 8, 4
    x = _blocks(2, k, 256, seed=salt)
    mat = erasure_jax._encode_matrix_bits(k, m)
    got = ReedSolomon(k, m, device="cpu").encode_blocks(x, salt=salt).numpy()
    assert np.array_equal(got, _jax_pallas_interpret(mat, x, m, salt=salt))
    assert np.array_equal(got, _jax_xla(mat, x ^ np.uint8(salt & 0xFF), m))


@pytest.mark.parametrize("k,m,lost", LOST)
def test_kernel_tables_emulation(k, m, lost):
    """The wrapper's nibble tables reproduce the plain version for
    encode and decode matrices (the kernel's arithmetic, on the host)."""
    x = _blocks(2, k, 96, seed=len(lost))
    enc = erasure_torch._encode_matrix_bits(k, m)
    ref = erasure_torch.gf_matmul_blocks_ref(enc, torch.from_numpy(x), m)
    assert np.array_equal(_emulate_kernel(enc, x, m), ref.numpy())
    sources = tuple(i for i in range(k + m) if i not in lost)[:k]
    mat = erasure_torch._transform_matrix_bits(k, m, sources, tuple(lost))
    ref = erasure_torch.gf_matmul_blocks_ref(mat, torch.from_numpy(x),
                                             len(lost))
    assert np.array_equal(_emulate_kernel(mat, x, len(lost)), ref.numpy())


def test_wrapper_cpu_tensor_runs_plain_version():
    k, m = 4, 2
    x = torch.from_numpy(_blocks(2, k, 64, seed=1))
    mat = erasure_torch._encode_matrix_bits(k, m)
    before = erasure_cuda.LAUNCHES
    got = erasure_cuda.gf_matmul_blocks(mat, x, m)
    assert erasure_cuda.LAUNCHES == before      # no kernel on the host
    assert torch.equal(got, erasure_torch.gf_matmul_blocks_ref(mat, x, m))


def test_wrapper_checks_inputs():
    mat = erasure_torch._encode_matrix_bits(4, 2)
    with pytest.raises(TypeError):
        erasure_cuda.gf_matmul_blocks(mat, torch.zeros(2, 4, 8), 2)
    with pytest.raises(ValueError):
        erasure_cuda.gf_matmul_blocks(
            mat, torch.zeros(2, 5, 8, dtype=torch.uint8), 2)
