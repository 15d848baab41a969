"""The port's GF(2^8) codec (minio_tpu_torch.ops.erasure_torch and the
CPU side of erasure_cuda) against the JAX package: the XLA bit-plane path
and the Pallas kernel in interpret mode.  Integer arithmetic throughout,
so every comparison is byte-exact (tolerance 0).

The CUDA kernel (minio_tpu_torch/csrc/gf_matmul.cu) needs the card;
chip_smoke.py holds it against the plain version there.  Here a numpy
model follows it word by word: the wrapper's row-packed tables, the
lookup offsets cut out of each input word by its nibble mask and one byte
permute (selector kOffsetSel + k), one accumulator word per column whose
bytes are four output rows, and the 4x4 byte transpose by the permute
table kTransposeSel, both parsed from the source, with CUDA's __byte_perm
emulated.  (erasure_pallas.gf_matmul_blocks runs its kernel in interpret
mode where S is a multiple of 128 and its XLA fallback elsewhere.)"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import erasure_jax, erasure_pallas
from minio_tpu.ops.erasure_cpu import ReedSolomonCPU
from minio_tpu_torch.ops import erasure_cuda, erasure_torch
from minio_tpu_torch.ops.erasure_torch import ReedSolomon

GF_CU = (Path(__file__).resolve().parent.parent / "minio_tpu_torch"
         / "csrc" / "gf_matmul.cu")
U64 = np.uint64
SIZES = [1, 17, 4097, 38401]
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


def byte_perm(x, y, sel: int) -> np.ndarray:
    """PTX `prmt.b32` in its default mode (CUDA's __byte_perm) on uint32
    arrays: byte b of the result is byte (sel >> 4b) & 7 of the eight
    bytes x (0-3), y (4-7); where bit 3 of that nibble is set, the chosen
    byte's top bit is replicated over the byte."""
    both = (np.asarray(y, dtype=U64) << U64(32)) | np.asarray(x, dtype=U64)
    out = np.zeros(both.shape, dtype=U64)
    for b in range(4):
        nibble = (sel >> (4 * b)) & 0xF
        byte = (both >> U64(8 * (nibble & 7))) & U64(0xFF)
        if nibble & 8:
            byte = np.where(byte & U64(0x80), U64(0xFF), U64(0))
        out |= byte << U64(8 * b)
    return out.astype(np.uint32)


def source_constants():
    """(nibble mask, offset selector, transpose steps) of the kernel,
    parsed from its source; a step is (x, y, sel)."""
    text = GF_CU.read_text()
    mask = int(re.search(r"kNibbleMask = (0x[0-9a-fA-F]+)u", text).group(1),
               16)
    osel = int(re.search(r"kOffsetSel = (0x[0-9a-fA-F]+)u", text).group(1),
               16)
    body = re.search(r"kTransposeSel\[8\] = \{(.*?)\n\s*\};", text,
                     re.S).group(1)
    steps = [(int(x), int(y), int(s, 16)) for x, y, s in
             re.findall(r"\{(\d+), (\d+), (0x[0-9a-fA-F]+)\}", body)]
    assert len(steps) == 8, body
    return mask, osel, steps


def _emulate_kernel(mat, x, rows, salt=None):
    """(B, C, S) uint8 -> (B, R, S) as the kernel computes it."""
    mask, osel, steps = source_constants()
    t = erasure_cuda.nibble_tables(mat)                 # (G, C, 2, 16)
    b, c, s = x.shape
    s16 = -(-s // 16) * 16                 # a thread's 16 columns
    xp = np.zeros((b, c, s16), dtype=np.uint8)
    xp[..., :s] = x
    w = xp.view("<u4").astype(np.uint32)                # (B, C, s16 / 4)
    if salt is not None:
        w ^= np.uint32((salt & 0xFF) * 0x01010101)
    out = np.zeros((b, 4 * t.shape[0], s16), dtype=np.uint8)
    for g in range(t.shape[0]):
        acc = np.zeros((4,) + w[:, 0].shape, dtype=np.uint32)  # column k
        for ci in range(c):
            lo4 = (w[:, ci] << np.uint32(2)) & np.uint32(mask)
            hi4 = (w[:, ci] >> np.uint32(2)) & np.uint32(mask)
            for k in range(4):
                off_lo = byte_perm(lo4, 0, osel + k)   # byte offsets
                off_hi = byte_perm(hi4, 0, osel + k)
                assert not ((off_lo | off_hi) & 3).any()
                assert (off_lo < 64).all() and (off_hi < 64).all()
                acc[k] ^= t[g, ci, 0][off_lo >> 2] ^ t[g, ci, 1][off_hi >> 2]
        v = list(acc) + [None] * 8
        for i, (sx, sy, sel) in enumerate(steps):
            v[4 + i] = byte_perm(v[sx], v[sy], sel)
        for r in range(4):
            out[:, 4 * g + r] = np.ascontiguousarray(
                v[8 + r].astype("<u4")).view(np.uint8).reshape(b, s16)
    return out[:, :rows, :s]


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


def _check(mat, x, rows, salt=None):
    got = _emulate_kernel(mat, x, rows, salt=salt)
    assert got.shape == (x.shape[0], rows, x.shape[2])
    xs = x if salt is None else x ^ np.uint8(salt & 0xFF)
    assert np.array_equal(got, _jax_xla(mat, xs, rows))
    assert np.array_equal(got, _jax_pallas_interpret(mat, x, rows, salt))


def test_byte_perm_follows_prmt():
    x, y = np.uint32(0x44332211), np.uint32(0x88776655)
    assert byte_perm(x, y, 0x3210) == x
    assert byte_perm(x, y, 0x7654) == y
    assert byte_perm(x, y, 0x0415) == 0x11552266
    assert byte_perm(x, y, 0x4441) == 0x55555522   # an offset selector


def test_transpose_table_transposes_4x4_bytes():
    _, _, steps = source_constants()
    cols = np.random.default_rng(3).integers(0, 1 << 32, (4, 64),
                                             dtype=np.uint64
                                             ).astype(np.uint32)
    v = list(cols) + [None] * 8
    for i, (sx, sy, sel) in enumerate(steps):
        v[4 + i] = byte_perm(v[sx], v[sy], sel)
    m = cols.astype("<u4").view(np.uint8).reshape(4, 64, 4)  # [k, n, r]
    for r in range(4):
        want = np.ascontiguousarray(m[:, :, r].T).view("<u4")[:, 0]
        assert np.array_equal(v[8 + r], want)


def test_packed_tables_layout():
    """Byte r' of [g, c, h, v] is M[4g + r', c] times v (h = 0) or
    v << 4 (h = 1); rows past R are zero."""
    mat = erasure_torch._encode_matrix_bits(5, 3)
    t = erasure_cuda.nibble_tables(mat)
    assert t.shape == (1, 5, 2, 16) and t.dtype == np.uint32
    assert not (t >> np.uint32(24)).any()             # row 3 of 3: none
    assert not t[:, :, :, 0].any()                    # M * 0 = 0
    for c in range(5):
        x = np.zeros((1, 5, 32), dtype=np.uint8)
        x[0, c, :16] = np.arange(16)
        x[0, c, 16:] = np.arange(16) << 4
        ref = erasure_torch.gf_matmul_blocks_ref(mat, torch.from_numpy(x),
                                                 3).numpy()[0]
        for r in range(3):
            got = (t[0, c].reshape(32) >> np.uint32(8 * r)) & 0xFF
            assert np.array_equal(got, ref[r])


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("k,m", GRID)
def test_model_encode_matches_jax(k, m, s):
    x = _blocks(1 if s > 4097 else 2, k, s, seed=k * 1000 + m + s)
    _check(erasure_jax._encode_matrix_bits(k, m), x, m)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("k,m,lost", LOST)
def test_model_transform_matches_jax(k, m, lost, s):
    sources = tuple(i for i in range(k + m) if i not in lost)[:k]
    mat = erasure_jax._transform_matrix_bits(k, m, sources, tuple(lost))
    _check(mat, _blocks(1, k, s, seed=len(lost) + s), len(lost))


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_model_output_rows(rows):
    """R = 1..4: one group of packed rows, the top bytes zero."""
    k, m = 8, 4
    lost = (0, 5, 9, 10)[:rows]
    sources = tuple(i for i in range(k + m) if i not in lost)[:k]
    mat = erasure_jax._transform_matrix_bits(k, m, sources, lost)
    _check(mat, _blocks(2, k, 4096, seed=rows), rows)


@pytest.mark.parametrize("s", [4096, 4097])
def test_model_more_than_four_rows(s):
    """EC:8+8 with 6 shards lost: two groups of output rows."""
    k, m, lost = 8, 8, (0, 2, 4, 9, 12, 15)
    sources = tuple(i for i in range(k + m) if i not in lost)[:k]
    mat = erasure_jax._transform_matrix_bits(k, m, sources, lost)
    assert erasure_cuda.nibble_tables(mat).shape == (2, 8, 2, 16)
    _check(mat, _blocks(1, k, s, seed=s), len(lost))


@pytest.mark.parametrize("k,m", [(16, 4), (20, 4)])
def test_model_wide_inputs(k, m):
    """C = 16, the widest C held in registers, and C = 20, which the
    kernel takes 16 input rows at a time."""
    _check(erasure_jax._encode_matrix_bits(k, m), _blocks(1, k, 4097, k), m)


@pytest.mark.parametrize("s", [4096, 38401])
@pytest.mark.parametrize("salt", [0x5A, 0x1FF])
def test_model_salted(salt, s):
    _check(erasure_jax._encode_matrix_bits(8, 4), _blocks(1, 8, s, salt), 4,
           salt=salt)
