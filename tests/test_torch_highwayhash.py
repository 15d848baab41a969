"""The port's plain HighwayHash-256 (minio_tpu_torch.ops.highwayhash_torch)
against the JAX package's device program on the JAX CPU backend, the
scalar spec and the numpy multi-stream spec, byte-exact, over every
length class (empty, bulk packets, each remainder branch); and the
wrapper of the Hopper kernel on the host."""

import numpy as np
import pytest
import torch

from minio_tpu.ops import highwayhash as jax_spec
from minio_tpu.ops.highwayhash_jax import hh256_batch_jax
from minio_tpu_torch.ops import highwayhash, highwayhash_cuda
from minio_tpu_torch.ops.highwayhash_torch import hh256_rows_ref

# The length classes of tests/test_highwayhash_jax.py: bulk packets and
# L = 0, one length per remainder branch (r & 16, r & 3), and an odd
# remainder like a k=12 shard's.
LENGTHS = ([0, 1, 31, 32, 64, 100, 1024]
           + [64 + r for r in (1, 3, 4, 8, 15, 16, 17, 20, 23, 31)]
           + [87382 % 512 + 22])


@pytest.mark.parametrize("length", LENGTHS)
def test_matches_jax_and_spec(length):
    x = np.random.default_rng(length).integers(0, 256, (3, length),
                                               dtype=np.uint8)
    got = hh256_rows_ref(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 32)
    assert np.array_equal(got, np.asarray(hh256_batch_jax(x)))
    assert np.array_equal(got, np.stack([
        np.frombuffer(jax_spec.highwayhash256(r.tobytes()), dtype=np.uint8)
        for r in x]))
    if length:                     # the numpy spec takes L > 0 only
        assert np.array_equal(got, jax_spec.highwayhash256_batch(x))


def test_constants_equal_the_jax_package():
    """The 'weights' carried across: key and init words."""
    assert highwayhash.MAGIC_KEY == jax_spec.MAGIC_KEY
    assert highwayhash.INIT0 == jax_spec.INIT0
    assert highwayhash.INIT1 == jax_spec.INIT1


def test_other_key_matches_spec():
    key = bytes(range(32))
    x = np.random.default_rng(9).integers(0, 256, (2, 77), dtype=np.uint8)
    got = hh256_rows_ref(torch.from_numpy(x), key).numpy()
    for i in range(2):
        assert got[i].tobytes() == jax_spec.highwayhash256(x[i].tobytes(),
                                                           key)


def test_rows_independent_and_bit_sensitive():
    x = np.zeros((3, 70), dtype=np.uint8)
    x[1, 69] = 1
    x[2, 0] = 0x80
    d = hh256_rows_ref(torch.from_numpy(x)).numpy()
    assert len({r.tobytes() for r in d}) == 3


def test_empty_batch():
    assert hh256_rows_ref(torch.zeros((0, 40), dtype=torch.uint8)).shape == \
        (0, 32)


def test_wrapper_runs_the_plain_version_on_the_host():
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4, 45), dtype=np.uint8))
    before = highwayhash_cuda.LAUNCHES
    got = highwayhash_cuda.hh256_rows(x)
    assert highwayhash_cuda.LAUNCHES == before       # no kernel on the host
    assert torch.equal(got, hh256_rows_ref(x))


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 2, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 8, dtype=torch.uint8),
                                    key=b"short")
