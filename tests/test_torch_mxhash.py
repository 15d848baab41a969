"""The port's mxh256 (minio_tpu_torch.ops.mxhash_torch) against the JAX
package's device program and its numpy spec, byte-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import mxhash as jax_spec
from minio_tpu.ops import mxhash_jax
from minio_tpu_torch.ops import mxhash, mxhash_torch


@pytest.mark.parametrize("length", [0, 1, 31, 255, 256, 257, 4096,
                                    131072 + 7])
def test_mxh256_rows_matches_jax_and_spec(length):
    x = np.random.default_rng(length).integers(0, 256, (3, length),
                                               dtype=np.uint8)
    got = mxhash_torch.mxh256_rows(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 32)
    assert np.array_equal(got, np.asarray(mxhash_jax.mxh256_rows(
        jnp.asarray(x))))
    assert np.array_equal(got, jax_spec.mxh256_batch(x))


def test_matrix_a_and_length_tag_equal():
    assert np.array_equal(mxhash.matrix_a(), jax_spec.matrix_a())
    for n in (0, 1, 1 << 20, (1 << 40) + 3):
        assert np.array_equal(mxhash.length_tag(n), jax_spec.length_tag(n))


def test_mxh256_detects_single_byte_change():
    x = np.zeros((2, 1000), dtype=np.uint8)
    x[1, 517] = 1
    d = mxhash_torch.mxh256_rows(torch.from_numpy(x)).numpy()
    assert not np.array_equal(d[0], d[1])


def test_mxh256_rows_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        mxhash_torch.mxh256_rows(torch.zeros(2, 8, dtype=torch.int32))


def test_mxh256_ignores_and_keeps_process_precision_settings():
    """The tree levels run in float64, which no TF32 or matmul-precision
    setting touches: the digest stays exact under the loosest setting, and
    the call leaves the process-wide settings as it found them."""
    x = np.random.default_rng(5).integers(0, 256, (4, 3000), dtype=np.uint8)
    want = np.asarray(mxhash_jax.mxh256_rows(jnp.asarray(x)))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        got = mxhash_torch.mxh256_rows(torch.from_numpy(x)).numpy()
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert np.array_equal(got, want)
