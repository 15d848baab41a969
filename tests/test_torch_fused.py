"""The port's fused PUT/GET programs (minio_tpu_torch.ops.fused) against
minio_tpu.ops.fused on the JAX CPU backend: same inputs, same output
layouts, byte-exact."""

import numpy as np
import pytest

from minio_tpu.ops import fused as jax_fused
from minio_tpu_torch.ops import fused


def _blocks(b, k, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, k, s),
                                                dtype=np.uint8)


@pytest.mark.parametrize("s", [512, 100])
@pytest.mark.parametrize("k,m", [(2, 2), (8, 4), (5, 3)])
def test_encode_and_hash_matches_jax(k, m, s):
    x = _blocks(3, k, s, seed=k + m + s)
    jp, jd = jax_fused.encode_and_hash(x, k, m, algo="mxh256")
    tp, td = fused.encode_and_hash(x, k, m, algo="mxh256", device="cpu")
    assert tp.shape == (3, m, s) and td.shape == (k + m, 3, 32)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("sources,targets", [
    ((0, 1, 2, 3, 4, 5, 6, 7), ()),                  # healthy: verify only
    ((0, 1, 2, 3, 4, 5, 8, 9), (6, 7)),              # 2 data rows lost
    ((2, 3, 4, 5, 6, 7, 8, 11), (0, 1, 9)),          # heal-style subset
])
@pytest.mark.parametrize("s", [256, 77])
def test_verify_and_transform_matches_jax(sources, targets, s):
    k, m = 8, 4
    x = _blocks(2, k, s, seed=len(targets) + s)
    jd, jo = jax_fused.verify_and_transform(x, k, m, sources, targets,
                                            algo="mxh256")
    td, to = fused.verify_and_transform(x, k, m, sources, targets,
                                        algo="mxh256", device="cpu")
    assert td.shape == (2, k, 32)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    if targets:
        assert to.shape == (2, len(targets), s)
        assert np.array_equal(to.numpy(), np.asarray(jo))
    else:
        assert to is None and jo is None


def test_highwayhash_names_the_later_slice():
    x = _blocks(1, 2, 64, seed=0)
    with pytest.raises(NotImplementedError, match="later slice"):
        fused.verify_and_transform(x, 2, 2, (0, 1), (),
                                   algo="highwayhash256S", device="cpu")
