"""The port's fused PUT/GET/heal programs (minio_tpu_torch.ops.fused)
against minio_tpu.ops.fused on the JAX CPU backend: same inputs, same
output layouts, byte-exact, for mxh256 and HighwayHash256S."""

import numpy as np
import pytest

from minio_tpu.ops import fused as jax_fused
from minio_tpu.ops.highwayhash import highwayhash256_batch
from minio_tpu_torch.ops import fused

HH = "highwayhash256S"


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


def test_encode_and_hash_highwayhash_matches_jax():
    k, m = 4, 2
    x = _blocks(3, k, 96, seed=31)
    jp, jd = jax_fused.encode_and_hash(x, k, m, algo=HH)
    tp, td = fused.encode_and_hash(x, k, m, algo=HH, device="cpu")
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    full = np.concatenate([x, tp.numpy()], axis=1).transpose(1, 0, 2)
    assert np.array_equal(td.numpy().reshape(-1, 32),
                          highwayhash256_batch(full.reshape(-1, 96)))


@pytest.mark.parametrize("sources,targets", [
    ((0, 1, 2, 3), ()),                    # healthy: verify only
    ((1, 2, 3, 4), (0, 5)),                # a data and a parity row
    ((0, 1, 2, 3), (4, 5)),                # heal: parity targets only
])
def test_verify_and_transform_highwayhash_matches_jax(sources, targets):
    k, m, s = 4, 2, 77
    x = _blocks(2, k, s, seed=40 + len(targets) + sources[0])
    jd, jo = jax_fused.verify_and_transform(x, k, m, sources, targets,
                                            algo=HH)
    td, to = fused.verify_and_transform(x, k, m, sources, targets, algo=HH,
                                        device="cpu")
    assert np.array_equal(td.numpy(), np.asarray(jd))
    if targets:
        assert np.array_equal(to.numpy(), np.asarray(jo))
    else:
        assert to is None and jo is None


def test_parity_targets_rebuild_the_encoded_parity():
    """Heal's form: the k data rows in, parity rows >= k out, equal to
    what encode produced."""
    k, m = 8, 4
    x = _blocks(2, k, 200, seed=50)
    parity, _ = fused.encode_and_hash(x, k, m, device="cpu")
    _, rebuilt = fused.verify_and_transform(
        x, k, m, tuple(range(k)), (8, 10, 11), algo=HH, device="cpu")
    assert np.array_equal(rebuilt.numpy(),
                          parity.numpy()[:, [0, 2, 3], :])


@pytest.mark.parametrize("algo", ["mxh256", HH])
def test_hash_rows_matches_jax(algo):
    x = _blocks(1, 5, 100, seed=60)[0]
    got = fused.hash_rows(x, algo, device="cpu")
    assert got.shape == (5, 32)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax_fused.hash_rows_async(x, algo)))


def test_highwayhash_verify_detects_flipped_bit():
    k, m = 4, 2
    x = _blocks(2, k, 64, seed=70)
    good = fused.verify_and_transform(x, k, m, (0, 1, 2, 3), (), algo=HH,
                                      device="cpu")[0].numpy()
    x[1, 0, 5] ^= 0x40
    bad = fused.verify_and_transform(x, k, m, (0, 1, 2, 3), (), algo=HH,
                                     device="cpu")[0].numpy()
    assert np.array_equal(good[0], bad[0])
    assert not np.array_equal(good[1, 0], bad[1, 0])
    assert np.array_equal(good[1, 1:], bad[1, 1:])


@pytest.mark.parametrize("algo", ["sha256", "blake2b512"])
def test_algorithms_without_a_device_program_raise(algo):
    """The device-digest gate raises for them; the programs take the
    host route instead (hashlib digests, equal to the JAX package's),
    and a name with neither route still raises."""
    from minio_tpu.storage import bitrot_io as jax_bitrot
    x = _blocks(1, 2, 64, seed=0)
    with pytest.raises(NotImplementedError, match="no device program"):
        fused.check_algo(algo)
    digests, _ = fused.verify_and_transform(x, 2, 2, (0, 1), (), algo=algo,
                                            device="cpu")
    want = jax_bitrot._hash_batch(x[0], algo)
    assert np.array_equal(digests.numpy()[0], want)
    assert np.array_equal(fused.hash_rows(x[0], algo, device="cpu").numpy(),
                          want)
    with pytest.raises(NotImplementedError, match="no device program"):
        fused.hash_rows(x[0], "crc32", device="cpu")
