"""The port's key derivation and uniforms equal JAX's, bit for bit.

Every tight comparison between the two packages rests on this: the port
reproduces ``jax.random.key`` / ``fold_in`` / ``split`` / ``bits`` with a
host-side threefry-2x32 (``ops/keys.py``) and the counter-hash uniforms of
``ops/fastrng.py`` in int64 torch arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.ops import fastrng as jfast
from cpu_ray_tracing_implementation_tpu_torch.ops import fastrng, keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

SEEDS = [0, 1, 42, 7, 2**31 + 5, 2**32 - 1]
FOLDS = [0, 3, 255, 0x5252, 2**31 + 7, 2**32 - 1]


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key(seed):
    np.testing.assert_array_equal(keys.key(seed), _data(jax.random.key(seed)))
    np.testing.assert_array_equal(
        convert.key_from_numpy(_data(jax.random.key(seed))), keys.key(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_split_bits(seed):
    jk, pk = jax.random.key(seed), keys.key(seed)
    for d in FOLDS:
        np.testing.assert_array_equal(keys.fold_in(pk, d),
                                      _data(jax.random.fold_in(jk, d)))
    for num in (2, 3):
        np.testing.assert_array_equal(keys.split(pk, num),
                                      _data(jax.random.split(jk, num)))
    np.testing.assert_array_equal(
        keys.bits2(pk), np.asarray(jax.random.bits(jk, (2,), jnp.uint32)))


@pytest.mark.parametrize("seed", [0, 42])
def test_fold_chains(seed):
    """The integrator's derivation: fold by sample, split, fold by bounce,
    take two seed words (integrator.py:81,252,318,409)."""
    jk, pk = jax.random.key(seed), keys.key(seed)
    for s in (0, 1, 255):
        js, ps = jax.random.fold_in(jk, s), keys.fold_in(pk, s)
        jc, jp = jax.random.split(js)
        pc, pp = keys.split(ps)
        np.testing.assert_array_equal(
            keys.bits2(pc), np.asarray(jax.random.bits(jc, (2,), jnp.uint32)))
        for b in (0, 1, 7):
            jb = jax.random.fold_in(jp, b)
            np.testing.assert_array_equal(
                keys.bits2(keys.fold_in(pp, b)),
                np.asarray(jax.random.bits(jb, (2,), jnp.uint32)))


def test_seed_words():
    jk = jax.random.key(7)
    np.testing.assert_array_equal(fastrng.seed_words(keys.key(7), 5),
                                  np.asarray(jfast.seed_words(jk, 5)))


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
@pytest.mark.parametrize("nslot", [1, 5, 10])
def test_uniforms_scalar_seed(seed, nslot):
    w = keys.bits2(keys.key(seed))
    ids = np.concatenate([np.arange(4096), [2**31 - 1, 2**30 + 17, 262143]])
    ref = np.asarray(jfast.uniforms(jnp.uint32(w[0]), jnp.uint32(w[1]),
                                    jnp.asarray(ids, jnp.int32), nslot))
    got = fastrng.uniforms(w[0], w[1], torch.as_tensor(ids, dtype=torch.int32),
                           nslot).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_uniforms_per_lane_seed():
    rng = np.random.default_rng(3)
    n = 3000
    s0 = rng.integers(0, 2**32, n, dtype=np.uint32)
    s1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = rng.integers(0, 2**31, n).astype(np.int32)
    ref = np.asarray(jfast.uniforms(jnp.asarray(s0), jnp.asarray(s1),
                                    jnp.asarray(ids), 9))
    got = fastrng.uniforms(torch.as_tensor(s0.astype(np.int64)),
                           torch.as_tensor(s1.astype(np.int64)),
                           torch.as_tensor(ids), 9).numpy()
    np.testing.assert_array_equal(got, ref)


def test_key_range_checked():
    with pytest.raises(ValueError):
        keys.key(-1)
    with pytest.raises(ValueError):
        convert.key_from_numpy(np.zeros(4, np.uint32))
