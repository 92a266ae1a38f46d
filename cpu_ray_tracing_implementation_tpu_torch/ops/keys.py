"""Host-side re-implementation of the ``jax.random`` key derivation.

The JAX integrator derives every random stream from a threefry-2x32 key
(``jax.random.key`` -> ``fold_in`` / ``split`` -> ``bits(key, (2,), uint32)``,
``models/integrator.py:81,252,318,409`` of the JAX package). The port must
reproduce those seed words bit for bit so both packages render the same
paths. All of it is scalar work on the host, so it runs in numpy ``uint32``.

With ``jax_threefry_partitionable`` on (the default of JAX 0.9), and
``T(k, x0, x1)`` the 20-round threefry-2x32 block:

- ``key(s)``            = ``(0, s)``
- ``fold_in(k, d)``     = ``T(k, 0, d)``
- ``split(k)[i]``       = ``T(k, 0, i)``
- ``bits(k, (2,))[i]``  = ``x0 ^ x1`` of ``T(k, 0, i)``

A key here is a ``uint32`` numpy array of shape [2], the same words
``jax.random.key_data`` returns.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The 20-round threefry-2x32 block of ``key`` ([2] uint32) over the
    counter words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.array(x0, np.uint32, ndmin=1)
    x1 = np.array(x1, np.uint32, ndmin=1)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= int(seed) < 1 << 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for data in [0, 2**32)."""
    x0, x1 = threefry2x32(k, 0, np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([x0[0], x1[0]], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` -> [num, 2] uint32."""
    x0, x1 = threefry2x32(k, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([x0, x1], axis=1)


def bits2(k: np.ndarray) -> np.ndarray:
    """``jax.random.bits(k, (2,), jnp.uint32)`` -> [2] uint32."""
    x0, x1 = threefry2x32(k, np.zeros(2, np.uint32),
                          np.arange(2, dtype=np.uint32))
    return x0 ^ x1
