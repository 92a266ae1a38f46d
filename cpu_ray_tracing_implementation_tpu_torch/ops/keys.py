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

The per-lane stream (``CRT_RNG=threefry``) folds a key by every lane's ray
id and draws its uniforms from the folded keys, so the same block runs on
tensors: ``threefry2x32_lanes``, ``fold_in_lanes`` and ``uniform``, in
``int64`` holding 32-bit words (torch's ``uint32`` supports few
operators), every sum masked back to 32 bits. With the flag above,
``uniform(k, (n,))`` draws its i-th word as ``bits`` does, ``x0 ^ x1`` of
``T(k, 0, i)``, and maps it to a float32 in [1, 2) by its top 23 bits,
minus 1.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ------------------------------------------------------ per-lane threefry
_M32 = 0xFFFFFFFF


def _words(k) -> tuple:
    """(k0, k1) of a key: int64 columns of an [R, 2] tensor of one key per
    lane, or the Python integers of a host [2] key (no copy to the card,
    which would synchronise its stream)."""
    if torch.is_tensor(k):
        return k[:, 0:1], k[:, 1:2]
    return int(k[0]), int(k[1])


def threefry2x32_lanes(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor) -> tuple:
    """``threefry2x32`` on int64 tensors of 32-bit words (key words
    ``k0``/``k1``, tensors or Python integers, and counters ``x0``/``x1``,
    broadcast together)."""
    k2 = k0 ^ k1 ^ int(_PARITY)
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in_lanes(k, data: torch.Tensor) -> torch.Tensor:
    """[R, 2] int64 keys ``jax.random.fold_in(k, data[r])``: ``k`` a host
    key shared by every lane or an [R, 2] tensor of per-lane keys, ``data``
    an [R] integer tensor of values in [0, 2**32)."""
    k0, k1 = _words(k)
    d = data.to(torch.int64).reshape(-1, 1) & _M32
    x0, x1 = threefry2x32_lanes(k0, k1, torch.zeros_like(d), d)
    return torch.cat([x0, x1], dim=1)


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """[R, n] float32 ``jax.random.uniform(k[r], (n,))`` of [R, 2] int64
    per-lane keys."""
    k0, k1 = _words(k)
    cnt = torch.arange(n, dtype=torch.int64, device=k.device)[None, :]
    x0, x1 = threefry2x32_lanes(k0, k1, torch.zeros_like(cnt), cnt)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
