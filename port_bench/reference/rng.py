"""The random streams of a render, as specified: threefry-2x32 keys and
the counter hash the path uniforms come from.

A key is a pair of 32-bit words. With ``T(k, x0, x1)`` the 20-round
threefry-2x32 block (Salmon et al., SC'11): ``key(s) = (0, s)``,
``fold_in(k, d) = T(k, 0, d)``, ``split(k)[i] = T(k, 0, i)`` and the seed
words of a key are ``bits(k)[i] = x0 ^ x1 of T(k, 0, i)``, i = 0, 1.

A lane's uniforms are a murmur3-style hash of (seed words, lane id, slot):
``x = id * 0x9E3779B9 + s0``, ``slot' = slot * 0xC2B2AE35 + s1``, ``h =
mix2(fmix(x) ^ slot')`` (mod 2**32 throughout), and the uniform is the top
24 bits of ``h`` times 2**-24.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry(k, x0: int, x1: int) -> tuple:
    """The threefry-2x32 block of key ``k`` over the counter (x0, x1)."""
    k0, k1 = int(k[0]), int(k[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> tuple:
    return 0, int(seed) & M32


def fold_in(k, data: int) -> tuple:
    return threefry(k, 0, int(data) & M32)


def split(k) -> tuple:
    return threefry(k, 0, 0), threefry(k, 0, 1)


def bits(k) -> tuple:
    a, b = threefry(k, 0, 0), threefry(k, 0, 1)
    return a[0] ^ a[1], b[0] ^ b[1]


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2**32 in int64 without overflow: c split in 16-bit halves
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix2(x):
    x = x ^ (x >> 15)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 13)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(s0: torch.Tensor, s1: torch.Tensor, ids: torch.Tensor, nslot: int) -> torch.Tensor:
    """[R, nslot] float32 uniforms of lanes ``ids`` [R] with per-lane seed
    words ``s0``, ``s1`` [R] (int64 tensors holding 32-bit words)."""
    x = (_mul(ids.to(torch.int64) & M32, 0x9E3779B9) + s0) & M32
    slot = _mul(torch.arange(nslot, dtype=torch.int64, device=ids.device), 0xC2B2AE35)
    slot = (slot[None, :] + s1[:, None]) & M32
    h = _mix2(_fmix(x)[:, None] ^ slot)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)
