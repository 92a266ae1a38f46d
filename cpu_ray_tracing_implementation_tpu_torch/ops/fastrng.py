"""Counter-hash uniforms for path sampling.

Port of ``cpu_ray_tracing_implementation_tpu/ops/fastrng.py``: a
murmur3-style two-round finalizer over (seed, lane id, slot), keyed by
seed words derived from the session key (``ops/keys.py``). The stream is
bit-for-bit the JAX package's.

Torch's ``uint32`` supports few operators, on the card fewer still, so the
hash runs in ``int64`` holding values in [0, 2**32). Each 32x32-bit
multiply is split into 16-bit halves so no intermediate passes 2**63, and
every result is masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import keys

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x7FEB352D
_C4 = 0x846CA68B
_GOLD = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (c & 0xFFFF)                       # < 2**48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16       # < 2**32
    return (lo + hi) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _mix2(x: torch.Tensor) -> torch.Tensor:
    """Second finalizer round (different constants)."""
    x = x ^ (x >> 15)
    x = _mul32(x, _C3)
    x = x ^ (x >> 13)
    x = _mul32(x, _C4)
    return x ^ (x >> 16)


def seed_words(key: np.ndarray, n: int) -> np.ndarray:
    """[n, 2] uint32 seed-word table: row i is ``bits(fold_in(key, i))``."""
    return np.stack([keys.bits2(keys.fold_in(key, i)) for i in range(n)])


def uniforms(s0, s1, ids: torch.Tensor, nslot: int) -> torch.Tensor:
    """[R, nslot] float32 uniforms in [0, 1) for integer lane ``ids``.

    ``s0``/``s1``: 32-bit seed words, as Python/numpy scalars or as [R]
    int64 tensors for per-lane seeds. A fixed function of (seed, id, slot)
    only, so it is invariant to batch position and batch size.
    """
    dev = ids.device
    s0, s1 = (s.to(device=dev, dtype=torch.int64) if torch.is_tensor(s)
              else torch.tensor(int(s), dtype=torch.int64, device=dev)
              for s in (s0, s1))
    x = (_mul32(ids.to(torch.int64) & _M32, _GOLD) + s0) & _M32
    slot = _mul32(torch.arange(nslot, dtype=torch.int64, device=dev), _C2)
    slot = (slot[None, :] + s1.reshape(-1, 1)) & _M32
    h = _mix2(_fmix(x)[:, None] ^ slot)
    # 24-bit mantissa path: exact float in [0, 1)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)
