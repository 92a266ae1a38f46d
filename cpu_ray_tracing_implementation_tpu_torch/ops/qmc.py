"""Owen-scrambled Sobol quasi-Monte-Carlo sampling (opt-in ``camera.qmc``).

Port of ``cpu_ray_tracing_implementation_tpu/ops/qmc.py``, bit for bit.
Sample ``s`` of a pixel takes point ``s`` of a 2-D Sobol (0,2)-sequence per
dimension pair (pixel jitter, BSDF direction, light UV, ...), with an Owen
scramble and an index shuffle per (pixel, pair) seeded by a counter hash of
(pixel id, global dimension index, session words) (PBRT's padded Sobol
sampler; Burley, "Practical Hash-based Owen Scrambling", JCGT 2020). The
stream is a fixed function of (pixel id, sample index, bounce, slot), so
the scan, the wavefront and any pixel partition draw the same numbers.

Torch's ``uint32`` supports few operators, so every word is an ``int64``
holding a value in [0, 2**32), with logical shifts (the value is
nonnegative) and each product reduced mod 2**32 by ``fastrng._mul32``. A
scalar (the scan's sample index and pair group) stays a Python integer,
which the same operators take, so no call copies a value to the card (on
the card a copy from the host synchronises the stream).
The second Sobol dimension, a 32-term XOR over the direction vectors, is
one gather from a table of the XOR of each byte's vectors and a 4-term
XOR. ``uniforms`` builds every slot of a block at once, [R, nslot] wide.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import fastrng, keys
from cpu_ray_tracing_implementation_tpu_torch.ops.fastrng import _M32, _mul32

# Sobol dimension-2 direction vectors: v_1 = 2^31, v_j = v_{j-1} ^ (v_{j-1}
# >> 1) (the Pascal-matrix construction)
_V1 = np.zeros(32, np.uint32)
_V1[0] = np.uint32(1) << 31
for _j in range(1, 32):
    _V1[_j] = _V1[_j - 1] ^ (_V1[_j - 1] >> np.uint32(1))

# [4 * 256]: entry 256 k + b is the XOR of _V1[8 k + j] over the set bits j
# of the byte b, so dimension 1 of an index is the XOR of four entries
_V1_BYTES = np.zeros((4, 256), np.int64)
for _k in range(4):
    for _b in range(256):
        _x = 0
        for _j in range(8):
            if (_b >> _j) & 1:
                _x ^= int(_V1[8 * _k + _j])
        _V1_BYTES[_k, _b] = _x
_V1_BYTES = _V1_BYTES.reshape(-1)

_M1 = 0x55555555
_M2 = 0x33333333
_M3 = 0x0F0F0F0F
_M4 = 0x00FF00FF
# Laine-Karras permutation constants (Burley, JCGT 2020, listing 3)
_LK1 = 0x3D20ADEA
_LK2 = 0x05526C56
_LK3 = 0x53A22864


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 constant on ``device``, copied there once."""
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


@functools.lru_cache(maxsize=None)
def _v1_bytes(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_V1_BYTES, device=device)


def _u32(x):
    """``x`` as 32-bit words: a Python integer for a scalar, else an int64
    tensor (from a tensor or an array) mod 2**32."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & _M32
    if np.ndim(x) == 0:
        return int(x) & _M32
    return torch.as_tensor(np.asarray(x, np.int64)) & _M32


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 1) & _M1) | ((x & _M1) << 1)
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M3) | ((x & _M3) << 4)
    x = ((x >> 8) & _M4) | ((x & _M4) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _sobol_dim0(index: torch.Tensor) -> torch.Tensor:
    """Van der Corput: the bit-reversed sample index."""
    return _reverse_bits(_u32(index))


def _sobol_dim1(index: torch.Tensor) -> torch.Tensor:
    """Second Sobol dimension: XOR of the direction vectors at the index's
    set bits, as the XOR of one table entry per byte."""
    idx = _u32(index)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=idx.device)
    rows = ((idx[..., None] >> shifts) & 0xFF) + 256 * torch.arange(
        4, dtype=torch.int64, device=idx.device)
    v = _v1_bytes(idx.device)[rows]
    return v[..., 0] ^ v[..., 1] ^ v[..., 2] ^ v[..., 3]


def _lk_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras permutation (Burley 2020, listing 3): every step carries
    information only toward higher bits, which in bit-reversed space is a
    nested (Owen) scramble that keeps the (0,2)-net structure."""
    s = _u32(seed)
    x = x ^ _mul32(x, _LK1)
    x = (x + s) & _M32
    x = _mul32(x, (s >> 16) | 1)
    x = x ^ _mul32(x, _LK2)
    return x ^ _mul32(x, _LK3)


def owen_scramble(x: torch.Tensor, seed) -> torch.Tensor:
    """Hash-based Owen scramble of a 32-bit sample coordinate."""
    return _reverse_bits(_lk_scramble(_reverse_bits(_u32(x)), seed))


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1) on the exact 24-bit mantissa path."""
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def sobol2d(index, seed0=None, seed1=None) -> torch.Tensor:
    """[..., 2] points of the (0,2)-sequence, optionally Owen-scrambled per
    coordinate."""
    idx = _u32(index)
    d0 = _sobol_dim0(idx)
    d1 = _sobol_dim1(idx)
    if seed0 is not None:
        d0 = owen_scramble(d0, seed0)
    if seed1 is not None:
        d1 = owen_scramble(d1, seed1)
    return torch.stack([_to_unit(d0), _to_unit(d1)], dim=-1)


# Slot -> (pair group, dimension within the pair): two-dimensional draws
# (BSDF direction, light UV, fuzz disk, pixel jitter, defocus disk) share a
# Sobol pair. Camera slots (models/camera.py): 0,1 jitter; 2 time; 3,4
# defocus.
CAM_GROUP = (0, 0, 1, 2, 2)
CAM_DIM = (0, 1, 0, 0, 1)
N_CAM_GROUPS = 3
# Bounce slots (ops/materials.py): 0 decision; 1,2 dir; 3 MIS; 4,5 light
# UV; 6,7 fuzz; 8 light pick; 9+ volume channels (singles).
_BOUNCE_GROUP = (0, 1, 1, 2, 3, 3, 4, 4, 5)
_BOUNCE_DIM = (0, 0, 1, 0, 0, 1, 0, 1, 0)
_N_BOUNCE_GROUPS = 6


def bounce_layout(nslot: int):
    """(groups, dims, n_groups) of a bounce block of ``nslot`` columns
    (NSLOT + the volumes, each volume slot a single group of its own)."""
    extra = nslot - len(_BOUNCE_GROUP)
    groups = _BOUNCE_GROUP + tuple(_N_BOUNCE_GROUPS + i for i in range(extra))
    dims = _BOUNCE_DIM + (0,) * extra
    return groups, dims, _N_BOUNCE_GROUPS + extra


def seed_words(key: np.ndarray) -> np.ndarray:
    """[2] uint32 session words that seed every scramble:
    ``jax.random.bits(key, (2,), uint32)`` of the render's base key. Never
    a per-sample fold: the Sobol index carries the sample progression, and
    the scramble must stay fixed across samples."""
    return keys.bits2(key)


def shuffle_index(index, seed) -> torch.Tensor:
    """Owen shuffle of the sample index (Burley 2020 section 10.3), most
    significant bit first, so a 2^k prefix of samples maps to an aligned
    2^k block of the sequence: independent shuffles per pair make the
    padded dimensions fill the hypercube while each pair keeps its net."""
    return owen_scramble(index, seed)


def uniforms(words, ids: torch.Tensor, index, base_group, groups, dims
             ) -> torch.Tensor:
    """[R, nslot] Owen-scrambled, index-shuffled Sobol uniforms.

    ``words``: [2] session seed words; ``ids``: [R] pixel ids; ``index``:
    the sample index, an integer or an [R] tensor (the wavefront's);
    ``base_group``: the block's first global pair group, an integer or an
    [R] tensor; ``groups``/``dims``: the per-slot layout (``bounce_layout``
    or ``CAM_GROUP`` / ``CAM_DIM``). Both dimensions of a pair share one
    shuffled index."""
    dev = ids.device
    w0, w1 = int(words[0]), int(words[1])
    pid = ((_mul32(_u32(ids), fastrng._GOLD) + w0) & _M32)[:, None]      # [R,1]

    def col(x):  # an integer, or an [R] tensor as a column against [R,S]
        x = _u32(x)
        return x.reshape(-1, 1) if torch.is_tensor(x) else x

    grp = (col(base_group) + _const(tuple(groups), dev)) & _M32
    d = _const(tuple(dims), dev)
    shuf_seed = fastrng._mix2(fastrng._fmix(pid ^ _mul32(grp, fastrng._C2)) ^ w1)
    si = shuffle_index(col(index), shuf_seed)
    coord = torch.where(d == 1, _sobol_dim1(si), _sobol_dim0(si))
    gdim = (_mul32(grp, 2) + d) & _M32
    seed = fastrng._mix2(fastrng._fmix(pid ^ _mul32(gdim, fastrng._C1)) ^ w1)
    return _to_unit(owen_scramble(coord, seed))
