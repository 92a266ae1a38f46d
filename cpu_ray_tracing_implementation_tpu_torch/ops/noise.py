"""Procedural noise as pure functions of position.

Port of ``cpu_ray_tracing_implementation_tpu/ops/noise.py`` (reference
src/noise.h). The tables are host numpy arrays made from a seed
(``make_perlin_tables`` / ``make_value_grid``, copied as they are so that
both packages' tables are bit-equal); the noise functions are plain torch
over [..., 3] points, differentiable with respect to position.

As in the JAX package: the three lattice lookups XOR one permutation table
(the reference uses ``perm_x`` for u, v and w, src/noise.h:35);
``value_noise`` clamps its indices where the reference reads out of bounds
(src/noise.h:109-116); worley and voronoi use the sin-dot hash constants of
src/noise.h:141-145.

The hash is chaotic in float32: its dot product reaches |x| ~ 2e4 in the
noise test scenes, where one ulp (~2e-3) of the argument moves ``sin`` by
as much, and ``sin`` is multiplied by 43758.5453 before ``fract``. So
``_cell_hash`` fixes its rounding: the dot product rounds as one fused
multiply-add per term (what XLA's CPU backend compiles the JAX package's
``jnp.sum(a * b)`` to, emulated in float64, where a product of two float32
values is exact), and ``sin`` is taken in float64 and rounded once to
float32. The two packages' hashes then agree except where the JAX
package's float32 ``sin`` is an ulp off (~1% of cells), which moves a hash
by ~3e-3; on the card the same float64 operations give the CPU's values.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

POINT_COUNT = 256

_HASH = ((127.1, 311.7, 74.7), (269.5, 183.3, 246.1), (113.5, 271.9, 307.7))


def make_perlin_tables(seed: int = 0):
    """Host-side: 256 random unit gradients + one permutation (src/noise.h:12-20)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True) + 1e-12
    perm = rng.permutation(POINT_COUNT)
    return g.astype(np.float32), perm.astype(np.int32)


def make_value_grid(resolution: int, seed: int = 1):
    """Host-side: [res, res, res] grid of uniforms (src/noise.h:95-103)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(resolution,) * 3).astype(np.float32)


def perlin_noise(p: torch.Tensor, grad: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gradient noise with smoothstep trilinear interpolation
    (src/noise.h:22-74). p: [..., 3]; grad: [256, 3]; perm: [256] int32.
    Returns [...] in ~[-1, 1]."""
    pf = torch.floor(p)
    ip = pf.to(torch.int32)
    d = p - pf
    mask = POINT_COUNT - 1
    iu, iv, iw = ip[..., 0] & mask, ip[..., 1] & mask, ip[..., 2] & mask
    s = d * d * (3.0 - 2.0 * d)  # smoothstep weights

    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                idx = (perm[((iu + i) & mask).long()] ^ perm[((iv + j) & mask).long()]
                       ^ perm[((iw + k) & mask).long()])
                corner_grad = grad[idx.long()]
                weight_v = d - p.new_tensor([i, j, k])
                w = ((i * s[..., 0] + (1 - i) * (1.0 - s[..., 0]))
                     * (j * s[..., 1] + (1 - j) * (1.0 - s[..., 1]))
                     * (k * s[..., 2] + (1 - k) * (1.0 - s[..., 2])))
                accum = accum + w * vm.dot(corner_grad, weight_v)
    return accum


def perlin_turb(p: torch.Tensor, grad: torch.Tensor, perm: torch.Tensor,
                depth: int = 7) -> torch.Tensor:
    """Fractal turbulence: |sum of halving-weight octaves| (src/noise.h:43-53)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * perlin_noise(p, grad, perm)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(accum)


def value_noise(p: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolated grid of uniforms (src/noise.h:95-137), the
    int32 indices clamped to the grid."""
    res = grid.shape[0]
    pf = torch.floor(p)
    ip = torch.clamp(pf.to(torch.int32), 0, res - 1)
    ip1 = torch.clamp(ip + 1, 0, res - 1)
    f = p - pf
    flat = grid.reshape(-1)

    def g(ix, iy, iz):
        # grid[ix, iy, iz] as one flat gather
        return flat[((ix * res + iy) * res + iz).long()]

    x0, y0, z0 = ip[..., 0], ip[..., 1], ip[..., 2]
    x1, y1, z1 = ip1[..., 0], ip1[..., 1], ip1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    y0z0 = vm.lerp(fx, g(x0, y0, z0), g(x1, y0, z0))
    y1z0 = vm.lerp(fx, g(x0, y1, z0), g(x1, y1, z0))
    y0z1 = vm.lerp(fx, g(x0, y0, z1), g(x1, y0, z1))
    y1z1 = vm.lerp(fx, g(x0, y1, z1), g(x1, y1, z1))
    return vm.lerp(fz, vm.lerp(fy, y0z0, y1z0), vm.lerp(fy, y0z1, y1z1))


def _fma_dot(u: torch.Tensor, c) -> torch.Tensor:
    """float32 u . c rounded as fma(u2, c2, fma(u1, c1, u0 * c0))."""
    c = u.new_tensor(c)
    u64, c64 = u.double(), c.double()
    acc = (u[..., 0] * c[0]).double()
    for i in (1, 2):
        acc = (u64[..., i] * c64[i] + acc).float().double()
    return acc.float()


def _cell_hash(u: torch.Tensor) -> torch.Tensor:
    """sin-dot hash -> pseudo-random offset in [0,1)^3 (src/noise.h:141-145),
    its rounding fixed as the module note says."""
    rand_v = torch.stack([_fma_dot(u, c) for c in _HASH], dim=-1)
    return vm.fract(torch.sin(rand_v.double()).float() * 43758.5453)


def _cells(p: torch.Tensor):
    """The 27 lattice cells around each point, in the JAX package's order."""
    floor_p = torch.floor(p)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                yield floor_p + p.new_tensor([i, j, k])


def worley_noise(p: torch.Tensor) -> torch.Tensor:
    """min squared distance to jittered lattice points over the 27-cell
    neighborhood (src/noise.h:139-168)."""
    min_dist = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype, device=p.device)
    for cell in _cells(p):
        min_dist = torch.minimum(min_dist, vm.length(cell + _cell_hash(cell) - p))
    return min_dist * min_dist


def voronoi_noise(p: torch.Tensor) -> torch.Tensor:
    """Hash value of the nearest jittered lattice point (src/noise.h:170-201)."""
    min_dist = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype, device=p.device)
    color = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for cell in _cells(p):
        pos = cell + _cell_hash(cell)
        dist = vm.length(pos - p)
        closer = dist < min_dist
        min_dist = torch.where(closer, dist, min_dist)
        color = torch.where(closer, _cell_hash(pos)[..., 0], color)
    return color
