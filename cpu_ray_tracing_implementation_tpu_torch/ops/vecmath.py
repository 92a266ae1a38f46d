"""Core 3-vector math on [..., 3] tensors.

Port of ``cpu_ray_tracing_implementation_tpu/ops/vecmath.py``: the same pure
functions over batched float32 tensors (reference: src/vec3.h, src/onb.h,
src/utility.h:70-87).
"""

from __future__ import annotations

import torch

EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis; [..., 3] x [..., 3] -> [...]."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_sq(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector; safe at zero (returns ~0 instead of NaN)."""
    return a / torch.sqrt(length_sq(a) + EPS)[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (reference: src/utility.h:70)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Snell refraction of unit vector v about unit normal n (src/utility.h:71-76,
    fabs under the sqrt, floored at 1e-12). ``eta`` is n_in/n_out, shape [...]."""
    cos_theta = torch.clamp(dot(-v, n), max=1.0)
    r_out_perp = eta[..., None] * (v + cos_theta[..., None] * n)
    k = torch.clamp(torch.abs(1.0 - length_sq(r_out_perp)), min=1e-12)
    return r_out_perp - torch.sqrt(k)[..., None] * n


def onb_from_normal(normal: torch.Tensor):
    """Orthonormal basis (x, y, z) with y = unit(normal) (src/onb.h:19-28).
    Returns three [..., 3] tensors."""
    y = normalize(normal)
    z_axis = y.new_tensor([0.0, 0.0, 1.0]).expand(y.shape)
    x_axis = y.new_tensor([1.0, 0.0, 0.0]).expand(y.shape)
    a = torch.where((torch.abs(y[..., 0]) > 0.9)[..., None], z_axis, x_axis)
    z = normalize(cross(y, a))
    x = cross(y, z)
    return x, y, z


def onb_transform(local: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Local (lx, ly, lz) -> world, with y the normal axis (src/onb.h)."""
    return local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * z


def lerp(t, a, b):
    """(1-t)*a + t*b (src/utility.h:84-85). ``t`` broadcasts against a/b."""
    return (1.0 - t) * a + t * b


def smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fract(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def outer_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[R,3] x [N,3] -> [R,N] pairwise dot products.

    The JAX package writes these as ``einsum(..., precision="highest")``
    contractions. Here they are three elementwise multiply-adds, so no
    float32 matmul (and no TF32 rounding on the card) is involved.
    """
    return (a[:, 0:1] * b[None, :, 0] + a[:, 1:2] * b[None, :, 1]
            + a[:, 2:3] * b[None, :, 2])
