"""Direction samplers and pdf evaluators, driven by explicit uniforms.

Port of ``cpu_ray_tracing_implementation_tpu/ops/sampling.py`` (the parts
``materials.scatter`` / ``scatter_nee``, ``materials.light_sample`` and
the thin-lens camera call). Semantics match reference src/utility.h:30-69
and src/pdf.h.

``cosine_dir`` has the JAX package's two constructions, chosen by
``CRT_COSINE`` when it is called (the JAX package reads it when it
traces): ``sphere`` (the default), normalize(n + a uniform point on the
unit sphere), and ``onb``, the reference's local cosine direction
(src/utility.h:62-69) in an orthonormal basis about the normal
(src/pdf.h:34-45).
"""

from __future__ import annotations

import os

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

PI = 3.14159265358979323846
INV_4PI = 1.0 / (4.0 * PI)


def unit_sphere_dir(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere, y the polar axis
    (src/utility.h:30-43)."""
    cos_theta = 1.0 - 2.0 * u1
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)],
        dim=-1)


def disk_sample(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk, z = 0: the closed-form sqrt/angle map
    of the JAX package (the reference rejection-samples,
    src/utility.h:47-53; same distribution, fixed uniform use)."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)


def cosine_local_dir(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction in the basis' local frame, y up
    (src/utility.h:62-69 ``random_cosine_direction`` with y = sqrt(1-r2))."""
    phi = 2.0 * PI * u1
    sq_r2 = torch.sqrt(u2)
    return torch.stack([torch.cos(phi) * sq_r2,
                        torch.sqrt(torch.clamp(1.0 - u2, min=0.0)),
                        torch.sin(phi) * sq_r2], dim=-1)


def cosine_impl() -> str:
    """``CRT_COSINE``: "sphere" (the default) or "onb"."""
    return os.environ.get("CRT_COSINE", "sphere")


def cosine_dir(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about unit ``normal``: by default a
    uniform point on the unit sphere about the normal tip (RTiOW §9.4);
    under ``CRT_COSINE=onb`` the local cosine direction in the normal's
    basis. Both sample cos(theta)/pi; they map (u1, u2) to different
    directions."""
    if cosine_impl() == "onb":
        x, y, z = vm.onb_from_normal(normal)
        return vm.onb_transform(cosine_local_dir(u1, u2), x, y, z)
    s = unit_sphere_dir(u1, u2)
    d = normal + s
    # s == -normal (measure zero): fall back to the normal itself, like the
    # reference's lambertian near_zero guard (src/material.h:66-68)
    degenerate = (vm.length_sq(d) < 1e-12)[..., None]
    return vm.normalize(torch.where(degenerate, normal, d))


def cosine_pdf(normal: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """max(0, cos(theta))/pi (src/pdf.h:37-40); ``normal`` must be unit."""
    cos_theta = vm.dot(vm.normalize(direction), normal)
    return torch.clamp(cos_theta / PI, min=0.0)


def sphere_pdf(direction: torch.Tensor) -> torch.Tensor:
    """pdf of the uniform sphere sampler: 1/(4 pi) (src/pdf.h:15-20)."""
    return torch.full(direction.shape[:-1], INV_4PI, dtype=direction.dtype,
                      device=direction.device)


def cone_dir(axis_unit: torch.Tensor, cos_max: torch.Tensor, u1: torch.Tensor,
             u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction in the cone of half-angle acos(cos_max) about
    ``axis_unit``: the solid-angle sphere-light sampler (Shirley, The Rest
    of Your Life section 12; the reference's ``sphere::random`` ignores the
    origin, src/sphere.h:81). Pairs with ``cone_pdf``."""
    z = 1.0 + u2 * (cos_max - 1.0)           # cos(theta) in [cos_max, 1]
    phi = 2.0 * PI * u1
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    local = torch.stack([torch.cos(phi) * s, z, torch.sin(phi) * s], dim=-1)
    x, y, zb = vm.onb_from_normal(axis_unit)
    return vm.onb_transform(local, x, y, zb)


def cone_pdf(cos_max: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of ``cone_dir``: 1 / (2 pi (1 - cos_max)), guarded
    against the degenerate cone (cos_max -> 1)."""
    return 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_max, min=1e-8))


def schlick_reflectance(cosine: torch.Tensor, refraction_index: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (src/material.h:135-139)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * one_minus ** 5
