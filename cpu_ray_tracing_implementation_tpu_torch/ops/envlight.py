"""Importance-sampled environment light (opt-in per scene).

Port of ``cpu_ray_tracing_implementation_tpu/ops/envlight.py``. In the
reference the background is found only by BSDF sampling
(src/camera.h:205-210). ``SceneBuilder.set_background(tex,
importance_sample=True)`` tabulates the background's luminance on an
equirect grid at build time and registers the environment as one more
light of the MIS mixture (``ops/materials.py``): directions are drawn in
proportion to texel luminance x sin(theta), and the mixture pdf gains the
matching term. Every texel carries a small floor mass, so the pdf is
positive wherever radiance could be, and the miss shade still evaluates
the exact background, so the estimator stays unbiased at any table
resolution.

Direction <-> (u, v) is the ``intersect.sphere_uv`` convention:
theta = arccos(-y) = pi v, phi = atan2(-z, x) + pi = 2 pi u.
"""

from __future__ import annotations

import math

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture

PI = float(torch.tensor(math.pi, dtype=torch.float32))  # np.float32(pi)


def dir_from_uv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unit direction whose ``sphere_uv`` is (u, v)."""
    theta = PI * v
    a = 2.0 * PI * u - PI
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(a), -torch.cos(theta), -st * torch.sin(a)],
                       dim=-1)


def build_tables(scene, res=(64, 128)):
    """(p_texel [H,W] per-texel probability, row_cdf [H], col_cdf [H,W]) of
    the scene's background texture, on the scene's device.

    The table holds the discrete texel probability; ``pdf`` turns it into a
    solid-angle density at the actual direction's sin(theta) (the
    texel-center sin would misstate the density within a texel)."""
    h, w = res
    dev = scene.device
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    vv, uu = torch.meshgrid(v, u, indexing="ij")          # [H,W]
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    dirs = dir_from_uv(uu, vv)
    tex_id = torch.full((h * w,), scene.background, dtype=torch.int32, device=dev)
    rgb = eval_texture(scene, tex_id, uu, vv, dirs)
    lum = (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1]
           + 0.0722 * rgb[:, 2]).reshape(h, w)
    sin_t = torch.sin(PI * v)[:, None]                    # [H,1]
    mass = torch.clamp(lum, min=0.0) * sin_t
    # floor mass: the pdf must be positive wherever radiance could be
    mass = mass + (torch.mean(mass) + 1e-6) * 1e-3 * sin_t
    p_texel = mass / torch.sum(mass)                      # [H,W]
    row_mass = torch.sum(p_texel, dim=1)                  # [H]
    row_cdf = torch.cumsum(row_mass, dim=0)
    col_cdf = torch.cumsum(p_texel / torch.clamp(row_mass, min=1e-20)[:, None],
                           dim=1)
    return p_texel, row_cdf, col_cdf


def _pick(cdf: torch.Tensor, x: torch.Tensor):
    """(index, remainder within the segment) of each x in a cumulative
    table: ``cdf`` [N] shared, or [R, N] one row per x. The index is the
    count of entries below x, as in the JAX package (a parallel cumsum
    need not come out monotone to the last ulp, so no binary search)."""
    n = cdf.shape[-1]
    if cdf.dim() == 1:
        cdf = cdf.expand(x.shape[0], n)
    idx = torch.sum(cdf < x[:, None], dim=-1)
    idx = torch.clamp(idx, 0, n - 1)
    hi = torch.gather(cdf, 1, idx[:, None])[:, 0]
    lo = torch.gather(cdf, 1, torch.clamp(idx - 1, min=0)[:, None])[:, 0]
    lo = torch.where(idx > 0, lo, torch.zeros_like(lo))
    frac = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    return idx, frac


def sample(scene, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """[R,3] environment directions drawn from the tabulated importance.
    The segment remainders serve as the jitter within the texel (uniform
    given the texel), so the density realized is exactly ``pdf``'s."""
    h, w = scene.env_texel_p.shape
    row, fr = _pick(scene.env_row_cdf, u1)
    col, fc = _pick(scene.env_col_cdf[row], u2)
    v = (row.to(torch.float32) + fr) / h
    u = (col.to(torch.float32) + fc) / w
    return dir_from_uv(u, v)


def pdf(scene, direction: torch.Tensor) -> torch.Tensor:
    """[R] solid-angle pdf of ``sample``: P H W / (2 pi^2 sin(theta)) for a
    texel of probability P, with sin at the actual direction."""
    h, w = scene.env_texel_p.shape
    u, v = isect.sphere_uv(vm.normalize(direction))
    j = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    i = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    sin_t = torch.clamp(torch.sin(PI * v), min=1e-4)
    return scene.env_texel_p[j, i] * (h * w) / (2.0 * PI * PI * sin_t)
