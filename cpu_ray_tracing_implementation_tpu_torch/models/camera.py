"""Camera models: perspective, orthographic, fisheye, thin-lens depth of
field; parameters and batched ray generation.

Port of ``cpu_ray_tracing_implementation_tpu/models/camera.py``
(src/camera.h:18-132,244-296). ``generate_rays`` maps (pixel id,
uniforms) -> (origin, direction, time); the uniforms come in explicit
slots:
  0,1: pixel jitter; 2: ray time; 3,4: defocus disk.
The parameters are tensors, so images are differentiable with respect to
the camera; the mode, resolution and sample counts are plain fields.
"""

from __future__ import annotations

from dataclasses import dataclass

import dataclasses

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
FISHEYE = 2
LENS = 3

N_CAM_SLOTS = 5


@dataclass(frozen=True)
class Camera:
    pos: torch.Tensor                # [3]
    lookat: torch.Tensor             # [3]
    fovy_deg: torch.Tensor           # scalar (perspective, fisheye, lens)
    focal_length: torch.Tensor       # scalar (perspective, fisheye)
    ortho_viewport_h: torch.Tensor   # scalar (orthographic)
    defocus_angle_deg: torch.Tensor  # scalar (lens)
    focus_dist: torch.Tensor         # scalar (lens)
    mode: int = PERSPECTIVE
    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 5
    # stratified pixel jitter (off by default, as in the JAX package)
    stratify: bool = False
    # per-sample radiance clamp (0 = off)
    clamp: float = 0.0
    # Russian roulette from this bounce on (0 = off)
    rr_depth: int = 0
    # next-event estimation: a shadow ray to a sampled light at every
    # diffuse vertex, power-heuristic MIS (off by default, as in JAX)
    nee: bool = False
    # Owen-scrambled Sobol sampling (``ops/qmc.py``): every dimension pair
    # of a path draws from a scrambled (0,2)-sequence indexed by the sample,
    # instead of the hash stream; ``stratify``'s grid is then skipped
    qmc: bool = False

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **changes) -> "Camera":
        """A copy with fields replaced (``apply_camera_params`` of
        ``models/diff.py``)."""
        return dataclasses.replace(self, **changes)


def _image_height(width: int, aspect_ratio: float) -> int:
    """int(width/aspect), clamped to >=1 (src/camera.h:34-36)."""
    return max(1, int(width / aspect_ratio))


def _mk(mode, width, aspect_ratio, pos, lookat, spp, max_depth, device, **kw):
    """A camera of ``mode`` on ``device`` (the card unless the caller asks
    for the CPU); parameters outside the mode keep their defaults."""
    device = tbl.as_device(device)
    params = dict(fovy_deg=90.0, focal_length=1.0, ortho_viewport_h=2.0,
                  defocus_angle_deg=0.0, focus_dist=1.0)
    params.update(kw)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(pos=f32(pos), lookat=f32(lookat),
                  **{k: f32(v) for k, v in params.items()}, mode=mode,
                  width=int(width), height=_image_height(width, aspect_ratio),
                  spp=int(spp), max_depth=int(max_depth))


def perspective(width, aspect_ratio, pos, lookat, focal_length=1.0, fovy_deg=90.0,
                spp=100, max_depth=5, device=tbl.DEFAULT_DEVICE) -> Camera:
    """src/camera.h:21-50"""
    return _mk(PERSPECTIVE, width, aspect_ratio, pos, lookat, spp, max_depth,
               device, focal_length=focal_length, fovy_deg=fovy_deg)


def orthographic(width, aspect_ratio, viewport_height, pos, lookat, spp=100,
                 max_depth=5, device=tbl.DEFAULT_DEVICE) -> Camera:
    """src/camera.h:52-72"""
    return _mk(ORTHOGRAPHIC, width, aspect_ratio, pos, lookat, spp, max_depth,
               device, ortho_viewport_h=viewport_height)


def fisheye(width, aspect_ratio, pos, lookat, focal_length=1.0, fovy_deg=90.0,
            spp=100, max_depth=5, device=tbl.DEFAULT_DEVICE) -> Camera:
    """src/camera.h:74-102"""
    return _mk(FISHEYE, width, aspect_ratio, pos, lookat, spp, max_depth,
               device, focal_length=focal_length, fovy_deg=fovy_deg)


def lens(width, aspect_ratio, pos, lookat, defocus_angle_deg, focus_dist=1.0,
         fovy_deg=90.0, spp=100, max_depth=5, device=tbl.DEFAULT_DEVICE) -> Camera:
    """src/camera.h:104-132 (thin-lens depth of field)"""
    return _mk(LENS, width, aspect_ratio, pos, lookat, spp, max_depth, device,
               defocus_angle_deg=defocus_angle_deg, focus_dist=focus_dist,
               fovy_deg=fovy_deg)


def stratum_grid(spp: int) -> tuple:
    """(nx, ny) with nx * ny == spp exactly and nx <= sqrt(spp) maximal."""
    spp = max(int(spp), 1)
    nx = max(int(np.sqrt(spp)), 1)
    while spp % nx:
        nx -= 1
    return nx, spp // nx


def stratify_pixel_jitter(cam: Camera, u: torch.Tensor, sample_idx) -> torch.Tensor:
    """Remap the pixel-jitter uniforms (slots 0,1) into sample
    ``sample_idx``'s stratum cell: the absolute sample index, an int or a
    per-lane [R] integer tensor (the wavefront's). No-op when cam.stratify
    is off or no sample index is known."""
    if not cam.stratify or sample_idx is None:
        return u
    nx, ny = stratum_grid(cam.spp)
    u = u.clone()
    if torch.is_tensor(sample_idx):
        s = torch.remainder(sample_idx, cam.spp)
        sx = torch.remainder(s, nx).to(torch.float32)
        sy = torch.div(s, nx, rounding_mode="floor").to(torch.float32)
    else:
        s = int(sample_idx) % cam.spp
        sx, sy = float(s % nx), float(s // nx)
    u[:, 0] = (sx + u[:, 0]) / nx
    u[:, 1] = (sy + u[:, 1]) / ny
    return u


def _basis(cam: Camera):
    """world_up = +y; right-handed camera frame (src/camera.h:25-28)."""
    world_up = cam.pos.new_tensor([0.0, 1.0, 0.0])
    d = vm.normalize(cam.lookat - cam.pos)
    right = vm.normalize(vm.cross(d, world_up))
    up = vm.cross(right, d)
    return d, right, up


def _viewport(cam: Camera):
    """Viewport height and width; the lens mode scales by focus_dist
    (src/camera.h:46-47,125-126)."""
    if cam.mode == ORTHOGRAPHIC:
        vh = cam.ortho_viewport_h
    else:
        theta = cam.fovy_deg * (smp.PI / 180.0)
        dist = cam.focus_dist if cam.mode == LENS else cam.focal_length
        vh = 2.0 * torch.tan(theta / 2.0) * dist
    return vh, vh * (cam.width / cam.height)  # the integer aspect (camera.h:41-47)


def generate_rays(cam: Camera, pixel_ids: torch.Tensor, u: torch.Tensor):
    """(origin [R,3], direction [R,3], time [R]) for flat pixel ids i*W+j,
    per mode as src/camera.h:244-284. The fisheye's equisolid bend is the
    reference's construction (camera.h:259-275) with the JAX package's
    asin and divide guards (the reference gives NaN at the image corners);
    lens rays carry time 0, as the reference's do."""
    if cam.mode not in (PERSPECTIVE, ORTHOGRAPHIC, FISHEYE, LENS):
        raise ValueError(f"unknown camera mode {cam.mode}")
    d, right, up = _basis(cam)
    vh, vw = _viewport(cam)
    W, H = cam.width, cam.height

    delta_u = (vw / W) * right
    delta_v = (-vh / H) * up

    i = torch.div(pixel_ids, W, rounding_mode="floor").to(torch.float32)
    j = torch.remainder(pixel_ids, W).to(torch.float32)
    jx = (j + (u[:, 0] - 0.5))[:, None]
    iy = (i + (u[:, 1] - 0.5))[:, None]
    time = u[:, 2]

    if cam.mode in (PERSPECTIVE, FISHEYE):
        dir00 = (cam.focal_length * d - vw / 2.0 * right + vh / 2.0 * up
                 + 0.5 * (delta_u + delta_v))
        ray_dir = dir00 + jx * delta_u + iy * delta_v
        if cam.mode == FISHEYE:
            r = vm.length(ray_dir - d)
            theta = torch.arcsin(torch.clamp(r / cam.focal_length, -1.0, 1.0))
            v1 = d[None, :]
            v2 = vm.normalize(ray_dir)
            dot12 = vm.dot(v1, v2)
            denom = torch.clamp(1.0 - dot12 * dot12, min=1e-12)
            sin_t = torch.sin(theta)
            b_prime = torch.sqrt(sin_t * sin_t / denom)
            a_prime = torch.cos(theta) - b_prime * dot12
            ray_dir = a_prime[:, None] * v1 + b_prime[:, None] * v2
        org = cam.pos.expand(ray_dir.shape)
        return org, ray_dir, time

    if cam.mode == ORTHOGRAPHIC:
        pos00 = (cam.pos - vw / 2.0 * right + vh / 2.0 * up
                 + 0.5 * (delta_u + delta_v))
        org = pos00 + jx * delta_u + iy * delta_v
        return org, d.expand(org.shape), time

    # LENS (src/camera.h:276-283): a jittered target on the focus plane,
    # the origin on the defocus disk
    fp00 = (cam.pos - vw / 2.0 * right + vh / 2.0 * up
            + 0.5 * (delta_u + delta_v))
    target = fp00 + jx * delta_u + iy * delta_v + cam.focus_dist * d
    defocus_radius = cam.focus_dist * torch.tan(
        cam.defocus_angle_deg * (smp.PI / 180.0) / 2.0)
    disk = smp.disk_sample(u[:, 3], u[:, 4])
    org = cam.pos + defocus_radius * (disk[:, 0:1] * right + disk[:, 1:2] * up)
    return org, target - org, torch.zeros_like(time)
