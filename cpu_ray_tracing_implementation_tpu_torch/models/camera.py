"""Perspective camera: parameters and batched ray generation.

Port of ``cpu_ray_tracing_implementation_tpu/models/camera.py`` for the
perspective mode (src/camera.h:21-50,244-284). ``generate_rays`` maps
(pixel id, uniforms) -> (origin, direction, time); the uniforms come in
explicit slots:
  0,1: pixel jitter; 2: ray time; 3,4: defocus disk.
The orthographic, fisheye and thin-lens modes are ROADMAP M3.
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
    pos: torch.Tensor           # [3]
    lookat: torch.Tensor        # [3]
    fovy_deg: torch.Tensor      # scalar
    focal_length: torch.Tensor  # scalar
    mode: int = PERSPECTIVE
    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 5
    # stratified pixel jitter (off by default, as in the JAX package)
    stratify: bool = False
    # per-sample radiance clamp (0 = off)
    clamp: float = 0.0

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


def perspective(width, aspect_ratio, pos, lookat, focal_length=1.0, fovy_deg=90.0,
                spp=100, max_depth=5, device=tbl.DEFAULT_DEVICE) -> Camera:
    """src/camera.h:21-50. Built on the card unless ``device`` says
    otherwise."""
    device = tbl.as_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(pos=f32(pos), lookat=f32(lookat), fovy_deg=f32(fovy_deg),
                  focal_length=f32(focal_length), mode=PERSPECTIVE,
                  width=int(width), height=_image_height(width, aspect_ratio),
                  spp=int(spp), max_depth=int(max_depth))


def stratum_grid(spp: int) -> tuple:
    """(nx, ny) with nx * ny == spp exactly and nx <= sqrt(spp) maximal."""
    spp = max(int(spp), 1)
    nx = max(int(np.sqrt(spp)), 1)
    while spp % nx:
        nx -= 1
    return nx, spp // nx


def stratify_pixel_jitter(cam: Camera, u: torch.Tensor, sample_idx) -> torch.Tensor:
    """Remap the pixel-jitter uniforms (slots 0,1) into sample
    ``sample_idx``'s stratum cell (an int: the absolute sample index).
    No-op when cam.stratify is off or no sample index is known."""
    if not cam.stratify or sample_idx is None:
        return u
    nx, ny = stratum_grid(cam.spp)
    s = int(sample_idx) % cam.spp
    u = u.clone()
    u[:, 0] = (float(s % nx) + u[:, 0]) / nx
    u[:, 1] = (float(s // nx) + u[:, 1]) / ny
    return u


def _basis(cam: Camera):
    """world_up = +y; right-handed camera frame (src/camera.h:25-28)."""
    world_up = cam.pos.new_tensor([0.0, 1.0, 0.0])
    d = vm.normalize(cam.lookat - cam.pos)
    right = vm.normalize(vm.cross(d, world_up))
    up = vm.cross(right, d)
    return d, right, up


def generate_rays(cam: Camera, pixel_ids: torch.Tensor, u: torch.Tensor):
    """(origin [R,3], direction [R,3], time [R]) for flat pixel ids i*W+j
    (src/camera.h:244-258)."""
    if cam.mode != PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported "
                                  "(other modes: ROADMAP M3)")
    d, right, up = _basis(cam)
    theta = cam.fovy_deg * (smp.PI / 180.0)
    vh = 2.0 * torch.tan(theta / 2.0) * cam.focal_length
    vw = vh * (cam.width / cam.height)
    W, H = cam.width, cam.height

    delta_u = (vw / W) * right
    delta_v = (-vh / H) * up

    i = torch.div(pixel_ids, W, rounding_mode="floor").to(torch.float32)
    j = torch.remainder(pixel_ids, W).to(torch.float32)
    jx = (j + (u[:, 0] - 0.5))[:, None]
    iy = (i + (u[:, 1] - 0.5))[:, None]
    time = u[:, 2]

    dir00 = (cam.focal_length * d - vw / 2.0 * right + vh / 2.0 * up
             + 0.5 * (delta_u + delta_v))
    ray_dir = dir00 + jx * delta_u + iy * delta_v
    org = cam.pos.expand(ray_dir.shape)
    return org, ray_dir, time
