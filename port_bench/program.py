"""The system under test: the port's public entry points, driven from a
scene description.

The harness reaches the port (``cpu_ray_tracing_implementation_tpu_torch``)
through this module and ``tracing.py``; the reference never
does.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder


def build_scene(desc, device):
    """(scene, texture row of each material, texture row of the background
    or None), built through ``SceneBuilder`` from the description."""
    b = SceneBuilder()
    tex_rows, mats = [], []
    for kind, color in desc.materials:
        t = b.solid(color)
        tex_rows.append(t)
        mats.append(b.lambertian(t) if kind == "lambertian" else b.diffuse_light(t))
    bg_row = None
    if desc.background is not None:
        bg_row = b.solid(desc.background)
        b.set_background(bg_row)
    for c, u, v, m in zip(desc.quad_corner, desc.quad_u, desc.quad_v, desc.quad_mat):
        b.quad(c, u, v, mats[int(m)])
    for q in desc.lights:
        b.light(q)
    for m in np.unique(desc.tri_mat):
        b.triangles(desc.tri_verts[desc.tri_mat == m], mats[int(m)])
    return b.build(device), tex_rows, bg_row


def build_camera(desc, width: int, spp: int, max_depth: int, device):
    c = desc.camera
    return cam_mod.perspective(width, c["aspect"], c["pos"], c["lookat"],
                               c["focal_length"], c["fovy_deg"], spp, max_depth,
                               device=device)


def key_words(key) -> np.ndarray:
    """A key as the port takes it: [2] uint32."""
    return np.array([int(key[0]), int(key[1])], np.uint32)


# entry name -> what one request runs; a traffic mix names its entry
def render_scan(scene, camera, key, target=None):
    return integrator.render_image(scene, camera, key_words(key))


def render_wavefront(scene, camera, key, target=None):
    return integrator.render_image_wavefront(scene, camera, key_words(key))


def grad_step(scene, camera, key, target, geometry=False):
    """(loss, gradients): the scene's leaves under their names, the
    camera's under ``camera.<name>``."""
    loss, (gs, gc) = diff.loss_and_grads(scene, camera, key_words(key), target,
                                         camera.spp, geometry=geometry)
    return loss, {**gs, **{f"camera.{k}": v for k, v in gc.items()}}


ENTRIES = {"scan": render_scan, "wavefront": render_wavefront, "grad": grad_step}
