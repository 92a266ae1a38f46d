"""The ``planar`` family, the program side: lambertian and diffuse-light
materials on quads, boxes and triangle meshes, a solid background and a
perspective camera (``scenes.describe``), built through the port's
``SceneBuilder``. The plain side is ``reference/planar.py``.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder

from port_bench.scenes import describe  # noqa: F401  (the family's description)

# fields of the port's Camera a traffic mix may set under "camera"
CAMERA_OPTIONS = ("stratify", "clamp", "rr_depth", "nee", "qmc")


def build_scene(desc, device):
    """(scene, leaves): the scene built through ``SceneBuilder`` from the
    description, and ``{"tex_rows": texture row of each material,
    "bg_row": texture row of the background or None}``."""
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
    return b.build(device), {"tex_rows": tex_rows, "bg_row": bg_row}


def build_camera(desc, width: int, spp: int, max_depth: int, device, **options):
    """The description's perspective camera; ``options`` replace fields of
    ``CAMERA_OPTIONS``."""
    unknown = sorted(set(options) - set(CAMERA_OPTIONS))
    if unknown:
        raise TypeError(f"build_camera takes no option {unknown[0]!r}")
    c = desc.camera
    cam = cam_mod.perspective(width, c["aspect"], c["pos"], c["lookat"],
                              c["focal_length"], c["fovy_deg"], spp, max_depth,
                              device=device)
    return cam.replace(**options) if options else cam
