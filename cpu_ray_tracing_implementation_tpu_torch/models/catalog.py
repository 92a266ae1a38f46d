"""Catalog scenes ported so far.

Port of ``cpu_ray_tracing_implementation_tpu/models/catalog.py``: each
function mirrors one scene of reference src/main.cc and returns ``(scene,
camera)`` on ``device``, the card unless the caller asks for the CPU.
``width``/``spp``/``max_depth`` overrides run scaled-down versions of the
same geometry. Scene-build randomness uses seeded numpy generators that
draw as the JAX package's do. The other 24 scenes are ROADMAP M13.
"""

from __future__ import annotations

import os

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE, as_device
from cpu_ray_tracing_implementation_tpu_torch.utils import image_io, procgen

# triangles of the procedural hall that stands in for Sponza at full size
SUBSTITUTE_TRIS = 260_000


def _cam_args(width, spp, max_depth, dw, dspp, ddepth):
    return (dw if width is None else width,
            dspp if spp is None else spp,
            ddepth if max_depth is None else max_depth)


def three_material_ball(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:69-85"""
    w, s, d = _cam_args(width, spp, max_depth, 1280, 100, 5)
    b = SceneBuilder()
    ground = b.lambertian(b.checker(odd=(1, 1, 1), even=(0.6, 0.6, 0.2), scale=1.0))
    glass = b.dielectric(1.5)
    matte = b.lambertian((0.4, 0.2, 0.1))
    metal = b.metal((0.7, 0.6, 0.5), 0.0)
    b.sphere((0, -1000, 0), 1000, ground)
    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, matte)
    b.sphere((4, 1, 0), 1.0, metal)
    b.set_background(b.solid((0.7, 0.8, 1.0)))
    return b.build(device), cam.perspective(w, 16 / 9, (13, 2, 3), (0, 0, 0), 1,
                                            20.0, s, d, device=device)


def random_motion_ball(width=None, spp=None, max_depth=None, seed=3,
                       device=DEFAULT_DEVICE):
    """main.cc:105-153, the final scene of Ray Tracing in One Weekend with
    motion blur: 333 moving spheres (those that the draws keep of a 22 x 22
    grid) and 4 static ones, 337 in all, one dense table (one chunk of 384
    lanes on the card's kernel K2). The numpy
    generator makes the draws of the JAX package's build in its order,
    those of skipped cells included, so the tables are the same."""
    w, s, d = _cam_args(width, spp, max_depth, 1280, 20, 50)
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambertian(b.checker((1, 1, 1), (0.6, 0.6, 0.2), 1.0))
    b.sphere((0, -1000, 0), 1000, ground)
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.uniform()
            c1 = np.array([a + 0.7 * rng.uniform(), 0.2, bb + 0.7 * rng.uniform()])
            c2 = c1 + np.array([0, rng.uniform(0, 0.15), 0])
            if np.linalg.norm(c1 - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.3:
                continue
            if choose < 0.8:
                albedo = rng.uniform(size=3) * rng.uniform(size=3)
                b.moving_sphere(c1, c2, 0.2, b.lambertian(tuple(albedo)))
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, size=3)
                b.moving_sphere(c1, c2, 0.2, b.metal(tuple(albedo), 0.0))
            else:
                b.moving_sphere(c1, c2, 0.2, b.dielectric(1.5))
    glass = b.dielectric(1.5)
    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, glass)
    b.set_background(b.solid((0.7, 0.8, 1.0)))
    return b.build(device), cam.perspective(w, 16 / 9, (13, 2, 3), (0, 0, 0), 1, 20,
                                            s, d, device=device)


def _cornell_walls(b: SceneBuilder, red, white, green):
    """The five walls of the cornell_box layout (main.cc:204-212)."""
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)


def cornell_box(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:198-225, the benchmark scene."""
    w, s, d = _cam_args(width, spp, max_depth, 600, 40, 4)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    _cornell_walls(b, red, white, green)
    b.box((0, 0, 0), (165, 330, 165), white, translate=(100, 0, 200))
    b.box((0, 0, 0), (165, 165, 165), white, translate=(50, 0, 100))
    light_q = b.quad((343, 554, 332), (-130, 0, 0), (0, 0, -105),
                     b.diffuse_light((15, 15, 15)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 1.0, (278, 278, -800), (278, 278, 0),
                                            1, 40.0, s, d, device=device)


def sponza(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:439-498, the 262k-triangle BVH scale test. Sponza.bin is
    absent from the reference snapshot, so a procedural colonnade hall of
    matching triangle count stands in (``utils/procgen.py``): 257,916
    triangles in 2,015 chunks at the default 200 px. The glTF loader is
    ROADMAP M13: wherever ``image_io.reference_asset`` finds
    ``Sponza/glTF/Sponza.gltf`` (where the JAX package would load it),
    this raises."""
    w, s, d = _cam_args(width, spp, max_depth, 200, 30, 5)
    device = as_device(device)  # before the hall is generated
    gltf = image_io.reference_asset("Sponza/glTF/Sponza.gltf")
    if os.path.exists(gltf):
        raise NotImplementedError(f"{gltf} is present: the glTF loader "
                                  "(ROADMAP M13) is not ported yet")
    b = SceneBuilder()
    white = b.lambertian((1.0, 1.0, 1.0))
    # scaled-down runs (tests) get a proportionally smaller hall
    n = SUBSTITUTE_TRIS if w >= 200 else max(2000, w * w * 40)
    b.triangles(procgen.colonnade_hall(target_tris=n), white)
    light_q = b.quad((0, 1200, 0), (500, 0, 0), (0, 0, 500),
                     b.diffuse_light((10, 10, 10)))
    b.light(light_q)
    b.set_background(b.solid((0.3, 0.35, 0.45)))
    return b.build(device), cam.perspective(w, 1.0, (500, 320, 90), (0, 280, 0),
                                            1, 45.0, s, d, device=device)


def all_materials_fixture(width=None, spp=None, max_depth=None,
                          device=DEFAULT_DEVICE):
    """Every differentiable material family live in one small scene
    (``catalog.py:540-565`` of the JAX package; not in SCENES): a checker
    ground (tex_color0 and tex_color1), a dielectric (ior), a fuzzy metal
    (fuzz), a gloss sphere (smoothness, spec_prob) and a quad light, seen
    by a perspective camera (ray time keeps geo_sph_c1 live)."""
    w, s, d = _cam_args(width, spp, max_depth, 64, 4, 4)
    b = SceneBuilder()
    ground = b.lambertian(b.checker((1, 1, 1), (0.6, 0.6, 0.2), 1.0))
    b.sphere((0, -1000, 0), 1000, ground)
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-2.2, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.3))
    b.sphere((2.2, 1, 0), 1.0, b.gloss((0.2, 0.5, 0.3), 0.8, 0.3))
    light_q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((5, 5, 5)))
    b.light(light_q)
    b.set_background(b.solid((0.4, 0.5, 0.7)))
    return b.build(device), cam.perspective(w, 1.0, (0, 2, 9), (0, 1, 0), 1, 30.0,
                                            s, d, device=device)


SCENES = {
    "three_material_ball": three_material_ball,
    "random_motion_ball": random_motion_ball,
    "cornell_box": cornell_box,
    "sponza": sponza,
}
