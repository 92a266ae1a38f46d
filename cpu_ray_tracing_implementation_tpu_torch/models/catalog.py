"""The scene catalog.

Port of ``cpu_ray_tracing_implementation_tpu/models/catalog.py``: each
function mirrors one scene of reference src/main.cc (or one of the JAX
package's extension scenes) and returns ``(scene, camera)`` on ``device``,
the card unless the caller asks for the CPU. ``width``/``spp``/``max_depth``
overrides run scaled-down versions of the same geometry. Scene-build
randomness uses seeded numpy generators that draw as the JAX package's do.
The glTF scenes load their assets through ``utils/gltf.py`` wherever
``image_io.reference_asset`` finds them, and take the JAX package's
fallbacks where it does not.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE, as_device
from cpu_ray_tracing_implementation_tpu_torch.utils import gltf, image_io, procgen

# triangles of the procedural hall that stands in for Sponza at full size
SUBSTITUTE_TRIS = 260_000


def _cam_args(width, spp, max_depth, dw, dspp, ddepth):
    return (dw if width is None else width,
            dspp if spp is None else spp,
            ddepth if max_depth is None else max_depth)


def _earth(b: SceneBuilder) -> int:
    """The earth picture (earthmap.jpg; a 1x1 magenta image where the
    reference snapshot is absent, as in the JAX package)."""
    return b.picture(image_io.load_image(image_io.reference_asset("earthmap.jpg")))


def _skybox(b: SceneBuilder) -> int:
    # bathroom.exr is missing from the snapshot: the procedural substitute
    return b.picture(image_io.procedural_sky())


def _onb_transform_np(normal, local):
    """numpy mirror of src/onb.h for procedural scene generation
    (sphereflake)."""
    y = normal / np.linalg.norm(normal)
    a = np.array([0.0, 0.0, 1.0]) if abs(y[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
    z = np.cross(y, a)
    z /= np.linalg.norm(z)
    x = np.cross(y, z)
    return local[0] * x + local[1] * y + local[2] * z


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


def three_material_ball_with_defocus_blur(width=None, spp=None, max_depth=None,
                                          device=DEFAULT_DEVICE):
    """main.cc:87-103 (thin-lens camera)"""
    w, s, d = _cam_args(width, spp, max_depth, 1280, 1000, 5)
    b = SceneBuilder()
    ground = b.lambertian(b.checker((1, 1, 1), (0.6, 0.6, 0.2), 1.0))
    glass = b.dielectric(1.5)
    matte = b.lambertian((0.4, 0.2, 0.1))
    metal = b.metal((0.7, 0.6, 0.5), 0.0)
    b.sphere((0, -1000, 0), 1000, ground)
    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, matte)
    b.sphere((4, 1, 0), 1.0, metal)
    b.set_background(b.solid((0.7, 0.8, 1.0)))
    return b.build(device), cam.lens(w, 16 / 9, (13, 2, 3), (1, 1, 1),
                                     defocus_angle_deg=2.0, focus_dist=15,
                                     fovy_deg=20.0, spp=s, max_depth=d, device=device)


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


def simple_light_earth(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:155-171 (a quad light, gloss, a perlin ground; loads
    earthmap.jpg)"""
    w, s, d = _cam_args(width, spp, max_depth, 1280, 500, 5)
    b = SceneBuilder()
    b.sphere((0, -1000, 0), 1000, b.lambertian(b.perlin(4)))
    b.sphere((0, 2, 0), 2, b.gloss(_earth(b), 1.0, 0.08))
    light_q = b.quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), b.diffuse_light((9, 9, 9)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 16 / 9, (26, 3, 6), (0, 2, 0), 1, 20.0,
                                            s, d, device=device)


def skybox_and_fisheye(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:173-183 (fisheye camera, the skybox substitute)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 500, 5)
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1, b.dielectric(1.0))
    b.set_background(_skybox(b))
    return b.build(device), cam.fisheye(w, 1, (1.1, 1.8, 1.1), (0, 0, 0), 1.0, 90,
                                        s, d, device=device)


def skybox_and_motion_blur(width=None, spp=None, max_depth=None,
                           device=DEFAULT_DEVICE):
    """main.cc:185-196 (loads earthmap.jpg)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 500, 5)
    b = SceneBuilder()
    b.moving_sphere((-0.2, 0, 0), (0.2, 0, 0), 1, b.lambertian(_earth(b)))
    b.set_background(_skybox(b))
    return b.build(device), cam.perspective(w, 1, (0, 0, 4), (0, 0, 0), 1.0, 70, s, d,
                                            device=device)


def _cornell_walls(b: SceneBuilder, red, white, green, top_variant: int = 0,
                   metal_walls=None):
    """Five Cornell walls; ``top_variant`` 0 is the cornell_box layout
    (main.cc:204-212), 1 that of the volume, specular and rotated variants
    (main.cc:234-240)."""
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    if top_variant == 0:
        b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
        b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
        b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), metal_walls or white)
    else:
        b.quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)
        b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
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


def cornell_box_with_volume(width=None, spp=None, max_depth=None,
                            device=DEFAULT_DEVICE):
    """main.cc:227-253 (constant-density smoke boxes, rotate_y)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 100, 5)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    _cornell_walls(b, red, white, green, top_variant=1)
    b.volume_box((0, 0, 0), (150, 280, 150), 0.02, (0, 0, 0),
                 rotate=("y", 45), translate=(265, 0, 285))
    b.volume_box((0, 0, 0), (140, 140, 140), 0.02, (1, 1, 1),
                 rotate=("y", -15), translate=(130, 0, 65))
    light_q = b.quad((113, 554, 127), (330, 0, 0), (0, 0, 305), b.diffuse_light((7, 7, 7)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 1.0, (278, 278, -800), (278, 278, 0),
                                            1, 40, s, d, device=device)


def cornell_box_with_rotated_box(width=None, spp=None, max_depth=None,
                                 device=DEFAULT_DEVICE):
    """main.cc:284-307 (rotate_z instancing)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 100, 5)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    _cornell_walls(b, red, white, green, top_variant=1)
    b.box((265, 0, 295), (430, 330, 460), white, rotate=("z", 15))
    light_q = b.quad((113, 554, 127), (330, 0, 0), (0, 0, 305), b.diffuse_light((7, 7, 7)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 1.0, (278, 278, -800), (278, 278, 0),
                                            1, 40, s, d, device=device)


def cornell_box_with_specular_box(width=None, spp=None, max_depth=None,
                                  device=DEFAULT_DEVICE):
    """main.cc:255-283 (mirror box in Cornell)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 500, 5)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    met = b.metal((1.0, 1.0, 1.0), 0.0)
    _cornell_walls(b, red, white, green, top_variant=1)
    b.box((0, 0, 0), (150, 280, 150), met, rotate=("y", 20), translate=(265, 0, 285))
    b.box((0, 0, 0), (140, 140, 140), white, rotate=("y", -15), translate=(130, 0, 65))
    light_q = b.quad((113, 554, 127), (330, 0, 0), (0, 0, 305), b.diffuse_light((7, 7, 7)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 1.0, (278, 278, -800), (278, 278, 0),
                                            1, 40, s, d, device=device)


def perlin_texture_ball(width=None, spp=None, max_depth=None, seed=12,
                        device=DEFAULT_DEVICE):
    """main.cc:402-437 (a field of 400 boxes, 2,401 quads in all, chunked
    into 19 chunks and packet routed; a perlin sphere and a dielectric). As in the JAX
    package the perlin sphere is translated, not rotated (a rotation of a
    sphere turns only its texture space), and the light quad is geometry
    only: the reference renders this scene without light sampling
    (main.cc:436)."""
    w, s, d = _cam_args(width, spp, max_depth, 600, 500, 5)
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0 = -1000.0 + i * 100.0
            z0 = -1000.0 + j * 100.0
            b.box((x0, 0.0, z0), (x0 + 100.0, rng.uniform(1, 101), z0 + 100.0), ground)
    b.quad((123, 554, 147), (300, 0, 0), (0, 0, 265), b.diffuse_light((7, 7, 7)))
    b.sphere((260, 150, 45), 50, b.dielectric(1.5))
    b.sphere((180, 280, 400), 80, b.lambertian(b.perlin(8)))
    return b.build(device), cam.perspective(w, 1.0, (478, 278, -600), (278, 278, 0),
                                            1, 40.0, s, d, device=device)


def sphereflake(width=None, spp=None, max_depth=None, depth_levels=4,
                device=DEFAULT_DEVICE):
    """main.cc:23-67, the recursive fractal: 7,381 metal spheres at depth 4
    (58 chunks, packet routed), the reference's only timed benchmark."""
    w, s, d = _cam_args(width, spp, max_depth, 400, 50, 5)
    b = SceneBuilder()
    metal = b.metal((0.5, 0.5, 0.5))

    def recur(radius, center, level, direction):
        b.sphere(center, radius, metal)
        if level == 0:
            return
        scale = 0.25
        for i in range(6):
            ang = 2.0 * np.pi * i / 6.0
            off = _onb_transform_np(direction, np.array([np.cos(ang), 0.0, np.sin(ang)]))
            new_dir = off.copy()
            off = off * (radius + radius * scale)
            recur(radius * scale, center + off, level - 1, new_dir)
        for i in range(3):
            ang = 2.0 * np.pi * i / 3.0
            off = _onb_transform_np(direction, np.array([
                np.cos(ang) * np.cos(np.pi / 3), np.sin(np.pi / 3),
                np.sin(ang) * np.cos(np.pi / 3)]))
            new_dir = off.copy()
            off = off * (radius + radius * scale)
            recur(radius * scale, center + off, level - 1, new_dir)

    recur(100.0, np.zeros(3), depth_levels, np.array([0.0, 1.0, 0.0]))
    b.set_background(_skybox(b))
    return b.build(device), cam.perspective(w, 1.0, (200, 200, 200), (0, 0, 0), 1,
                                            90.0, s, d, device=device)


def white_sphere(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:500-510 (minimal smoke test)"""
    w, s, d = _cam_args(width, spp, max_depth, 400, 100, 5)
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1, b.metal((1.0, 1.0, 1.0), 0.1))
    b.set_background(b.solid((1.0, 1.0, 1.0)))
    return b.build(device), cam.perspective(w, 1.0, (13, 2, 3), (0, 0, 0), 1, 20, s, d,
                                            device=device)


def _gloss_room(b: SceneBuilder):
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.quad((18, -4, -3), (0, 8, 0), (0, 0, 6), green)
    b.quad((0, -4, -3), (0, 8, 0), (0, 0, 6), red)
    b.quad((0, -4, -3), (18, 0, 0), (0, 0, 6), white)
    b.quad((0, 4, -3), (18, 0, 0), (0, 0, 6), white)
    b.quad((0, -4, -3), (18, 0, 0), (0, 10, 0), white)


def different_fuzz_metal(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:512-547 (metal fuzz sweep 0 -> 1)"""
    w, s, d = _cam_args(width, spp, max_depth, 760, 1000, 10)
    b = SceneBuilder()
    _gloss_room(b)
    for x, fuzz in ((2, 0.0), (5.5, 0.25), (9, 0.5), (12.5, 0.75), (16, 1.0)):
        b.sphere((x, 0, -0.5), 1.25, b.metal((1.0, 1.0, 1.0), fuzz))
    light_q = b.quad((5.5, 3.995, -1.25), (7, 0, 0), (0, 0, 2.5), b.diffuse_light((7, 7, 7)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 19 / 9, (9, 0, 15.2), (9, 0, 1), 1, 40.0,
                                            s, d, device=device)


def infinite_reflection(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:549-579 (parallel mirrors, depth 30; loads earthmap.jpg)"""
    w, s, d = _cam_args(width, spp, max_depth, 600, 1000, 30)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    metal = b.metal((0.8, 0.8, 0.8), 0.0)
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), metal)
    b.quad((0, 0, 0), (555, 0, 0), (0, 555, 0), metal)
    b.sphere((460, 80, 80), 60, b.gloss(_earth(b), 0.97, 0.18))
    b.box((0, 0, 0), (140, 140, 140), white, rotate=("y", -15), translate=(130, 0, 65))
    light_q = b.quad((113, 554, 127), (330, 0, 0), (0, 0, 305), b.diffuse_light((5, 5, 5)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 1.0, (500, 290, 550), (400, 278, 0), 1,
                                            40.0, s, d, device=device)


def cornell_box_with_glossy_ball(width=None, spp=None, max_depth=None,
                                 device=DEFAULT_DEVICE):
    """main.cc:309-343 (gloss specular-probability sweep, 19:9; loads
    earthmap.jpg)"""
    w, s, d = _cam_args(width, spp, max_depth, 760, 1000, 10)
    b = SceneBuilder()
    _gloss_room(b)
    earth = _earth(b)
    for x, prob in ((3, 1.0), (7, 0.40), (11, 0.15), (15, 0.02)):
        b.sphere((x, 0, -0.5), 1.25, b.gloss(earth, 1.0, prob))
    light_q = b.quad((5.5, 3.995, -1.25), (7, 0, 0), (0, 0, 2.5), b.diffuse_light((8, 8, 8)))
    b.light(light_q)
    return b.build(device), cam.perspective(w, 19 / 9, (9, 0, 15.2), (9, 0, 1), 1, 40.0,
                                            s, d, device=device)


def _noise_test(tex_fn, extent, vp_h, cam_pos, cam_look, width, spp, max_depth,
                device):
    """A noise texture on one quad, seen by an orthographic camera."""
    b = SceneBuilder()
    b.quad((0, 0, 0), (extent, 0, 0), (0, extent, 0), b.lambertian(tex_fn(b)))
    b.set_background(b.solid((1.0, 1.0, 1.0)))
    return b.build(device), cam.orthographic(width, 1, vp_h, cam_pos, cam_look, spp,
                                             max_depth, device=device)


def test_perlin_noise(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:581-593 (orthographic camera, perlin on a quad)"""
    w, s, d = _cam_args(width, spp, max_depth, 400, 10, 5)
    return _noise_test(lambda b: b.perlin(1), 10, 10, (5, 5, 1), (5, 5, 0), w, s, d,
                       device)


def test_value_noise(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:595-606"""
    w, s, d = _cam_args(width, spp, max_depth, 400, 10, 5)
    return _noise_test(lambda b: b.value(40), 40, 20, (20, 20, 1), (20, 20, 0), w, s,
                       d, device)


def test_worley_noise(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:608-618"""
    w, s, d = _cam_args(width, spp, max_depth, 400, 10, 5)
    return _noise_test(lambda b: b.worley(), 40, 20, (20, 20, 1), (20, 20, 0), w, s, d,
                       device)


def test_voronoi_noise(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:620-631"""
    w, s, d = _cam_args(width, spp, max_depth, 400, 10, 5)
    return _noise_test(lambda b: b.voronoi(), 40, 20, (20, 20, 1), (20, 20, 0), w, s,
                       d, device)


def glass_fox(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:345-400: the glTF Fox as dielectric triangles under the
    skybox. Without Fox.gltf the mesh is empty, as in the JAX package."""
    w, s, d = _cam_args(width, spp, max_depth, 600, 200, 5)
    b = SceneBuilder()
    glass = b.dielectric(1.5)
    b.triangles(gltf.load_triangles(image_io.reference_asset("Fox/glTF/Fox.gltf")),
                glass)
    b.set_background(_skybox(b))
    return b.build(device), cam.perspective(w, 1.0, (220, 220, 220), (0, 20, 0), 1,
                                            45.0, s, d, device=device)


def sponza(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """main.cc:439-498, the 262k-triangle BVH scale test: the triangles of
    ``Sponza/glTF/Sponza.gltf`` wherever ``image_io.reference_asset`` finds
    it. Sponza.bin is absent from the reference snapshot, so where the
    loader comes back empty a procedural colonnade hall of matching
    triangle count stands in (``utils/procgen.py``): 257,916 triangles in
    2,015 chunks at the default 200 px."""
    w, s, d = _cam_args(width, spp, max_depth, 200, 30, 5)
    device = as_device(device)  # before the hall is generated
    b = SceneBuilder()
    white = b.lambertian((1.0, 1.0, 1.0))
    verts = gltf.load_triangles(image_io.reference_asset("Sponza/glTF/Sponza.gltf"))
    if not len(verts):
        # scaled-down runs (tests) get a proportionally smaller hall
        n = SUBSTITUTE_TRIS if w >= 200 else max(2000, w * w * 40)
        verts = procgen.colonnade_hall(target_tris=n)
    b.triangles(verts, white)
    light_q = b.quad((0, 1200, 0), (500, 0, 0), (0, 0, 500),
                     b.diffuse_light((10, 10, 10)))
    b.light(light_q)
    b.set_background(b.solid((0.3, 0.35, 0.45)))
    return b.build(device), cam.perspective(w, 1.0, (500, 320, 90), (0, 280, 0),
                                            1, 45.0, s, d, device=device)


def smoke_fox(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """The glTF Fox as a constant-density medium (a VOL_MESH boundary; the
    JAX package's extension scene). The Fox is non-convex, so the medium
    fills each ray's [entry, last exit] span. Without Fox.gltf the medium
    is bounded by the JAX package's fallback mesh of 16 triangles (an
    octagonal double cone)."""
    w, s, d = _cam_args(width, spp, max_depth, 400, 60, 5)
    device = as_device(device)
    verts = gltf.load_triangles(image_io.reference_asset("Fox/glTF/Fox.gltf"))
    if not len(verts):  # asset missing: keep the scene buildable
        th = np.linspace(0, 2 * np.pi, 9)[:-1]
        ring = np.stack([40 * np.cos(th), 40 + 0 * th, 40 * np.sin(th)], -1)
        apex_t = np.array([0.0, 90.0, 0.0])
        apex_b = np.array([0.0, -10.0, 0.0])
        verts = np.concatenate([
            np.stack([ring, np.roll(ring, -1, 0), np.broadcast_to(apex_t, ring.shape)], 1),
            np.stack([np.roll(ring, -1, 0), ring, np.broadcast_to(apex_b, ring.shape)], 1)])
    b = SceneBuilder()
    b.volume_mesh(verts, 0.04, (0.8, 0.8, 0.85))
    b.quad((-400, 0, -400), (800, 0, 0), (0, 0, 800), b.lambertian((0.45, 0.4, 0.35)))
    lq = b.quad((-80, 220, -80), (160, 0, 0), (0, 0, 160), b.diffuse_light((6, 6, 6)))
    b.light(lq)
    b.set_background(b.solid((0.35, 0.45, 0.6)))
    return b.build(device), cam.perspective(w, 1.0, (220, 120, 220), (0, 45, 0), 1,
                                            45.0, s, d, device=device)


def textured_fox(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """The glTF Fox with its per-vertex normals, UVs and PNG texture (the
    JAX package's extension scene; the reference's loader parses them and
    discards them, src/main.cc:353-393): smooth-shaded, texture-mapped
    lambertian, each primitive bound to its own glTF material
    (``SceneBuilder.gltf_asset``). Without Fox.gltf a magenta sphere
    stands in, as in the JAX package."""
    w, s, d = _cam_args(width, spp, max_depth, 600, 100, 5)
    b = SceneBuilder()
    asset = gltf.load_asset(image_io.reference_asset("Fox/glTF/Fox.gltf"))
    if not b.gltf_asset(asset):  # asset missing: keep the scene buildable
        b.sphere((0, 40, 0), 40.0, b.lambertian((1.0, 0.0, 1.0)))
    b.set_background(_skybox(b))
    return b.build(device), cam.perspective(w, 1.0, (220, 220, 220), (0, 40, 0), 1,
                                            45.0, s, d, device=device)


def cornell_box_with_sphere_light(width=None, spp=None, max_depth=None,
                                  device=DEFAULT_DEVICE):
    """The Cornell box lit by an emissive sphere sampled as a light by
    solid-angle cone sampling (the JAX package's extension scene; the
    reference's sphere-light hook, src/sphere.h:76-81, is a placeholder)."""
    w, s, d = _cam_args(width, spp, max_depth, 600, 40, 4)
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    _cornell_walls(b, red, white, green)
    b.box((0, 0, 0), (165, 330, 165), white, translate=(100, 0, 200))
    b.box((0, 0, 0), (165, 165, 165), white, translate=(50, 0, 100))
    b.sphere_light(b.sphere((278, 500, 279), 54.0, b.diffuse_light((15, 15, 15))))
    return b.build(device), cam.perspective(w, 1.0, (278, 278, -800), (278, 278, 0),
                                            1, 40.0, s, d, device=device)


def dispersion_prism(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """Spectral dispersion (the JAX package's extension scene): a
    dense-flint glass sphere (Cauchy B exaggerated to 0.08 um^2) in front
    of three thin white light strips on a black background. Every path
    carries a hero wavelength, refracts at the Cauchy-shifted IOR and is
    weighted by the normalized wavelength response (``ops/spectrum.py``),
    the render layer that the reference's spectrum.h only scaffolds."""
    w, s, d = _cam_args(width, spp, max_depth, 400, 200, 6)
    b = SceneBuilder()
    glass = b.dielectric(1.5, dispersion=0.08)
    white = b.diffuse_light((8.0, 8.0, 8.0))
    b.sphere((0, 0, -3), 1.0, glass)
    for y in (-0.8, 0.0, 0.8):
        b.quad((-2.0, y - 0.05, -6.5), (4.0, 0, 0), (0, 0.1, 0), white)
    b.set_background(b.solid((0.0, 0.0, 0.0)))
    return b.build(device), cam.perspective(w, 1.0, (0, 0, 0), (0, 0, -3), 1, 40.0,
                                            s, d, device=device)


def sunlit_spheres(width=None, spp=None, max_depth=None, device=DEFAULT_DEVICE):
    """The importance-sampled environment light (the JAX package's
    extension scene, ``ops/envlight.py``): a small bright sun patch on a
    dim sky picture lights four spheres; ``importance_sample=True`` puts
    the background in the MIS mixture, so diffuse surfaces find the sun by
    construction."""
    w, s, d = _cam_args(width, spp, max_depth, 400, 50, 5)
    sky = np.full((64, 128, 3), 8.0, np.float32)
    for j in range(64):  # soft vertical gradient, byte scale
        sky[j] += 30.0 * (1.0 - abs(j - 20) / 44.0)
    sky[14:18, 30:35] = 255.0  # the sun
    b = SceneBuilder()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian((0.7, 0.7, 0.7)))
    b.sphere((-1.6, 0.8, 0), 0.8, b.lambertian((0.7, 0.3, 0.2)))
    b.sphere((0.0, 0.8, 0), 0.8, b.metal((0.8, 0.8, 0.9), 0.05))
    b.sphere((1.6, 0.8, 0), 0.8, b.gloss((0.2, 0.5, 0.3), 0.8, 0.3))
    b.set_background(b.picture(sky), importance_sample=True)
    return b.build(device), cam.perspective(w, 1.78, (0, 1.4, 5.5), (0, 0.8, 0),
                                            1, 35.0, s, d, device=device)


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
    "three_material_ball_with_defocus_blur": three_material_ball_with_defocus_blur,
    "random_motion_ball": random_motion_ball,
    "skybox_and_fisheye": skybox_and_fisheye,
    "skybox_and_motion_blur": skybox_and_motion_blur,
    "cornell_box": cornell_box,
    "cornell_box_with_rotated_box": cornell_box_with_rotated_box,
    "cornell_box_with_specular_box": cornell_box_with_specular_box,
    "glass_fox": glass_fox,
    "sphereflake": sphereflake,
    "sponza": sponza,
    "white_sphere": white_sphere,
    "different_fuzz_metal": different_fuzz_metal,
    "infinite_reflection": infinite_reflection,
    "cornell_box_with_glossy_ball": cornell_box_with_glossy_ball,
    "simple_light_earth": simple_light_earth,
    "cornell_box_with_volume": cornell_box_with_volume,
    "perlin_texture_ball": perlin_texture_ball,
    "test_perlin_noise": test_perlin_noise,
    "test_value_noise": test_value_noise,
    "test_worley_noise": test_worley_noise,
    "test_voronoi_noise": test_voronoi_noise,
    "smoke_fox": smoke_fox,
    "cornell_box_with_sphere_light": cornell_box_with_sphere_light,
    "textured_fox": textured_fox,
    "dispersion_prism": dispersion_prism,
    "sunlit_spheres": sunlit_spheres,
}
