"""The port routes every catalog scene as the JAX package does.

For each scene of the port's catalog at 16 px (built, not rendered), with
``CRT_ACCEL`` unset and set to each accelerator and ``CRT_SORT`` unset,
``on`` and ``off``, the port's ``accel_mode``, ``_auto_mode``,
``_sort_wanted`` (at the 16 px frame's rays and at 160,000) and
``integrator._perray_routed`` decide as the JAX package's do on its own
build of the scene. Under ``auto``, sphereflake, perlin_texture_ball, the
16 px colonnade and the glTF Fox stand-in (576 triangles, 5 chunks) take
the packet route, coherence-sorted at 160,000 rays where the scene has at
least 32 chunks; a colonnade of more than 256 chunks (30 px here; 2,015 at
its own 200 px) takes the per-ray route.
"""

import pytest

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.utils import procgen

ENVS = [(None, None), ("ray", None), ("packet", None), ("bvh", None),
        ("pallas", None), ("chunked", None), (None, "on"), (None, "off"),
        ("packet", "on")]


def _kmax(scene):
    return max([int(c.mat.shape[0]) for c in (scene.sphere_chunks, scene.quad_chunks,
                                               scene.tri_chunks) if c is not None],
               default=0)


def _decide(pkg_isect, pkg_int, scene, n_pix):
    k = _kmax(scene)
    return (pkg_isect.accel_mode(), pkg_isect._auto_mode(k) if k else None,
            pkg_isect._sort_wanted(scene, n_pix), pkg_isect._sort_wanted(scene, 160_000),
            pkg_int._perray_routed(scene))


def _check(name, ps, js, n_pix, monkeypatch):
    for accel, sort in ENVS:
        for var, val in (("CRT_ACCEL", accel), ("CRT_SORT", sort)):
            if val is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, val)
        got = _decide(isect, integrator, ps, n_pix)
        assert got == _decide(jisect, jint, js, n_pix), (name, accel, sort)
    monkeypatch.delenv("CRT_ACCEL", raising=False)
    monkeypatch.delenv("CRT_SORT", raising=False)
    return _decide(isect, integrator, ps, n_pix)


@pytest.mark.parametrize("name", sorted(catalog.SCENES))
def test_catalog_scene_routes_as_jax(name, monkeypatch):
    ps, pc = catalog.SCENES[name](width=16, spp=1, max_depth=1, device="cpu")
    js, _ = jcat.SCENES[name](width=16, spp=1, max_depth=1)
    assert _kmax(ps) == _kmax(js)
    mode, auto, sort_small, sort_big, perray = _check(name, ps, js, pc.width * pc.height,
                                                      monkeypatch)
    assert mode == "auto" and not sort_small and not perray
    if name in ("sphereflake", "perlin_texture_ball", "sponza"):
        assert auto == "packet" and sort_big == (_kmax(ps) >= 32)
        assert sort_big == (name != "perlin_texture_ball")   # 58, 19, 71 chunks


def test_fox_standin_and_large_colonnade_route_as_jax(tmp_path, monkeypatch):
    pos, nrm, uv, idx = procgen.ellipsoid_mesh(24, 13)
    procgen.write_gltf(str(tmp_path / "Fox" / "glTF" / "Fox.gltf"), pos, idx, nrm, uv,
                       png=procgen.checker_png(),
                       nodes=[{"mesh": 0, "translation": [0, 45, 0]}])
    monkeypatch.setenv("CRT_ASSETS", str(tmp_path))
    for name in ("glass_fox", "textured_fox"):
        ps, pc = catalog.SCENES[name](width=16, spp=1, max_depth=1, device="cpu")
        js, _ = jcat.SCENES[name](width=16, spp=1, max_depth=1)
        assert ps.counts[2] == 576 and _kmax(ps) == _kmax(js) == 5
        decided = _check(name, ps, js, 256, monkeypatch)
        assert decided[1] == "packet" and not decided[3] and not decided[4]
    monkeypatch.delenv("CRT_ASSETS")
    # the JAX package's decisions read only the chunk tables' shapes and the
    # scene's AABB, so they are asked of the port's own build here
    ps, pc = catalog.sponza(width=30, spp=1, max_depth=1, device="cpu")
    assert _kmax(ps) >= isect.RAY_MIN_CHUNKS == jisect.RAY_MIN_CHUNKS
    decided = _check("sponza 30 px", ps, ps, 900, monkeypatch)
    assert decided[1] == "ray" and decided[4] and not decided[3]
    # the colonnade at its own 200 px: 2,015 chunks
    assert isect._auto_mode(2015) == jisect._auto_mode(2015) == "ray"
