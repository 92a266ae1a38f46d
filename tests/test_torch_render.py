"""Whole-slice check: the port renders the golden workload like JAX.

Each ported scene renders at the golden workload of
tests/test_golden.py (16 px, 4 spp, depth 3, key 42) through the same
tables (``scene_from_numpy``) and the same key. The image mean must lie
within 2e-3 of JAX's and of the recorded golden mean, and at least 98% of
pixels within 1e-3 of JAX's image (a path can branch differently where
float rounding moves a ray across a primitive edge). At 16 px the
colonnade (sponza) has 71 chunks: JAX takes its tile-packet route there
and the port its per-ray route (K3 + K4); both are exact.
random_motion_ball's 337 moving spheres stay one dense table (kernel K2's
1-chunk view of 384 lanes in the port); sphereflake's 7,381 spheres take
58 chunks (JAX's packet route, the port's per-ray route). The F1 scenes
load earthmap.jpg or Fox.gltf, which this checkout lacks: both packages
take the same fallback, so they are held to live JAX only, not to the golden
means recorded with the asset. dispersion_prism (hero wavelengths) and
sunlit_spheres (the importance-sampled sky) are held to both; the Cornell
box under ``camera.qmc`` and under ``CRT_RNG=threefry`` to live JAX, the
same contract.
"""

import jax
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, film, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

# tests/test_golden.py GOLDEN_MEANS (recorded on the JAX package)
GOLDEN_MEANS = {"cornell_box": 0.160999, "three_material_ball": 0.563181,
                "random_motion_ball": 0.426140, "sponza": 0.402695,
                "cornell_box_with_rotated_box": 0.535078,
                "cornell_box_with_specular_box": 0.488185,
                "different_fuzz_metal": 0.322772, "skybox_and_fisheye": 0.633859,
                "sphereflake": 0.592463,
                "three_material_ball_with_defocus_blur": 0.605853,
                "white_sphere": 1.000000, "dispersion_prism": 0.782510,
                "sunlit_spheres": 0.090164}
# scenes whose asset is missing here (ROADMAP F1): earthmap.jpg, and the
# Fox, whose absence gives glass_fox an empty mesh and textured_fox a
# magenta sphere in both packages
F1_SCENES = ("cornell_box_with_glossy_ball", "infinite_reflection",
             "skybox_and_motion_blur", "glass_fox", "textured_fox")
# The depth at which pixels are held to JAX's, where it is not the golden
# workload's. sphereflake is a fractal of mirror spheres seen from 346
# units: a grazing hit on a sphere of radius 0.39 is ill-conditioned in
# float32, and on the same 4,096 camera rays both packages' hit t lie up to
# 1.6e-4 (JAX) and 1e-4 (port) from a float64 solve, on 33 to 47 rays each.
# The mirrors amplify that from the second bounce on (97% of pixels within
# 1e-3 at depth 3), so pixels are compared where every path ends at its
# first hit, and the golden workload by its mean.
PIXEL_DEPTH = {"sphereflake": 1}


def _render_both(name, depth, **cam_kw):
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=depth)
    jc = jc.replace(**cam_kw)
    jkey = jax.random.key(42)
    ref = np.asarray(jint.render_image(js, jc, jkey))
    img = integrator.render_image(
        convert.scene_from_numpy(js, device="cpu"),
        convert.camera_from_numpy(jc, device="cpu"),
        convert.key_from_numpy(jax.random.key_data(jkey))).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    return img, ref


@pytest.mark.parametrize("name", sorted(GOLDEN_MEANS) + list(F1_SCENES))
def test_golden_workload_matches_jax(name):
    img, ref = _render_both(name, 3)
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    if name in GOLDEN_MEANS:
        np.testing.assert_allclose(img.mean(), GOLDEN_MEANS[name], atol=2e-3)
    if name in PIXEL_DEPTH:
        img, ref = _render_both(name, PIXEL_DEPTH[name])
    close = np.abs(img - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()


@pytest.mark.parametrize("variant", ["qmc", "threefry"])
def test_cornell_estimator_variant_matches_jax(monkeypatch, variant):
    """Owen-Sobol QMC (``camera.qmc``) and the per-lane threefry stream,
    which the JAX package reads when it traces (hence the cleared caches)."""
    cam_kw = {"qmc": True} if variant == "qmc" else {}
    if variant == "threefry":
        monkeypatch.setenv("CRT_RNG", "threefry")
    jax.clear_caches()
    try:
        img, ref = _render_both("cornell_box", 3, **cam_kw)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    close = np.abs(img - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()


@pytest.mark.parametrize("name", sorted(GOLDEN_MEANS))
def test_own_catalog_matches_golden(name):
    """The port's own catalog build and key give the same image."""
    s, c = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
    img = integrator.render_image(s, c, keys.key(42))
    assert img.shape == (c.height, c.width, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(float(img.mean()), GOLDEN_MEANS[name], atol=2e-3)


def test_sample_partition_invariance():
    """The sample index keys the RNG: two halves sum to the whole."""
    s, c = catalog.cornell_box(width=8, spp=4, max_depth=3, device="cpu")
    ids = torch.arange(c.width * c.height, dtype=torch.int32)
    key = keys.key(5)
    whole = integrator.accumulate_samples_subset(s, c, key, ids, 0, 4)
    halves = (integrator.accumulate_samples_subset(s, c, key, ids, 0, 2)
              + integrator.accumulate_samples_subset(s, c, key, ids, 2, 2))
    torch.testing.assert_close(whole, halves, atol=1e-5, rtol=1e-5)
    # pixel subsets render the same samples as the full frame
    sub = integrator.accumulate_samples_subset(s, c, key, ids[10:30], 0, 4)
    torch.testing.assert_close(sub, whole[10:30], atol=0, rtol=0)


def test_film(tmp_path):
    img = torch.rand(4, 5, 3) * 1.5
    b = film.to_bytes(img)
    assert b.shape == (4, 5, 3) and b.dtype == np.uint8
    g = np.clip(film.linear_to_gamma(img).numpy(), 0, 0.999)
    np.testing.assert_array_equal(b, (255.999 * g).astype(np.uint8))
    film.write_ppm(str(tmp_path / "x.ppm"), img)
    head = (tmp_path / "x.ppm").read_text().split("\n")[:3]
    assert head == ["P3", "5 4", "255"]
