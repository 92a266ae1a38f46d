"""The importance-sampled environment light in the port against the JAX
package.

``envlight.build_tables`` on sunlit_spheres' sky, from the port's own
build and from JAX's tables carried across: rtol 1e-5 (two float32
cumsums, whose summation order may differ in the last ulp). ``sample`` and
``pdf`` on JAX's own tables (``convert.scene_from_numpy``): directions atol
1e-5, pdf rtol 1e-4. The light mixture with the environment as its only
light and beside a quad light: ``light_sample`` / ``light_pdf`` atol 1e-4,
as tests/test_torch_nee.py holds the sphere lights. sunlit_spheres with NEE
(the shadow ray's environment term) at the golden workload against JAX's
render: the mean within 2e-3 and 98% of pixels within 1e-3, and the
wavefront against the scan (rtol/atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import envlight as jenv
from cpu_ray_tracing_implementation_tpu.ops import materials as jmat
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops import envlight, keys
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

N = 4096
RNG = np.random.default_rng(23)
TABLE_TOL = dict(rtol=1e-5, atol=1e-9)
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sunlit():
    js, jc = jcat.sunlit_spheres(width=16, spp=4, max_depth=3)
    return js, jc, convert.scene_from_numpy(js, device="cpu")


def _tables(scene):
    return [np.asarray(t) if not torch.is_tensor(t) else t.numpy()
            for t in (scene.env_texel_p, scene.env_row_cdf, scene.env_col_cdf)]


def test_build_tables_match_jax(sunlit):
    js, _, ps = sunlit
    ref = _tables(js)
    own, _ = catalog.sunlit_spheres(width=16, spp=4, max_depth=3, device="cpu")
    assert own.has_env_light and own.has_lights
    for got, want in zip(_tables(own), ref):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TABLE_TOL)
    # rebuilt from the tables JAX's scene carries, at another resolution
    for got, want in zip(envlight.build_tables(ps, (32, 48)),
                         jenv.build_tables(js, (32, 48))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TABLE_TOL)


def test_sample_and_pdf_match_jax(sunlit):
    js, _, ps = sunlit
    u1, u2 = RNG.uniform(0, 1, (2, N)).astype(np.float32)
    # the corners of the unit square: the first and last texels of a row
    u1[:4], u2[:4] = [0.0, 0.0, 0.9999999, 0.9999999], [0.0, 0.9999999, 0.0, 0.9999999]
    got = envlight.sample(ps, torch.as_tensor(u1), torch.as_tensor(u2)).numpy()
    ref = np.asarray(jenv.sample(js, jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    d = np.concatenate([ref, RNG.normal(size=(N, 3)).astype(np.float32)])
    np.testing.assert_allclose(envlight.pdf(ps, torch.as_tensor(d)).numpy(),
                               np.asarray(jenv.pdf(js, jnp.asarray(d))), rtol=1e-4)
    u = torch.as_tensor(u1)
    np.testing.assert_allclose(envlight.dir_from_uv(u, torch.as_tensor(u2)).numpy(),
                               np.asarray(jenv.dir_from_uv(u1, u2)), atol=1e-6)


def test_pdf_integrates_to_one(sunlit):
    """The solid-angle pdf integrates to 1 over the sphere (uniform MC)."""
    ps = sunlit[2]
    g = torch.Generator().manual_seed(5)
    d = torch.randn((200_000, 3), generator=g)
    est = float((envlight.pdf(ps, d) * 4.0 * np.pi).mean())
    assert abs(est - 1.0) < 0.05, est


def _mixed(builder):
    """An env-lit scene with a quad light beside the sky: three lights."""
    b = builder()
    sky = np.full((8, 16, 3), 20.0, np.float32)
    sky[2, 5] = 255.0
    b.sphere((0, -100, 0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.light(b.quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4))))
    b.sphere_light(b.sphere((2, 2, 0), 0.5, b.diffuse_light((6, 6, 6))))
    b.set_background(b.picture(sky), importance_sample=True, env_res=(8, 16))
    return b


@pytest.mark.parametrize("which", ["env_only", "mixed"])
def test_light_sample_and_pdf_match_jax(sunlit, which):
    if which == "env_only":
        js, ps = sunlit[0], sunlit[2]
    else:
        js = _mixed(JSceneBuilder).build()
        ps = convert.scene_from_numpy(js, device="cpu")
        own = _mixed(SceneBuilder).build("cpu")
        for got, want in zip(_tables(own), _tables(js)):
            np.testing.assert_allclose(got, want, **TABLE_TOL)
    origin = RNG.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    origin[:, 1] = np.abs(origin[:, 1]) + 0.05
    u = RNG.uniform(0, 1, (3, N)).astype(np.float32)
    got = mat.light_sample(ps, torch.as_tensor(origin), *map(torch.as_tensor, u)).numpy()
    ref = np.asarray(jmat.light_sample(js, origin, *u))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    d = np.array(ref)
    d[::2] = RNG.normal(size=(N // 2, 3))
    np.testing.assert_allclose(
        mat.light_pdf(ps, torch.as_tensor(origin), torch.as_tensor(d)).numpy(),
        np.asarray(jmat.light_pdf(js, origin, d)), atol=1e-4, rtol=1e-4)


def test_nee_render_matches_jax(sunlit):
    """NEE collects the sun through shadow rays that escape to the sky."""
    js, jc, ps = sunlit
    jc = jc.replace(nee=True)
    jkey = jax.random.key(42)
    ref = np.asarray(jint.render_image(js, jc, jkey))
    pc = convert.camera_from_numpy(jc, device="cpu")
    key = convert.key_from_numpy(jax.random.key_data(jkey))
    img = integrator.render_image(ps, pc, key).numpy()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    assert (np.abs(img - ref).max(-1) <= 1e-3).mean() >= 0.98
    wave = integrator.render_image_wavefront(ps, pc, key).numpy()
    np.testing.assert_allclose(wave, img, **WAVEFRONT_TOL)


def test_importance_sample_off_leaves_no_tables():
    b = SceneBuilder()
    b.sphere((0, 0, -2), 0.5, b.lambertian((0.5, 0.5, 0.5)))
    b.set_background(b.solid((0.3, 0.4, 0.5)))
    s = b.build("cpu")
    assert not s.has_env_light and not s.has_lights and s.env_texel_p is None
    cam = catalog.sunlit_spheres(width=8, spp=1, max_depth=2, device="cpu")[1]
    img = integrator.render_image(s, cam, keys.key(1))
    assert bool(torch.isfinite(img).all())
