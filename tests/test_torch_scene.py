"""The port's SceneBuilder and camera against the JAX package's.

Tables built by the port equal the JAX build carried across with
``utils/convert.scene_from_numpy`` exactly; camera rays from the same
uniforms agree to atol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import camera as jcam
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam
from cpu_ray_tracing_implementation_tpu_torch.models import catalog
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

STATIC = ("background", "tex_types_used", "mat_types_used", "counts",
          "world_lo", "world_hi")


def _assert_scenes_equal(a: sc.Scene, b: sc.Scene):
    for table in sc._TABLES:
        ta, tb = getattr(a, table), getattr(b, table)
        for f in dataclasses.fields(ta):
            xa, xb = getattr(ta, f.name), getattr(tb, f.name)
            assert xa.dtype == xb.dtype, (table, f.name)
            assert torch.equal(xa, xb), (table, f.name)
    assert torch.equal(a.lights, b.lights)
    for name in STATIC:
        assert getattr(a, name) == getattr(b, name), name
    assert (a.world_offset is None) == (b.world_offset is None)
    if a.world_offset is not None:
        assert torch.equal(a.world_offset, b.world_offset)


@pytest.mark.parametrize("name", sorted(catalog.SCENES))
def test_builder_matches_jax_build(name):
    js, _ = jcat.SCENES[name](width=16, spp=1)
    ps, _ = catalog.SCENES[name](width=16, spp=1)
    _assert_scenes_equal(ps, convert.scene_from_numpy(js))


def test_counts_and_padding():
    ps, _ = catalog.cornell_box(width=16)
    assert ps.counts == (0, 18, 0, 0)
    # empty tables keep one inactive row; volumes pad to one slot
    assert ps.spheres.rad.shape == (1,) and not bool(ps.spheres.active[0])
    assert ps.n_volumes == 1
    view, pack = ps.quad_view
    assert view.corner.shape == (1, 128, 3) and pack.shape == (1, 16, 128)
    assert int(view.active.sum()) == 18


def test_recenter_matches_jax():
    """A scene far from the origin is recentered exactly as in JAX."""
    def build(b):
        m = b.lambertian((0.5, 0.5, 0.5))
        b.sphere((1e4, 5e3, -2e4), 1.0, m)
        b.sphere((1e4 + 3, 5e3, -2e4), 0.5, m)
        b.quad((1e4 - 5, 5e3 - 1, -2e4 - 5), (10, 0, 0), (0, 0, 10), m)
        b.triangle((1e4, 5e3 + 2, -2e4), (1e4 + 1, 5e3 + 2, -2e4),
                   (1e4, 5e3 + 3, -2e4), m)
        return b.build()

    js = build(JSceneBuilder())
    ps = build(sc.SceneBuilder())
    assert ps.world_offset is not None
    _assert_scenes_equal(ps, convert.scene_from_numpy(js))


def test_chunked_tables_not_ported():
    b = sc.SceneBuilder()
    m = b.lambertian((1, 1, 1))
    for i in range(513):
        b.sphere((i, 0, 0), 0.1, m)
    with pytest.raises(NotImplementedError, match="M8"):
        b.build()


def test_camera_matches_jax():
    js, jc = jcat.cornell_box(width=24, spp=2)
    pc = convert.camera_from_numpy(jc)
    _, own = catalog.cornell_box(width=24, spp=2)
    for f in ("width", "height", "spp", "max_depth", "mode"):
        assert getattr(pc, f) == getattr(own, f) == getattr(jc, f)
    assert torch.equal(pc.pos, own.pos) and torch.equal(pc.fovy_deg, own.fovy_deg)


@pytest.mark.parametrize("name", sorted(catalog.SCENES))
def test_generate_rays_matches_jax(name):
    _, jc = jcat.SCENES[name](width=40, spp=1)
    pc = convert.camera_from_numpy(jc)
    rng = np.random.default_rng(11)
    n = jc.width * jc.height
    ids = rng.permutation(n)[:500].astype(np.int32)
    u = rng.uniform(0, 1, (500, cam.N_CAM_SLOTS)).astype(np.float32)
    jo, jd, jt = jcam.generate_rays(jc, jnp.asarray(ids), jnp.asarray(u))
    po, pd, pt = cam.generate_rays(pc, torch.as_tensor(ids), torch.as_tensor(u))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_stratified_jitter_matches_jax():
    _, jc = jcat.cornell_box(width=16, spp=6)
    jc = jc.replace(stratify=True)
    pc = convert.camera_from_numpy(jc)
    u = np.random.default_rng(2).uniform(0, 1, (64, 5)).astype(np.float32)
    for s in (0, 4, 7):
        ref = np.asarray(jcam.stratify_pixel_jitter(jc, jnp.asarray(u), s))
        got = cam.stratify_pixel_jitter(pc, torch.as_tensor(u), s).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-7)


def test_unported_camera_modes_raise():
    jc = jcam.lens(16, 1.0, (0, 0, 1), (0, 0, 0), 10.0, spp=1)
    with pytest.raises(NotImplementedError, match="M3"):
        convert.camera_from_numpy(jc)
