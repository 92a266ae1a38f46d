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
          "world_lo", "world_hi", "has_bilinear")


def _assert_scenes_equal(a: sc.Scene, b: sc.Scene):
    """Every table (the noise tables and the volumes' optional mesh columns
    included), the lights and sphere lights, images, static fields and
    chunked tables equal, dtype and all."""
    for table in sc._TABLES:
        ta, tb = getattr(a, table), getattr(b, table)
        for f in dataclasses.fields(ta):
            xa, xb = getattr(ta, f.name), getattr(tb, f.name)
            assert (xa is None) == (xb is None), (table, f.name)
            if xa is None:
                continue
            assert xa.dtype == xb.dtype, (table, f.name)
            assert torch.equal(xa, xb), (table, f.name)
    assert torch.equal(a.lights, b.lights)
    assert (a.sphere_lights is None) == (b.sphere_lights is None)
    if a.sphere_lights is not None:
        assert torch.equal(a.sphere_lights, b.sphere_lights)
    assert len(a.images) == len(b.images)
    for ia, ib in zip(a.images, b.images):
        assert ia.dtype == ib.dtype and torch.equal(ia, ib)
    for name in STATIC:
        assert getattr(a, name) == getattr(b, name), name
    assert (a.world_offset is None) == (b.world_offset is None)
    if a.world_offset is not None:
        assert torch.equal(a.world_offset, b.world_offset)
    for name in sc._CHUNKS:
        ca, cb = getattr(a, name), getattr(b, name)
        assert (ca is None) == (cb is None), name
        if ca is not None:
            for f in dataclasses.fields(ca):
                xa, xb = getattr(ca, f.name), getattr(cb, f.name)
                assert xa.dtype == xb.dtype and torch.equal(xa, xb), (name, f.name)
        order = name.replace("_chunks", "_chunk_order")
        oa, ob = getattr(a, order), getattr(b, order)
        assert (oa is None) == (ob is None), order
        if oa is not None:
            assert torch.equal(oa, ob), order


@pytest.mark.parametrize("name", sorted(catalog.SCENES))
def test_builder_matches_jax_build(name):
    js, _ = jcat.SCENES[name](width=16, spp=1)
    ps, _ = catalog.SCENES[name](width=16, spp=1, device="cpu")
    _assert_scenes_equal(ps, convert.scene_from_numpy(js, device="cpu"))


def test_counts_and_padding():
    ps, _ = catalog.cornell_box(width=16, device="cpu")
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
        return b

    js = build(JSceneBuilder()).build()
    ps = build(sc.SceneBuilder()).build("cpu")
    assert ps.world_offset is not None
    _assert_scenes_equal(ps, convert.scene_from_numpy(js, device="cpu"))


def test_chunked_tables_not_ported():
    """Above DENSE_MAX rows a table is chunked (it no longer raises), and
    it never gets a 1-chunk dense view: the per-ray accelerator reads it."""
    b = sc.SceneBuilder()
    m = b.lambertian((1, 1, 1))
    for i in range(513):
        b.sphere((i, 0, 0), 0.1, m)
    ps = b.build("cpu")
    assert ps.sphere_chunks.rad.shape == (5, 128)
    assert int(ps.sphere_chunks.active.sum()) == 513
    assert sorted(ps.sphere_chunk_order.tolist()) == list(range(513))
    with pytest.raises(ValueError, match="no 1-chunk view"):
        ps.sphere_view
    tabs = ps.sphere_perray
    assert tabs.table.shape == (5, 7, 128) and tabs.boxes.shape == (8, 128)


def test_entry_points_default_to_the_card():
    """The port builds on the card unless asked for the CPU: without a card
    a call that names no device raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        catalog.cornell_box(width=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.SceneBuilder().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cam.perspective(8, 1.0, (0, 0, 1), (0, 0, 0))
    js, jc = jcat.cornell_box(width=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.scene_from_numpy(js)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.camera_from_numpy(jc)


@pytest.mark.parametrize("width,n_tris,n_chunks", [(32, 38268, 299)])
def test_colonnade_chunk_tables_match_jax(width, n_tris, n_chunks):
    """The colonnade's chunk tables (corner, eu, ev, mat, active, lo, hi and
    the BVH order) equal the JAX build exactly."""
    js, _ = jcat.sponza(width=width, spp=1)
    ps, _ = catalog.sponza(width=width, spp=1, device="cpu")
    assert ps.counts == (0, 1, n_tris, 0)
    assert ps.tri_chunks.corner.shape == (n_chunks, 128, 3)
    assert ps.quad_chunks is None and ps.sphere_chunks is None
    _assert_scenes_equal(ps, convert.scene_from_numpy(js, device="cpu"))


def _random_builder(builder, kind, n=600, seed=3):
    b = builder()
    mats = [b.lambertian((1, 1, 1)), b.metal((0.5, 0.5, 0.5))]
    r = np.random.default_rng(seed)
    for i in range(n):
        p = r.uniform(-10, 10, 3)
        if kind == "sphere":
            b.moving_sphere(p, p + r.normal(size=3) * 0.2, r.uniform(0.1, 0.5),
                            mats[i % 2])
        else:
            b.quad(p, r.normal(size=3), r.normal(size=3), mats[i % 2])
    return b


@pytest.mark.parametrize("kind", ["sphere", "quad"])
def test_random_chunk_tables_match_jax(kind):
    """600 spheres / 600 quads: chunked exactly as in JAX, and carried
    across by scene_from_numpy."""
    js = _random_builder(JSceneBuilder, kind).build()
    ps = _random_builder(sc.SceneBuilder, kind).build("cpu")
    chunks = ps.sphere_chunks if kind == "sphere" else ps.quad_chunks
    assert chunks.mat.shape == (5, 128)
    _assert_scenes_equal(ps, convert.scene_from_numpy(js, device="cpu"))


def test_camera_matches_jax():
    js, jc = jcat.cornell_box(width=24, spp=2)
    pc = convert.camera_from_numpy(jc, device="cpu")
    _, own = catalog.cornell_box(width=24, spp=2, device="cpu")
    for f in ("width", "height", "spp", "max_depth", "mode"):
        assert getattr(pc, f) == getattr(own, f) == getattr(jc, f)
    assert torch.equal(pc.pos, own.pos) and torch.equal(pc.fovy_deg, own.fovy_deg)


@pytest.mark.parametrize("name", sorted(catalog.SCENES))
def test_generate_rays_matches_jax(name):
    _, jc = jcat.SCENES[name](width=40, spp=1)
    pc = convert.camera_from_numpy(jc, device="cpu")
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
    pc = convert.camera_from_numpy(jc, device="cpu")
    u = np.random.default_rng(2).uniform(0, 1, (64, 5)).astype(np.float32)
    for s in (0, 4, 7):
        ref = np.asarray(jcam.stratify_pixel_jitter(jc, jnp.asarray(u), s))
        got = cam.stratify_pixel_jitter(pc, torch.as_tensor(u), s).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-7)


def test_unported_camera_modes_raise():
    """All four modes are ported; a mode outside them raises. ``camera.qmc``
    is ported too and carried across."""
    jc = jcam.lens(16, 1.0, (0, 0, 1), (0, 0, 0), 10.0, spp=1)
    with pytest.raises(ValueError, match="mode 7"):
        convert.camera_from_numpy(jc.replace(mode=7), device="cpu")
    assert convert.camera_from_numpy(jc.replace(qmc=True), device="cpu").qmc
    assert not convert.camera_from_numpy(jc, device="cpu").qmc
    pc = convert.camera_from_numpy(jc, device="cpu")
    with pytest.raises(ValueError, match="mode 7"):
        cam.generate_rays(pc.replace(mode=7), torch.arange(4, dtype=torch.int32),
                          torch.zeros((4, cam.N_CAM_SLOTS)))
