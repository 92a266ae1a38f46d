"""Plain versions of kernels K1 (planar) and K2 (sphere) against the JAX
Pallas kernels (interpret mode) and the JAX chunk-scan oracle.

The port's ``chunked.planar_closest`` / ``sphere_closest`` are what the
fused wrappers run for CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernels to on the card. Inputs are made from seeds with numpy and go
through both packages. Tolerances (those of tests/test_pallas.py): equal
hit masks and materials, t rtol 1e-4 / atol 1e-4, normal and center atol
1e-4, u atol 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import chunked as jch
from cpu_ray_tracing_implementation_tpu.ops import pallas_intersect as jpk
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

TMIN = 1e-3


def _to_torch(jchunks, cls):
    return cls(*[torch.as_tensor(np.array(getattr(jchunks, f.name)))
                 for f in dataclasses.fields(cls)])


def _planar_table(kind, n=700, seed=1):
    """JAX-built chunked (BVH-ordered) triangle or quad table."""
    b = JSceneBuilder()
    mats = [b.lambertian((1, 1, 1)), b.metal((0.5, 0.5, 0.5))]
    r = np.random.default_rng(seed)
    for i in range(n):
        p = r.uniform(-10, 10, 3)
        if kind == "tri":
            b.triangle(p, p + r.normal(size=3), p + r.normal(size=3), mats[i % 2])
        else:
            b.quad(p, r.normal(size=3), r.normal(size=3), mats[i % 2])
    s = b.build()
    return s.tri_chunks if kind == "tri" else s.quad_chunks


def _sphere_table(n=700, seed=5):
    b = JSceneBuilder()
    mats = [b.lambertian((1, 1, 1)), b.metal((0.5, 0.5, 0.5))]
    r = np.random.default_rng(seed)
    for i in range(n):
        c = r.uniform(-10, 10, 3)
        b.moving_sphere(c, c + [0.3, 0, 0], r.uniform(0.1, 0.5), mats[i % 2])
    return b.build().sphere_chunks


def _rays(seed, n, lo=-12.0, hi=12.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    return org, dirs, time


def _scene_rays(name, n=2000, seed=0):
    """Rays from the scene's camera plus random secondary rays inside it."""
    js, jc = jcat.SCENES[name](width=16, spp=1)
    rng = np.random.default_rng(seed)
    pos = np.asarray(jc.pos)
    look = np.asarray(jc.lookat)
    dirs = (look - pos)[None] + rng.normal(size=(n, 3)) * np.linalg.norm(look - pos) * 0.3
    org = np.repeat(pos[None], n, 0)
    half = n // 2
    lo = np.asarray(js.world_lo)
    hi = np.asarray(js.world_hi)
    lo, hi = np.maximum(lo, -20), np.minimum(hi, 20)
    org[half:] = rng.uniform(lo, hi, (n - half, 3))
    dirs[half:] = rng.normal(size=(n - half, 3))
    return (js, org.astype(np.float32), dirs.astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def _check_planar(got, ref, min_hits=50):
    t, (n, u, v, m) = got
    t_r, (n_r, u_r, v_r, m_r) = ref
    valid = np.isfinite(t_r)
    assert valid.sum() >= min_hits
    np.testing.assert_array_equal(np.isfinite(t), valid)
    np.testing.assert_allclose(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n[valid], n_r[valid], atol=1e-4)
    np.testing.assert_allclose(u[valid], u_r[valid], atol=1e-3)
    np.testing.assert_allclose(v[valid], v_r[valid], atol=1e-3)
    np.testing.assert_array_equal(m[valid], m_r[valid])


def _check_sphere(got, ref, min_hits=50):
    t, (c, r, m) = got
    t_r, (c_r, r_r, m_r) = ref
    valid = np.isfinite(t_r)
    assert valid.sum() >= min_hits
    np.testing.assert_array_equal(np.isfinite(t), valid)
    np.testing.assert_allclose(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c[valid], c_r[valid], atol=1e-4)
    np.testing.assert_allclose(r[valid], r_r[valid], atol=1e-6)
    np.testing.assert_array_equal(m[valid], m_r[valid])


def _np_planar(out):
    t, (n, u, v, m, _pid) = out
    return np.asarray(t), tuple(np.asarray(x) for x in (n, u, v, m))


def _np_sphere(out):
    t, (c, r, m, _pid) = out
    return np.asarray(t), tuple(np.asarray(x) for x in (c, r, m))


def _port_planar(org, dirs, chunks, triangle):
    out = ch.planar_closest(torch.as_tensor(org), torch.as_tensor(dirs),
                            chunks, TMIN, triangle)
    return _np_planar(tuple(x.numpy() if torch.is_tensor(x) else
                            tuple(y.numpy() for y in x) for x in out))


def _port_sphere(org, dirs, time, chunks):
    out = ch.sphere_closest(torch.as_tensor(org), torch.as_tensor(dirs),
                            torch.as_tensor(time), chunks, TMIN)
    return _np_sphere(tuple(x.numpy() if torch.is_tensor(x) else
                            tuple(y.numpy() for y in x) for x in out))


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_planar_random_table(kind):
    """700 primitives in 6 BVH-ordered chunks."""
    jchunks = _planar_table(kind)
    assert jchunks.corner.shape[0] == 6
    org, dirs, _ = _rays(0, 600)
    tri = kind == "tri"
    got = _port_planar(org, dirs, _to_torch(jchunks, ch.PlanarChunks), tri)
    jo, jd = jnp.asarray(org), jnp.asarray(dirs)
    _check_planar(got, _np_planar(jch.planar_closest(jo, jd, jchunks, TMIN, tri)))
    _check_planar(got, _np_planar(jpk.planar_closest_pallas(
        jo, jd, jchunks, TMIN, triangle=tri, interpret=True)))


def test_sphere_random_table():
    jchunks = _sphere_table()
    assert jchunks.rad.shape[0] == 6
    org, dirs, time = _rays(1, 600)
    got = _port_sphere(org, dirs, time, _to_torch(jchunks, ch.SphereChunks))
    jo, jd, jt = jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(time)
    _check_sphere(got, _np_sphere(jch.sphere_closest(jo, jd, jt, jchunks, TMIN)))
    _check_sphere(got, _np_sphere(jpk.sphere_closest_pallas(
        jo, jd, jt, jchunks, TMIN, interpret=True)))


def test_planar_cornell_view():
    """The main path: Cornell's 18 quads as one chunk of 128."""
    js, org, dirs, _ = _scene_rays("cornell_box")
    scene = convert.scene_from_numpy(js, device="cpu")
    view, pack = scene.quad_view
    assert view.corner.shape == (1, 128, 3)
    jview = jpk.dense_quad_view(js.quads)
    np.testing.assert_allclose(pack.numpy(),
                               np.asarray(jpk.pack_prim_constants(jview)),
                               rtol=1e-6, atol=1e-6)
    got = _port_planar(org, dirs, view, False)
    jo, jd = jnp.asarray(org), jnp.asarray(dirs)
    _check_planar(got, _np_planar(jch.planar_closest(jo, jd, jview, TMIN, False)),
                  min_hits=1000)
    _check_planar(got, _np_planar(jpk.planar_closest_pallas(
        jo, jd, jview, TMIN, triangle=False, interpret=True)), min_hits=1000)


def test_sphere_three_material_ball_view():
    """The main path: three_material_ball's 4 spheres as one chunk of 128."""
    js, org, dirs, time = _scene_rays("three_material_ball")
    scene = convert.scene_from_numpy(js, device="cpu")
    view, pack = scene.sphere_view
    assert view.rad.shape == (1, 128)
    jview = jpk.dense_sphere_view(js.spheres)
    np.testing.assert_allclose(pack.numpy(),
                               np.asarray(jpk.pack_sphere_constants(jview)),
                               rtol=1e-6, atol=1e-6)
    got = _port_sphere(org, dirs, time, view)
    jo, jd, jt = jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(time)
    _check_sphere(got, _np_sphere(jch.sphere_closest(jo, jd, jt, jview, TMIN)),
                  min_hits=500)
    _check_sphere(got, _np_sphere(jpk.sphere_closest_pallas(
        jo, jd, jt, jview, TMIN, interpret=True)), min_hits=500)


def test_sphere_random_motion_ball_view():
    """random_motion_ball's 337 spheres as one chunk of 384 (three 128-lane
    slices for kernel K2), with motion-blur ray times: the plain version
    against the Pallas kernel in interpret mode (hits, materials, t,
    center) and against the JAX chunk scan (the winner's pid too)."""
    js, org, dirs, time = _scene_rays("random_motion_ball", n=400, seed=3)
    scene = convert.scene_from_numpy(js, device="cpu")
    view, pack = scene.sphere_view
    assert view.rad.shape == (1, 384) and int(view.active.sum()) == 337
    jview = jpk.dense_sphere_view(js.spheres)
    np.testing.assert_allclose(pack.numpy(),
                               np.asarray(jpk.pack_sphere_constants(jview)),
                               rtol=1e-6, atol=1e-6)
    out = ch.sphere_closest(torch.as_tensor(org), torch.as_tensor(dirs),
                            torch.as_tensor(time), view, TMIN)
    got = _np_sphere(tuple(x.numpy() if torch.is_tensor(x) else
                           tuple(y.numpy() for y in x) for x in out))
    jo, jd, jt = jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(time)
    _check_sphere(got, _np_sphere(jpk.sphere_closest_pallas(
        jo, jd, jt, jview, TMIN, interpret=True)), min_hits=150)
    ref = jch.sphere_closest(jo, jd, jt, jview, TMIN)
    _check_sphere(got, _np_sphere(ref), min_hits=150)
    hit = np.isfinite(got[0])
    small = hit & (got[1][1] < 1.0)   # hits on the 0.2-radius spheres
    assert small.sum() >= 20
    np.testing.assert_array_equal(out[1][3].numpy()[hit], np.asarray(ref[1][3])[hit])


def test_triangle_view():
    """dense_tri_view: a small triangle table as one chunk."""
    b = JSceneBuilder()
    m = b.lambertian((1, 1, 1))
    r = np.random.default_rng(4)
    for _ in range(40):
        p = r.uniform(-3, 3, 3)
        b.triangle(p, p + r.normal(size=3), p + r.normal(size=3), m)
    js = b.build()
    scene = convert.scene_from_numpy(js, device="cpu")
    view, _ = scene.tri_view
    org, dirs, _ = _rays(5, 800, -4, 4)
    got = _port_planar(org, dirs, view, True)
    jview = jpk.dense_tri_view(js.tris)
    _check_planar(got, _np_planar(jpk.planar_closest_pallas(
        jnp.asarray(org), jnp.asarray(dirs), jview, TMIN, triangle=True,
        interpret=True)))


def test_ray_padding_r77():
    """R not a multiple of the kernels' tiles: R=77 gives 77 results equal
    to the oracle's."""
    jchunks = _planar_table("tri", 600)
    org, dirs, _ = _rays(3, 77)
    t, _ = _port_planar(org, dirs, _to_torch(jchunks, ch.PlanarChunks), True)
    assert t.shape == (77,)
    t_ref, _ = jch.planar_closest(jnp.asarray(org), jnp.asarray(dirs), jchunks,
                                  TMIN, True)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(np.asarray(t_ref)))


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the chunk scan and launches nothing."""
    jchunks = _sphere_table(600)
    chunks = _to_torch(jchunks, ch.SphereChunks)
    org, dirs, time = (torch.as_tensor(x) for x in _rays(2, 300))
    fi.reset_launches()
    t, payload = fi.sphere_closest_fused(org, dirs, time, chunks, TMIN)
    t_ref, payload_ref = ch.sphere_closest(org, dirs, time, chunks, TMIN)
    assert torch.equal(t, t_ref)
    assert len(payload) == 3    # center, rad, mat: no primitive id
    for a, b in zip(payload, payload_ref):
        assert torch.equal(a, b)
    assert fi.LAUNCHES == {"planar_closest": 0, "sphere_closest": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel entry points take CUDA tensors only: no CPU fallback."""
    rays = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fi.planar_closest_kernel(rays, torch.zeros((1, 16, 128)), TMIN)
    with pytest.raises(ValueError, match="CUDA"):
        fi.sphere_closest_kernel(rays, torch.zeros((1, 16, 128)), TMIN)

