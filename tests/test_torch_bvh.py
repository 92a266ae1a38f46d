"""The port's BVH traversal oracle (``ops/bvh.py``, ``CRT_ACCEL=bvh``)
against the JAX package's and the chunk route.

The trees come from the JAX scene (``convert.scene_from_numpy`` carries
them across), so both packages traverse the same nodes; the port's own
builder gives a tree whose threaded links equal JAX's. Traversal against
the chunk scan and against JAX's traversal: equal hit masks, materials
and pids, t within rtol 1e-4 (spheres also atol 2e-4: the two rounding
orders of the expanded quadratic), normal and center within atol 1e-4,
(u, v) and rad within 1e-3. The visit counts of ``traversal_stats`` are
integers of the same slab tests, equal to JAX's. The VJP (autograd
through the chunk scan) against JAX's at its gradient tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import scene as jscene
from cpu_ray_tracing_implementation_tpu.ops import bvh as jbvh
from cpu_ray_tracing_implementation_tpu.utils import accel as jaccel
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import bvh
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import accel, convert

TMIN = 1e-3
R = 160
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
_SCENES = {}


def _scene(kind, n=600):
    """(JAX scene, port scene) of a random chunked table with its tree."""
    if kind not in _SCENES:
        rng = np.random.default_rng({"tri": 8, "sphere": 12}[kind])
        b = jscene.SceneBuilder()
        mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.5, 0.5, 0.5)),
                b.dielectric(1.5)]
        for i, c in enumerate(rng.normal(0, 3.0, (n, 3))):
            m = mats[1 + i % 2]
            if kind == "sphere":
                b.moving_sphere(c, c + rng.normal(0, 0.1, 3),
                                abs(rng.normal(0.2, 0.05)) + 0.05, m)
            else:
                v = c + rng.normal(0, 0.3, (3, 3))
                b.triangle(v[0], v[1], v[2], m)
        js = b.build()
        _SCENES[kind] = js, convert.scene_from_numpy(js, device="cpu")
    return _SCENES[kind]


def _rays(seed, n=R):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    return org, dirs, time


def _tables(kind):
    js, ps = _scene(kind)
    if kind == "sphere":
        return js.sphere_chunks, js.sphere_tree, ps.sphere_chunks, ps.sphere_tree
    return js.tri_chunks, js.tri_tree, ps.tri_chunks, ps.tri_tree


def test_threaded_links_equal_jax():
    rng = np.random.default_rng(1)
    c = rng.normal(0, 5.0, (3000, 3)).astype(np.float32)
    _, nodes = accel.build_bvh(c, c - 0.1, c + 0.1, max_leaf=8)
    assert nodes is not None and len(nodes) > 500
    for got, ref in zip(accel.threaded_links(nodes), jaccel.threaded_links(nodes)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    # the port's own build gives the JAX scene's tree
    port, _ = catalog.sphereflake(width=16, spp=1, max_depth=1, device="cpu")
    js, _ = jcat.sphereflake(width=16, spp=1, max_depth=1)
    np.testing.assert_array_equal(port.sphere_tree.node_pack.numpy(),
                                  np.asarray(js.sphere_tree.node_pack))
    np.testing.assert_allclose(port.sphere_tree.prim_pack.numpy(),
                               np.asarray(js.sphere_tree.prim_pack), rtol=1e-6, atol=1e-6)


def _hold(t_p, pay_p, t_r, pay_r, kind):
    t_p, t_r = t_p.numpy(), np.asarray(t_r)
    hit = np.isfinite(t_p)
    np.testing.assert_array_equal(np.isfinite(t_r), hit)
    np.testing.assert_allclose(t_p[hit], t_r[hit], rtol=1e-4,
                               atol=2e-4 if kind == "sphere" else 0.0)
    mat_i = 2 if kind == "sphere" else 3
    np.testing.assert_array_equal(pay_p[mat_i].numpy()[hit], np.asarray(pay_r[mat_i])[hit])
    np.testing.assert_array_equal(pay_p[-1].numpy()[hit], np.asarray(pay_r[-1])[hit])
    atols = {0: 1e-4, 1: 1e-3} if kind == "sphere" else {0: 1e-4, 1: 1e-3, 2: 1e-3}
    for i, atol in atols.items():
        np.testing.assert_allclose(pay_p[i].numpy()[hit], np.asarray(pay_r[i])[hit],
                                   rtol=0, atol=atol)
    return hit


def _port_bvh(kind, org, dirs, time, tmax):
    _, _, pc, pt = _tables(kind)
    to, td, tt = (torch.as_tensor(x) for x in (org, dirs, time))
    if kind == "sphere":
        return bvh.sphere_closest_bvh(to, td, tt, pc, pt, TMIN, tmax)
    return bvh.planar_closest_bvh(to, td, pc, pt, TMIN, True, tmax)


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_traversal_matches_chunk_route_and_jax(kind):
    org, dirs, time = _rays(3)
    jc, jt, pc, _ = _tables(kind)
    t_p, pay_p = _port_bvh(kind, org, dirs, time, float("inf"))
    to, td, tt = (torch.as_tensor(x) for x in (org, dirs, time))
    jo, jd, jtm = (jnp.asarray(x) for x in (org, dirs, time))
    if kind == "sphere":
        t_o, pay_o = ch.sphere_closest(to, td, tt, pc, TMIN)
        t_j, pay_j = jbvh.sphere_closest_bvh(jo, jd, jtm, jt, TMIN)
    else:
        t_o, pay_o = ch.planar_closest(to, td, pc, TMIN, True)
        t_j, pay_j = jbvh.planar_closest_bvh(jo, jd, jt, TMIN, True)
    hit = _hold(t_p, pay_p, t_o, pay_o, kind)
    _hold(t_p, pay_p, t_j, pay_j, kind)
    assert hit.sum() > 20


def test_tmax_respected_and_all_miss_terminates():
    org, dirs, time = _rays(4)
    t, _ = _port_bvh("tri", org, dirs, time, float("inf"))
    hit = torch.isfinite(t)
    cap = torch.where(hit, t * 0.999, torch.full_like(t, 40.0))
    t_c, _ = _port_bvh("tri", org, dirs, time, cap)
    assert not torch.isfinite(t_c[hit]).any()
    far = np.tile(np.float32([0.0, 0.0, 500.0]), (R, 1))
    up = np.tile(np.float32([0.0, 0.0, 1.0]), (R, 1))
    for kind in ("tri", "sphere"):
        t_m, pay_m = _port_bvh(kind, far, up, time, float("inf"))
        assert not torch.isfinite(t_m).any() and int(pay_m[-1].abs().sum()) == 0
        it, nv, lv = bvh.traversal_stats(torch.as_tensor(far), torch.as_tensor(up),
                                         _tables(kind)[3], TMIN)
        assert it == 1 and int(nv.max()) == 1 and int(lv.sum()) == 0


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_traversal_stats_equal_jax(kind):
    org, dirs, _ = _rays(5)
    _, jt, _, pt = _tables(kind)
    it, nv, lv = bvh.traversal_stats(torch.as_tensor(org), torch.as_tensor(dirs), pt, TMIN)
    jit_, jnv, jlv = jbvh.traversal_stats(jnp.asarray(org), jnp.asarray(dirs), jt, TMIN)
    assert it == int(jit_) and it > 5
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_vjp_matches_jax(kind):
    """The backward is autograd through the port's chunk scan: equal to it.
    Against JAX's VJP at its gradient tolerances on the geometry; on the
    per-ray (org, dirs) entries, where a grazing ray's derivative is
    ill-conditioned in float32 (the packages round t apart), on 99% of them."""
    org, dirs, time = _rays(6)
    jc, jt, pc, pt = _tables(kind)
    w = np.random.default_rng(3).normal(0, 1, (R, 8)).astype(np.float32)
    names = ("c0", "c1", "rad") if kind == "sphere" else ("corner", "eu", "ev")

    def loss(t, pay, lib):
        wl = jnp.asarray(w) if lib is jnp else torch.as_tensor(w)
        t0 = lib.where(lib.isfinite(t), t, lib.zeros_like(t))
        out = (t0 * wl[:, 0]).sum() + (pay[0] * wl[:, 1:4]).sum()
        return out + (pay[1] * wl[:, 4]).sum()

    def jloss(o, d, *geo):
        c = jc.replace(**dict(zip(names, geo)))
        if kind == "sphere":
            t, pay = jbvh.sphere_closest_accel(o, d, jnp.asarray(time), c, jt, TMIN)
        else:
            t, pay = jbvh.planar_closest_accel(o, d, c, jt, TMIN, True)
        return loss(t, pay, jnp)

    def port(route):
        xs = [torch.as_tensor(org).requires_grad_(), torch.as_tensor(dirs).requires_grad_()]
        xs += [getattr(pc, n).detach().clone().requires_grad_() for n in names]
        chunks = dataclasses.replace(pc, **dict(zip(names, xs[2:])))
        tt = torch.as_tensor(time)
        if kind == "sphere":
            t, pay = (bvh.sphere_closest_bvh(xs[0], xs[1], tt, chunks, pt, TMIN)
                      if route == "bvh" else ch.sphere_closest(xs[0], xs[1], tt, chunks,
                                                               TMIN))
        else:
            t, pay = (bvh.planar_closest_bvh(xs[0], xs[1], chunks, pt, TMIN, True)
                      if route == "bvh" else ch.planar_closest(xs[0], xs[1], chunks, TMIN,
                                                               True))
        return torch.autograd.grad(loss(t, pay, torch), xs)

    geo = [getattr(jc, n) for n in names]
    ref = jax.grad(jloss, argnums=tuple(range(5)))(jnp.asarray(org), jnp.asarray(dirs),
                                                  *geo)
    got = port("bvh")
    for g, s in zip(got, port("chunked")):
        torch.testing.assert_close(g, s, rtol=0, atol=0)
    # the padding lanes' (zero-area) gradients are NaN in JAX's scan, 0 here
    act = pc.active.numpy()
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy()[act], np.asarray(r)[act], **GRAD_TOL)
    for g, r in zip(got[:2], ref[:2]):
        r = np.asarray(r)
        ok = np.abs(g.numpy() - r) <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(r)
        assert ok.mean() >= 0.99, ok.mean()


def test_image_through_bvh_matches_chunked(monkeypatch):
    scene, cam = catalog.sphereflake(width=12, spp=1, max_depth=2, device="cpu")
    imgs = {}
    for mode in ("bvh", "chunked"):
        monkeypatch.setenv("CRT_ACCEL", mode)
        imgs[mode] = integrator.render_image(scene, cam, keys.key(42))
    a, b = imgs["bvh"], imgs["chunked"]
    assert torch.isfinite(a).all()
    np.testing.assert_allclose(float(a.mean()), float(b.mean()), atol=2e-3)
    assert float(((a - b).abs().amax(-1) <= 1e-3).float().mean()) >= 0.98


def test_apply_scene_params_refreshes_tree():
    """A moved sphere moves in the tree's primitive rows too (the JAX
    package leaves them stale, ROADMAP F3)."""
    scene, _ = catalog.sphereflake(width=16, spp=1, max_depth=1, device="cpu")
    params = diff.scene_params(scene, geometry=True)
    params["geo_sph_c0"] = params["geo_sph_c0"] + 0.25
    params["geo_sph_c1"] = params["geo_sph_c1"] + 0.25
    moved = diff.apply_scene_params(scene, params)
    with torch.no_grad():
        flat = bvh.flatten_chunk_pack(fi.pack_sphere_constants(moved.sphere_chunks))
    n = flat.shape[0]
    torch.testing.assert_close(moved.sphere_tree.prim_pack[:n, :14], flat[:, :14])
    assert not torch.equal(moved.sphere_tree.prim_pack, scene.sphere_tree.prim_pack)
    torch.testing.assert_close(moved.sphere_tree.node_pack, scene.sphere_tree.node_pack)
