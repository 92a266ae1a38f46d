"""Shading modules of the port against the JAX package, elementwise.

Samplers, textures, the merged closest ``Hit``, light sampling and
``materials.scatter`` get the same numpy inputs in both packages. The
elementwise functions agree to float32 rounding (atol 1e-5); hits agree
ray by ray except where float rounding moves a ray across a primitive
edge (at most 0.5% of rays).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu.ops import materials as jmat
from cpu_ray_tracing_implementation_tpu.ops import sampling as jsmp
from cpu_ray_tracing_implementation_tpu.ops import textures as jtex
from cpu_ray_tracing_implementation_tpu.ops import vecmath as jvm
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat
from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.ops import textures as tex
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

RNG = np.random.default_rng(21)
N = 4096


def _u(*shape):
    return RNG.uniform(0, 1, shape).astype(np.float32)


def _unit(n):
    v = RNG.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=1e-5)


def test_samplers():
    u1, u2 = _u(N), _u(N)
    n = _unit(N)
    T = torch.as_tensor
    _close(smp.unit_sphere_dir(T(u1), T(u2)), jsmp.unit_sphere_dir(u1, u2))
    _close(smp.cosine_dir(T(n), T(u1), T(u2)), jsmp.cosine_dir(n, u1, u2))
    d = _unit(N)
    _close(smp.cosine_pdf(T(n), T(d)), jsmp.cosine_pdf(n, d))
    _close(smp.sphere_pdf(T(d)), jsmp.sphere_pdf(d))
    ri = RNG.uniform(0.5, 2.0, N).astype(np.float32)
    _close(smp.schlick_reflectance(T(u1), T(ri)), jsmp.schlick_reflectance(u1, ri))


def test_vecmath():
    v, n = _unit(N), _unit(N)
    eta = RNG.uniform(0.5, 2.0, N).astype(np.float32)
    T = torch.as_tensor
    _close(vm.reflect(T(v), T(n)), jvm.reflect(v, n))
    _close(vm.refract(T(v), T(n), T(eta)), jvm.refract(v, n, eta), atol=1e-4)
    for a, b in zip(vm.onb_from_normal(T(n)), jvm.onb_from_normal(n)):
        _close(a, b)
    _close(vm.cross(T(v), T(n)), jvm.cross(v, n))


def test_checker_texture_negative_coords():
    """jnp.mod parity below zero: remainder, not fmod."""
    js, _ = jcat.three_material_ball(width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    p = RNG.uniform(-7, 7, (N, 3)).astype(np.float32)
    uu, vv = _u(N), _u(N)
    tid = RNG.integers(0, js.textures.ttype.shape[0], N).astype(np.int32)
    ref = jtex.eval_texture(js, jnp.asarray(tid), uu, vv, p)
    got = tex.eval_texture(ps, torch.as_tensor(tid), torch.as_tensor(uu),
                           torch.as_tensor(vv), torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _scene_rays(js, jc, n=N):
    pos = np.asarray(jc.pos)
    look = np.asarray(jc.lookat)
    org = np.repeat(pos[None], n, 0).astype(np.float32)
    dirs = ((look - pos)[None] + RNG.normal(size=(n, 3))
            * np.linalg.norm(look - pos) * 0.25).astype(np.float32)
    return org, dirs, _u(n)


def _port_hit(h):
    return isect.Hit(**{f.name: torch.as_tensor(np.array(getattr(h, f.name)))
                        for f in dataclasses.fields(isect.Hit)})


@pytest.mark.parametrize("name", ["cornell_box", "three_material_ball"])
def test_intersect_matches_jax(name):
    """Port: fused wrappers on the 1-chunk views; JAX on the CPU: the dense
    XLA route. Same hits to rounding."""
    js, jc = jcat.SCENES[name](width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    org, dirs, time = _scene_rays(js, jc)
    u_vol = np.zeros((N, js.n_volumes), np.float32)
    jh = jisect.intersect_brute(js, org, dirs, time, 1e-3, u_vol)
    ph = isect.intersect_brute(ps, torch.as_tensor(org), torch.as_tensor(dirs),
                               torch.as_tensor(time), 1e-3, torch.as_tensor(u_vol))
    valid = np.asarray(jh.valid)
    assert valid.sum() > N // 2
    same = (ph.valid.numpy() == valid) & (ph.mat.numpy() == np.asarray(jh.mat))
    assert same.mean() > 0.995
    both = same & valid
    _close(ph.t.numpy()[both], np.asarray(jh.t)[both], atol=1e-3)
    _close(ph.normal.numpy()[both], np.asarray(jh.normal)[both], atol=1e-4)
    np.testing.assert_array_equal(ph.front.numpy()[both], np.asarray(jh.front)[both])
    _close(ph.u.numpy()[both], np.asarray(jh.u)[both], atol=1e-3)
    _close(ph.v.numpy()[both], np.asarray(jh.v)[both], atol=1e-3)


@pytest.mark.parametrize("name", ["cornell_box", "three_material_ball"])
def test_scatter_matches_jax(name):
    """Given the same Hit and uniforms, scatter gives the same direction,
    weight and continuation."""
    js, jc = jcat.SCENES[name](width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    org, dirs, time = _scene_rays(js, jc)
    u_vol = np.zeros((N, js.n_volumes), np.float32)
    jh = jisect.intersect_brute(js, org, dirs, time, 1e-3, u_vol)
    u = _u(N, jmat.NSLOT + js.n_volumes)
    jd, jw, jc_ = jmat.scatter(js, jh, dirs, u)
    pd, pw, pc = mat.scatter(ps, _port_hit(jh), torch.as_tensor(dirs),
                             torch.as_tensor(u))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc_))
    live = np.asarray(jc_)
    _close(pd.numpy()[live], np.asarray(jd)[live], atol=1e-4)
    _close(pw.numpy()[live], np.asarray(jw)[live], atol=1e-4)
    je = jmat.emitted(js, jh)
    _close(mat.emitted(ps, _port_hit(jh)).numpy(), je)


def test_light_sample_and_pdf_match_jax():
    js, _ = jcat.cornell_box(width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    origin = RNG.uniform(1, 554, (N, 3)).astype(np.float32)
    u3 = _u(N, 3)
    ref = jmat.light_sample(js, origin, u3[:, 0], u3[:, 1], u3[:, 2])
    got = mat.light_sample(ps, torch.as_tensor(origin), *torch.as_tensor(u3).T)
    _close(got.numpy(), ref, atol=1e-3)
    d = np.array(ref)
    d[::2] = RNG.normal(size=(N // 2, 3))
    _close(mat.light_pdf(ps, torch.as_tensor(origin), torch.as_tensor(d)).numpy(),
           jmat.light_pdf(js, origin, d), atol=1e-4)


def test_unported_families_raise():
    """Every material family is ported since isotropic media (ROADMAP M5):
    an isotropic lane scatters into a uniform sphere direction with weight
    albedo * (1/4pi) / (1/4pi) = albedo, as the JAX package's. Dispersion
    (M6) and the importance-sampled environment light (M5) are ported and
    carried across by ``scene_from_numpy``, and so are per-vertex triangle
    attributes (M4), which raised there before."""
    b = sc.SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b._mat_row(mtype=sc.MAT_ISOTROPIC, tex=b.solid((0.3, 0.5, 0.7)))
    b.sphere((0, 0, 0), 1.0, m)
    ps = b.build("cpu")
    h = isect.Hit(valid=torch.ones(2, dtype=torch.bool), t=torch.ones(2),
                  p=torch.zeros(2, 3), normal=torch.ones(2, 3),
                  front=torch.ones(2, dtype=torch.bool), u=torch.zeros(2),
                  v=torch.zeros(2), mat=torch.ones(2, dtype=torch.int32))
    u = torch.full((2, 10), 0.25)
    d, w, c = mat.scatter(ps, h, torch.ones(2, 3), u)
    assert bool(c.all())
    torch.testing.assert_close(d, smp.unit_sphere_dir(u[:, 1], u[:, 2]))
    torch.testing.assert_close(w, torch.tensor([[0.3, 0.5, 0.7]] * 2))
    js, _ = jcat.three_material_ball(width=16)
    jd = js.replace(materials=js.materials.replace(
        dispersion=js.materials.dispersion.at[1].set(0.01)), has_dispersion=True)
    pd = convert.scene_from_numpy(jd, device="cpu")
    assert pd.has_dispersion and not convert.scene_from_numpy(js, device="cpu").has_dispersion
    np.testing.assert_array_equal(pd.materials.dispersion.numpy(),
                                  np.asarray(jd.materials.dispersion))
    env = jnp.full((2, 4), 0.125)
    pe = convert.scene_from_numpy(js.replace(env_texel_p=env, env_row_cdf=env[:, 0],
                                             env_col_cdf=env), device="cpu")
    assert pe.has_env_light and pe.has_lights
    np.testing.assert_array_equal(pe.env_texel_p.numpy(), np.asarray(env))
    from cpu_ray_tracing_implementation_tpu.models.scene import TriAttrs as JTriAttrs

    cols = {f: jnp.zeros((2, 3)) for f in ("n0", "n1", "n2")}
    cols.update({f: jnp.full((2, 2), 0.5) for f in ("uv0", "uv1", "uv2")})
    pa = convert.scene_from_numpy(
        js.replace(tri_attrs=JTriAttrs(**cols, smooth=jnp.array([True, False]))),
        device="cpu")
    assert pa.tri_attrs.smooth.tolist() == [True, False]
    np.testing.assert_array_equal(pa.tri_attrs.uv1.numpy(), np.full((2, 2), 0.5))
    assert convert.scene_from_numpy(js, device="cpu").tri_attrs is None
