"""Next-event estimation, Russian roulette and sphere lights in the port
against the JAX package.

Elementwise (the same hits and uniforms into both packages): cone_dir and
cone_pdf, light_sample and light_pdf with sphere lights (alone and mixed
with a quad light), and scatter_nee, to atol 1e-4 (directions and weights;
the JAX package contracts products into multiply-adds). Renders: the scan
with ``nee``, with ``rr_depth`` and with both, at 16 px, 4 spp, depth 4,
key 42, against JAX's: the mean within 2e-3 and at least 98% of pixels
within 1e-3 (tests/test_torch_render.py's contract). The wavefront against
the port's scan at spp >= 4, rtol/atol 1e-5 (each path is the scan's; the
roulette uniforms come from a host table of the scan's seed words).
Gradients with NEE: one central difference, as the JAX package's
``tests/test_nee.py:105`` checks them finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu.ops import materials as jmat
from cpu_ray_tracing_implementation_tpu.ops import sampling as jsmp
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, replay
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat
from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.utils import convert, profiling

N = 4096
RNG = np.random.default_rng(31)
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread renders them as fast
    and leaves the other test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u(*shape):
    return RNG.uniform(0, 1, shape).astype(np.float32)


def _close(got, ref, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=1e-4)


def _port_hit(h):
    return isect.Hit(**{f.name: torch.as_tensor(np.array(getattr(h, f.name)))
                        for f in dataclasses.fields(isect.Hit)})


def test_cone_sampling_matches_jax():
    axis = RNG.normal(size=(N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    cos_max = RNG.uniform(0.0, 0.999, N).astype(np.float32)
    u1, u2 = _u(N), _u(N)
    T = torch.as_tensor
    d = smp.cone_dir(T(axis), T(cos_max), T(u1), T(u2)).numpy()
    _close(d, jsmp.cone_dir(axis, cos_max, u1, u2), atol=1e-5)
    # every sample lies in its cone
    assert ((d * axis).sum(-1) >= cos_max - 1e-5).all()
    _close(smp.cone_pdf(T(cos_max)).numpy(), jsmp.cone_pdf(cos_max), atol=0)


def _mixed_lights(builder):
    """A room with a quad light and two sphere lights."""
    b = builder()
    white = b.lambertian((0.7, 0.7, 0.7))
    b.quad((-5, -1, -5), (10, 0, 0), (0, 0, 10), white)
    b.light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4))))
    b.sphere_light(b.sphere((2, 2, 0), 0.5, b.diffuse_light((6, 5, 4))))
    b.sphere((0, 0.5, 0), 0.5, white)
    b.sphere_light(b.sphere((-2, 1.5, 1), 0.3, b.diffuse_light((3, 3, 8))))
    return b


@pytest.mark.parametrize("which", ["sphere_light_scene", "mixed"])
def test_light_sample_and_pdf_match_jax(which):
    if which == "mixed":
        js = _mixed_lights(JSceneBuilder).build()
        ps = _mixed_lights(sc.SceneBuilder).build("cpu")
        origin = RNG.uniform(-4, 3, (N, 3)).astype(np.float32)
        assert ps.n_sphere_lights == 2 and int(ps.lights.shape[0]) == 1
    else:
        js, _ = jcat.cornell_box_with_sphere_light(width=16)
        ps, _ = catalog.cornell_box_with_sphere_light(width=16, device="cpu")
        origin = RNG.uniform(1, 554, (N, 3)).astype(np.float32)
        assert ps.n_sphere_lights == 1 and int(ps.lights.shape[0]) == 0
    assert ps.has_lights
    u3 = _u(N, 3)
    ref = jax.jit(lambda o, uu: jmat.light_sample(js, o, uu[:, 0], uu[:, 1], uu[:, 2]))(
        origin, u3)
    got = mat.light_sample(ps, torch.as_tensor(origin), *torch.as_tensor(u3).T)
    _close(got.numpy(), ref, atol=1e-3)
    d = np.array(ref)
    d[::3] = RNG.normal(size=d[::3].shape)
    got_pdf = mat.light_pdf(ps, torch.as_tensor(origin), torch.as_tensor(d)).numpy()
    ref_pdf = np.asarray(jax.jit(lambda o, dd: jmat.light_pdf(js, o, dd))(origin, d))
    np.testing.assert_allclose(got_pdf, ref_pdf, rtol=1e-3, atol=1e-6)
    assert (ref_pdf > 0).mean() > 0.5


@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_with_sphere_light"])
def test_scatter_nee_matches_jax(name):
    js, jc = jcat.SCENES[name](width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    pos, look = np.asarray(jc.pos), np.asarray(jc.lookat)
    org = np.repeat(pos[None], N, 0).astype(np.float32)
    dirs = ((look - pos)[None] + RNG.normal(size=(N, 3)) * 200.0).astype(np.float32)
    time = _u(N)
    u = _u(N, jmat.NSLOT + js.n_volumes)
    jh, ref = jax.jit(lambda o, d, t, uu: (
        lambda h: (h, jmat.scatter_nee(js, h, d, uu)))(
            jisect.intersect_brute(js, o, d, t, 1e-3, uu[:, jmat.SLOT_VOLUME0:])))(
        org, dirs, time, u)
    got = mat.scatter_nee(ps, _port_hit(jh), torch.as_tensor(dirs), torch.as_tensor(u))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    live = np.asarray(ref[2])
    for i, (g, r) in enumerate(zip(got, ref)):
        if i == 2:
            continue
        g, r = g.numpy(), np.asarray(r)
        sel = live if i in (0, 1) else np.asarray(jh.valid)
        _close(g[sel], r[sel], atol=1e-4)
    assert float(np.abs(np.asarray(ref[5])).sum()) > 0.0


# (scene, camera fields): NEE on the sphere light, roulette alone, both on
# the Cornell box's quad light
RENDERS = [("cornell_box_with_sphere_light", dict(nee=True)),
           ("cornell_box_with_sphere_light", dict(rr_depth=1)),
           ("cornell_box", dict(nee=True, rr_depth=2))]


@pytest.mark.parametrize("name,kw", RENDERS,
                         ids=["sphere_light-nee", "sphere_light-rr", "cornell-nee-rr"])
def test_scan_render_matches_jax(name, kw):
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=4)
    jc = jc.replace(**kw)
    ref = np.asarray(jint.render_image(js, jc, jax.random.key(42), unroll=(1, 1)))
    ps, pc = (convert.scene_from_numpy(js, device="cpu"),
              convert.camera_from_numpy(jc, device="cpu"))
    assert (pc.nee, pc.rr_depth) == (jc.nee, jc.rr_depth)
    img = integrator.render_image(ps, pc, keys.key(42)).numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    assert (np.abs(img - ref).max(-1) <= 1e-3).mean() >= 0.98


def test_sphere_light_golden():
    """cornell_box_with_sphere_light at the golden workload: the port's own
    build against tests/test_golden.py's mean."""
    ps, pc = catalog.cornell_box_with_sphere_light(width=16, spp=4, max_depth=3,
                                                   device="cpu")
    img = integrator.render_image(ps, pc, keys.key(42))
    np.testing.assert_allclose(float(img.mean()), 0.427467, atol=2e-3)


@pytest.mark.parametrize("lanes", [None, 97])
@pytest.mark.parametrize("kw", [dict(nee=True), dict(rr_depth=2),
                                dict(nee=True, rr_depth=1)],
                         ids=["nee", "rr", "nee-rr"])
def test_wavefront_matches_scan(kw, lanes):
    scene, cam = catalog.cornell_box_with_sphere_light(width=10, spp=4, max_depth=4,
                                                       device="cpu")
    cam = cam.replace(**kw)
    key = keys.key(7)
    scan = integrator.render_image(scene, cam, key)
    acc = integrator.render_wavefront(scene, cam, key, cam.spp, lanes=lanes)
    wave = (acc / cam.spp).reshape(scan.shape)
    torch.testing.assert_close(wave, scan, **WAVEFRONT_TOL)


def test_rr_words_match_jax():
    """The host table of roulette seed words equals the words the JAX
    package's scan draws: bits(fold_in(fold_in(k_path, 0x5252), b))."""
    key = jax.random.key(9)
    words = integrator._bits_table(integrator.wavefront_keys(
        convert.key_from_numpy(jax.random.key_data(key)), 3, 4, sample_offset=2,
        rr=True)["rr"])
    for s in range(3):
        _, k_path = jax.random.split(jax.random.fold_in(key, 2 + s))
        k_rr = jax.random.fold_in(k_path, 0x5252)
        for b in range(4):
            ref = np.asarray(jax.random.bits(jax.random.fold_in(k_rr, b), (2,), jnp.uint32))
            np.testing.assert_array_equal(words[s, b], ref)


def test_nee_intersects_twice_per_bounce_but_the_last(monkeypatch):
    """The scan skips the last segment's shadow ray on the host: 2 depth - 1
    intersections per sample (kernel launches on the card). The wavefront
    gates it per lane and traces a shadow ray every loop iteration."""
    scene, cam = catalog.cornell_box_with_sphere_light(width=4, spp=2, max_depth=3,
                                                       device="cpu")
    calls = {"intersect": 0, "scatter_nee": 0}

    def counted(fn, name):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(isect, "intersect_brute", counted(isect.intersect_brute,
                                                          "intersect"))
    monkeypatch.setattr(mat, "scatter_nee", counted(mat.scatter_nee, "scatter_nee"))
    for nee, want in ((False, cam.spp * cam.max_depth),
                      (True, cam.spp * (2 * cam.max_depth - 1))):
        calls.update(intersect=0, scatter_nee=0)
        integrator.render_image(scene, cam.replace(nee=nee, rr_depth=2), keys.key(0))
        assert calls["intersect"] == want, (nee, calls)
        assert calls["scatter_nee"] == (cam.spp * cam.max_depth if nee else 0)
    calls.update(intersect=0)
    integrator.reset_wavefront()
    integrator.render_image_wavefront(scene, cam.replace(nee=True), keys.key(0))
    assert calls["intersect"] == 2 * integrator.WAVEFRONT["iterations"] > 0
    make, kwargs, spp, grad, wavefront, cam_kw = profiling.WORKLOADS[
        "cornell_sphere_light_nee"]
    assert make is catalog.cornell_box_with_sphere_light and cam_kw["nee"]


def test_tape_records_the_shadow_rays():
    """Under NEE the tape holds both decisions of a bounce, path ray then
    shadow ray, and plays them back in that order: the replay render equals
    the recording, and the recording the default render."""
    scene, cam = catalog.cornell_box_with_sphere_light(width=8, spp=1, max_depth=3,
                                                       device="cpu")
    cam = cam.replace(nee=True, rr_depth=1)
    ids = torch.arange(cam.width * cam.height, dtype=torch.int32)
    tape = replay.Tape()
    key = keys.key(4)
    rec = integrator.accumulate_samples_subset(scene, cam, key, ids, 0, 1,
                                               isect_fn=tape.record)
    assert len(tape) == 2 * cam.max_depth - 1
    play = integrator.accumulate_samples_subset(scene, cam, key, ids, 0, 1,
                                                isect_fn=tape.play)
    torch.testing.assert_close(play, rec, rtol=0, atol=0)
    plain = integrator.accumulate_samples_subset(scene, cam, key, ids, 0, 1)
    close = (play - plain).abs().amax(-1) <= 1e-3
    assert close.float().mean() >= 0.98


def test_nee_gradient_central_difference():
    """A wall albedo's gradient under NEE and roulette against central
    differences of the same loss (cornell_box, 10 px, 2 spp, depth 3)."""
    scene, cam = catalog.cornell_box(width=10, spp=2, max_depth=3, device="cpu")
    cam = cam.replace(nee=True, rr_depth=2)
    target = torch.zeros((cam.height, cam.width, 3))
    key = keys.key(5)
    loss, (gs, _) = diff.loss_and_grads(scene, cam, key, target, 2)
    assert all(bool(torch.isfinite(g).all()) for g in gs.values())
    p0 = diff.scene_params(scene)
    name, idx, eps = "tex_color0", (1, 0), 1e-2

    def loss_at(delta):
        p = dict(p0)
        p[name] = p0[name].clone()
        p[name][idx] += delta
        return float(diff.image_loss(diff.apply_scene_params(scene, p), cam, key,
                                     target, 2))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    ad = float(gs[name][idx])
    assert abs(ad) > 1e-6 and abs(ad - fd) <= 2e-2 * abs(fd), (ad, fd)
