"""Constant-density volumes in the port against the JAX package.

``volume_sample`` for box, sphere and mesh boundaries on the same rays and
uniforms: equal hit masks and volume ids, t within rtol 1e-4 / atol 1e-3;
a 12-triangle mesh box against the analytic box
(``tests/test_volume_mesh.py:66``'s bounds). The merged ``Hit`` and
isotropic scatter on cornell_box_with_volume, to the rounding of
tests/test_torch_shading.py. The volume replay (``_volume_t_one``) against
JAX's on box and sphere winners, and finite gradients on the lanes no
volume won (the NaN guard). Renders: cornell_box_with_volume and
smoke_fox (on its fallback mesh, ROADMAP F1: held to JAX only) at the
golden workload (mean within 2e-3, 98% of pixels within 1e-3); the
wavefront against the scan with NEE and roulette at 4 spp (rtol/atol
1e-5); ``loss_and_grads`` with NEE through the volumes against JAX's at
``tests/test_torch_diff.py``'s tolerances, on both routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu.ops import materials as jmat
from cpu_ray_tracing_implementation_tpu.ops import replay as jreplay
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, replay
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

N = 2048
RNG = np.random.default_rng(41)
SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread renders them as fast
    and leaves the other test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_tris(a, b):
    """The 12 triangles of the box [a, b]."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = np.array([[x, y, z] for x in (a[0], b[0]) for y in (a[1], b[1])
                  for z in (a[2], b[2])])
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    return np.array([[c[f[0]], c[f[i]], c[f[i + 1]]] for f in faces for i in (1, 2)])


def _volumes(builder):
    """A rotated box, a sphere and a mesh box, each its own medium."""
    b = builder()
    b.volume_box((-1, -1, -1), (1, 2, 1), 0.5, (0.9, 0.9, 0.9), rotate=("y", 30),
                 translate=(0, 0, -4))
    b.volume_sphere((2.5, 0.5, -5), 1.2, 0.8, (0.5, 0.6, 0.7))
    b.volume_mesh(_box_tris((-3.5, -1, -6), (-1.5, 1, -4)), 1.5, (1, 1, 1))
    return b


def _rays(n=N, seed=0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 3])
    target = rng.uniform((-4, -1.5, -7), (4, 2.5, -3), (n, 3))
    dirs = (target - org).astype(np.float32)
    return org, dirs


def test_volume_sample_matches_jax():
    js = _volumes(JSceneBuilder).build()
    ps = _volumes(sc.SceneBuilder).build("cpu")
    assert ps.n_volumes == 3 and ps.volumes.mesh_v0.shape == (12, 3)
    org, dirs = _rays()
    t_surface = RNG.uniform(5, 12, N).astype(np.float32)
    t_surface[::5] = np.inf
    u = RNG.uniform(1e-4, 1, (N, 3)).astype(np.float32)
    jt, jv, jok = jax.jit(lambda *a: jisect.volume_sample(a[0], a[1], js.volumes, 1e-3,
                                                          *a[2:]))(
        org, dirs, t_surface, u)
    t, v, ok = isect.volume_sample(torch.as_tensor(org), torch.as_tensor(dirs),
                                   ps.volumes, 1e-3, torch.as_tensor(t_surface),
                                   torch.as_tensor(u))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    sel = np.asarray(jok)
    np.testing.assert_array_equal(v.numpy()[sel], np.asarray(jv)[sel])
    np.testing.assert_allclose(t.numpy()[sel], np.asarray(jt)[sel], rtol=1e-4, atol=1e-3)
    # every kind of boundary was entered
    assert set(np.asarray(jv)[sel].tolist()) == {0, 1, 2}


def test_mesh_box_equals_analytic_box():
    a, b = (-1.0, -1.0, -5.0), (1.0, 1.0, -3.0)
    bm, ba = sc.SceneBuilder(), sc.SceneBuilder()
    bm.volume_mesh(_box_tris(a, b), 0.7, (1, 1, 1))
    ba.volume_box(a, b, 0.7, (1, 1, 1))
    sm, sa = bm.build("cpu"), ba.build("cpu")
    rng = np.random.default_rng(0)
    org = torch.as_tensor(rng.uniform(-4, 4, (256, 3)).astype(np.float32))
    target = torch.as_tensor((np.array([0, 0, -4]) + rng.uniform(-1.5, 1.5, (256, 3)))
                             .astype(np.float32))
    dirs = target - org
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    u = torch.as_tensor(rng.uniform(1e-4, 1.0, (256, 1)).astype(np.float32))
    t_surface = torch.full((256,), 1e30)
    tm, _, ok_m = isect.volume_sample(org, dirs, sm.volumes, 1e-3, t_surface, u)
    ta, _, ok_a = isect.volume_sample(org, dirs, sa.volumes, 1e-3, t_surface, u)
    assert torch.equal(ok_m, ok_a) and int(ok_a.sum()) > 20
    torch.testing.assert_close(tm[ok_a], ta[ok_a], rtol=2e-4, atol=2e-4)


def _port_hit(h):
    return isect.Hit(**{f.name: torch.as_tensor(np.array(getattr(h, f.name)))
                        for f in dataclasses.fields(isect.Hit)})


@pytest.fixture(scope="module")
def volume_hits():
    """cornell_box_with_volume's camera rays and uniforms, and JAX's hits."""
    js, jc = jcat.cornell_box_with_volume(width=16)
    ps = convert.scene_from_numpy(js, device="cpu")
    pos, look = np.asarray(jc.pos), np.asarray(jc.lookat)
    org = np.repeat(pos[None], N, 0).astype(np.float32)
    dirs = ((look - pos)[None] + RNG.normal(size=(N, 3)) * 150.0).astype(np.float32)
    time = RNG.uniform(0, 1, N).astype(np.float32)
    u = RNG.uniform(0, 1, (N, jmat.NSLOT + js.n_volumes)).astype(np.float32)
    jh = jax.jit(lambda *a: jisect.intersect_brute(js, *a[:3], 1e-3, a[3]))(
        org, dirs, time, u[:, jmat.SLOT_VOLUME0:])
    return js, ps, org, dirs, time, u, jh


def test_intersect_with_volumes_matches_jax(volume_hits):
    js, ps, org, dirs, time, u, jh = volume_hits
    T = torch.as_tensor
    ph = isect.intersect_brute(ps, T(org), T(dirs), T(time), 1e-3,
                               T(u[:, jmat.SLOT_VOLUME0:]))
    valid = np.asarray(jh.valid)
    same = (ph.valid.numpy() == valid) & (ph.mat.numpy() == np.asarray(jh.mat))
    assert same.mean() > 0.995
    iso = np.asarray(js.materials.mtype)[np.asarray(jh.mat)] == 4
    assert (iso & valid).sum() > 50   # rays that scattered in a medium
    both = same & valid
    np.testing.assert_allclose(ph.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ph.normal.numpy()[both], np.asarray(jh.normal)[both],
                               atol=1e-4)


@pytest.mark.parametrize("nee", [False, True], ids=["mixture", "nee"])
def test_isotropic_scatter_matches_jax(volume_hits, nee):
    js, ps, org, dirs, time, u, jh = volume_hits
    fn, jfn = (mat.scatter_nee, jmat.scatter_nee) if nee else (mat.scatter, jmat.scatter)
    ref = jax.jit(lambda h, d, uu: jfn(js, h, d, uu))(jh, dirs, u)
    got = fn(ps, _port_hit(jh), torch.as_tensor(dirs), torch.as_tensor(u))
    live = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), live)
    iso = live & (np.asarray(js.materials.mtype)[np.asarray(jh.mat)] == 4)
    assert iso.sum() > 50
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy()[live], np.asarray(ref[i])[live],
                                   atol=1e-4, rtol=1e-4)
    if nee:
        valid = np.asarray(jh.valid)
        for i in (3, 4, 5):
            np.testing.assert_allclose(got[i].numpy()[valid], np.asarray(ref[i])[valid],
                                       atol=1e-4, rtol=1e-4)


def test_volume_replay_matches_jax(volume_hits):
    """``_volume_t_one`` on box winners against JAX's; gradients through it
    stay finite on the lanes another type won (u = 0 there: the NaN
    guard)."""
    js, ps, org, dirs, time, u, _ = volume_hits
    u_vol = u[:, jmat.SLOT_VOLUME0:].copy()
    u_vol[::7] = 0.0
    idx = RNG.integers(0, 2, N).astype(np.int32)
    ref = np.asarray(jreplay._volume_t_one(jnp.asarray(org), jnp.asarray(dirs),
                                           js.volumes, jnp.asarray(idx),
                                           jnp.asarray(u_vol), 1e-3))
    o = torch.as_tensor(org).requires_grad_()
    d = torch.as_tensor(dirs).requires_grad_()
    got = replay._volume_t_one(o, d, ps.volumes, torch.as_tensor(idx).long(),
                               torch.as_tensor(u_vol), 1e-3)
    fin = np.isfinite(ref) & (np.abs(ref) < 1e29)
    assert fin.sum() > N // 4
    np.testing.assert_allclose(got.detach().numpy()[fin], ref[fin], rtol=1e-4, atol=1e-3)
    # the winner-masked t, as replay_hit merges it, has finite gradients
    t = torch.where(torch.as_tensor(fin), got, torch.zeros_like(got))
    gd = torch.autograd.grad(t.sum(), (o, d))
    assert all(bool(torch.isfinite(g).all()) for g in gd)


@pytest.mark.parametrize("name", ["cornell_box_with_volume", "smoke_fox"])
def test_winner_pack_decides_volumes(name):
    """winner_pack's volume decisions equal intersect_brute's, and the
    replayed hit reproduces its t: box volumes, and smoke_fox's mesh volume,
    whose entry the port replays from its triangles (ROADMAP F6: the JAX
    package's replay takes a unit sphere there)."""
    scene, cam = catalog.SCENES[name](width=48, spp=1, device="cpu")
    ids = torch.arange(N, dtype=torch.int32)
    org, dirs, time = cam_mod.generate_rays(
        cam, ids, torch.as_tensor(RNG.uniform(0, 1, (N, 5)).astype(np.float32)))
    u_vol = torch.as_tensor(RNG.uniform(0, 1, (N, scene.n_volumes)).astype(np.float32))
    packed = replay.winner_pack(scene, org, dirs, time, 1e-3, u_vol)
    hit = isect.intersect_brute(scene, org, dirs, time, 1e-3, u_vol)
    vol = (packed >= 0) & ((packed >> 28) == replay.TYPE_VOL)
    assert int(vol.sum()) > 20
    assert torch.equal(packed >= 0, hit.valid)
    rh = replay.replay_hit(scene, org, dirs, time, u_vol, packed, 1e-3)
    assert torch.equal(rh.mat, hit.mat)
    torch.testing.assert_close(rh.t[vol], hit.t[vol], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["cornell_box_with_volume", "smoke_fox"])
def test_volume_scene_golden_matches_jax(name):
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=3)
    ref = np.asarray(jint.render_image(js, jc, jax.random.key(42), unroll=(1, 1)))
    ps, pc = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
    img = integrator.render_image(ps, pc, keys.key(42)).numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    if name == "cornell_box_with_volume":   # smoke_fox: F1, JAX only
        np.testing.assert_allclose(img.mean(), 0.487237, atol=2e-3)
    assert (np.abs(img - ref).max(-1) <= 1e-3).mean() >= 0.98


@pytest.mark.parametrize("name", ["cornell_box_with_volume", "smoke_fox"])
def test_wavefront_matches_scan(name):
    scene, cam = catalog.SCENES[name](width=10, spp=4, max_depth=4, device="cpu")
    cam = cam.replace(nee=True, rr_depth=2)
    key = keys.key(8)
    scan = integrator.render_image(scene, cam, key)
    wave = integrator.render_image_wavefront(scene, cam, key)
    torch.testing.assert_close(wave, scan, rtol=1e-5, atol=1e-5)
    assert float(scan.mean()) > 0.01


@pytest.fixture(scope="module")
def volume_grads():
    js, jc = jcat.cornell_box_with_volume(width=10, spp=2, max_depth=3)
    jc = jc.replace(nee=True)
    jkey = jax.random.key(3)
    loss, (gs, gc) = jdiff.loss_and_grads(js, jc, jkey, jnp.zeros((jc.height, jc.width, 3)),
                                          spp=2, unroll=(1, 1))
    port = (convert.scene_from_numpy(js, device="cpu"),
            convert.camera_from_numpy(jc, device="cpu"),
            convert.key_from_numpy(jax.random.key_data(jkey)))
    return port, (float(loss), convert.params_to_numpy(gs), convert.params_to_numpy(gc))


@pytest.mark.parametrize("replay_isect", [None, False], ids=["replay", "oracle"])
def test_nee_volume_grads_match_jax(volume_grads, replay_isect):
    (scene, cam, key), (j_loss, j_gs, j_gc) = volume_grads
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, key,
                                         torch.zeros((cam.height, cam.width, 3)), 2,
                                         replay_isect=replay_isect)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    for name, g in gs.items():
        np.testing.assert_allclose(g.numpy(), j_gs[name], err_msg=name, **SCENE_TOL)
    for name, g in gc.items():
        np.testing.assert_allclose(g.numpy(), j_gc[name], err_msg=name, **CAMERA_TOL)
    # the isotropic media's albedo rows are live
    assert float(gs["tex_color0"].abs().sum()) > 0.0
