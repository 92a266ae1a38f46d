"""Per-vertex triangle attributes, glTF assets and the glTF scenes of the
port against the JAX package.

- ``interpolate_tri_attrs`` on random inputs;
- ``intersect_brute`` on an attributed mesh of 400 triangles (a dense
  table: the port reads K1's pid and payload (u, v), JAX its XLA brute
  route) and of 600 (chunked: the port's per-ray route, JAX's packet
  route), both carried across from the JAX scene by ``scene_from_numpy``:
  equal hit masks; normals within atol 1e-4 and u, v within 1e-3, except
  on rays that a float64 solve finds within 1e-4 of a triangle edge
  (counted, and at most 2% of the rays);
- ``SceneBuilder.gltf_asset`` on a glTF both loaders read: every table,
  picture and attribute row equal, dense and chunked (the attribute rows
  in the chunk order);
- the replay gradients of an attributed mesh against JAX's
  ``loss_and_grads`` at its gradient tolerances
  (``tests/test_replay.py:106-112``);
- glass_fox, textured_fox (a 576- and a 480-triangle stand-in), smoke_fox
  and sponza with ``$CRT_ASSETS`` pointed at stand-in glTF files written
  here, each package building its own scene: image means within 2e-3 at
  the golden workload (16 px, 4 spp, depth 3, key 42). The reference's Fox
  and Sponza are absent (ROADMAP F1), so the port is held to live JAX.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.models.scene import TriAttrs as JTriAttrs
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu.utils import gltf as jgltf
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert, gltf, procgen

SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)
TMIN = 1e-3
# (segments, rings) of the ellipsoid stand-ins: 400 triangles (one dense
# table), 600 (5 chunks of 128), the Fox's 576 and a 480 that stays dense
MESHES = {"dense_400": (20, 11), "chunked_600": (25, 13)}
FOX = (24, 13)
FOX_DENSE = (24, 11)
# the Fox stand-in's pose: a node transform like the real asset's
FOX_NODE = {"mesh": 0, "translation": [0.0, 45.0, 0.0],
            "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [1.2, 1.0, 1.2]}


def _attributed_mesh(segments, rings):
    """[T,3,3] vertices, [T,3,3] normals and [T,3,2] UVs of an ellipsoid."""
    pos, nrm, uv, idx = procgen.ellipsoid_mesh(segments, rings, radii=(1.5, 1.0, 0.8))
    c = idx.reshape(-1, 3)
    return pos[c], nrm[c], uv[c]


def test_interpolate_tri_attrs_matches_jax():
    rng = np.random.default_rng(0)
    T, R = 50, 400

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    cols = dict(n0=unit(T), n1=unit(T), n2=unit(T),
                uv0=rng.uniform(size=(T, 2)).astype(np.float32),
                uv1=rng.uniform(size=(T, 2)).astype(np.float32),
                uv2=rng.uniform(size=(T, 2)).astype(np.float32),
                smooth=rng.uniform(size=T) < 0.7)
    cols["n1"][3] = -cols["n0"][3]   # a blend that cancels to ~zero
    pid = rng.integers(0, T, R).astype(np.int32)
    a, b = rng.uniform(0, 0.5, (2, R)).astype(np.float32)
    a[:4], b[:4], pid[:4] = 0.5, 0.0, 3
    geo = unit(R)
    ref = jisect.interpolate_tri_attrs(
        JTriAttrs(**{k: jnp.asarray(v) for k, v in cols.items()}), jnp.asarray(pid),
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(geo))
    got = isect.interpolate_tri_attrs(
        sc.TriAttrs(**{k: torch.as_tensor(v) for k, v in cols.items()}),
        torch.as_tensor(pid), torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(geo))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def _rays(R, seed):
    """Rays from a shell of radius 6 toward points near the mesh."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3))
    org = 6.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    aim = rng.uniform(-1.6, 1.6, (R, 3)) * np.array([1.0, 0.7, 0.6])
    dirs = aim - org
    return (org.astype(np.float32), (dirs / np.linalg.norm(dirs, axis=-1,
                                                            keepdims=True)).astype(np.float32))


def _near_edge(tris, org, dirs, eps=1e-4):
    """[R] bool: rays whose float64 closest hit (or a triangle in front of
    it) lies within ``eps`` of a triangle edge, where float32 routes may
    decide differently."""
    v0 = tris[:, 0].astype(np.float64)
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    o, d = org.astype(np.float64), dirs.astype(np.float64)
    p = np.cross(d[:, None], e2[None])
    det = np.einsum("rtk,tk->rt", p, e1)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = o[:, None] - v0[None]
    a = np.einsum("rtk,rtk->rt", s, p) * inv
    q = np.cross(s, e1[None])
    b = np.einsum("rk,rtk->rt", d, q) * inv
    t = np.einsum("tk,rtk->rt", e2, q) * inv
    margin = np.minimum(np.minimum(a, b), 1.0 - a - b)
    hit = ok & (t > TMIN) & (margin >= 0.0)
    t_best = np.where(hit, t, np.inf).min(axis=1)
    front = ok & (t > TMIN) & (t <= t_best[:, None] * (1.0 + 1e-4) + 1e-6)
    return (front & (np.abs(margin) < eps)).any(axis=1)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_intersect_attributed_mesh_matches_jax(mesh):
    verts, nrm, uv = _attributed_mesh(*MESHES[mesh])
    jb = JSceneBuilder()
    jb.triangles(verts, jb.lambertian((0.5, 0.5, 0.5)), normals=nrm, uvs=uv)
    js = jb.build()
    ps = convert.scene_from_numpy(js, device="cpu")
    assert ps.tri_attrs is not None
    assert (ps.tri_chunks is not None) == (mesh == "chunked_600")
    R = 4096
    org, dirs = _rays(R, seed=len(verts))
    time = np.zeros(R, np.float32)
    u_vol = np.zeros((R, 1), np.float32)
    ref = jisect.intersect_brute(js, jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(time),
                                 TMIN, jnp.asarray(u_vol))
    got = isect.intersect_brute(ps, torch.as_tensor(org), torch.as_tensor(dirs),
                                torch.as_tensor(time), TMIN, torch.as_tensor(u_vol))
    near = _near_edge(verts, org, dirs)
    valid = got.valid.numpy()
    j_valid = np.asarray(ref.valid)
    assert 0.2 < valid.mean() < 0.9
    bad = valid != j_valid
    both = valid & j_valid
    bad |= both & (np.abs(got.normal.numpy() - np.asarray(ref.normal)).max(-1) > 1e-4)
    bad |= both & (np.abs(got.u.numpy() - np.asarray(ref.u)) > 1e-3)
    bad |= both & (np.abs(got.v.numpy() - np.asarray(ref.v)) > 1e-3)
    print(f"{mesh}: {bad.sum()} of {R} rays differ, {near.sum()} near an edge")
    assert not (bad & ~near).any(), np.nonzero(bad & ~near)
    assert bad.sum() <= 0.02 * R
    # the attributes are live: smooth normals differ from the flat ones of
    # the same scene without them, and the UVs vary
    flat = isect.intersect_brute(ps.replace(tri_attrs=None), torch.as_tensor(org),
                                 torch.as_tensor(dirs), torch.as_tensor(time), TMIN,
                                 torch.as_tensor(u_vol))
    turned = np.abs(flat.normal.numpy() - got.normal.numpy()).max(-1) > 1e-3
    assert turned[both].mean() > 0.9
    assert got.u.numpy()[both].std() > 0.1 and got.v.numpy()[both].std() > 0.1


def _write_standin(root, segments, rings, png=True, **kw):
    pos, nrm, uv, idx = procgen.ellipsoid_mesh(segments, rings)
    path = root / "Fox" / "glTF" / "Fox.gltf"
    procgen.write_gltf(str(path), pos, idx, nrm, uv,
                       png=procgen.checker_png() if png else None,
                       nodes=[FOX_NODE], **kw)
    return path


@pytest.mark.parametrize("rings", [5, 13], ids=["dense", "chunked"])
def test_gltf_asset_builds_as_jax(tmp_path, rings):
    """A textured primitive (factor 0.5, 0.8, 1) and a second one with no
    material (default white): the port's builder and loader give the same
    tables, pictures and attribute rows as JAX's."""
    path = _write_standin(tmp_path, 24, rings, base_color=(0.5, 0.8, 1.0, 1.0))
    doc = json.loads(path.read_text())
    bare = dict(doc["meshes"][0]["primitives"][0])
    bare.pop("material")
    doc["meshes"][0]["primitives"].append(bare)
    path.write_text(json.dumps(doc))
    jb, pb = JSceneBuilder(), sc.SceneBuilder()
    n = jb.gltf_asset(jgltf.load_asset(str(path)))
    assert pb.gltf_asset(gltf.load_asset(str(path))) == n == 2 * (48 * (rings - 1))
    js, ps = jb.build(), pb.build("cpu")
    assert (ps.tri_chunks is not None) == (rings == 13)
    for name, cls in sc._TABLES.items():
        for f, col in zip(convert._columns(getattr(js, name), cls),
                          convert._columns(getattr(ps, name), cls)):
            if f is not None:
                np.testing.assert_array_equal(col, f, err_msg=name)
    assert len(ps.images) == len(js.images) == 1
    np.testing.assert_array_equal(ps.images[0].numpy(), np.asarray(js.images[0]))
    for f, col in zip(convert._columns(js.tri_attrs, sc.TriAttrs),
                      convert._columns(ps.tri_attrs, sc.TriAttrs)):
        np.testing.assert_array_equal(col, f)
    if ps.tri_chunks is not None:
        np.testing.assert_array_equal(ps.tri_chunk_order.numpy(), np.asarray(js.tri_chunk_order))
        for f, col in zip(convert._columns(js.tri_chunks, sc._CHUNKS["tri_chunks"]),
                          convert._columns(ps.tri_chunks, sc._CHUNKS["tri_chunks"])):
            np.testing.assert_array_equal(col, f)


def _grad_scene(builder, segments, rings):
    """An attributed, textured ellipsoid under a quad light."""
    verts, nrm, uv = _attributed_mesh(segments, rings)
    pic = np.random.default_rng(1).uniform(0, 255, (4, 4, 3)).astype(np.float32)
    builder.triangles(verts, builder.lambertian(builder.picture(pic)), normals=nrm, uvs=uv)
    builder.light(builder.quad((-2, 3, -2), (4, 0, 0), (0, 0, 4),
                               builder.diffuse_light((4, 4, 4))))
    builder.set_background(builder.solid((0.2, 0.3, 0.4)))
    return builder


@pytest.mark.parametrize("mesh", ["dense", "chunked"])
def test_replay_grads_with_attributes_match_jax(mesh):
    from cpu_ray_tracing_implementation_tpu.models import camera as jcam

    js = _grad_scene(JSceneBuilder(), *({"dense": (12, 6), "chunked": (25, 13)}[mesh])).build()
    jc = jcam.perspective(10, 1.0, (0, 1, 5), (0, 0, 0), 1, 40.0, 2, 3)
    jkey = jax.random.key(7)
    target = jnp.zeros((jc.height, jc.width, 3))
    j_loss, (j_gs, j_gc) = jdiff.loss_and_grads(js, jc, jkey, target, spp=2, unroll=(1, 1))
    ps = convert.scene_from_numpy(js, device="cpu")
    pc = convert.camera_from_numpy(jc, device="cpu")
    j_gs, j_gc = convert.params_to_numpy(j_gs), convert.params_to_numpy(j_gc)
    # the dense table: the winner replay and the oracle route (K1's pid
    # under autograd, the chunk-scan VJP); chunked: the accelerator's replay
    for route in ([None, False] if mesh == "dense" else [None]):
        loss, (gs, gc) = diff.loss_and_grads(ps, pc, convert.key_from_numpy(
            jax.random.key_data(jkey)), torch.zeros((pc.height, pc.width, 3)), 2,
            replay_isect=route)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
        assert np.abs(gs["geo_tri_v0"].numpy()).max() > 0
        for name, g in gs.items():
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), j_gs[name], err_msg=name, **SCENE_TOL)
        for name, g in gc.items():
            np.testing.assert_allclose(g.numpy(), j_gc[name], err_msg=name, **CAMERA_TOL)


def test_fused_pid_under_autograd():
    """``planar_closest_fused(..., with_pid=True)`` with inputs that need a
    gradient: pid a non-differentiable output equal to the plain scan's,
    and the other outputs' gradients those of plain autograd."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi

    verts, _, _ = _attributed_mesh(20, 11)
    v0 = torch.as_tensor(verts[:, 0]).requires_grad_()
    e1 = torch.as_tensor(verts[:, 1] - verts[:, 0]).requires_grad_()
    e2 = torch.as_tensor(verts[:, 2] - verts[:, 0]).requires_grad_()
    mat = torch.zeros(len(verts), dtype=torch.int32)
    view = fi.dense_planar_view(v0, e1, e2, mat, torch.ones(len(verts), dtype=torch.bool))
    org, dirs = (torch.as_tensor(x) for x in _rays(512, seed=3))
    t, (n, u, v, m, pid) = fi.planar_closest_fused(org, dirs, view, TMIN, True,
                                                   with_pid=True)
    t_r, (n_r, u_r, v_r, m_r, pid_r) = ch.planar_closest(org, dirs, view, TMIN, True)
    assert torch.equal(pid, pid_r) and not pid.requires_grad and t.requires_grad
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(512, 6)).astype(np.float32))

    def grads(t, n, u, v):
        fin = torch.isfinite(t)
        loss = (torch.where(fin, t, torch.zeros_like(t)) * w[:, 0]).sum() + (
            n * w[:, 1:4]).sum() + (u * w[:, 4]).sum() + (v * w[:, 5]).sum()
        return torch.autograd.grad(loss, (v0, e1, e2))

    for g, g_r in zip(grads(t, n, u, v), grads(t_r, n_r, u_r, v_r)):
        assert torch.equal(g, g_r)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Stand-in asset roots: the Fox at 576 triangles (chunked) and at 480
    (dense), and a small Sponza glTF + .bin."""
    fox = tmp_path_factory.mktemp("fox576")
    _write_standin(fox, *FOX, image_in="bufferView")
    fox_dense = tmp_path_factory.mktemp("fox480")
    _write_standin(fox_dense, *FOX_DENSE)
    procgen.write_gltf(str(fox / "Sponza" / "glTF" / "Sponza.gltf"),
                       procgen.colonnade_hall(target_tris=2000).reshape(-1, 3))
    return {"fox576": fox, "fox480": fox_dense}


@pytest.mark.parametrize("name,root", [
    ("glass_fox", "fox576"), ("textured_fox", "fox576"), ("textured_fox", "fox480"),
    ("smoke_fox", "fox576"), ("sponza", "fox576")])
def test_gltf_scene_matches_jax(assets, monkeypatch, name, root):
    monkeypatch.setenv("CRT_ASSETS", str(assets[root]))
    ps, pc = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=3)
    assert ps.counts == tuple(js.counts)
    assert (ps.tri_attrs is not None) == (name == "textured_fox")
    if name in ("glass_fox", "textured_fox"):
        assert ps.counts[2] == {"fox576": 576, "fox480": 480}[root]
        assert (ps.tri_chunks is not None) == (root == "fox576")
    img = integrator.render_image(ps, pc, keys.key(42))
    ref = np.asarray(jint.render_image(js, jc, jax.random.key(42)))
    assert torch.isfinite(img).all() and img.shape == ref.shape
    np.testing.assert_allclose(float(img.mean()), ref.mean(), atol=2e-3)
