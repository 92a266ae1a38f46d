"""The port's differentiable render (models/diff.py) against the JAX package.

The same tables (``scene_from_numpy``), camera and key go through both
packages' ``loss_and_grads``. Tolerances are those of the JAX package's own
replay-against-remat test (``tests/test_replay.py:106-112``): loss rtol
1e-4; scene gradients rtol 2e-3, atol 1e-5; camera gradients rtol 5e-3,
atol 1e-4. One JAX compile per shape serves every case (module fixtures):
the JAX package's gradients with and without replay, and with and without
geometry, agree within these tolerances (its tests assert so), so each of
the port's four routes is held to JAX's default (replay, geometry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)
# the material families __graft_entry__.py asserts live, and the camera's
LIVE = ("tex_color0", "tex_color1", "mat_fuzz", "mat_ior", "mat_smoothness",
        "mat_spec_prob", "pos", "lookat", "fovy_deg", "focal_length", "geo_sph_c1")


def _port(js, jc, jkey):
    return (convert.scene_from_numpy(js, device="cpu"),
            convert.camera_from_numpy(jc, device="cpu"),
            convert.key_from_numpy(jax.random.key_data(jkey)))


def _jax_grads(js, jc, jkey, spp):
    target = jnp.zeros((jc.height, jc.width, 3))
    loss, (gs, gc) = jdiff.loss_and_grads(js, jc, jkey, target, spp=spp)
    return float(loss), convert.params_to_numpy(gs), convert.params_to_numpy(gc)


def _check(port, ref, keys_=None):
    loss, gs, gc = port
    j_loss, j_gs, j_gc = ref
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    for name, g in gs.items():
        np.testing.assert_allclose(g.numpy(), j_gs[name], err_msg=name, **SCENE_TOL)
    for name, g in gc.items():
        np.testing.assert_allclose(g.numpy(), j_gc[name], err_msg=name, **CAMERA_TOL)


@pytest.fixture(scope="module")
def cornell():
    js, jc = jcat.cornell_box(width=12, spp=2, max_depth=3)
    jkey = jax.random.key(3)
    return _port(js, jc, jkey), _jax_grads(js, jc, jkey, 2)


@pytest.mark.parametrize("geometry", [True, False], ids=["geometry", "appearance"])
@pytest.mark.parametrize("replay_isect", [None, False], ids=["replay", "oracle"])
def test_cornell_loss_and_grads_match_jax(cornell, replay_isect, geometry):
    (scene, cam, key), ref = cornell
    target = torch.zeros((cam.height, cam.width, 3))
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, key, target, 2,
                                         replay_isect=replay_isect,
                                         geometry=geometry)
    assert any(k.startswith("geo_") for k in gs) == geometry
    _check((loss, gs, gc), ref)


def test_replay_route_matches_oracle_route(cornell):
    (scene, cam, key), _ = cornell
    target = torch.full((cam.height, cam.width, 3), 0.1)
    l0, (gs0, gc0) = diff.loss_and_grads(scene, cam, key, target, 2,
                                         replay_isect=False)
    l1, (gs1, gc1) = diff.loss_and_grads(scene, cam, key, target, 2)
    _check((l1, gs1, gc1), (float(l0), convert.params_to_numpy(gs0),
                            convert.params_to_numpy(gc0)))


def _fd(scene, cam, key, target, name, idx, eps):
    p0 = diff.scene_params(scene)

    def loss_at(delta):
        p = dict(p0)
        p[name] = p0[name].clone()
        p[name][idx] += delta
        return float(diff.image_loss(diff.apply_scene_params(scene, p), cam, key,
                                     target, 2))

    return (loss_at(eps) - loss_at(-eps)) / (2 * eps)


@pytest.mark.parametrize("name,idx,eps,rtol", [
    ("tex_color0", (1, 0), 1e-2, 2e-2),        # a wall albedo (test_replay.py:115-135)
    ("geo_quad_corner", (4, 2), 0.3, 1e-2),    # the back wall's depth
], ids=["albedo", "quad_corner"])
def test_grads_match_finite_differences(name, idx, eps, rtol):
    """Central differences of the replay loss (the same key, so the loss is
    a deterministic smooth function of the parameter) against its
    gradient. The back wall moves 0.3 of 555 units: no sampled ray crosses
    an edge, so both measure the interior term."""
    scene, cam = catalog.cornell_box(width=10, spp=2, max_depth=2, device="cpu")
    target = torch.zeros((cam.height, cam.width, 3))
    key = keys.key(5)
    _, (gs, _) = diff.loss_and_grads(scene, cam, key, target, 2)
    ad = float(gs[name][idx])
    fd = _fd(scene, cam, key, target, name, idx, eps)
    assert abs(ad) > 1e-6
    assert abs(ad - fd) <= rtol * abs(fd), (ad, fd)


@pytest.fixture(scope="module")
def all_materials():
    js, jc = jcat.all_materials_fixture(width=16, spp=4, max_depth=3)
    jkey = jax.random.key(0)
    return _port(js, jc, jkey), _jax_grads(js, jc, jkey, 4)


def test_all_material_families_live_and_match_jax(all_materials):
    (scene, cam, key), ref = all_materials
    target = torch.zeros((cam.height, cam.width, 3))
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, key, target, 4)
    grads = {**gs, **gc}
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
    for name in LIVE:
        assert float(grads[name].norm()) > 0.0, name
    _check((loss, gs, gc), ref)


def _toy():
    """A small fit: recover a wall albedo from a target render (the JAX
    package's tests/test_fit_checkpoint.py)."""
    js, jc = jcat.cornell_box(width=8, spp=2, max_depth=2)
    target = np.asarray(jint.render_image(js, jc, jax.random.key(7), spp=8))
    wrong = js.replace(textures=js.textures.replace(
        color0=js.textures.color0.at[1].set(jnp.array([0.9, 0.1, 0.1]))))
    return wrong, jc, target


def test_fit_scene_sgd_matches_jax():
    wrong, jc, target = _toy()
    _, j_losses = jdiff.fit_scene(wrong, jc, jnp.asarray(target), steps=3, lr=0.3,
                                  spp=2, seed=1)
    scene, cam, _ = _port(wrong, jc, jax.random.key(0))
    fitted, losses = diff.fit_scene(scene, cam, torch.as_tensor(target), steps=3,
                                    lr=0.3, spp=2, seed=1)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert not torch.equal(fitted.textures.color0, scene.textures.color0)


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.3), ("adam", 0.05)])
def test_fit_checkpoint_resume_equals_uninterrupted(tmp_path, optimizer, lr):
    wrong, jc, target = _toy()
    scene, cam, _ = _port(wrong, jc, jax.random.key(0))
    target = torch.as_tensor(target)
    kw = dict(steps=4, lr=lr, spp=2, seed=1, optimizer=optimizer)
    full_scene, full_losses = diff.fit_scene(scene, cam, target, **kw)
    ck = str(tmp_path / "fit.npz")
    diff.fit_scene(scene, cam, target, **{**kw, "steps": 2}, checkpoint_path=ck,
                   checkpoint_every=2)
    res_scene, res_losses = diff.fit_scene(scene, cam, target, **kw,
                                           checkpoint_path=ck, checkpoint_every=2)
    assert res_losses == full_losses
    assert torch.equal(res_scene.textures.color0, full_scene.textures.color0)
    with pytest.raises(ValueError, match="fingerprint"):
        diff.fit_scene(scene, cam, target, **{**kw, "lr": 2 * lr}, checkpoint_path=ck)


def test_fit_scene_grad_mask_freezes_rows():
    wrong, jc, target = _toy()
    scene, cam, _ = _port(wrong, jc, jax.random.key(0))
    mask = torch.zeros_like(scene.textures.color0)
    mask[1] = 1.0
    fitted, _ = diff.fit_scene(scene, cam, torch.as_tensor(target), steps=2, lr=0.5,
                               spp=2, seed=3, param_filter={"tex_color0"},
                               grad_mask={"tex_color0": mask})
    got = fitted.textures.color0
    assert float((got[1] - scene.textures.color0[1]).abs().max()) > 1e-4
    rows = [i for i in range(got.shape[0]) if i != 1]
    assert torch.equal(got[rows], scene.textures.color0[rows])
    assert torch.equal(fitted.quads.corner, scene.quads.corner)   # filtered out


def test_params_round_trip_and_perspective_only():
    scene, cam = catalog.cornell_box(width=8, spp=1, max_depth=1, device="cpu")
    p = diff.scene_params(scene)
    assert set(diff.scene_params(scene, geometry=False)) < set(p)
    back = convert.params_from_numpy(convert.params_to_numpy(p), device="cpu")
    s2 = diff.apply_scene_params(scene, back)
    for name in ("corner", "eu", "ev"):
        assert torch.equal(getattr(s2.quads, name), getattr(scene.quads, name))
    c2 = diff.apply_camera_params(cam, diff.camera_params(cam))
    assert torch.equal(c2.pos, cam.pos) and c2.width == cam.width
    # the orthographic mode's leaves (a perspective camera's otherwise)
    assert set(diff.camera_params(cam.replace(mode=1))) == {"pos", "lookat",
                                                            "ortho_viewport_h"}
