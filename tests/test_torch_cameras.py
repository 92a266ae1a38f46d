"""The port's four camera models against the JAX package's.

``generate_rays`` of each mode against JAX's at the same uniforms (atol
1e-5); the differentiable leaves per mode (``diff.camera_params``) against
JAX's; the thin-lens camera's gradients against JAX's ``loss_and_grads``
at the JAX package's replay-against-remat tolerances (loss rtol 1e-4,
scene rtol 2e-3 / atol 1e-5, camera rtol 5e-3 / atol 1e-4); and the
orthographic and fisheye gradients against central finite differences of
the port's own ``image_loss``, in a scene without silhouette edges (a
mirror sphere filling the view under a bilinear sky), where the image is a
smooth function of the camera.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import camera as jcam
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam
from cpu_ray_tracing_implementation_tpu_torch.models import diff
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)

# (JAX constructor, its arguments, port constructor): one camera per mode,
# the fisheye wide enough that its corner rays reach the asin clamp
CAMERAS = {
    "perspective": (jcam.perspective, (24, 1.5, (1, 2, 6), (0, 0.5, 0), 1.3, 35.0),
                    cam.perspective),
    "orthographic": (jcam.orthographic, (24, 1.0, 3.0, (0, 0, 5), (0.2, 0, 0)),
                     cam.orthographic),
    "fisheye": (jcam.fisheye, (24, 1.0, (1.1, 1.8, 1.1), (0, 0, 0), 1.0, 120.0),
                cam.fisheye),
    "lens": (jcam.lens, (24, 16 / 9, (13, 2, 3), (1, 1, 1), 2.0, 15.0, 20.0),
             cam.lens),
}


@pytest.mark.parametrize("mode", sorted(CAMERAS))
def test_generate_rays_matches_jax(mode):
    jmake, args, make = CAMERAS[mode]
    jc = jmake(*args, spp=2, max_depth=3)
    pc = make(*args, spp=2, max_depth=3, device="cpu")
    assert pc.mode == jc.mode and (pc.width, pc.height) == (jc.width, jc.height)
    rng = np.random.default_rng(5)
    n = jc.width * jc.height
    ids = np.arange(n, dtype=np.int32)
    u = rng.uniform(0, 1, (n, cam.N_CAM_SLOTS)).astype(np.float32)
    jo, jd, jt = jcam.generate_rays(jc, jnp.asarray(ids), jnp.asarray(u))
    po, pd, pt = cam.generate_rays(pc, torch.as_tensor(ids), torch.as_tensor(u))
    assert bool(torch.isfinite(pd).all()) and bool(torch.isfinite(po).all())
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    if mode == "lens":   # lens rays carry no time, as the reference's
        assert not bool(pt.any())
    # the port's own constructor and the carried-across JAX camera agree
    cc = convert.camera_from_numpy(jc, device="cpu")
    for name in ("pos", "lookat", "fovy_deg", "focal_length", "ortho_viewport_h",
                 "defocus_angle_deg", "focus_dist"):
        assert torch.equal(getattr(cc, name), getattr(pc, name)), name


@pytest.mark.parametrize("mode", sorted(CAMERAS))
def test_camera_params_per_mode_match_jax(mode):
    jmake, args, make = CAMERAS[mode]
    jp = jdiff.camera_params(jmake(*args, spp=1))
    pp = diff.camera_params(make(*args, spp=1, device="cpu"))
    assert list(pp) == list(jp)
    for name, v in pp.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[name]))


def test_lens_gradients_match_jax():
    js, jc = jcat.three_material_ball_with_defocus_blur(width=8, spp=2, max_depth=2)
    jkey = jax.random.key(4)
    target = np.full((jc.height, jc.width, 3), 0.3, np.float32)
    j_loss, (j_gs, j_gc) = jdiff.loss_and_grads(js, jc, jkey, jnp.asarray(target),
                                                spp=2)
    loss, (gs, gc) = diff.loss_and_grads(
        convert.scene_from_numpy(js, device="cpu"),
        convert.camera_from_numpy(jc, device="cpu"),
        convert.key_from_numpy(jax.random.key_data(jkey)), torch.as_tensor(target), 2)
    assert set(gc) == {"pos", "lookat", "fovy_deg", "defocus_angle_deg", "focus_dist"}
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    for name, g in gs.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(j_gs[name]), err_msg=name,
                                   **SCENE_TOL)
    for name, g in gc.items():
        assert float(g.abs().sum()) > 0.0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j_gc[name]), err_msg=name,
                                   **CAMERA_TOL)


def _mirror_ball(camera):
    """A mirror sphere that fills ``camera``'s whole view under a smooth
    bilinear sky: every path reflects once and reads the sky, a smooth
    function of the camera (no silhouette, no texel step)."""
    v = np.linspace(0.0, 1.0, 32)[:, None]
    u = np.linspace(0.0, 1.0, 64)[None, :]
    sky = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * u) * np.cos(np.pi * v),
                    0.5 + 0.3 * np.cos(2 * np.pi * u + 1.0) * v,
                    0.3 + 0.6 * v * v + 0.0 * u], axis=-1) * 255.0
    b = SceneBuilder()
    b.sphere((0, 0, -20), 20.0, b.metal((0.9, 0.8, 0.7), 0.0))
    b.set_background(b.picture(sky, filter="bilinear"))
    return b.build("cpu"), camera


@pytest.mark.parametrize("mode,name,idx,eps", [
    ("orthographic", "ortho_viewport_h", (), 1e-2),
    ("orthographic", "pos", (1,), 1e-2),
    ("fisheye", "fovy_deg", (), 1e-2),
    ("fisheye", "pos", (1,), 1e-2)])
def test_gradients_match_finite_differences(mode, name, idx, eps):
    if mode == "orthographic":
        camera = cam.orthographic(8, 1.0, 3.0, (0.5, 0.3, 5), (0.3, 0, 0), spp=2,
                                  max_depth=2, device="cpu")
    else:
        camera = cam.fisheye(8, 1.0, (0.4, 0.2, 1.5), (0, 0, 0), 1.0, 50.0, spp=2,
                             max_depth=2, device="cpu")
    scene, camera = _mirror_ball(camera)
    key = keys.key(2)
    target = torch.full((camera.height, camera.width, 3), 0.2)
    _, (_, gc) = diff.loss_and_grads(scene, camera, key, target, 2)
    p0 = diff.camera_params(camera)

    def loss_at(delta):
        p = dict(p0)
        p[name] = p0[name].clone()
        p[name][idx] += delta
        return float(diff.image_loss(scene, diff.apply_camera_params(camera, p), key,
                                     target, 2))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    ad = float(gc[name][idx])
    assert abs(ad) > 1e-6
    assert abs(ad - fd) <= 1e-2 * abs(fd), (ad, fd)
