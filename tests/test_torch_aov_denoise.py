"""AOVs (``models/aov.py``) and the denoiser (``utils/denoise.py``) of the
port against the JAX package's.

``render_aovs`` on the same tables and key under each stream (``fast``,
``CRT_RNG=threefry``, ``camera.qmc``): coverage equal; normal, albedo and
depth within atol 1e-4 on at least 99% of pixels, on three_material_ball
(hit distances of a few units). On the Cornell box, whose hit distances
reach ~1,400 units, JAX's dense XLA route and the port's kernel payload
round t apart by a few float32 ulps, so its depth is held at rtol 1e-6.
``denoise`` on the same numpy inputs within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import aov as jaov
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.utils import denoise as jdenoise
from cpu_ray_tracing_implementation_tpu_torch.models import aov, integrator
from cpu_ray_tracing_implementation_tpu_torch.utils import convert, denoise

AOVS = ("normal", "albedo", "depth", "coverage")


def _both(name, monkeypatch, stream):
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=3)
    if stream == "qmc":
        jc = jc.replace(qmc=True)
    if stream == "threefry":
        # JAX reads the stream when it traces: clear the traces around it
        monkeypatch.setenv("CRT_RNG", "threefry")
        jax.clear_caches()
    jkey = jax.random.key(11)
    try:
        ref = jaov.render_aovs(js, jc, jkey)
    finally:
        if stream == "threefry":
            jax.clear_caches()
    got = aov.render_aovs(convert.scene_from_numpy(js, device="cpu"),
                          convert.camera_from_numpy(jc, device="cpu"),
                          convert.key_from_numpy(jax.random.key_data(jkey)))
    return got, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("stream", ["fast", "threefry", "qmc"])
def test_render_aovs_matches_jax(monkeypatch, stream):
    got, ref = _both("three_material_ball", monkeypatch, stream)
    for k in AOVS:
        assert got[k].shape == ref[k].shape and torch.isfinite(got[k]).all(), k
    np.testing.assert_array_equal(got["coverage"].numpy(), ref["coverage"])
    assert 0.0 < ref["coverage"].mean() < 1.0
    for k in ("normal", "albedo", "depth"):
        close = (np.abs(got[k].numpy() - ref[k]) <= 1e-4).all(axis=-1)
        assert close.mean() >= 0.99, (k, close.mean())


def test_render_aovs_cornell_matches_jax(monkeypatch):
    got, ref = _both("cornell_box", monkeypatch, "fast")
    np.testing.assert_array_equal(got["coverage"].numpy(), ref["coverage"])
    for k in ("normal", "albedo"):
        close = (np.abs(got[k].numpy() - ref[k]) <= 1e-4).all(axis=-1)
        assert close.mean() >= 0.99, (k, close.mean())
    close = np.abs(got["depth"].numpy() - ref["depth"]) <= 1e-6 * ref["depth"]
    assert close.mean() >= 0.99 and ref["depth"].max() > 1000.0


def _inputs(seed, h=24, w=20):
    """A noisy beauty image and AOV-like guides with an uncovered corner,
    a depth step and a firefly."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img[5, 7] = 40.0
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n[:, w // 2:] = (0.0, 1.0, 0.0)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    cov = np.ones((h, w, 1), np.float32)
    cov[:4, :4] = 0.0
    n[:4, :4] = 0.0
    depth = np.where(np.arange(w)[None, :, None] < w // 3, 3.0, 9.0).repeat(h, 0)
    depth = (depth * cov).astype(np.float32)
    alb = (rng.uniform(0.1, 0.9, (h, w, 3)) * cov).astype(np.float32)
    return img, {"normal": n, "albedo": alb, "depth": depth, "coverage": cov}


@pytest.mark.parametrize("iterations,despike", [(4, True), (2, False), (1, True)])
def test_denoise_matches_jax(iterations, despike):
    img, aovs = _inputs(iterations)
    ref = np.asarray(jdenoise.denoise(jnp.asarray(img), {k: jnp.asarray(v) for k, v in
                                                         aovs.items()},
                                      iterations=iterations, despike=despike))
    got = denoise.denoise(torch.as_tensor(img), {k: torch.as_tensor(v) for k, v in
                                                 aovs.items()},
                          iterations=iterations, despike=despike)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dy,dx", [(0, 0), (3, -2), (-16, 16), (40, 1)])
def test_shift_clamps_edges_as_jax(dy, dx):
    x = np.arange(6 * 5 * 2, dtype=np.float32).reshape(6, 5, 2)
    np.testing.assert_array_equal(denoise._shift(torch.as_tensor(x), dy, dx).numpy(),
                                  np.asarray(jdenoise._shift(jnp.asarray(x), dy, dx)))


def test_denoise_of_a_render_lowers_its_error():
    """On the port's own Cornell render (the JAX package's
    ``test_denoise_reduces_mse``), the denoised 4-spp image is much nearer
    a high-spp render than the raw one, in tone-mapped MSE."""
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.ops import keys

    scene, cam = catalog.cornell_box(width=32, spp=4, max_depth=4, device="cpu")
    noisy = integrator.render_image(scene, cam, keys.key(0))
    clean = integrator.render_image(scene, cam, keys.key(9), spp=256)
    out = denoise.denoise(noisy, aov.render_aovs(scene, cam, keys.key(0)))
    assert torch.isfinite(out).all()

    def tm(x):
        return x / (1.0 + x)

    mse_in = float(((tm(noisy) - tm(clean)) ** 2).mean())
    mse_out = float(((tm(out) - tm(clean)) ** 2).mean())
    assert mse_out < 0.6 * mse_in, (mse_in, mse_out)
