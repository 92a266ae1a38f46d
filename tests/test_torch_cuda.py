"""The CUDA kernels K1 and K2 on the card, against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are chip_smoke.py's: equal hit masks and materials, t within
rtol 1e-4 / atol 1e-4, every other payload field (normal, u, v; center,
rad) within atol 1e-3.
"""

import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import keys

pytestmark = pytest.mark.cuda

TMIN = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _t(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def _planar_chunks(rng, dev, K=6, C=128, n=700):
    corner = rng.uniform(-10, 10, (K * C, 3)).astype(np.float32)
    eu = rng.normal(size=(K * C, 3)).astype(np.float32)
    ev = rng.normal(size=(K * C, 3)).astype(np.float32)
    act = np.arange(K * C) < n
    pts = np.stack([corner, corner + eu, corner + ev, corner + eu + ev])
    lo = np.where(act[:, None], pts.min(0), np.inf).reshape(K, C, 3).min(1)
    hi = np.where(act[:, None], pts.max(0), -np.inf).reshape(K, C, 3).max(1)
    return ch.PlanarChunks(
        corner=_t(corner.reshape(K, C, 3), dev), eu=_t(eu.reshape(K, C, 3), dev),
        ev=_t(ev.reshape(K, C, 3), dev),
        mat=_t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C), dev),
        active=_t(act.reshape(K, C), dev), lo=_t(lo.astype(np.float32), dev),
        hi=_t(hi.astype(np.float32), dev))


def _sphere_chunks(rng, dev, K=6, C=128, n=700):
    c0 = rng.uniform(-10, 10, (K * C, 3)).astype(np.float32)
    c1 = (c0 + 0.3 * rng.normal(size=(K * C, 3))).astype(np.float32)
    rad = rng.uniform(0.05, 0.85, K * C).astype(np.float32)
    act = np.arange(K * C) < n
    lo = np.where(act[:, None], np.minimum(c0, c1) - rad[:, None], np.inf)
    hi = np.where(act[:, None], np.maximum(c0, c1) + rad[:, None], -np.inf)
    return ch.SphereChunks(
        c0=_t(c0.reshape(K, C, 3), dev), c1=_t(c1.reshape(K, C, 3), dev),
        rad=_t(rad.reshape(K, C), dev),
        mat=_t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C), dev),
        active=_t(act.reshape(K, C), dev),
        lo=_t(lo.reshape(K, C, 3).min(1).astype(np.float32), dev),
        hi=_t(hi.reshape(K, C, 3).max(1).astype(np.float32), dev))


def _rays(rng, dev, n):
    org = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    return _t(org, dev), _t(dirs, dev), _t(time, dev)


def _check(got, ref, payload_atol):
    t, payload = got
    t_r, payload_r = ref
    valid = torch.isfinite(t_r)
    assert int(valid.sum()) > 100
    assert torch.equal(torch.isfinite(t), valid)
    assert torch.equal(payload[-1][valid], payload_r[-1][valid])      # mat
    torch.testing.assert_close(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    for x, x_r in zip(payload[:-1], payload_r[:-1]):
        torch.testing.assert_close(x[valid], x_r[valid], rtol=0, atol=payload_atol)


@pytest.mark.parametrize("triangle", [False, True], ids=["quad", "tri"])
def test_planar_kernel_matches_plain(dev, triangle):
    rng = np.random.default_rng(6)
    chunks = _planar_chunks(rng, dev)
    org, dirs, _ = _rays(rng, dev, 20000)
    fi.reset_launches()
    got = fi.planar_closest_fused(org, dirs, chunks, TMIN, triangle)
    assert fi.LAUNCHES == {"planar_closest": 1, "sphere_closest": 0}
    ref = ch.planar_closest(org, dirs, chunks, TMIN, triangle)
    torch.cuda.synchronize()
    # the plain version also returns the primitive id, which the kernel lacks
    _check(got, (ref[0], ref[1][:4]), 1e-3)


def test_sphere_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    chunks = _sphere_chunks(rng, dev)
    org, dirs, time = _rays(rng, dev, 20000)
    fi.reset_launches()
    got = fi.sphere_closest_fused(org, dirs, time, chunks, TMIN)
    assert fi.LAUNCHES == {"planar_closest": 0, "sphere_closest": 1}
    ref = ch.sphere_closest(org, dirs, time, chunks, TMIN)
    torch.cuda.synchronize()
    _check(got, (ref[0], ref[1][:3]), 1e-3)


@pytest.mark.parametrize("n_rays", [1, 77, 128, 129])
def test_ragged_ray_counts(dev, n_rays):
    """R not a multiple of the kernel's block of 128 rays."""
    rng = np.random.default_rng(n_rays)
    chunks = _planar_chunks(rng, dev, K=2, n=200)
    org, dirs, _ = _rays(rng, dev, n_rays)
    got = fi.planar_closest_fused(org, dirs, chunks, TMIN, False)
    ref = ch.planar_closest(org, dirs, chunks, TMIN, False)
    assert got[0].shape == (n_rays,)
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pack = torch.zeros((1, 16, 128), device=dev)
    rays = torch.zeros((8, 256), device=dev)
    with pytest.raises(TypeError, match="float32"):
        fi.planar_closest_kernel(rays.double(), pack, TMIN)
    with pytest.raises(ValueError, match="contiguous"):
        fi.planar_closest_kernel(torch.zeros((256, 8), device=dev).T, pack, TMIN)
    with pytest.raises(ValueError, match="rows"):
        fi.sphere_closest_kernel(rays[:7], pack, TMIN)


@pytest.mark.parametrize("name,golden", [("cornell_box", 0.160999),
                                         ("three_material_ball", 0.563181)])
def test_golden_render_on_card(dev, name, golden):
    """The main path on the card launches its kernel and gives the golden
    workload's mean (tests/test_golden.py, atol 2e-3)."""
    scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=dev)
    fi.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - golden) <= 2e-3
    kernel = "sphere_closest" if name == "three_material_ball" else "planar_closest"
    assert fi.LAUNCHES[kernel] == cam.spp * cam.max_depth
