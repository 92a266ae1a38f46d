"""Gradients never vanish silently at a kernel boundary.

A kernel launched through ctypes writes outputs that carry no graph. The
fused closest-hit drop-ins are ``torch.autograd.Function``s whose backward
is autograd through the plain chunk scan (the JAX package's
``pallas_intersect.py:203-225``), and every raw kernel wrapper refuses an
input that needs a gradient. The kernel route is exercised here on the CPU
by standing a graph-less emulation of K1 / K2 (the plain version under
``torch.no_grad``, packed as the kernel packs its output) in for the
kernel: its gradients must equal plain autograd through the chunk scan
exactly. ``sphere_uv`` carries the JAX package's guards, so its gradient is
finite at the poles and at atan2(0, 0) and its values are unchanged.
"""

import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops.sampling import PI
from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe

TMIN = 1e-3


def _planar(rng, K=2, C=128, n=200):
    corner = rng.uniform(-4, 4, (K * C, 3)).astype(np.float32)
    eu = rng.normal(size=(K * C, 3)).astype(np.float32)
    ev = rng.normal(size=(K * C, 3)).astype(np.float32)
    act = np.arange(K * C) < n
    pts = np.stack([corner, corner + eu, corner + ev, corner + eu + ev])
    lo = np.where(act[:, None], pts.min(0), np.inf).reshape(K, C, 3).min(1)
    hi = np.where(act[:, None], pts.max(0), -np.inf).reshape(K, C, 3).max(1)
    t = torch.as_tensor
    return ch.PlanarChunks(
        corner=t(corner.reshape(K, C, 3)).requires_grad_(),
        eu=t(eu.reshape(K, C, 3)).requires_grad_(),
        ev=t(ev.reshape(K, C, 3)).requires_grad_(),
        mat=t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C)),
        active=t(act.reshape(K, C)), lo=t(lo.astype(np.float32)),
        hi=t(hi.astype(np.float32)))


def _spheres(rng, K=2, C=128, n=200):
    c0 = rng.uniform(-4, 4, (K * C, 3)).astype(np.float32)
    c1 = (c0 + 0.3 * rng.normal(size=(K * C, 3))).astype(np.float32)
    rad = rng.uniform(0.1, 0.6, K * C).astype(np.float32)
    act = np.arange(K * C) < n
    lo = np.where(act[:, None], np.minimum(c0, c1) - rad[:, None], np.inf)
    hi = np.where(act[:, None], np.maximum(c0, c1) + rad[:, None], -np.inf)
    t = torch.as_tensor
    return ch.SphereChunks(
        c0=t(c0.reshape(K, C, 3)).requires_grad_(),
        c1=t(c1.reshape(K, C, 3)).requires_grad_(),
        rad=t(rad.reshape(K, C)).requires_grad_(),
        mat=t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C)),
        active=t(act.reshape(K, C)),
        lo=t(lo.reshape(K, C, 3).min(1).astype(np.float32)),
        hi=t(hi.reshape(K, C, 3).max(1).astype(np.float32)))


def _rays(rng, n=400):
    org = torch.as_tensor(rng.uniform(-6, 6, (n, 3)).astype(np.float32))
    dirs = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    time = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32))
    return org.requires_grad_(), dirs.requires_grad_(), time.requires_grad_()


def _emulate_planar(chunks):
    """K1 on the CPU: the plain scan's result packed into [8, R] rows with
    no graph, as the CUDA kernel writes them."""
    def kernel(rays, pack, tmin, tmax=fi.BIG, triangle=False, with_pid=False):
        with torch.no_grad():
            t, (n, u, v, m, pid) = ch.planar_closest(
                rays[0:3].T, rays[3:6].T, chunks, tmin, triangle, tmax=tmax)
            hit = torch.isfinite(t)
            out = torch.stack([torch.where(hit, t, torch.full_like(t, fi.BIG)),
                               n[:, 0], n[:, 1], n[:, 2], u, v, m.float(),
                               hit.float()])
        return (out, pid) if with_pid else out
    return kernel


def _emulate_sphere(chunks):
    def kernel(rays, pack, tmin, tmax=fi.BIG, with_pid=False):
        with torch.no_grad():
            t, (c, r, m, pid) = ch.sphere_closest(
                rays[0:3].T, rays[3:6].T, rays[6], chunks, tmin, tmax=tmax)
            hit = torch.isfinite(t)
            out = torch.stack([torch.where(hit, t, torch.full_like(t, fi.BIG)),
                               c[:, 0], c[:, 1], c[:, 2], r, m.float(),
                               hit.float(), torch.zeros_like(t)])
        return (out, pid) if with_pid else out
    return kernel


def _weighted(rng, outs):
    """A scalar that reads every differentiable output (t where finite)."""
    total = 0.0
    for x in outs:
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        total = total + (x * torch.as_tensor(
            rng.normal(size=tuple(x.shape)).astype(np.float32))).sum()
    return total


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("triangle", [False, True], ids=["quad", "tri"])
def test_planar_kernel_route_keeps_gradients(monkeypatch, triangle):
    rng = np.random.default_rng(11)
    chunks = _planar(rng)
    org, dirs, _ = _rays(rng)
    leaves = [org, dirs, chunks.corner, chunks.eu, chunks.ev]
    monkeypatch.setattr(fi, "_on_card", lambda x: True)
    monkeypatch.setattr(fi, "planar_closest_kernel", _emulate_planar(chunks))
    t, (n, u, v, _) = fi.planar_closest_fused(org, dirs, chunks, TMIN, triangle,
                                              pack=torch.zeros(1))
    assert t.grad_fn is not None and int(torch.isfinite(t).sum()) > 50
    got = _grads(_weighted(np.random.default_rng(3), (t, n, u, v)), leaves)
    t_r, (n_r, u_r, v_r, _, _) = ch.planar_closest(org, dirs, chunks, TMIN, triangle)
    ref = _grads(_weighted(np.random.default_rng(3), (t_r, n_r, u_r, v_r)), leaves)
    for g, g_r in zip(got, ref):
        assert g is not None and torch.equal(g, g_r)


def test_sphere_kernel_route_keeps_gradients(monkeypatch):
    rng = np.random.default_rng(12)
    chunks = _spheres(rng)
    org, dirs, time = _rays(rng)
    leaves = [org, dirs, chunks.c0, chunks.c1, chunks.rad]
    monkeypatch.setattr(fi, "_on_card", lambda x: True)
    monkeypatch.setattr(fi, "sphere_closest_kernel", _emulate_sphere(chunks))
    t, (c, r, _) = fi.sphere_closest_fused(org, dirs, time, chunks, TMIN,
                                           pack=torch.zeros(1))
    assert t.grad_fn is not None and int(torch.isfinite(t).sum()) > 50
    got = _grads(_weighted(np.random.default_rng(4), (t, c, r)), leaves)
    t_r, (c_r, r_r, _, _) = ch.sphere_closest(org, dirs, time, chunks, TMIN)
    ref = _grads(_weighted(np.random.default_rng(4), (t_r, c_r, r_r)), leaves)
    for g, g_r in zip(got, ref):
        assert g is not None and torch.equal(g, g_r)


def test_cpu_route_gradients_equal_plain_autograd():
    """On CPU tensors the drop-in takes the plain scan in its forward and the
    chunk-scan VJP in its backward: the same gradients as autograd."""
    rng = np.random.default_rng(13)
    chunks = _planar(rng)
    org, dirs, _ = _rays(rng)
    leaves = [org, dirs, chunks.corner, chunks.eu, chunks.ev]
    t, (n, u, v, _) = fi.planar_closest_fused(org, dirs, chunks, TMIN, False)
    got = _grads(_weighted(np.random.default_rng(5), (t, n, u, v)), leaves)
    t_r, (n_r, u_r, v_r, _, _) = ch.planar_closest(org, dirs, chunks, TMIN, False)
    ref = _grads(_weighted(np.random.default_rng(5), (t_r, n_r, u_r, v_r)), leaves)
    for g, g_r in zip(got, ref):
        assert torch.equal(g, g_r)


def test_raw_kernel_wrappers_refuse_inputs_that_need_a_gradient():
    """No wrapper of a ctypes kernel returns a result that silently drops a
    gradient; under torch.no_grad() the same call goes on to its device
    checks."""
    x8 = torch.zeros((8, 16), requires_grad=True)
    pack = torch.zeros((1, 16, 128))
    r8 = torch.zeros((16, 8), requires_grad=True)
    calls = [
        lambda: fi.planar_closest_kernel(x8, pack, TMIN),
        lambda: fi.sphere_closest_kernel(x8, pack, TMIN),
        lambda: fs.cull_select_kernel(r8, torch.zeros((8, 128)), torch.zeros((16, 2)),
                                      4, 100, TMIN),
        lambda: fsw.sweep_kernel(r8, torch.zeros((16, 4), dtype=torch.int32),
                                 torch.zeros((16, 4)), torch.zeros((16, 8)),
                                 torch.zeros((3, 9, 128)), TMIN, True, False),
        lambda: gather_probe.gather_sum_kernel(torch.zeros((16, 4), dtype=torch.int32),
                                               torch.zeros((8, 16), requires_grad=True)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()


def _sphere_uv_unguarded(n):
    """The formula without guards. Its atan2 takes contiguous components:
    PyTorch's CPU atan2 rounds a strided input (scalar loop) and a
    contiguous one (vector loop) an ulp apart, and the guarded version's
    selects hand it contiguous tensors."""
    y = torch.clamp(-n[..., 1], -1.0, 1.0)
    nz, nx = (-n[..., 2]).contiguous(), n[..., 0].contiguous()
    deg = (nz == 0.0) & (nx == 0.0)
    phi = torch.where(deg, torch.zeros_like(nz), torch.atan2(nz, nx)) + PI
    return phi / (2.0 * PI), torch.arccos(y) / PI


def test_sphere_uv_is_ad_safe_and_unchanged():
    rng = np.random.default_rng(14)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    # the poles and the atan2(0, 0) lanes
    n[:4] = [[0, 1, 0], [0, -1, 0], [0, 1, 0], [0, -1, 0]]
    n = torch.tensor(n, requires_grad=True)
    u, v = isect.sphere_uv(n)
    u0, v0 = _sphere_uv_unguarded(n)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    # a masked lane's zero cotangent must not turn into NaN
    w = torch.ones(200)
    w[:4] = 0.0
    (g,) = torch.autograd.grad(((u + v) * w).sum(), n)
    assert bool(torch.isfinite(g).all())
    (g0,) = torch.autograd.grad(((u0 + v0) * w).sum(), n)
    assert not bool(torch.isfinite(g0).all())   # what the guards prevent
    torch.testing.assert_close(g[4:], g0[4:], rtol=0, atol=0)
