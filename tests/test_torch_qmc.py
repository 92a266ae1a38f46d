"""Owen-scrambled Sobol sampling (``ops/qmc.py``, ``camera.qmc``) in the
port against the JAX package.

The uint32 primitives and ``qmc.uniforms`` are bit-equal to JAX's on
numpy-seeded inputs: scalar and per-lane sample indices and pair groups,
the camera and bounce layouts, volume slots. The (0,2)-net property holds
at 2^k samples, unscrambled and Owen-scrambled. Renders: the wavefront
under QMC equals the scan (rtol/atol 1e-5), for the Cornell box and, with
per-lane pair groups past the volume slots, the volume Cornell box; the
QMC scan itself is held to JAX's render in tests/test_torch_render.py.
Gradients under QMC: ``loss_and_grads`` (two passes, the second replaying
the first) equals plain autograd through one render at the JAX package's
gradient tolerances, so both passes draw the same Sobol points.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.ops import qmc as jq
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import qmc

RNG = np.random.default_rng(41)
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)
SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)


def _u32(n):
    return RNG.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(got.numpy().dtype))


def test_primitives_bit_equal():
    x, s = _u32(4096), _u32(4096)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    _eq(qmc._reverse_bits(_t(x)), jq._reverse_bits(jnp.asarray(x)))
    _eq(qmc._sobol_dim0(_t(x)), jq._sobol_dim0(jnp.asarray(x)))
    _eq(qmc._sobol_dim1(_t(x)), jq._sobol_dim1(jnp.asarray(x)))
    _eq(qmc._lk_scramble(_t(x), _t(s)), jq._lk_scramble(jnp.asarray(x), jnp.asarray(s)))
    _eq(qmc.owen_scramble(_t(x), _t(s)), jq.owen_scramble(jnp.asarray(x), jnp.asarray(s)))
    _eq(qmc.shuffle_index(_t(x), _t(s)), jq.shuffle_index(jnp.asarray(x), jnp.asarray(s)))
    _eq(qmc._to_unit(_t(x)), jq._to_unit(jnp.asarray(x)))
    idx = np.arange(4096, dtype=np.uint32)
    _eq(qmc.sobol2d(_t(idx), 0xDEADBEEF, 12345),
        jq.sobol2d(jnp.asarray(idx), jnp.uint32(0xDEADBEEF), jnp.uint32(12345)))
    assert qmc._V1.tolist() == jq._V1.tolist()


def test_layouts_and_seed_words():
    assert (qmc.CAM_GROUP, qmc.CAM_DIM, qmc.N_CAM_GROUPS) == (
        jq.CAM_GROUP, jq.CAM_DIM, jq.N_CAM_GROUPS)
    for nslot in (9, 10, 12):
        assert qmc.bounce_layout(nslot) == jq.bounce_layout(nslot)
    for seed in (0, 42, 2**32 - 1):
        np.testing.assert_array_equal(
            qmc.seed_words(keys.key(seed)),
            np.asarray(jq.seed_words(jax.random.key(seed))))


@pytest.mark.parametrize("nslot", [9, 11])
def test_uniforms_bit_equal(nslot):
    """Scalar and per-lane sample indices and pair groups, camera and
    bounce layouts (volume slots past NSLOT)."""
    words = qmc.seed_words(keys.key(3))
    jwords = jq.seed_words(jax.random.key(3))
    ids = RNG.integers(0, 512 * 512, 700).astype(np.int32)
    groups, dims, ngroups = qmc.bounce_layout(nslot)
    sidx = RNG.integers(0, 4096, 700).astype(np.int32)
    bounce = RNG.integers(0, 8, 700).astype(np.int32)
    cases = [
        (5, qmc.N_CAM_GROUPS + 3 * ngroups, groups, dims),
        (255, 0, qmc.CAM_GROUP, qmc.CAM_DIM),
        (sidx, 0, qmc.CAM_GROUP, qmc.CAM_DIM),
        (sidx, qmc.N_CAM_GROUPS + bounce * ngroups, groups, dims),
    ]
    for index, base, g, d in cases:
        got = qmc.uniforms(words, torch.as_tensor(ids),
                           torch.as_tensor(index) if isinstance(index, np.ndarray)
                           else index,
                           torch.as_tensor(base) if isinstance(base, np.ndarray)
                           else base, g, d)
        ref = np.asarray(jq.uniforms(jwords, jnp.asarray(ids), index, base, g, d))
        assert got.dtype == torch.float32 and got.shape == (700, len(g))
        np.testing.assert_array_equal(got.numpy(), ref)


def _is_02_net(pts: np.ndarray) -> bool:
    """Every elementary interval of area 1/n holds exactly one of n points."""
    n = len(pts)
    k = int(np.log2(n))
    for a in range(k + 1):
        b = k - a
        cell = (np.floor(pts[:, 0] * (1 << a)).astype(int) * (1 << b)
                + np.floor(pts[:, 1] * (1 << b)).astype(int))
        if len(np.unique(cell)) != n:
            return False
    return True


def test_02_net_property():
    for k in (2, 4, 6, 8):
        assert _is_02_net(qmc.sobol2d(torch.arange(1 << k)).numpy()), k
    for seed0, seed1 in itertools.product((1, 0xDEADBEEF, 12345), (7, 0xC0FFEE)):
        pts = qmc.sobol2d(torch.arange(64), seed0, seed1).numpy()
        assert _is_02_net(pts), (seed0, seed1)
    # a pair of one pixel's block: its 2^k-sample prefix is a (0,2)-net
    words = qmc.seed_words(keys.key(9))
    ids = torch.full((64,), 1234, dtype=torch.int32)
    u = qmc.uniforms(words, ids, torch.arange(64), 0, qmc.CAM_GROUP, qmc.CAM_DIM)
    assert _is_02_net(u[:, :2].numpy())


@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_with_volume"])
def test_wavefront_matches_scan(name):
    s, c = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
    c = c.replace(qmc=True, rr_depth=2, stratify=True)
    key = keys.key(11)
    scan = integrator.render_image(s, c, key)
    wave = (integrator.render_wavefront(s, c, key, 4, lanes=100) / 4).reshape(scan.shape)
    torch.testing.assert_close(wave, scan, **WAVEFRONT_TOL)


def test_gradients_replay_the_recorded_samples():
    """Under QMC the backward pass draws the forward pass's Sobol points:
    its gradients equal plain autograd through one render."""
    s, c = catalog.cornell_box(width=8, spp=3, max_depth=3, device="cpu")
    c = c.replace(qmc=True)
    key = keys.key(5)
    target = torch.full((c.height, c.width, 3), 0.1)
    loss, (gs, gc) = diff.loss_and_grads(s, c, key, target, 3, geometry=False)
    sp = {k: v.detach().clone().requires_grad_() for k, v in
          diff.scene_params(s, geometry=False).items()}
    cp = {k: v.detach().clone().requires_grad_() for k, v in diff.camera_params(c).items()}
    img = integrator.render_image(diff.apply_scene_params(s, sp),
                                  diff.apply_camera_params(c, cp), key, spp=3)
    ref = torch.mean((img - target) ** 2)
    ref.backward()
    np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-5)
    for name, g in gs.items():
        want = torch.zeros_like(g) if sp[name].grad is None else sp[name].grad
        np.testing.assert_allclose(g.numpy(), want.numpy(), err_msg=name, **SCENE_TOL)
    for name, g in gc.items():
        np.testing.assert_allclose(g.numpy(), cp[name].grad.numpy(), err_msg=name,
                                   **CAMERA_TOL)
    assert float(gs["tex_color0"].abs().sum()) > 0
