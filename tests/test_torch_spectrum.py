"""Spectral dispersion in the port against the JAX package.

``ops/spectrum.py``: the host tables (``RGB_BASIS``,
``SPECTRAL_WEIGHT_NORM``) are equal; ``wavelength_to_rgb`` is equal on
every segment boundary and on a dense grid but for counted byte flips of
at most 1 (XLA's and torch's float32 ``pow`` may differ in the last ulp,
which moves a ``round`` at a .5 boundary: at most one channel in 1,000 may
flip; none did on the CPU when this was written);
``cauchy_ior_shift`` and ``to_rgb`` within rtol 1e-6. The hero-wavelength
render: the wavefront equals the scan (rtol/atol 1e-5) through the refill,
in the ``fast`` and the threefry stream; ``mat_dispersion`` is a parameter
of dispersive scenes only, and its gradient on the prism at 8 px matches
JAX's at the JAX package's gradient tolerances (tests/test_torch_diff.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu.ops import spectrum as jsp
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import spectrum as sp
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

RNG = np.random.default_rng(17)
SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)
# the segment and factor boundaries of src/spectrum.h:140-200
BOUNDARIES = (380.0, 420.0, 440.0, 490.0, 510.0, 580.0, 645.0, 700.0, 701.0,
              750.0, 780.0)


def test_host_tables_equal():
    assert sp.NUM_BINS == jsp.NUM_BINS == 75
    np.testing.assert_array_equal(sp.WAVELENGTHS, jsp.WAVELENGTHS)
    np.testing.assert_array_equal(sp.RGB_BASIS, jsp.RGB_BASIS)
    np.testing.assert_array_equal(sp.SPECTRAL_WEIGHT_NORM, jsp.SPECTRAL_WEIGHT_NORM)
    for w in (379.0, 380.0, 455.5, 600.0, 779.0, 781.0):
        np.testing.assert_array_equal(sp._wavelength_to_rgb_scalar(w),
                                      jsp._wavelength_to_rgb_scalar(w))


def _byte_flips(wl: np.ndarray) -> int:
    got = sp.wavelength_to_rgb(torch.as_tensor(wl)).numpy()
    ref = np.asarray(jsp.wavelength_to_rgb(jnp.asarray(wl)))
    diff_ = np.abs(got - ref)
    assert diff_.max() <= 1.0, diff_.max()
    return int((diff_ > 0).sum())


def test_wavelength_to_rgb_boundaries():
    """Exact on every boundary and one float32 ulp either side of it."""
    b = np.array(BOUNDARIES, np.float32)
    wl = np.concatenate([b, np.nextafter(b, np.float32(0)),
                         np.nextafter(b, np.float32(1e4))])
    assert _byte_flips(wl) == 0


def test_wavelength_to_rgb_dense_grid():
    """A dense grid and random wavelengths over 370-790 nm: equal but for
    counted byte flips of at most 1."""
    wl = np.concatenate([np.linspace(370.0, 790.0, 42001, dtype=np.float32),
                         RNG.uniform(370.0, 790.0, 20000).astype(np.float32)])
    flips = _byte_flips(wl)
    assert flips <= 3 * wl.size // 1000, flips


def test_cauchy_to_rgb_and_weight():
    wl = RNG.uniform(380.0, 750.0, 4096).astype(np.float32)
    np.testing.assert_allclose(sp.cauchy_ior_shift(torch.as_tensor(wl)).numpy(),
                               np.asarray(jsp.cauchy_ior_shift(jnp.asarray(wl))),
                               rtol=1e-6, atol=1e-7)
    assert abs(float(sp.cauchy_ior_shift(torch.tensor(589.0)))) < 1e-5
    spd = RNG.uniform(0, 2, (64, sp.NUM_BINS)).astype(np.float32)
    spd[0] = 0.0
    np.testing.assert_allclose(sp.to_rgb(torch.as_tensor(spd)).numpy(),
                               np.asarray(jsp.to_rgb(jnp.asarray(spd))), rtol=1e-6)
    np.testing.assert_allclose(sp.to_linear_rgb(torch.as_tensor(spd)).numpy(),
                               np.asarray(jsp.to_linear_rgb(jnp.asarray(spd))),
                               rtol=1e-6)
    # the path weight is white in expectation over uniform wavelengths
    grid = torch.linspace(380.0, 750.0, 20001)
    np.testing.assert_allclose(sp.spectral_path_weight(grid).mean(0).numpy(), 1.0,
                               atol=5e-3)


def test_spd_helpers():
    # the constructors build on the card unless the caller asks for the CPU
    for fn in (sp.zeros, sp.constant, sp.line):
        assert inspect.signature(fn).parameters["device"].default == DEFAULT_DEVICE
    line = sp.line(452.0, 3.0, device="cpu")
    assert line.shape == (75,) and float(line.sum()) == 3.0 and float(line[14]) == 3.0
    np.testing.assert_array_equal(sp.add_line(line, 452.0, 1.0).numpy(),
                                  np.asarray(jsp.add_line(jsp.line(452.0, 3.0), 452.0, 1.0)))
    assert float(sp.zeros((2,), device="cpu").abs().sum()) == 0.0
    assert sp.constant(0.5, (3,), device="cpu").shape == (3, 75)


def test_dispersion_flag_and_params():
    """``mat_dispersion`` is a parameter where the scene disperses only."""
    b = SceneBuilder()
    b.sphere((0, 0, -3), 1.0, b.dielectric(1.5))
    plain = b.build("cpu")
    assert not plain.has_dispersion
    assert "mat_dispersion" not in diff.scene_params(plain)
    prism, _ = catalog.dispersion_prism(width=8, spp=1, max_depth=2, device="cpu")
    assert prism.has_dispersion
    assert "mat_dispersion" in diff.scene_params(prism, geometry=False)
    assert "mat_dispersion" in diff.NONNEG_PARAMS


@pytest.mark.parametrize("rng", ["fast", "threefry"])
def test_wavefront_matches_scan(monkeypatch, rng):
    """Each lane's hero wavelength is the scan's draw for its path, through
    the refill (a pool of 96 lanes for 256 pixels)."""
    monkeypatch.setenv("CRT_RNG", rng)
    s, c = catalog.dispersion_prism(width=16, spp=4, max_depth=3, device="cpu")
    key = keys.key(7)
    scan = integrator.render_image(s, c, key)
    wave = (integrator.render_wavefront(s, c, key, 4, lanes=96) / 4).reshape(scan.shape)
    torch.testing.assert_close(wave, scan, **WAVEFRONT_TOL)


def test_dispersion_gradients_match_jax():
    js, jc = jcat.dispersion_prism(width=8, spp=2, max_depth=3)
    jkey = jax.random.key(0)
    target = jnp.zeros((jc.height, jc.width, 3))
    # unroll (1, 1): the same sampled streams (integrator.py's UNROLL note of
    # the JAX package), compiled in half the time
    j_loss, (j_gs, _) = jdiff.loss_and_grads(js, jc, jkey, target, spp=2,
                                             unroll=(1, 1))
    j_gs = convert.params_to_numpy(j_gs)
    scene = convert.scene_from_numpy(js, device="cpu")
    cam = convert.camera_from_numpy(jc, device="cpu")
    loss, (gs, _) = diff.loss_and_grads(
        scene, cam, convert.key_from_numpy(jax.random.key_data(jkey)),
        torch.zeros((cam.height, cam.width, 3)), 2)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert set(gs) == set(j_gs)
    g = gs["mat_dispersion"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    for name, grad in gs.items():
        np.testing.assert_allclose(grad.numpy(), j_gs[name], err_msg=name, **SCENE_TOL)
