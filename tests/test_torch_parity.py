"""The C++ reference parity gates of tests/test_parity.py, held by the port.

Same scenes, workloads, downsample grid and gates (PSNR and mean relative
error against the checked-in box-downsampled reference images). The port
renders on the CPU here; chip_smoke.py runs the same gates on the card.
"""

import os

import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, film, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys

DATA = os.path.join(os.path.dirname(__file__), "data")

# scene -> (width, spp, downsample factor, min PSNR dB, max mean rel err);
# the values of tests/test_parity.py CASES
CASES = {
    "cornell_box": (300, 16, 4, 30.0, 0.04),
    "three_material_ball": (320, 16, 4, 38.0, 0.02),
}


def _downsample(img: np.ndarray, f: int) -> np.ndarray:
    h, w = (img.shape[0] // f) * f, (img.shape[1] // f) * f
    return img[:h, :w].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_parity(name):
    width, spp, f, min_psnr, max_mean_rel = CASES[name]
    ref_ds = np.load(os.path.join(DATA, f"parity_{name}.npz"))["ref_ds"].astype(np.float64)
    scene, cam = catalog.SCENES[name](width=width, spp=spp, device="cpu")
    img = integrator.render_image(scene, cam, keys.key(0))
    ours = np.clip(film.linear_to_gamma(img).numpy(), 0.0, 1.0)
    a = _downsample(ours, f)
    assert a.shape == ref_ds.shape, (a.shape, ref_ds.shape)
    mse = float(np.mean((a - ref_ds) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    mean_rel = abs(ours.mean() - ref_ds.mean()) / ref_ds.mean()
    assert psnr > min_psnr, f"{name}: PSNR {psnr:.2f} dB < {min_psnr}"
    assert mean_rel < max_mean_rel, f"{name}: mean rel err {mean_rel:.4f}"
