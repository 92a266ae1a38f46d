"""Spectral power distributions, the wavelength -> RGB map, and the
hero-wavelength dispersion terms.

Port of ``cpu_ray_tracing_implementation_tpu/ops/spectrum.py`` (reference
src/spectrum.h): 75 bins over 380-750 nm at 5 nm steps, the piecewise
linear wavelength -> RGB map (src/spectrum.h:140-200) and the
intensity-weighted spectrum -> RGB integration (src/spectrum.h:202-231) as
one product against a [NUM_BINS, 3] basis built on the host.

The live use is the hero-wavelength render mode (``Scene.has_dispersion``):
each (pixel, sample) path carries one wavelength drawn uniformly from
[WAVELENGTH_MIN, WAVELENGTH_MAX], dielectrics refract at a Cauchy-shifted
IOR (``cauchy_ior_shift``), and the path's RGB radiance is weighted by the
normalized wavelength response (``spectral_path_weight``).

``wavelength_to_rgb`` rounds ``255 * (seg * factor) ** 0.8`` in float32 at
a continuous wavelength, as the JAX package does; a last-ulp difference of
``pow`` between XLA and torch can flip a byte at a ``.5`` boundary (at most
1/255 of one channel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE

WAVELENGTH_MIN = 380
WAVELENGTH_MAX = 750
WAVELENGTH_STEP = 5
NUM_BINS = (WAVELENGTH_MAX - WAVELENGTH_MIN) // WAVELENGTH_STEP + 1  # 75
GAMMA = 0.80  # display gamma of the wavelength map (src/spectrum.h:138)

WAVELENGTHS = np.arange(WAVELENGTH_MIN, WAVELENGTH_MAX + 1, WAVELENGTH_STEP,
                        dtype=np.float64)


def zeros(batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    """All-zero SPD (src/spectrum.h:43-47)."""
    return torch.zeros((*batch_shape, NUM_BINS), dtype=torch.float32, device=device)


def constant(v: float, batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.full((*batch_shape, NUM_BINS), float(v), dtype=torch.float32,
                      device=device)


def _bin(wavelength: float) -> int:
    return int((wavelength - WAVELENGTH_MIN) / WAVELENGTH_STEP)


def line(wavelength: float, intensity: float, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Single-line SPD (src/spectrum.h:51-56): ``intensity`` in the bin
    holding ``wavelength`` (no rounding, as in the reference)."""
    spd = zeros(device=device)
    spd[_bin(wavelength)] = intensity
    return spd


def add_line(spd: torch.Tensor, wavelength: float, intensity: float) -> torch.Tensor:
    """spectrum::add (src/spectrum.h:58-62), out of place."""
    out = spd.clone()
    out[..., _bin(wavelength)] += intensity
    return out


def _wavelength_to_rgb_scalar(wl: float) -> np.ndarray:
    """Host mirror of wavelengthToRGB (src/spectrum.h:140-200): byte-scale
    RGB of one wavelength, in float64."""
    if wl < 380.0 or wl > 780.0:
        return np.zeros(3)
    r = g = b = 0.0
    if 380 <= wl < 440:
        r, g, b = -(wl - 440) / 60.0, 0.0, 1.0
    elif 440 <= wl < 490:
        r, g, b = 0.0, (wl - 440) / 50.0, 1.0
    elif 490 <= wl < 510:
        r, g, b = 0.0, 1.0, -(wl - 510) / 20.0
    elif 510 <= wl < 580:
        r, g, b = (wl - 510) / 70.0, 1.0, 0.0
    elif 580 <= wl < 645:
        r, g, b = 1.0, -(wl - 645) / 65.0, 0.0
    elif 645 <= wl < 780:
        r, g, b = 1.0, 0.0, 0.0
    if 380 <= wl < 420:
        factor = 0.3 + 0.7 * (wl - 380) / 40.0
    elif 420 <= wl < 701:
        factor = 1.0
    elif 701 <= wl < 781:
        factor = 0.3 + 0.7 * (780 - wl) / 80.0
    else:
        factor = 0.0

    def chan(c):
        return 0.0 if c == 0.0 else round(255 * (c * factor) ** GAMMA)

    return np.array([chan(r), chan(g), chan(b)], np.float64)


# [NUM_BINS, 3] byte-scale RGB basis, built once on the host
RGB_BASIS = np.stack(
    [_wavelength_to_rgb_scalar(w) for w in WAVELENGTHS]).astype(np.float32)


def wavelength_to_rgb(wavelength) -> torch.Tensor:
    """Byte-scale [..., 3] of the piecewise map (src/spectrum.h:140-200) at
    float32 wavelengths (``spectrum.py:98-122`` of the JAX package)."""
    wl = torch.as_tensor(wavelength, dtype=torch.float32)
    zero = torch.zeros_like(wl)
    one = torch.ones_like(wl)
    seg = torch.stack([
        torch.where((wl >= 380) & (wl < 440), -(wl - 440) / 60.0,
                    torch.where((wl >= 510) & (wl < 580), (wl - 510) / 70.0,
                                torch.where(wl >= 580, one, zero))),
        torch.where((wl >= 440) & (wl < 490), (wl - 440) / 50.0,
                    torch.where((wl >= 490) & (wl < 580), one,
                                torch.where((wl >= 580) & (wl < 645),
                                            -(wl - 645) / 65.0, zero))),
        torch.where(wl < 490, torch.where(wl >= 380, one, zero),
                    torch.where(wl < 510, -(wl - 510) / 20.0, zero)),
    ], dim=-1)
    seg = torch.where(((wl < 380) | (wl > 780))[..., None], torch.zeros_like(seg), seg)
    factor = torch.where((wl >= 380) & (wl < 420), 0.3 + 0.7 * (wl - 380) / 40.0,
                         torch.where((wl >= 420) & (wl < 701), one,
                                     torch.where((wl >= 701) & (wl < 781),
                                                 0.3 + 0.7 * (780 - wl) / 80.0, zero)))
    scaled = torch.round(255.0 * torch.pow(
        torch.clamp(seg * factor[..., None], min=0.0), GAMMA))
    return torch.where(seg == 0.0, torch.zeros_like(scaled), scaled)


@functools.lru_cache(maxsize=None)
def _on(name: str, device: torch.device) -> torch.Tensor:
    """A host table of this module on ``device``, copied there once (a copy
    from the host synchronises the card's stream)."""
    table = {"RGB_BASIS": RGB_BASIS, "SPECTRAL_WEIGHT_NORM": SPECTRAL_WEIGHT_NORM}[name]
    return torch.as_tensor(table, device=device)


def to_rgb(spd: torch.Tensor) -> torch.Tensor:
    """Intensity-weighted byte-scale RGB of an [..., NUM_BINS] SPD
    (spectrumToRGB, src/spectrum.h:202-231): one product against
    ``RGB_BASIS``, normalized by the total intensity."""
    total = torch.sum(spd, dim=-1, keepdim=True)
    rgb = spd @ _on("RGB_BASIS", spd.device)
    return torch.where(total > 0, rgb / torch.clamp(total, min=1e-20),
                       torch.zeros_like(rgb))


def to_linear_rgb(spd: torch.Tensor) -> torch.Tensor:
    """[0, 1]-scale ``to_rgb``."""
    return to_rgb(spd) / 255.0


# E over lambda ~ U(380, 750) of the linear RGB response, per channel: a
# path's weight divides by it, so a dispersion-free path stays white in
# expectation
SPECTRAL_WEIGHT_NORM = np.maximum(
    np.mean([_wavelength_to_rgb_scalar(w)
             for w in np.arange(WAVELENGTH_MIN, WAVELENGTH_MAX + 0.25, 0.5)],
            axis=0) / 255.0,
    1e-6).astype(np.float32)


def spectral_path_weight(wl: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB weight of a hero-wavelength path; its mean over uniform
    wavelengths is (1, 1, 1)."""
    return (wavelength_to_rgb(wl) / 255.0) / _on("SPECTRAL_WEIGHT_NORM", wl.device)


def cauchy_ior_shift(wl_nm: torch.Tensor) -> torch.Tensor:
    """1/lambda_um^2 - 1/0.589^2: times a material's Cauchy B, its IOR
    offset at ``wl_nm`` (zero at the 589 nm sodium line, where
    ``Materials.ior`` is given)."""
    lam_um = torch.as_tensor(wl_nm, dtype=torch.float32) * 1e-3
    return 1.0 / (lam_um * lam_um) - 1.0 / (0.589 * 0.589)
