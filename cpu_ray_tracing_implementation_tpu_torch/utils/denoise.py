"""Edge-avoiding à-trous wavelet denoiser, guided by AOVs.

Port of ``cpu_ray_tracing_implementation_tpu/utils/denoise.py`` (the
reference ships raw Monte-Carlo output only): the à-trous wavelet filter
with edge-stopping functions [Dammertz et al. 2010, "Edge-Avoiding
À-Trous Wavelet Transform for fast Global Illumination Filtering"].

Each iteration is 25 edge-clamped shifts of the whole [H,W,3] image with
elementwise weights, plain tensor code on the image's device: the JAX
package computes it in XLA, outside any Pallas kernel, so there is no
kernel to port. Eager PyTorch runs some 2,000 small kernels per call at
4 iterations.

Guidance comes from ``models/aov.py`` buffers:
- normal: cosine^sigma_normal edge-stop (SVGF's w_n)
- depth: relative-difference edge-stop (scale-free)
- colour: luminance-difference edge-stop, sigma halved per iteration so
  later (wider) taps only cross genuinely similar regions
- albedo: demodulated before filtering and re-applied after, so texture
  detail is preserved rather than smoothed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 1-D B3-spline taps; the 5x5 kernel is their outer product
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[y+dy, x+dx] with edge clamping, same [H,W,C] shape."""
    h, w = x.shape[0], x.shape[1]
    ady, adx = abs(dy), abs(dx)
    # replicate padding reads the last two dims of a [1,C,H,W] view
    xp = F.pad(x.permute(2, 0, 1)[None], (adx, adx, ady, ady), mode="replicate")
    xp = xp[0].permute(1, 2, 0)
    return xp[ady + dy:ady + dy + h, adx + dx:adx + dx + w]


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return (0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2])[..., None]


def _local_std(luma: torch.Tensor) -> torch.Tensor:
    """3x3 box-window standard deviation of luminance: the per-pixel noise
    estimate that scales the colour edge-stop (the role SVGF's filtered
    variance buffer plays)."""
    s = torch.zeros_like(luma)
    s2 = torch.zeros_like(luma)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = _shift(luma, dy, dx)
            s = s + q
            s2 = s2 + q * q
    mu = s / 9.0
    return torch.sqrt(torch.clamp(s2 / 9.0 - mu * mu, min=0.0))


def _despike(img: torch.Tensor) -> torch.Tensor:
    """Firefly suppression: a pixel whose luminance exceeds its 8
    neighbours' mean + 3 std collapses to the neighbour level (its colour
    direction kept). Isolated bright speckles otherwise widen their own
    colour gate and ride through every iteration."""
    luma = _luminance(img)
    s = torch.zeros_like(luma)
    s2 = torch.zeros_like(luma)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            q = _shift(luma, dy, dx)
            s = s + q
            s2 = s2 + q * q
    mu = s / 8.0
    sd = torch.sqrt(torch.clamp(s2 / 8.0 - mu * mu, min=0.0))
    spike = luma > mu + 3.0 * sd + 1e-4
    scale = torch.where(spike, (mu + sd) / torch.clamp(luma, min=1e-8),
                        torch.ones_like(luma))
    return torch.where(spike, img * scale, img)


@torch.no_grad()
def denoise(img: torch.Tensor, aovs: dict, *, iterations: int = 4,
            sigma_color: float = 3.0, sigma_normal: float = 64.0,
            sigma_depth: float = 0.15, despike: bool = True) -> torch.Tensor:
    """Denoised [H,W,3] linear-radiance image (``denoise.py:89-146`` of the
    JAX package).

    ``img``: the beauty render (``integrator.render_image``); ``aovs``: the
    dict of ``aov.render_aovs`` on the same scene and camera, its tensors
    on ``img``'s device. ``sigma_color`` is in units of the local noise
    level (3x3 luminance std), so the colour gate is wide where the
    estimator is noisy and tight where it has converged."""
    normal = aovs["normal"]
    depth = aovs["depth"]
    coverage = aovs["coverage"]

    # demodulate albedo (uncovered pixels, pure background, keep raw
    # radiance: their albedo buffer is 0)
    alb = torch.where(coverage > 0.5, torch.clamp(aovs["albedo"], min=0.02),
                      torch.ones_like(aovs["albedo"]))
    out = img / alb
    if despike:
        out = _despike(out)

    for i in range(iterations):
        step = 1 << i
        luma = _luminance(out)
        gate = (sigma_color / (1 << i)) * (_local_std(luma) + 1e-3)
        acc = torch.zeros_like(out)
        wsum = torch.zeros_like(luma)
        for ky, wy in zip((-2, -1, 0, 1, 2), _B3):
            for kx, wx in zip((-2, -1, 0, 1, 2), _B3):
                dy, dx = ky * step, kx * step
                q = _shift(out, dy, dx)
                n_q = _shift(normal, dy, dx)
                z_q = _shift(depth, dy, dx)
                c_q = _shift(coverage, dy, dx)
                l_q = _shift(luma, dy, dx)

                w_n = torch.clamp(torch.sum(normal * n_q, -1, keepdim=True),
                                  min=0.0) ** sigma_normal
                # uncovered pixels carry a zero normal; background-to-
                # background pairs must still average (the colour gate rules)
                w_n = torch.clamp(w_n + (1.0 - coverage) * (1.0 - c_q), max=1.0)
                # scale-free relative depth difference; hit/miss pairs get
                # near-zero weight through coverage below
                dz = torch.abs(depth - z_q) / (torch.maximum(depth, z_q) + 1e-4)
                w_z = torch.exp(-(dz / sigma_depth) ** 2)
                w_c = torch.exp(-((luma - l_q) / gate) ** 2)
                w_cov = torch.exp(-8.0 * torch.abs(coverage - c_q))
                w = (wy * wx) * w_n * w_z * w_c * w_cov
                acc = acc + w * q
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)

    return out * alb
