"""Adaptive sampling: per-pixel variance-driven sample allocation.

Port of ``cpu_ray_tracing_implementation_tpu/models/adaptive.py`` (the
reference renders a fixed spp everywhere, src/camera.h:163-171): pixels
sample in fixed-size rounds until their 95% per-channel confidence
interval falls under a relative tolerance, and converged pixels stop
paying. The sample budget concentrates where the estimator is noisy.

Each round renders the unconverged pixel ids through the scan's
``integrator.accumulate_samples_subset``. Every sample's RNG is keyed by
(pixel id, absolute sample index), so a pixel's samples are the same
whichever round it lands in; the image's sums continue one float32
running sum per pixel on the device, so at ``rel_tol=0`` the adaptive
render is bitwise the uniform ``max_spp`` render. The host keeps float64
accumulators for the stopping rule, as the JAX package does (a float64
copy of each running sum, and the float64 sum of the rounds' sums of
squares): each round ends in one copy of its [k,3] sums to the host, the
round's only synchronisation. Over a mesh (``parallel/mesh.py``) each
round's ids are split over the ranks and the ranks' sums and moments
gathered onto every rank (``parallel/collectives.map_pixels``), so each
makes the same host decision and the result is bitwise the single-device
render. The JAX package pads each round's id count to a power of two to bound its jit shapes; eager PyTorch has no shapes to
bound, so the port does not pad.

The stopping rule carries the usual adaptive-sampling caveat: stopping on
a sample-dependent statistic adds a vanishing, O(1/n) bias, which
``min_spp`` bounds [Purgathofer 1987-style confidence-interval
termination].
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.parallel.collectives import map_pixels


def _round(scene, camera, key, ids, offset, step, accum, mesh):
    """(running sums, sums of squares) [k,3] of one round over ``ids``;
    over a mesh each rank renders its share and the shares are gathered."""
    out = map_pixels(mesh, ids, lambda ids, accum: torch.stack(
        integrator.accumulate_samples_subset(
            scene, camera, key, ids, offset, step,
            batch_pixels=integrator.scan_batch_pixels(scene), accum=accum,
            moments=True), dim=1), accum)
    return out[:, 0], out[:, 1]


def render_image_adaptive(scene, camera, key: np.ndarray, *, rel_tol: float = 0.05,
                          min_spp: int = 8, max_spp: int | None = None,
                          chunk_spp: int = 8, zero_var_spp: int = 32,
                          return_spp_map: bool = False, mesh=None):
    """Adaptive render: the [H,W,3] image on the scene's device (and, with
    ``return_spp_map``, the [H,W] int64 numpy map of samples per pixel).

    A pixel stops once every channel's 95% CI half-width of the mean is
    below ``rel_tol * (mean + 0.05)`` (the +0.05 keeps near-black pixels
    from demanding unbounded precision). ``rel_tol=0`` never stops a pixel:
    the result is bitwise the uniform ``max_spp`` render.

    ``zero_var_spp``: a pixel whose samples are all zero so far has a zero
    CI that proves nothing (a dark indirect-only corner looks like true
    black until one path lands), so it may not stop before this count; a
    pixel of nonzero constant value (a directly seen emitter) has truly
    converged and is exempt. ``mesh`` (``parallel.mesh.Mesh``): each
    round's unconverged ids shard over its ranks, every rank calling with
    the same arguments; bitwise the single-device render, spp map
    included."""
    max_spp = camera.spp if max_spp is None else max_spp
    min_spp = min(min_spp, max_spp)
    n_pix = camera.width * camera.height
    dev = scene.device

    total = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    sum_rgb = np.zeros((n_pix, 3), np.float64)
    sum_rgb2 = np.zeros((n_pix, 3), np.float64)
    counts = np.zeros((n_pix,), np.int64)

    active = np.arange(n_pix, dtype=np.int32)
    done_spp = 0
    while done_spp < max_spp and active.size:
        step = int(min(chunk_spp, max_spp - done_spp))
        ids = torch.from_numpy(active).to(dev)
        rows = ids.long()
        run, sq = _round(scene, camera, key, ids, done_spp, step, total[rows], mesh)
        total[rows] = run
        host = torch.stack([run, sq]).cpu().numpy().astype(np.float64)
        sum_rgb[active] = host[0]
        sum_rgb2[active] += host[1]
        counts[active] += step
        done_spp += step

        if done_spp >= min_spp and rel_tol > 0.0 and done_spp < max_spp:
            n = counts[active].astype(np.float64)[:, None]
            mean = sum_rgb[active] / n                    # [k,3]
            var = np.maximum(sum_rgb2[active] / n - mean * mean, 0.0)
            var *= n / np.maximum(n - 1.0, 1.0)           # Bessel correction
            ci = 1.96 * np.sqrt(var / n)
            # a pixel stops only when every channel's CI is inside
            unconverged = (ci > rel_tol * (mean + 0.05)).any(axis=1)
            unsettled = ((sum_rgb[active].sum(axis=1) == 0.0)
                         & (n[:, 0] < zero_var_spp))
            active = active[unconverged | unsettled]

    spp_per_pixel = torch.from_numpy(counts.astype(np.float32)).to(dev)
    img = (total / torch.clamp(spp_per_pixel, min=1.0)[:, None]).reshape(
        camera.height, camera.width, 3)
    if return_spp_map:
        return img, counts.reshape(camera.height, camera.width)
    return img
