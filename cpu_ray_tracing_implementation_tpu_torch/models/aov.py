"""Arbitrary output variables (AOVs): first-hit feature buffers.

Port of ``cpu_ray_tracing_implementation_tpu/models/aov.py`` (the
reference renders beauty only, src/camera.h:146-171): one extra pass
records, per pixel, the first camera hit's features averaged over spp:

- ``normal``   [H,W,3] mean face-forward shading normal (re-normalized)
- ``albedo``   [H,W,3] mean base colour (the hit material's texture)
- ``depth``    [H,W,1] mean hit distance t (0 where nothing was hit)
- ``coverage`` [H,W,1] fraction of samples that hit anything

They guide the edge-avoiding denoiser (``utils/denoise.py``). Raygen draws
the beauty pass's per-(pixel, sample) uniforms (``integrator.render_sample``)
under each stream, ``fast``, ``CRT_RNG=threefry`` and ``camera.qmc``, so
the buffers are anti-aliased by the same camera jitter, defocus and
motion-time draws as the beauty image. On the card the first hits go
through the same kernels as the render's first bounce.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import qmc
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture


def _first_hit(scene, camera, key, pixel_ids, sample_idx, qmc_words=None):
    """One sample's first-hit (normal, albedo, depth, coverage), drawing
    ``render_sample``'s raygen and bounce-0 uniforms (so volume boundaries
    are sampled with the beauty pass's stream); ``qmc_words``: the session
    words of a ``camera.qmc`` render (``aov.py:35-86`` of the JAX
    package)."""
    nslot = mat_ops.NSLOT + scene.n_volumes
    k_cam, k_path = keys.split(key)
    if camera.qmc:
        u_cam = qmc.uniforms(qmc_words, pixel_ids, sample_idx, 0, qmc.CAM_GROUP,
                             qmc.CAM_DIM)
        groups, dims, _ = qmc.bounce_layout(nslot)
        u = qmc.uniforms(qmc_words, pixel_ids, sample_idx, qmc.N_CAM_GROUPS,
                         groups, dims)
    else:
        u_cam = integrator._per_ray_uniforms(k_cam, pixel_ids, cam_mod.N_CAM_SLOTS)
        u_cam = cam_mod.stratify_pixel_jitter(camera, u_cam, sample_idx)
        u = integrator._per_ray_uniforms(keys.fold_in(k_path, 0), pixel_ids, nslot)
    org, dirs, time = cam_mod.generate_rays(camera, pixel_ids, u_cam)
    if scene.world_offset is not None:
        org = org - scene.world_offset[None, :]
    hit = isect.intersect_brute(scene, org, dirs, time, integrator.T_MIN,
                                u[:, mat_ops.SLOT_VOLUME0:],
                                active=torch.ones_like(pixel_ids, dtype=torch.bool))
    albedo = eval_texture(scene, tbl.take_rows(scene.materials.tex, hit.mat),
                          hit.u, hit.v, hit.p)
    v = hit.valid
    zero = torch.zeros_like(hit.t)
    return (torch.where(v[:, None], hit.normal, torch.zeros_like(hit.normal)),
            torch.where(v[:, None], albedo, torch.zeros_like(albedo)),
            torch.where(v, hit.t, zero), v.to(torch.float32))


@torch.no_grad()
def render_aovs(scene, camera, key, spp: int | None = None) -> dict:
    """Feature buffers dict of [H,W,C] tensors on the scene's device,
    averaged over ``spp`` camera samples (``aov.py:89-110`` of the JAX
    package): the normal, albedo and depth over the samples that hit,
    coverage over all."""
    spp = camera.spp if spp is None else spp
    n_pix = camera.width * camera.height
    dev = scene.device
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=dev)
    qmc_words = qmc.seed_words(key) if camera.qmc else None
    n = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    a = torch.zeros_like(n)
    d = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    c = torch.zeros_like(d)
    for s in range(spp):
        n_s, a_s, d_s, c_s = _first_hit(scene, camera, keys.fold_in(key, s),
                                        pixel_ids, s, qmc_words=qmc_words)
        n, a, d, c = n + n_s, a + a_s, d + d_s, c + c_s
    denom = torch.clamp(c, min=1.0)
    normal = vm.normalize(n / denom[:, None])
    normal = torch.where((c > 0)[:, None], normal, torch.zeros_like(normal))
    h, w = camera.height, camera.width
    return {"normal": normal.reshape(h, w, 3),
            "albedo": (a / denom[:, None]).reshape(h, w, 3),
            "depth": (d / denom).reshape(h, w, 1),
            "coverage": (c / spp).reshape(h, w, 1)}
