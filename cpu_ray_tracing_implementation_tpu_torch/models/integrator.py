"""Path-tracing integrator: the classic per-sample scan.

Port of ``cpu_ray_tracing_implementation_tpu/models/integrator.py:44-463,
807-825``. The recursive ``camera::ray_color`` (src/camera.h:193-241)
becomes a loop over bounces carrying (origin, direction, time, throughput,
radiance, alive) for a whole ray batch; material branching is masked-lane
selects (``ops/materials.py``).

Randomness is the JAX package's ``fast`` stream, bit for bit: the session
key is folded per sample, split into camera and path keys, and folded per
bounce on the host (``ops/keys.py``); each fold's two seed words drive the
counter hash of ``ops/fastrng.py`` keyed by pixel id and slot.

Gradients: every step is differentiable, and the intersector is a
parameter (``isect_fn``): ``intersect_brute`` by default, the winner replay
(``ops/replay.py``) on the gradient path. ``models/diff.py`` renders each
sample twice, once to record the winners and once, with autograd on, to
replay them: the per-sample recompute that the JAX package gets from
``jax.checkpoint`` saving only the winner ids (``integrator.py:391-415``).

Not ported yet: QMC, Russian roulette, next-event estimation, spectral
dispersion, pixel batching, and the wavefront (ROADMAP M6, M10, M12).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import fastrng
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import replay
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture

T_MIN = 1e-3  # shadow-acne bias, interval(0.001, inf) (src/camera.h:198)


def background_color(scene, dirs: torch.Tensor) -> torch.Tensor:
    """Environment lookup on miss (src/camera.h:180-190), as a direct
    direction -> equirect UV transform."""
    if scene.background < 0:
        return torch.zeros_like(dirs)
    unit_d = vm.normalize(dirs)
    u, v = isect.sphere_uv(unit_d)
    tex_id = torch.full(u.shape, scene.background, dtype=torch.int32,
                        device=dirs.device)
    return eval_texture(scene, tex_id, u, v, unit_d)


def _per_ray_uniforms(key: np.ndarray, ray_ids: torch.Tensor, nslot: int) -> torch.Tensor:
    """[R, nslot] uniforms of the ``fast`` stream: two seed words from
    ``key`` (``jax.random.bits(key, (2,), uint32)``) hashed with (ray id,
    slot). Keyed by ray id, so invariant to how the batch is split."""
    w = keys.bits2(key)
    return fastrng.uniforms(w[0], w[1], ray_ids, nslot)


def _shade_step(scene, org, dirs, time, throughput, radiance, alive, u,
                isect_fn=None):
    """One path segment for every lane: intersect, add miss-background and
    emission, scatter (estimator: src/camera.h:193-241). ``isect_fn``: the
    intersector (the signature of ``intersect_brute``, which None picks)."""
    isect_fn = isect.intersect_brute if isect_fn is None else isect_fn
    hit = isect_fn(scene, org, dirs, time, T_MIN, u[:, mat_ops.SLOT_VOLUME0:],
                   active=alive)

    # miss -> background, lane terminates
    bg = background_color(scene, dirs)
    miss = (alive & ~hit.valid)[:, None]
    radiance = radiance + torch.where(miss, throughput * bg,
                                      torch.zeros_like(bg))

    # emission at the hit (front-face diffuse_light); the material rows and
    # texture are shared with the scatter path
    lit = alive & hit.valid
    pre = mat_ops.mat_rows(scene, hit)
    emit = mat_ops.emitted(scene, hit, pre=pre)
    radiance = radiance + torch.where(lit[:, None], throughput * emit,
                                      torch.zeros_like(emit))

    new_dir, weight, continues = mat_ops.scatter(scene, hit, dirs, u, pre=pre)
    alive = lit & continues
    throughput = torch.where(alive[:, None], throughput * weight,
                             torch.zeros_like(weight))
    org = torch.where(alive[:, None], hit.p, org)
    dirs = torch.where(alive[:, None], new_dir, dirs)
    return org, dirs, time, throughput, radiance, alive


def render_rays(scene, org, dirs, time, key: np.ndarray, max_depth: int,
                ray_ids=None, isect_fn=None) -> torch.Tensor:
    """Radiance [R,3] for a batch of rays. ``ray_ids``: per-ray ids keying
    the RNG (defaults to batch position); ``isect_fn``: see _shade_step."""
    n_rays = org.shape[0]
    nslot = mat_ops.NSLOT + scene.n_volumes
    if ray_ids is None:
        ray_ids = torch.arange(n_rays, dtype=torch.int32, device=org.device)
    if scene.world_offset is not None:
        # recentered scene: trace in the shifted frame
        org = org - scene.world_offset[None, :]
    throughput = torch.ones((n_rays, 3), dtype=org.dtype, device=org.device)
    radiance = torch.zeros((n_rays, 3), dtype=org.dtype, device=org.device)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=org.device)
    for bounce in range(max_depth):
        u = _per_ray_uniforms(keys.fold_in(key, bounce), ray_ids, nslot)
        org, dirs, time, throughput, radiance, alive = _shade_step(
            scene, org, dirs, time, throughput, radiance, alive, u, isect_fn)
    return radiance


def render_sample(scene, camera, key: np.ndarray, pixel_ids: torch.Tensor,
                  sample_idx=None, isect_fn=None) -> torch.Tensor:
    """One sample of every pixel in ``pixel_ids``: raygen + integrate.
    Randomness is keyed by pixel id, so any partition of the pixel set
    gives identical samples."""
    k_cam, k_path = keys.split(key)
    u_cam = _per_ray_uniforms(k_cam, pixel_ids, cam_mod.N_CAM_SLOTS)
    u_cam = cam_mod.stratify_pixel_jitter(camera, u_cam, sample_idx)
    org, dirs, time = cam_mod.generate_rays(camera, pixel_ids, u_cam)
    rad = render_rays(scene, org, dirs, time, k_path, camera.max_depth,
                      ray_ids=pixel_ids, isect_fn=isect_fn)
    if camera.clamp > 0.0:
        rad = torch.clamp(rad, max=camera.clamp)  # firefly clamp
    return rad


def accumulate_samples_subset(scene, camera, key: np.ndarray,
                              pixel_ids: torch.Tensor, sample_offset: int,
                              spp: int, isect_fn=None) -> torch.Tensor:
    """Radiance SUM [N,3] over samples [sample_offset, sample_offset+spp)
    for a pixel-id subset. The sample index keys the RNG, so any partition
    of the sample range accumulates to the same image."""
    accum = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=pixel_ids.device)
    for s in range(spp):
        s_abs = sample_offset + s
        accum = accum + render_sample(scene, camera, keys.fold_in(key, s_abs),
                                      pixel_ids, sample_idx=s_abs,
                                      isect_fn=isect_fn)
    return accum


def render_image(scene, camera, key: np.ndarray, spp: int | None = None,
                 replay_isect: bool = False) -> torch.Tensor:
    """Full image [H,W,3] (linear radiance, pre-gamma) on the scene's
    device. ``key``: [2] uint32 key words (``ops/keys.key(seed)``, or
    ``utils/convert.key_from_numpy`` of a JAX key). ``replay_isect``: the
    gradient path's intersection (``ops/replay.py``), dense tables only."""
    spp = camera.spp if spp is None else spp
    n_pix = camera.width * camera.height
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=scene.device)
    accum = accumulate_samples_subset(
        scene, camera, key, pixel_ids, 0, spp,
        isect_fn=replay.intersect_replay if replay_isect else None)
    return (accum / spp).reshape(camera.height, camera.width, 3)
