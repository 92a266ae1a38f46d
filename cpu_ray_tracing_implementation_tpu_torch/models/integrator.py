"""Path-tracing integrators: the classic per-sample scan and the
path-regeneration wavefront.

Port of ``cpu_ray_tracing_implementation_tpu/models/integrator.py:44-825``.
The recursive ``camera::ray_color`` (src/camera.h:193-241) becomes a loop
over bounces carrying (origin, direction, time, throughput, radiance,
alive) for a whole ray batch; material branching is masked-lane selects
(``ops/materials.py``). The scan renders one sample of every pixel (or of
a pixel batch, ``scan_batch_pixels``) at a time; the wavefront keeps a
pool of lanes full, refilling a lane with the next (pixel, sample) path as
soon as its path ends (``render_wavefront``).

Randomness is the JAX package's, bit for bit: the session key is folded
per sample, split into camera and path keys, and folded per bounce on the
host (``ops/keys.py``). In the default ``fast`` stream each fold's two seed
words drive the counter hash of ``ops/fastrng.py`` keyed by pixel id and
slot; under ``CRT_RNG=threefry`` (read where the stream is drawn, as the
JAX package reads it where it traces) each lane folds the key by its pixel id
and draws ``jax.random.uniform``'s numbers from its own key
(``keys.fold_in_lanes``, ``keys.uniform``). Under ``camera.qmc`` the
camera and bounce uniforms come from the Owen-scrambled Sobol sequence of
``ops/qmc.py`` at the sample's index, its scrambles seeded by the base
key's words, never a per-sample fold.

Gradients: every step is differentiable, and the intersector is a
parameter (``isect_fn``): ``intersect_brute`` by default, the winner replay
(``ops/replay.py``) on the gradient path. ``models/diff.py`` renders each
sample twice, once to record the winners and once, with autograd on, to
replay them: the per-sample recompute that the JAX package gets from
``jax.checkpoint`` saving only the winner ids (``integrator.py:391-415``).

Opt-in estimator features of the camera, in both integrators and on the
gradient path: Russian roulette (``camera.rr_depth``, its uniforms from a
second fold of the path key, ``0x5252``) and next-event estimation
(``camera.nee``: a shadow ray to a sampled light at every diffuse vertex,
through the same intersector, and the power-heuristic weight ``emis_w``
carried from vertex to vertex; where the environment is a light, a shadow
ray that escapes collects the background).

Spectral dispersion (``Scene.has_dispersion``): every (pixel, sample) path
draws a hero wavelength from ``fold_in(key, 0x5ec7)`` of its sample key,
dielectrics refract at its Cauchy-shifted IOR, and the path's radiance is
weighted by the normalized wavelength response (``ops/spectrum.py``); the
wavefront carries each lane's wavelength through the refill.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import fastrng
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import qmc
from cpu_ray_tracing_implementation_tpu_torch.ops import replay
from cpu_ray_tracing_implementation_tpu_torch.ops import spectrum
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

T_MIN = 1e-3  # shadow-acne bias, interval(0.001, inf) (src/camera.h:198)
# the fold of the path key that seeds the Russian-roulette stream, leaving
# every slot stream untouched (``integrator.py:228-231`` of the JAX package)
RR_FOLD = 0x5252
# the Weyl shift that gives the shadow ray volume uniforms of its own
SHADOW_U_SHIFT = 0.61803398875
# the fold of the sample key that seeds the hero-wavelength stream
# (``integrator.py:320-329`` of the JAX package)
WL_FOLD = 0x5EC7


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


def _rng_impl() -> str:
    """The path-sampling stream, ``CRT_RNG``: "fast" (the default, the
    counter hash of ``ops/fastrng.py``) or "threefry" (per-lane
    ``jax.random`` folds, ``integrator.py:59-67`` of the JAX package)."""
    return os.environ.get("CRT_RNG", "fast")


def _per_ray_uniforms(key: np.ndarray, ray_ids: torch.Tensor, nslot: int) -> torch.Tensor:
    """[R, nslot] uniforms keyed by ray id, so invariant to how the batch is
    split. ``fast``: two seed words from ``key`` (``jax.random.bits(key,
    (2,), uint32)``) hashed with (ray id, slot); ``threefry``:
    ``jax.random.uniform(fold_in(key, id), (nslot,))`` per ray."""
    if _rng_impl() == "fast":
        w = keys.bits2(key)
        return fastrng.uniforms(w[0], w[1], ray_ids, nslot)
    return keys.uniform(keys.fold_in_lanes(key, ray_ids), nslot)


def _wavelength(u: torch.Tensor) -> torch.Tensor:
    """Hero wavelength (nm) of a uniform: U(WAVELENGTH_MIN, WAVELENGTH_MAX)."""
    return (spectrum.WAVELENGTH_MIN
            + u * (spectrum.WAVELENGTH_MAX - spectrum.WAVELENGTH_MIN))


def _shade_step(scene, org, dirs, time, throughput, radiance, alive, u,
                isect_fn=None, rr_u=None, emis_w=None, nee_shadow=True,
                ior_shift=None):
    """One path segment for every lane: intersect, add miss-background and
    emission, scatter (estimator: src/camera.h:193-241;
    ``integrator.py:86-182`` of the JAX package). ``isect_fn``: the
    intersector (the signature of ``intersect_brute``, which None picks).

    ``rr_u``: [R] uniforms enabling Russian roulette for this segment
    (lanes with rr_u < 0 exempt): survivors of p = clamp(max channel of the
    throughput, 0.05, 1) rescale by 1/p. ``emis_w``: [R] carried
    power-heuristic weight, which turns on next-event estimation: emission
    and background met by the path are weighted by it, a shadow ray
    collects direct light, and the next segment's weight is returned too.
    ``nee_shadow``: a bool or [R] bool tensor; the final segment skips the
    shadow ray (it would collect light one vertex past the depth budget), a
    Python False skips its intersection altogether; where the environment
    is a light, a shadow ray that hits nothing collects the background.
    ``ior_shift``: [R] Cauchy term of each path's hero wavelength (None:
    the RGB render)."""
    nee = emis_w is not None
    isect_fn = isect.intersect_brute if isect_fn is None else isect_fn
    u_vol = u[:, mat_ops.SLOT_VOLUME0:]
    with trace.span("crt.intersect"):
        hit = isect_fn(scene, org, dirs, time, T_MIN, u_vol, active=alive)

    # miss -> background, lane terminates
    with trace.span("crt.background"):
        bg = background_color(scene, dirs)
    if nee:
        bg = bg * emis_w[:, None]
    miss = (alive & ~hit.valid)[:, None]
    radiance = radiance + torch.where(miss, throughput * bg,
                                      torch.zeros_like(bg))

    # emission at the hit (front-face diffuse_light); the material rows and
    # texture are shared with the scatter path
    lit = alive & hit.valid
    with trace.span("crt.mat_rows"):
        pre = mat_ops.mat_rows(scene, hit)
    with trace.span("crt.emitted"):
        emit = mat_ops.emitted(scene, hit, pre=pre)
    if nee:
        emit = emit * emis_w[:, None]
    radiance = radiance + torch.where(lit[:, None], throughput * emit,
                                      torch.zeros_like(emit))

    if nee:
        with trace.span("crt.scatter"):
            (new_dir, weight, continues, emis_w_next, nee_dir,
             nee_w) = mat_ops.scatter_nee(scene, hit, dirs, u, ior_shift, pre=pre)
        if scene.has_lights and nee_shadow is not False:
            # the shadow ray: occluders are non-emissive, so the emission of
            # its nearest hit is visibility x L_e; a volume on the way
            # scatters it with the analytic probability (a Weyl-shifted
            # uniform of its own), an unbiased transmittance estimate
            sh_active = lit & nee_shadow
            u_vol_sh = torch.remainder(u_vol + SHADOW_U_SHIFT, 1.0)
            with trace.span("crt.intersect"):
                sh = isect_fn(scene, hit.p, nee_dir, time, T_MIN, u_vol_sh,
                              active=sh_active)
            with trace.span("crt.emitted"):
                sh_le = mat_ops.emitted(scene, sh)
            if scene.has_env_light:
                with trace.span("crt.background"):
                    sh_bg = background_color(scene, nee_dir)
                sh_le = sh_le + torch.where(sh.valid[:, None], torch.zeros_like(sh_le),
                                            sh_bg)
            radiance = radiance + torch.where(sh_active[:, None],
                                              throughput * nee_w * sh_le,
                                              torch.zeros_like(sh_le))
    else:
        with trace.span("crt.scatter"):
            new_dir, weight, continues = mat_ops.scatter(scene, hit, dirs, u, ior_shift,
                                                         pre=pre)
    alive = lit & continues
    throughput = torch.where(alive[:, None], throughput * weight,
                             torch.zeros_like(weight))
    if rr_u is not None:
        apply = rr_u >= 0.0
        p = torch.where(apply, torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0),
                        torch.ones_like(rr_u))
        survive = rr_u < p
        throughput = torch.where((alive & survive)[:, None], throughput / p[:, None],
                                 torch.zeros_like(throughput))
        alive = alive & survive
    org = torch.where(alive[:, None], hit.p, org)
    dirs = torch.where(alive[:, None], new_dir, dirs)
    if nee:
        return org, dirs, time, throughput, radiance, alive, emis_w_next
    return org, dirs, time, throughput, radiance, alive


def render_rays(scene, org, dirs, time, key: np.ndarray, max_depth: int,
                ray_ids=None, isect_fn=None, rr_depth: int = 0,
                nee: bool = False, wavelength=None, qmc_words=None,
                sample_idx=None) -> torch.Tensor:
    """Radiance [R,3] for a batch of rays. ``ray_ids``: per-ray ids keying
    the RNG (defaults to batch position); ``isect_fn``: see _shade_step.
    ``rr_depth``: Russian roulette from that bounce on (0 = off), its
    uniforms ``_per_ray_uniforms(fold_in(fold_in(key, RR_FOLD), bounce))``;
    ``nee``: next-event estimation (the last bounce's shadow ray is
    skipped, and so is its intersection). ``wavelength``: [R] hero
    wavelengths (nm) of a dispersive scene: dielectrics refract at the
    Cauchy-shifted IOR and the radiance is weighted by
    ``spectrum.spectral_path_weight``. ``qmc_words`` (with ``sample_idx``):
    the bounce uniforms come from ``qmc.uniforms`` at that sample index."""
    n_rays = org.shape[0]
    nslot = mat_ops.NSLOT + scene.n_volumes
    if ray_ids is None:
        ray_ids = torch.arange(n_rays, dtype=torch.int32, device=org.device)
    if scene.world_offset is not None:
        # recentered scene: trace in the shifted frame
        org = org - scene.world_offset[None, :]
    ior_shift = None if wavelength is None else spectrum.cauchy_ior_shift(wavelength)
    if qmc_words is not None:
        groups, dims, n_groups = qmc.bounce_layout(nslot)
    throughput = torch.ones((n_rays, 3), dtype=org.dtype, device=org.device)
    radiance = torch.zeros((n_rays, 3), dtype=org.dtype, device=org.device)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=org.device)
    emis_w = (torch.ones((n_rays,), dtype=torch.float32, device=org.device)
              if nee else None)
    k_rr = keys.fold_in(key, RR_FOLD) if rr_depth else None
    for bounce in range(max_depth):
        with trace.span("crt.bounce"):
            with trace.span("crt.uniforms"):
                if qmc_words is not None:
                    u = qmc.uniforms(qmc_words, ray_ids, sample_idx,
                                     qmc.N_CAM_GROUPS + bounce * n_groups, groups, dims)
                else:
                    u = _per_ray_uniforms(keys.fold_in(key, bounce), ray_ids, nslot)
                # below rr_depth every lane is exempt (p = 1, a no-op), so no draw
                rr_u = (_per_ray_uniforms(keys.fold_in(k_rr, bounce), ray_ids, 1)[:, 0]
                        if rr_depth and bounce >= rr_depth else None)
            out = _shade_step(scene, org, dirs, time, throughput, radiance, alive, u,
                              isect_fn, rr_u=rr_u, emis_w=emis_w,
                              nee_shadow=bounce < max_depth - 1, ior_shift=ior_shift)
        org, dirs, time, throughput, radiance, alive = out[:6]
        if nee:
            emis_w = out[6]
    if wavelength is not None:
        # radiance is linear in the initial throughput: weighting it after
        # the bounces equals starting the path at that weight
        radiance = radiance * spectrum.spectral_path_weight(wavelength)
    return radiance


def render_sample(scene, camera, key: np.ndarray, pixel_ids: torch.Tensor,
                  sample_idx=None, isect_fn=None, qmc_words=None) -> torch.Tensor:
    """One sample of every pixel in ``pixel_ids``: raygen + integrate.
    Randomness is keyed by pixel id, so any partition of the pixel set
    gives identical samples. ``qmc_words``: the session words
    (``qmc.seed_words`` of the render's base key, not of this sample's key)
    that ``camera.qmc`` needs, with ``sample_idx``."""
    k_cam, k_path = keys.split(key)
    if camera.qmc and (qmc_words is None or sample_idx is None):
        raise ValueError("a camera.qmc render needs qmc_words and "
                         "sample_idx (qmc.seed_words of the base key)")
    with trace.span("crt.raygen"):
        if camera.qmc:
            # the Sobol jitter is stratified already; stratify's grid would
            # break the (0,2) progression, so it is skipped
            u_cam = qmc.uniforms(qmc_words, pixel_ids, sample_idx, 0,
                                 qmc.CAM_GROUP, qmc.CAM_DIM)
        else:
            u_cam = _per_ray_uniforms(k_cam, pixel_ids, cam_mod.N_CAM_SLOTS)
            u_cam = cam_mod.stratify_pixel_jitter(camera, u_cam, sample_idx)
        org, dirs, time = cam_mod.generate_rays(camera, pixel_ids, u_cam)
    wavelength = None
    if scene.has_dispersion:
        # a fold of its own keeps the RGB render's streams untouched
        wavelength = _wavelength(_per_ray_uniforms(keys.fold_in(key, WL_FOLD),
                                                   pixel_ids, 1)[:, 0])
    rad = render_rays(scene, org, dirs, time, k_path, camera.max_depth,
                      ray_ids=pixel_ids, isect_fn=isect_fn,
                      rr_depth=camera.rr_depth, nee=camera.nee,
                      wavelength=wavelength,
                      qmc_words=qmc_words if camera.qmc else None,
                      sample_idx=sample_idx)
    if camera.clamp > 0.0:
        rad = torch.clamp(rad, max=camera.clamp)  # firefly clamp
    return rad


def _perray_routed(scene) -> bool:
    """True when ``intersect_brute`` routes some table of this scene to the
    per-ray visit-list accelerator (``ops/perray.py``), the batch-coupled
    route the pool and batch sizes below are chosen for: ``CRT_ACCEL=ray``,
    or ``auto`` with a table of at least ``RAY_MIN_CHUNKS`` chunks
    (``integrator.py:472-482`` of the JAX package). Packet-routed scenes
    (sphereflake, the 16 px colonnade) keep the whole frame, as there."""
    mode = isect.accel_mode()
    n_chunks = max(isect._chunk_counts(scene), default=0)
    return mode == "ray" or (mode == "auto" and n_chunks >= isect.RAY_MIN_CHUNKS)


# The automatic pixel batch of the scan and lane pool of the wavefront on
# per-ray-routed scenes (None: the whole frame, a lane per pixel): the
# faster setting on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, each
# setting warmed up and timed twice in turns). The colonnade, 200x200, 30
# spp, depth 5: the scan 5.949 and 7.806 s in batches of 8,192 pixels,
# 1.729 and 1.858 s whole; the wavefront 5.415 and 5.695 s at 8,192 lanes,
# 1.102 and 1.377 s at 40,000. Sphereflake, 400x400, 50 spp, depth 5: the
# scan 30.4 and 42.3 s in batches of 8,192 pixels; the wavefront 8.781
# and 10.979 s at 8,192 lanes, 0.499 and 0.833 s at 160,000. Every batch
# or loop iteration pays a fixed host cost of some 500 kernel launches and
# a synchronisation per selection phase, which the whole frame amortises.
AUTO_SCAN_TILE = None
AUTO_WF_LANES = None


def scan_batch_pixels(scene) -> int | None:
    """Automatic pixel batch of the classic scan (None: the whole frame).
    On per-ray-routed scenes every selection phase runs until the worst ray
    of the batch is done, so a batch couples its rays; which size is faster
    depends on the device, and ``AUTO_SCAN_TILE`` records the card's
    choice. Dense scenes keep the whole frame. Override:
    ``CRT_SCAN_TILE=<n|full>`` (``integrator.py:351-364`` of the JAX
    package)."""
    v = os.environ.get("CRT_SCAN_TILE")
    if v:
        return None if v == "full" else int(v)
    return AUTO_SCAN_TILE if _perray_routed(scene) else None


def wavefront_lanes(scene, L: int, cap: int | None = None) -> int | None:
    """Automatic lane pool of the wavefront for ``L`` pixels (None: one
    lane per pixel). As for the scan's batch, a per-ray-routed pool is
    batch-coupled; ``AUTO_WF_LANES`` records the card's choice. The pool
    size changes no path's radiance, only the order of the flushes into
    the image. Override: ``CRT_WF_LANES=<n|full>`` (``integrator.py:485-504``
    of the JAX package). ``cap``: at most that many lanes (the CLI's
    ``--tile-pixels``)."""
    v = os.environ.get("CRT_WF_LANES")
    if v:
        lanes = None if v == "full" else min(int(v), L)
    elif AUTO_WF_LANES is None or not _perray_routed(scene):
        lanes = None
    else:
        lanes = min(AUTO_WF_LANES, L)
    return min(int(cap), lanes or L) if cap else lanes


def accumulate_samples_subset(scene, camera, key: np.ndarray,
                              pixel_ids: torch.Tensor, sample_offset: int,
                              spp: int, isect_fn=None,
                              batch_pixels: int | None = None,
                              accum: torch.Tensor | None = None,
                              moments: bool = False):
    """Radiance SUM [N,3] over samples [sample_offset, sample_offset+spp)
    for a pixel-id subset. The sample index keys the RNG, so any partition
    of the sample range accumulates to the same image.

    ``batch_pixels`` (see ``scan_batch_pixels``): render the subset in
    batches of that many pixels (the last one shorter). The RNG is keyed by
    pixel id and each pixel sums its samples in the same order, so the
    result is bitwise the unbatched one. ``accum`` [N,3]: a running sum to
    continue, so that calls over consecutive sample ranges sum bitwise as
    one call over their union does. ``moments``: return (sum, sum of
    squares [N,3]) instead, the second moments per channel that adaptive
    sampling's stopping rule reads (``adaptive.py:44-67`` of the JAX
    package)."""
    n = pixel_ids.shape[0]
    step = n if not batch_pixels or batch_pixels >= n else int(batch_pixels)
    sample_keys = [keys.fold_in(key, sample_offset + s) for s in range(spp)]
    qmc_words = qmc.seed_words(key) if camera.qmc else None
    sums, squares = [], []
    for start in range(0, n, max(step, 1)):
        ids = pixel_ids[start:start + step]
        total = (torch.zeros((ids.shape[0], 3), dtype=torch.float32,
                             device=pixel_ids.device)
                 if accum is None else accum[start:start + step])
        sq = torch.zeros_like(total) if moments else None
        for s, k in enumerate(sample_keys):
            with trace.span("crt.sample"):
                rad = render_sample(scene, camera, k, ids, sample_idx=sample_offset + s,
                                    isect_fn=isect_fn, qmc_words=qmc_words)
            total = total + rad
            if moments:
                sq = sq + rad * rad
        sums.append(total)
        squares.append(sq)
    total = sums[0] if len(sums) == 1 else torch.cat(sums)
    if not moments:
        return total
    return total, squares[0] if len(squares) == 1 else torch.cat(squares)


def accumulate_samples(scene, camera, key: np.ndarray, sample_offset: int,
                       spp: int, isect_fn=None,
                       batch_pixels: int | None = None) -> torch.Tensor:
    """Radiance SUM [H*W,3] of every pixel over samples [sample_offset,
    sample_offset+spp) (``integrator.py:447-464`` of the JAX package)."""
    pixel_ids = torch.arange(camera.width * camera.height, dtype=torch.int32,
                             device=scene.device)
    return accumulate_samples_subset(scene, camera, key, pixel_ids,
                                     sample_offset, spp, isect_fn=isect_fn,
                                     batch_pixels=batch_pixels)


def render_image(scene, camera, key: np.ndarray, spp: int | None = None,
                 replay_isect: bool = False) -> torch.Tensor:
    """Full image [H,W,3] (linear radiance, pre-gamma) on the scene's
    device, through the classic scan in the automatic pixel batches
    (``scan_batch_pixels``). ``key``: [2] uint32 key words
    (``ops/keys.key(seed)``, or ``utils/convert.key_from_numpy`` of a JAX
    key). ``replay_isect``: the gradient path's intersection
    (``ops/replay.py``), dense tables only."""
    spp = camera.spp if spp is None else spp
    with trace.entry("crt.render"):
        accum = accumulate_samples(
            scene, camera, key, 0, spp,
            isect_fn=replay.intersect_replay if replay_isect else None,
            batch_pixels=scan_batch_pixels(scene))
        return (accum / spp).reshape(camera.height, camera.width, 3)


def render_image_tiled(scene, camera, key: np.ndarray, spp: int | None = None,
                       tile_pixels: int = 1 << 18) -> torch.Tensor:
    """``render_image`` in scan tiles of ``tile_pixels`` pixels, the last
    one shorter (``integrator.py:828-852`` of the JAX package, which pads
    it to bound its jit shapes; eager PyTorch does not need to): bitwise
    the untiled render for any tile, the device holding one tile's lanes
    at a time."""
    spp = camera.spp if spp is None else spp
    with trace.entry("crt.render"):
        accum = accumulate_samples(scene, camera, key, 0, spp, batch_pixels=tile_pixels)
        return (accum / spp).reshape(camera.height, camera.width, 3)


# ------------------------------------------------------------ wavefront
# renders through render_wavefront and the loop iterations they ran,
# summed over renders (the loop's condition is one host synchronisation
# per iteration; the per-ray accelerator adds one per selection phase,
# counted in ``perray.PHASES``)
WAVEFRONT = {"renders": 0, "iterations": 0}


def reset_wavefront() -> None:
    WAVEFRONT["renders"] = 0
    WAVEFRONT["iterations"] = 0


def wavefront_keys(key: np.ndarray, spp: int, max_depth: int,
                   sample_offset: int = 0, rr: bool = False) -> dict:
    """The keys that samples [sample_offset, sample_offset+spp) of the scan
    fold its lanes' streams from, built on the host, uint32 numpy arrays:
    ``cam`` [spp, 2], ``split(fold_in(key, s))[0]``; ``path`` [spp,
    max_depth, 2], ``fold_in(split(fold_in(key, s))[1], b)``; ``wl`` [spp,
    2], ``fold_in(fold_in(key, s), WL_FOLD)``; with ``rr``, ``rr`` [spp,
    max_depth, 2], ``fold_in(fold_in(split(fold_in(key, s))[1], RR_FOLD),
    b)`` (``integrator.py:567-633`` of the JAX package)."""
    out = {"cam": np.zeros((spp, 2), np.uint32),
           "path": np.zeros((spp, max_depth, 2), np.uint32),
           "wl": np.zeros((spp, 2), np.uint32)}
    if rr:
        out["rr"] = np.zeros((spp, max_depth, 2), np.uint32)
    for s in range(spp):
        k_s = keys.fold_in(key, sample_offset + s)
        k_cam, k_path = keys.split(k_s)
        out["cam"][s] = k_cam
        out["wl"][s] = keys.fold_in(k_s, WL_FOLD)
        for b in range(max_depth):
            out["path"][s, b] = keys.fold_in(k_path, b)
        if rr:
            k_rr = keys.fold_in(k_path, RR_FOLD)
            for b in range(max_depth):
                out["rr"][s, b] = keys.fold_in(k_rr, b)
    return out


def _bits_table(table: np.ndarray) -> np.ndarray:
    """``bits2`` of every key of a [..., 2] key table: the ``fast`` stream's
    seed words."""
    flat = table.reshape(-1, 2)
    return np.stack([keys.bits2(k) for k in flat]).reshape(table.shape)


@torch.no_grad()
def render_wavefront(scene, camera, key: np.ndarray, spp: int,
                     pixel_ids: torch.Tensor | None = None,
                     lanes: int | None = None,
                     sample_offset: int = 0) -> torch.Tensor:
    """Path-regeneration wavefront: radiance SUM [L,3] over samples
    [sample_offset, sample_offset+spp) of the L pixels of ``pixel_ids``
    (global pixel ids, in their order; None: the whole frame).

    A pool of ``lanes`` lanes (None: L) stays full: when a path ends, its
    lane adds its radiance to the image and starts the next unissued
    (pixel, sample) path, so the work is the number of path segments
    actually traced, not spp x max_depth per pixel. Every path draws the
    scan's uniforms keyed by its global pixel id, from host tables of the
    keys the scan folds (``wavefront_keys``: their seed words in the
    ``fast`` stream, the keys themselves under ``CRT_RNG=threefry``, the
    base key's words under ``camera.qmc``), so each path's radiance is
    bitwise the scan's; only the order in which a pixel's samples are
    summed differs (the flush is an ``index_add_``, atomic on the card),
    so the image is allclose to the scan's, not bitwise, whatever the pool
    size.

    The loop runs on the host until no lane is alive: one synchronisation
    per iteration (``WAVEFRONT`` counts them). Forward only, under
    ``torch.no_grad``: gradients take the scan (``models/diff.py``), as in
    the JAX package (``integrator.py:507-770``).

    Under ``camera.nee`` each lane carries its power-heuristic weight
    (reset to 1 on refill) and skips the shadow ray on its own last bounce;
    under ``camera.rr_depth`` each lane draws the scan's roulette uniform;
    on a dispersive scene each lane carries its path's hero wavelength,
    drawn again at every refill (``spawn_wavelength``)."""
    dev = scene.device
    L = camera.width * camera.height if pixel_ids is None else int(pixel_ids.shape[0])
    total = L * spp
    R = L if lanes is None else max(1, min(int(lanes), total))
    max_depth = camera.max_depth
    nslot = mat_ops.NSLOT + scene.n_volumes
    nee, rr_depth = camera.nee, camera.rr_depth
    dispersive = scene.has_dispersion
    use_qmc = camera.qmc
    fast = _rng_impl() == "fast"
    tables = wavefront_keys(key, spp, max_depth, sample_offset, rr=bool(rr_depth))
    # the fast stream's lanes hash with their table row's seed words; the
    # threefry stream's fold their row's key by their pixel id
    dev_tables = {name: torch.as_tensor(
        (_bits_table(t) if fast else t).astype(np.int64).reshape(-1, 2), device=dev)
        for name, t in tables.items()}
    if use_qmc:
        q_words = qmc.seed_words(key)
        qb_groups, qb_dims, qb_ngroups = qmc.bounce_layout(nslot)

    def draw(name, row, pix, n):
        """[R, n] uniforms of each lane from row ``row`` of a table."""
        t = dev_tables[name][row]
        if fast:
            return fastrng.uniforms(t[:, 0], t[:, 1], pix, n)
        return keys.uniform(keys.fold_in_lanes(t, pix), n)

    def gpix(lane):
        return lane if pixel_ids is None else pixel_ids[lane.long()]

    def sample_of(path_id):
        return torch.clamp(torch.div(path_id, L, rounding_mode="floor"), 0, spp - 1)

    def spawn(path_id):
        """Camera rays of the given paths; a path id >= total is a lane
        with nothing left to render (inactive)."""
        pix = gpix(torch.remainder(path_id, L))
        if use_qmc:
            u_cam = qmc.uniforms(q_words, pix, sample_offset + sample_of(path_id),
                                 0, qmc.CAM_GROUP, qmc.CAM_DIM)
        else:
            u_cam = draw("cam", sample_of(path_id).long(), pix, cam_mod.N_CAM_SLOTS)
            u_cam = cam_mod.stratify_pixel_jitter(
                camera, u_cam,
                sample_offset + torch.div(path_id, L, rounding_mode="floor"))
        org, dirs, time = cam_mod.generate_rays(camera, pix, u_cam)
        if scene.world_offset is not None:
            org = org - scene.world_offset[None, :]
        return org, dirs, time, path_id < total

    def spawn_wavelength(path_id):
        """Each lane's hero wavelength, the scan's draw for its path."""
        pix = gpix(torch.remainder(path_id, L))
        return _wavelength(draw("wl", sample_of(path_id).long(), pix, 1)[:, 0])

    path_id = torch.arange(R, dtype=torch.int32, device=dev)
    bounce = torch.zeros((R,), dtype=torch.int32, device=dev)
    with trace.span("crt.raygen"):
        org, dirs, time, alive = spawn(path_id)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    issued = torch.tensor(R, dtype=torch.int32, device=dev)
    image = torch.zeros((L, 3), dtype=torch.float32, device=dev)
    emis_w = torch.ones((R,), dtype=torch.float32, device=dev) if nee else None
    wl = spawn_wavelength(path_id) if dispersive else None
    iterations = 0
    while bool(alive.any()):
        with trace.span("crt.iteration"):
            iterations += 1
            lane = torch.remainder(path_id, L)
            pix = gpix(lane)
            b = torch.clamp(bounce, 0, max_depth - 1)
            row = (sample_of(path_id) * max_depth + b).long()
            with trace.span("crt.uniforms"):
                if use_qmc:
                    u = qmc.uniforms(q_words, pix, sample_offset + sample_of(path_id),
                                     qmc.N_CAM_GROUPS + b * qb_ngroups, qb_groups,
                                     qb_dims)
                else:
                    u = draw("path", row, pix, nslot)
                rr_u = None
                if rr_depth:
                    rr_u = torch.where(bounce >= rr_depth, draw("rr", row, pix, 1)[:, 0],
                                       torch.full((R,), -1.0, device=dev))
            out = _shade_step(scene, org, dirs, time, throughput, radiance, alive, u,
                              rr_u=rr_u, emis_w=emis_w,
                              nee_shadow=bounce < max_depth - 1,
                              ior_shift=spectrum.cauchy_ior_shift(wl) if dispersive else None)
            org, dirs, time, throughput, radiance, alive2 = out[:6]
            bounce = bounce + 1
            alive2 = alive2 & (bounce < max_depth)

            done = alive & ~alive2              # the path just ended
            flush = radiance
            if dispersive:
                # the scan's weighting: radiance is linear in the initial throughput
                flush = radiance * spectrum.spectral_path_weight(wl)
            if camera.clamp > 0.0:
                flush = torch.clamp(flush, max=camera.clamp)  # firefly clamp
            image.index_add_(0, lane.long(),
                             torch.where(done[:, None], flush, torch.zeros_like(flush)))

            # refill the finished lanes with the next unissued paths, in order
            done_i = done.to(torch.int32)
            new_id = issued + torch.cumsum(done_i, 0, dtype=torch.int32) - 1
            take = done & (new_id < total)
            path_id = torch.where(take, new_id,
                                  torch.where(done, torch.full_like(path_id, total),
                                              path_id))
            issued = issued + done_i.sum(dtype=torch.int32)

            with trace.span("crt.raygen"):
                s_org, s_dirs, s_time, s_active = spawn(path_id)
            fresh = done[:, None]
            org = torch.where(fresh, s_org, org)
            dirs = torch.where(fresh, s_dirs, dirs)
            time = torch.where(done, s_time, time)
            throughput = torch.where(fresh, torch.ones_like(throughput), throughput)
            radiance = torch.where(fresh, torch.zeros_like(radiance), radiance)
            bounce = torch.where(done, torch.zeros_like(bounce), bounce)
            alive = torch.where(done, s_active, alive2)
            if dispersive:
                wl = torch.where(done, spawn_wavelength(path_id), wl)
            if nee:
                emis_w = torch.where(done, torch.ones_like(out[6]), out[6])
    WAVEFRONT["renders"] += 1
    WAVEFRONT["iterations"] += iterations
    return image


def render_image_wavefront(scene, camera, key: np.ndarray, spp: int | None = None,
                           tile_pixels: int | None = None) -> torch.Tensor:
    """Full image [H,W,3] through the wavefront, at the automatic lane pool
    (``wavefront_lanes``). ``tile_pixels``: render the frame in tiles of
    that many pixels, each its own wavefront (the last tile padded with
    pixel 0, whose rows are discarded); every path's radiance is the
    untiled render's, only the flush order differs
    (``integrator.py:772-805`` of the JAX package)."""
    spp = camera.spp if spp is None else spp
    n_pix = camera.width * camera.height
    with trace.entry("crt.render"):
        if tile_pixels is None or tile_pixels >= n_pix:
            accum = render_wavefront(scene, camera, key, spp,
                                     lanes=wavefront_lanes(scene, n_pix))
            return (accum / spp).reshape(camera.height, camera.width, 3)
        tile = int(tile_pixels)
        out = []
        for start in range(0, n_pix, tile):
            n_real = min(tile, n_pix - start)
            ids = torch.zeros((tile,), dtype=torch.int32, device=scene.device)
            ids[:n_real] = torch.arange(start, start + n_real, dtype=torch.int32,
                                        device=scene.device)
            acc = render_wavefront(scene, camera, key, spp, pixel_ids=ids,
                                   lanes=wavefront_lanes(scene, tile))
            out.append(acc[:n_real])
        return (torch.cat(out) / spp).reshape(camera.height, camera.width, 3)
