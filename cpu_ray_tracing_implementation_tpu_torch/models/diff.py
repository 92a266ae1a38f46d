"""Differentiable rendering: parameters, loss and gradients, inverse rendering.

Port of ``cpu_ray_tracing_implementation_tpu/models/diff.py``. Radiance is
differentiable in the material and texture parameters (albedo and
emission, metal fuzz, dielectric IOR and, on a dispersive scene, its
Cauchy coefficient, gloss smoothness and specular probability), in the
geometry (sphere centers and radii, quad corners and
edges, triangle vertices) and in the camera (position, look-at, and the
parameters of its mode: ``camera_params``).

Estimator: detached sampling. Sampled directions come from explicit
uniforms, so they carry no parameter dependence; the throughput weights
do, and the discrete lobe picks carry a score-function weight
(``ops/materials.py``). Camera gradients flow through ray generation.
Visibility (silhouette) changes carry no gradient term.

``loss_and_grads`` renders twice (the port's counterpart of the JAX
package's per-sample ``jax.checkpoint``, which no PyTorch graph of a whole
render could hold: at 512x512, depth 8, one sample's graph is about a
gigabyte):

1. the forward pass, under ``torch.no_grad``, renders every sample and
   gives the image and the loss. On the winner-replay route each bounce's
   winner ids (4 bytes per lane) go onto a ``replay.Tape``;
2. the backward pass renders each sample again with autograd on, and
   ``torch.autograd.backward`` takes its share of d loss / d image (the
   image is the mean of the samples) before the next sample is drawn, so
   no graph spans two samples. On the replay route the winners are read
   back from the tape: the pass launches no closest-hit kernel. On the
   oracle route, and on chunked tables, the pass intersects again.

Both passes run the same operations on the same inputs, so the second
reproduces the first and the gradients are those of the first pass's loss.
The camera's estimator fields pass through as the render reads them
(``render_sample``): under ``camera.nee`` a bounce intersects twice, the
path's ray and then the shadow ray, and the tape keeps both winners in
that order; under ``camera.rr_depth`` the roulette's survival probability
depends on the throughput and is differentiated as the JAX package's is;
a volume winner replays its entry and scatter distance
(``replay._volume_t_one``). Under ``camera.qmc`` both passes draw from the
base key's session words (``qmc.seed_words``), and a dispersive scene's
hero wavelength comes from each sample's key, so the replayed sample is the
recorded one.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import bvh
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, qmc, replay
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

# Families that fit_scene projects onto [0, inf); geometry coordinates are
# free-sign.
NONNEG_PARAMS = frozenset({
    "tex_color0", "tex_color1", "mat_fuzz", "mat_ior", "mat_smoothness",
    "mat_spec_prob", "mat_dispersion", "geo_sph_rad",
})


def _use_replay(scene, replay_isect: bool | None = None) -> bool:
    """The winner-replay route (``ops/replay.py``): None picks it wherever it
    applies (dense tables) unless ``CRT_REPLAY=0`` (read per call, as
    ``diff.py:31-41`` of the JAX package reads it); False forces the
    remat-everything VJP oracle (the fused kernels' chunk-scan backward)."""
    if replay_isect is None:
        return os.environ.get("CRT_REPLAY", "1") != "0" and replay.supported(scene)
    if replay_isect and not replay.supported(scene):
        raise ValueError("the winner replay covers dense tables only; a "
                         "chunked scene replays inside its accelerator")
    return bool(replay_isect)


# ---------------------------------------------------------------- params
def scene_params(scene, geometry: bool = True) -> dict:
    """The differentiable leaves of a scene, as a flat dict of its tensors.

    ``geometry=False`` exposes the texture and material families only.
    ``mat_dispersion`` is there only when ``scene.has_dispersion``: on any
    other scene the render never reads the table, and its gradient would
    be zero. Geometry parameters (``geo_*``) are the dense tables of each family
    present; on a chunked scene ``apply_scene_params`` re-derives the chunk
    tables from them through the build's BVH order."""
    p = {
        "tex_color0": scene.textures.color0,
        "tex_color1": scene.textures.color1,
        "mat_fuzz": scene.materials.fuzz,
        "mat_ior": scene.materials.ior,
        "mat_smoothness": scene.materials.smoothness,
        "mat_spec_prob": scene.materials.spec_prob,
    }
    if scene.has_dispersion:
        p["mat_dispersion"] = scene.materials.dispersion
    if not geometry:
        return p
    n_sph, n_quad, n_tri, _ = scene.counts
    if n_sph:
        p["geo_sph_c0"] = scene.spheres.c0
        p["geo_sph_c1"] = scene.spheres.c1
        p["geo_sph_rad"] = scene.spheres.rad
    if n_quad:
        p["geo_quad_corner"] = scene.quads.corner
        p["geo_quad_eu"] = scene.quads.eu
        p["geo_quad_ev"] = scene.quads.ev
    if n_tri:
        p["geo_tri_v0"] = scene.tris.v0
        p["geo_tri_v1"] = scene.tris.v1
        p["geo_tri_v2"] = scene.tris.v2
    return p


def apply_scene_params(scene, params: dict):
    """``scene`` with the tables of ``params`` (``scene_params``' keys) in
    place; chunked tables are re-derived from the dense ones
    (``ops/chunked.rechunk_*``), so their gradients reach the dense rows,
    and each BVH tree's primitive rows are rebuilt from the re-derived
    chunks (the JAX package leaves them stale, ROADMAP F3), so the
    traversal oracle's forward and its chunk-scan backward see the same
    geometry."""
    replace = dataclasses.replace
    mats = replace(scene.materials, fuzz=params["mat_fuzz"],
                   ior=params["mat_ior"], smoothness=params["mat_smoothness"],
                   spec_prob=params["mat_spec_prob"])
    if "mat_dispersion" in params:
        mats = replace(mats, dispersion=params["mat_dispersion"])
    scene = scene.replace(
        textures=replace(scene.textures, color0=params["tex_color0"],
                         color1=params["tex_color1"]),
        materials=mats)
    if "geo_sph_c0" in params:
        c0, c1, rad = (params[k] for k in ("geo_sph_c0", "geo_sph_c1", "geo_sph_rad"))
        scene = scene.replace(spheres=replace(scene.spheres, c0=c0, c1=c1, rad=rad))
        if scene.sphere_chunks is not None:
            scene = scene.replace(sphere_chunks=ch.rechunk_sphere(
                scene.sphere_chunks, c0, c1, rad, scene.sphere_chunk_order))
            scene = _refresh_tree(scene, "sphere", fi.pack_sphere_constants)
    if "geo_quad_corner" in params:
        corner, eu, ev = (params[k] for k in ("geo_quad_corner", "geo_quad_eu",
                                              "geo_quad_ev"))
        scene = scene.replace(quads=replace(scene.quads, corner=corner, eu=eu, ev=ev))
        if scene.quad_chunks is not None:
            scene = scene.replace(quad_chunks=ch.rechunk_planar(
                scene.quad_chunks, corner, eu, ev, scene.quad_chunk_order))
            scene = _refresh_tree(scene, "quad", fi.pack_prim_constants)
    if "geo_tri_v0" in params:
        v0, v1, v2 = (params[k] for k in ("geo_tri_v0", "geo_tri_v1", "geo_tri_v2"))
        scene = scene.replace(tris=replace(scene.tris, v0=v0, v1=v1, v2=v2))
        if scene.tri_chunks is not None:
            # chunk rows hold (corner, eu, ev) = (v0, v1 - v0, v2 - v0), as
            # the build derives them
            scene = scene.replace(tri_chunks=ch.rechunk_planar(
                scene.tri_chunks, v0, v1 - v0, v2 - v0, scene.tri_chunk_order))
            scene = _refresh_tree(scene, "tri", fi.pack_prim_constants)
    return scene


def _refresh_tree(scene, fam: str, pack_fn):
    """``scene`` with its ``fam`` tree's primitive rows rebuilt from its
    (re-derived) ``fam`` chunks; no tree, no change."""
    tree = getattr(scene, f"{fam}_tree")
    if tree is None:
        return scene
    with torch.no_grad():
        pack = pack_fn(getattr(scene, f"{fam}_chunks"))
    return scene.replace(**{f"{fam}_tree": bvh.refresh_tree(tree, bvh.flatten_chunk_pack(pack))})


def camera_params(camera) -> dict:
    """The camera's differentiable leaves for its mode only
    (``diff.py:166-189`` of the JAX package): a parameter outside the
    mode's ray generation has a gradient of zero. Perspective and fisheye:
    field of view and focal length; orthographic: the viewport height;
    thin lens: field of view, defocus angle and focus distance (which takes
    the focal length's place in the viewport)."""
    p = {"pos": camera.pos, "lookat": camera.lookat}
    if camera.mode == cam_mod.ORTHOGRAPHIC:
        p["ortho_viewport_h"] = camera.ortho_viewport_h
    elif camera.mode == cam_mod.LENS:
        p["fovy_deg"] = camera.fovy_deg
        p["defocus_angle_deg"] = camera.defocus_angle_deg
        p["focus_dist"] = camera.focus_dist
    else:  # perspective, fisheye
        p["fovy_deg"] = camera.fovy_deg
        p["focal_length"] = camera.focal_length
    return p


def apply_camera_params(camera, params: dict):
    return camera.replace(**params)


# ---------------------------------------------------------------- losses
def image_loss(scene, camera, key: np.ndarray, target: torch.Tensor, spp: int,
               replay_isect: bool | None = None) -> torch.Tensor:
    """Mean squared pixel error of an spp-sample render against ``target``,
    through the same intersection as ``loss_and_grads`` (so its finite
    differences match that function's gradients)."""
    img = integrator.render_image(scene, camera, key, spp=spp,
                                  replay_isect=_use_replay(scene, replay_isect))
    return torch.mean((img - target) ** 2)


def _forward_pass(scene, camera, key, spp: int, tape, pixel_ids=None,
                  samples=None) -> torch.Tensor:
    """Pass 1: the [H,W,3] image under no_grad; ``tape`` (a
    ``replay.Tape`` or None) records each bounce's winners. A rank of a
    mesh (``parallel/mesh.py``) passes its ``pixel_ids`` [N] and its
    ``samples`` = (offset, count) and gets its [N,3] part of the image:
    the radiance sum of those samples over ``spp``. The defaults are the
    whole frame and samples [0, spp)."""
    with torch.no_grad(), trace.span("crt.forward"):
        ids = pixel_ids if pixel_ids is not None else torch.arange(
            camera.width * camera.height, dtype=torch.int32, device=scene.device)
        offset, count = samples or (0, spp)
        accum = integrator.accumulate_samples_subset(
            scene, camera, key, ids, offset, count,
            isect_fn=None if tape is None else tape.record)
        img = accum / spp
        return img if pixel_ids is not None else img.reshape(camera.height,
                                                             camera.width, 3)


def _backward_pass(scene, camera, key, spp: int, sp: dict, cp: dict,
                   grad_img: torch.Tensor, tape, pixel_ids=None, samples=None) -> None:
    """Pass 2: each sample rendered again from the parameter leaves ``sp``
    and ``cp`` with autograd on, its graph consumed by one backward (its
    share of ``grad_img``) before the next sample; ``tape`` plays the
    winners back (or None: intersect again). ``pixel_ids`` and
    ``samples`` as in ``_forward_pass``; ``grad_img`` is then [N,3]."""
    with trace.span("crt.backward"):
        if pixel_ids is None:
            pixel_ids = torch.arange(camera.width * camera.height, dtype=torch.int32,
                                     device=scene.device)
        offset, count = samples or (0, spp)
        grad_rad = (grad_img / spp).reshape(-1, 3)
        qmc_words = qmc.seed_words(key) if camera.qmc else None
        for s in range(offset, offset + count):
            with torch.enable_grad(), trace.span("crt.sample"):
                s_scene = apply_scene_params(scene, sp)
                s_cam = apply_camera_params(camera, cp)
                rad = integrator.render_sample(
                    s_scene, s_cam, keys.fold_in(key, s), pixel_ids, sample_idx=s,
                    isect_fn=None if tape is None else tape.play, qmc_words=qmc_words)
            with trace.span("crt.autograd"):
                torch.autograd.backward(rad, grad_rad)


def _value_and_grad(scene, camera, key, target, spp: int, rep: bool,
                    sp: dict, cp: dict) -> torch.Tensor:
    """The loss of the forward pass; the gradients accumulate into the
    ``.grad`` of the leaves in ``sp`` and ``cp``."""
    tape = replay.Tape() if rep else None
    with torch.no_grad():
        base = apply_scene_params(scene, sp)
        base_cam = apply_camera_params(camera, cp)
    img = _forward_pass(base, base_cam, key, spp, tape)
    diff = img - target
    loss = torch.mean(diff * diff)
    _backward_pass(scene, camera, key, spp, sp, cp, 2.0 * diff / diff.numel(),
                   tape)
    return loss


def _leaves(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def _grads(leaves: dict) -> dict:
    return {k: torch.zeros_like(v) if v.grad is None else v.grad
            for k, v in leaves.items()}


def loss_and_grads(scene, camera, key: np.ndarray, target: torch.Tensor,
                   spp: int, replay_isect: bool | None = None,
                   geometry: bool = True):
    """(loss, (scene_param_grads, camera_param_grads)) of the mean squared
    error of an spp-sample render against ``target``.

    ``geometry``: include the ``geo_*`` families (``scene_params``).
    ``replay_isect``: None = the winner replay where it applies, False =
    the remat-everything VJP oracle (``_use_replay``)."""
    with trace.entry("crt.grad_step"):
        rep = _use_replay(scene, replay_isect)
        sp = _leaves(scene_params(scene, geometry=geometry))
        cp = _leaves(camera_params(camera))
        loss = _value_and_grad(scene, camera, key, target, spp, rep, sp, cp)
        return loss, (_grads(sp), _grads(cp))


# ---------------------------------------------------------------- fitting
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


def _fit_fingerprint(params, lr, spp, seed, optimizer) -> str:
    """Config fingerprint guarding checkpoint resume: refusing a mismatched
    resume beats silently mixing two optimizations."""
    shapes = ",".join(f"{n}:{tuple(params[n].shape)}" for n in sorted(params))
    return f"{shapes}|lr={lr}|spp={spp}|seed={seed}|opt={optimizer}"


def _save_fit_state(path, fingerprint, step, params, opt_state, losses) -> None:
    arrays = {f"param_{n}": v.detach().cpu().numpy() for n, v in params.items()}
    for slot in ("mu", "nu"):
        arrays.update({f"{slot}_{n}": v.cpu().numpy()
                       for n, v in opt_state.get(slot, {}).items()})
    tmp = path + ".tmp"  # np.savez appends .npz to a name without it
    np.savez(tmp, __fingerprint=np.array(fingerprint), __step=np.array(step),
             __losses=np.asarray(losses, np.float64),
             __count=np.array(opt_state.get("count", 0)), **arrays)
    os.replace(tmp + ".npz", path)


def _load_fit_state(path, fingerprint, params, opt_state):
    """(step, params, opt_state, losses), or None when ``path`` is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["__fingerprint"]) != fingerprint:
            raise ValueError("fit checkpoint fingerprint mismatch: refusing to "
                             f"resume ({z['__fingerprint']} != {fingerprint})")

        def load(prefix, like):
            return {n: torch.as_tensor(z[f"{prefix}_{n}"], device=v.device)
                    for n, v in like.items()}

        params = load("param", params)
        if opt_state:
            opt_state = {"count": int(z["__count"]),
                         "mu": load("mu", opt_state["mu"]),
                         "nu": load("nu", opt_state["nu"])}
        return int(z["__step"]), params, opt_state, list(z["__losses"])


def _adam_update(g: dict, state: dict, lr: float):
    """optax.adam(lr) written out: (updates, new state)."""
    count = state["count"] + 1
    mu = {n: (1 - _ADAM_B1) * g[n] + _ADAM_B1 * state["mu"][n] for n in g}
    nu = {n: (1 - _ADAM_B2) * g[n] * g[n] + _ADAM_B2 * state["nu"][n] for n in g}
    c1 = 1 - _ADAM_B1 ** count
    c2 = 1 - _ADAM_B2 ** count
    updates = {n: -lr * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + _ADAM_EPS))
               for n in g}
    return updates, {"count": count, "mu": mu, "nu": nu}


def fit_scene(scene, camera, target, steps: int = 100, lr: float = 0.5,
              spp: int = 8, seed: int = 0, param_filter=None, grad_mask=None,
              log=None, optimizer: str = "sgd",
              checkpoint_path: str | None = None, checkpoint_every: int = 25):
    """Gradient-based inverse rendering on the scene parameters (the camera
    stays fixed).

    ``param_filter``: parameter names to optimize (the others frozen).
    ``grad_mask``: per-parameter multipliers broadcast against each
    gradient, for finer freezing. ``optimizer``: "sgd" or "adam" (optax's
    adam with its default betas and eps). ``checkpoint_path``: an atomic
    .npz of the fit state written every ``checkpoint_every`` steps; an
    existing file with a matching fingerprint resumes, and the RNG is keyed
    by the absolute step, so a resumed fit equals the uninterrupted one.
    Returns (fitted scene, losses)."""
    params = {n: v.detach().clone() for n, v in scene_params(scene).items()}
    names = set(params) if param_filter is None else set(param_filter)
    if optimizer == "adam":
        opt_state = {"count": 0, "mu": {n: torch.zeros_like(v) for n, v in params.items()},
                     "nu": {n: torch.zeros_like(v) for n, v in params.items()}}
    elif optimizer == "sgd":
        opt_state = {}
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    losses = []
    key = keys.key(seed)
    start = 0
    fp = _fit_fingerprint(params, lr, spp, seed, optimizer)
    if checkpoint_path:
        got = _load_fit_state(checkpoint_path, fp, params, opt_state)
        if got is not None:
            start, params, opt_state, losses = got
            if log:
                log(f"[fit] resumed at step {start}")

    rep = _use_replay(scene)
    mask = grad_mask or {}
    for i in range(start, steps):
        leaves = _leaves(params)
        loss = _value_and_grad(scene, camera, keys.fold_in(key, i), target, spp,
                               rep, leaves, {})
        losses.append(float(loss))
        g = _grads(leaves)
        g = {n: g[n] * mask.get(n, 1.0) if n in names else torch.zeros_like(g[n])
             for n in g}
        if optimizer == "adam":
            updates, opt_state = _adam_update(g, opt_state, lr)
            stepped = {n: params[n] + updates[n] for n in params}
        else:
            stepped = {n: params[n] - lr * g[n] for n in params}
        # frozen parameters skip the update and the projection; only the
        # NONNEG_PARAMS families are clipped (geometry is free-sign)
        params = {n: (torch.clamp(stepped[n], min=0.0) if n in NONNEG_PARAMS
                      else stepped[n]) if n in names else params[n]
                  for n in params}
        if log and i % 10 == 0:
            log(f"[fit] step {i}: loss {losses[-1]:.6f}")
        if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
            _save_fit_state(checkpoint_path, fp, i + 1, params, opt_state, losses)
    return apply_scene_params(scene, params), losses
