"""Multi-device rendering and gradients over ``torch.distributed``.

Port of ``cpu_ray_tracing_implementation_tpu/parallel/mesh.py``, the
counterpart of the reference's row-parallel fan-out (src/camera.h:158,
``std::for_each(std::execution::par_unseq)`` over rows). A mesh is a group
of processes, one rank each, that every function here is called in with
the same arguments (SPMD): each rank builds its own copy of the scene,
renders its share of the pixels (or of the samples), and the collectives
give every rank the same result, the full image or the loss and
gradients, as the JAX package's jit outputs do.

- Pixel sharding: the pixel ids are padded to a multiple of the rank count
  with pixel 0 and split into contiguous shares; each rank renders its
  share through the port's own ``integrator.accumulate_samples_subset`` or
  ``render_wavefront(pixel_ids=)``, and ``dist.all_gather`` assembles the
  image (the padded rows are dropped). Every sample's RNG is keyed by
  (pixel id, absolute sample index), so the scan's image is bitwise the
  single-device render's.
- Sample sharding (``render_image_spp_sharded``) splits the sample range
  and ``dist.all_reduce`` sums the partial radiance; the 2-D mesh
  (``make_mesh_2d``) does both, pixels over its ``tile`` axis and samples
  over its ``samp`` axis, each axis a subgroup of its own.
- Gradients keep ``models/diff.py``'s two passes: each rank runs the
  no-grad forward pass on its pixels and sample range, the partial images
  are all-reduced over ``samp``, each rank takes d loss / d image for its
  valid pixels and runs the per-sample backward with it; the loss and the
  parameter gradients are then all-reduced in one flat buffer. No
  collective is differentiated.

A mesh of one rank needs no process group: every collective is then
skipped and each function gives the single-device result. The backend is
the caller's (``dist.init_process_group``): NCCL with a card per rank,
gloo on the CPU, or gloo for ranks that share one card (NCCL refuses
that). The collectives (``parallel/collectives.py``) take card tensors
under either backend.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import replay
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import as_device
from cpu_ray_tracing_implementation_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, map_pixels, share)

AXIS = "chips"
TILE_AXIS = "tile"
SAMP_AXIS = "samp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a render is split over. ``group``: the process group of
    all of them (None: one rank and no group); ``rank`` and ``size``: this
    rank's index in it and its size; ``device``: this rank's device;
    ``shape`` over ``axis_names``: (size,) for the 1-D mesh, (tile, samp)
    for the 2-D one, whose ``tile_group`` holds the ranks of this rank's
    sample range and ``samp_group`` those of its pixel tile."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = (AXIS,)
    shape: tuple = (1,)
    tile_group: object = None
    samp_group: object = None

    @property
    def coords(self) -> tuple:
        """(tile index, samp index) of this rank on a 2-D mesh."""
        return divmod(self.rank, self.shape[1])


def _rank_device(rank: int, device) -> torch.device:
    """The named device, else rank r's card: ``cuda:(local_rank %
    device_count)``, the local rank from ``LOCAL_RANK`` (torchrun) or the
    rank itself. Without a card a mesh that names no device raises."""
    if device is not None:
        return as_device(device)
    if not torch.cuda.is_available():
        return as_device("cuda")  # raises, naming device="cpu"
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(group=None, device=None) -> Mesh:
    """1-D mesh over ``group`` (default: the initialized world; with no
    process group initialized, a mesh of this process alone)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, _rank_device(0, device))
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    return Mesh(group, rank, size, _rank_device(rank, device), (AXIS,), (size,))


def make_mesh_2d(shape=None, group=None, device=None) -> Mesh:
    """2-D (tile, samp) mesh: pixel tiles shard over ``tile``, the sample
    range over ``samp``. ``shape`` defaults to the most-square factoring
    with the larger factor on ``tile`` (pixel sharding needs no reduction;
    sample sharding pays one all-reduce). Rank r sits at (r // samp, r %
    samp). Every rank of the world calls this: each subgroup is made by
    ``dist.new_group``, which all ranks enter."""
    base = make_mesh(group, device)
    n = base.size
    if shape is None:
        t = int(np.sqrt(n))
        while n % t:
            t -= 1
        shape = (max(t, n // t), min(t, n // t))
    shape = tuple(int(s) for s in shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    mesh = dataclasses.replace(base, axis_names=(TILE_AXIS, SAMP_AXIS), shape=shape)
    if base.group is None:
        return mesh
    ranks = dist.get_process_group_ranks(base.group)
    backend = dist.get_backend(base.group)
    n_tile, n_samp = shape
    i, j = mesh.coords
    samp_group = tile_group = None
    for a in range(n_tile):   # the ranks of one pixel tile: its sample ranges
        g = dist.new_group([ranks[a * n_samp + b] for b in range(n_samp)], backend=backend)
        samp_group = g if a == i else samp_group
    for b in range(n_samp):   # the ranks of one sample range: the tiles
        g = dist.new_group([ranks[a * n_samp + b] for a in range(n_tile)], backend=backend)
        tile_group = g if b == j else tile_group
    return dataclasses.replace(mesh, tile_group=tile_group, samp_group=samp_group)


def _pixels(scene, camera) -> torch.Tensor:
    return torch.arange(camera.width * camera.height, dtype=torch.int32,
                        device=scene.device)


# ---------------------------------------------------------------- renders
def accumulate_samples_sharded(scene, camera, key: np.ndarray, sample_offset: int,
                               spp: int, mesh: Mesh,
                               batch_pixels: int | None = None) -> torch.Tensor:
    """Radiance SUM [H*W,3] over samples [sample_offset, sample_offset+spp),
    pixels sharded over the mesh: bitwise the single-device
    ``integrator.accumulate_samples`` (per-pixel streams and sample order
    do not depend on the shard). ``batch_pixels``: each rank's scan pixel
    batch (default ``integrator.scan_batch_pixels``). A sharded
    checkpoint's chunks shard the same way (``utils/checkpoint.py``)."""
    bp = batch_pixels or integrator.scan_batch_pixels(scene)
    return map_pixels(mesh, _pixels(scene, camera), lambda ids: (
        integrator.accumulate_samples_subset(scene, camera, key, ids, sample_offset,
                                             spp, batch_pixels=bp)))


def accumulate_wavefront_sharded(scene, camera, key: np.ndarray, sample_offset: int,
                                 spp: int, mesh: Mesh,
                                 lanes_cap: int | None = None) -> torch.Tensor:
    """Radiance SUM [H*W,3] over samples [sample_offset, sample_offset+spp)
    through one wavefront per rank over its pixel share (pool
    ``integrator.wavefront_lanes`` of the share, capped at ``lanes_cap``).
    Each path's radiance is the single-device wavefront's; a pixel's
    samples may be flushed in another order (ROADMAP F2), so the sum is
    allclose to the single-device one, not bitwise."""
    return map_pixels(mesh, _pixels(scene, camera), lambda ids: (
        integrator.render_wavefront(scene, camera, key, spp, pixel_ids=ids,
                                    lanes=integrator.wavefront_lanes(scene, ids.shape[0],
                                                                     lanes_cap),
                                    sample_offset=sample_offset)))


def render_image_sharded(scene, camera, key: np.ndarray, mesh: Mesh,
                         spp: int | None = None,
                         batch_pixels: int | None = None) -> torch.Tensor:
    """Full image [H,W,3], pixels sharded over the mesh, the scene on every
    rank: bitwise ``integrator.render_image``. ``batch_pixels``: each
    rank's scan pixel batch (the CLI's --tile-pixels)."""
    spp = camera.spp if spp is None else spp
    acc = accumulate_samples_sharded(scene, camera, key, 0, spp, mesh,
                                     batch_pixels=batch_pixels)
    return (acc / spp).reshape(camera.height, camera.width, 3)


def render_image_wavefront_sharded(scene, camera, key: np.ndarray, mesh: Mesh,
                                   spp: int | None = None,
                                   lanes_cap: int | None = None) -> torch.Tensor:
    """Full image [H,W,3] through the path-regeneration wavefront, pixels
    sharded over the mesh: each rank runs its own wavefront over its share
    (the reference's fan-out of its BVH render, src/camera.h:158), and the
    image assembles with one gather."""
    spp = camera.spp if spp is None else spp
    acc = accumulate_wavefront_sharded(scene, camera, key, 0, spp, mesh,
                                       lanes_cap=lanes_cap)
    return (acc / spp).reshape(camera.height, camera.width, 3)


def render_image_spp_sharded(scene, camera, key: np.ndarray, mesh: Mesh,
                             spp: int | None = None) -> torch.Tensor:
    """Full image; the sample axis sharded: each rank renders ceil(spp /
    size) samples of every pixel (the range padded to a multiple of the
    rank count, as the JAX package pads it) and the partial sums are
    all-reduced."""
    spp = camera.spp if spp is None else spp
    per = -(-spp // mesh.size)
    acc = integrator.accumulate_samples(scene, camera, key, mesh.rank * per, per,
                                        batch_pixels=integrator.scan_batch_pixels(scene))
    acc = all_reduce(acc, mesh.group)
    return (acc / (per * mesh.size)).reshape(camera.height, camera.width, 3)


def _check_2d(mesh: Mesh) -> tuple:
    if len(mesh.shape) != 2:
        raise ValueError(f"a 2-D (tile, samp) mesh is needed, got shape {mesh.shape}")
    return mesh.shape


def render_image_sharded_2d(scene, camera, key: np.ndarray, mesh: Mesh,
                            spp: int | None = None) -> torch.Tensor:
    """Full image on a 2-D (tile, samp) mesh: pixels shard over ``tile``,
    the sample range over ``samp``; partial radiance is all-reduced over
    ``samp`` and the tiles gathered over ``tile``. The same per-(pixel,
    sample) streams as the single-device render; only the float order of
    the sample sum differs (allclose, not bitwise)."""
    spp = camera.spp if spp is None else spp
    n_tile, n_samp = _check_2d(mesh)
    i, j = mesh.coords
    per = -(-spp // n_samp)
    ids = share(_pixels(scene, camera), n_tile, i)
    acc = integrator.accumulate_samples_subset(
        scene, camera, key, ids, j * per, per,
        batch_pixels=integrator.scan_batch_pixels(scene))
    acc = all_reduce(acc, mesh.samp_group)
    flat = all_gather(acc, mesh.tile_group, n_tile)[:camera.width * camera.height]
    return (flat / (per * n_samp)).reshape(camera.height, camera.width, 3)


# -------------------------------------------------------------- gradients
def _loss_and_grad(scene, camera, key, target, mesh, parts, index, samples, spp,
                   samp_group, counts_loss):
    """One rank's share of the training step: pixel share ``index`` of
    ``parts``, samples ``samples`` = (offset, count) of an image averaged
    over ``spp``; ``samp_group`` sums the partial images of one tile;
    ``counts_loss``: this rank adds its tile's loss (one rank per tile)."""
    n_pix = camera.width * camera.height
    ids = share(_pixels(scene, camera), parts, index)
    tgt = share(target.reshape(-1, 3).to(device=scene.device, dtype=torch.float32),
                parts, index)
    valid = share(torch.ones((n_pix, 1), device=scene.device), parts, index)
    rep = diff._use_replay(scene)
    sp = diff._leaves(diff.scene_params(scene))
    cp = diff._leaves(diff.camera_params(camera))
    tape = replay.Tape() if rep else None
    with torch.no_grad():
        base = diff.apply_scene_params(scene, sp)
        base_cam = diff.apply_camera_params(camera, cp)
    img = diff._forward_pass(base, base_cam, key, spp, tape, pixel_ids=ids,
                             samples=samples)
    img = all_reduce(img, samp_group)
    d = (img - tgt) * valid
    diff._backward_pass(scene, camera, key, spp, sp, cp, 2.0 * d / (n_pix * 3), tape,
                        pixel_ids=ids, samples=samples)
    gs, gc = diff._grads(sp), diff._grads(cp)
    loss = (d * d).sum() if counts_loss else d.new_zeros(())
    leaves = [*gs.values(), *gc.values()]
    flat = all_reduce(torch.cat([loss.reshape(1), *(g.reshape(-1) for g in leaves)]),
                      mesh.group)
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return flat[0] / (n_pix * 3), (dict(zip(gs, out[:len(gs)])),
                                   dict(zip(gc, out[len(gs):])))


def render_loss_and_grad_sharded(scene, camera, key: np.ndarray, target: torch.Tensor,
                                 mesh: Mesh, spp: int | None = None):
    """(loss, (scene_grads, camera_grads)) of the mean squared pixel error
    against ``target``, pixels sharded over the mesh: the same loss
    convention and parameter dicts as ``diff.loss_and_grads`` (the full
    differentiable set, geometry included), gradients all-reduced. The
    data-parallel training step of the differentiable renderer."""
    spp = camera.spp if spp is None else spp
    return _loss_and_grad(scene, camera, key, target, mesh, mesh.size, mesh.rank,
                          (0, spp), spp, None, True)


def render_loss_and_grad_sharded_2d(scene, camera, key: np.ndarray, target: torch.Tensor,
                                    mesh: Mesh, spp: int | None = None):
    """The training step on a 2-D (tile, samp) mesh: pixels over ``tile``,
    samples over ``samp`` (the range padded to a multiple of its size); a
    tile's partial images are all-reduced over ``samp`` before the loss,
    so each rank's upstream gradient sees its tile's full sample mean; the
    loss and gradients are all-reduced over both axes."""
    spp = camera.spp if spp is None else spp
    n_tile, n_samp = _check_2d(mesh)
    i, j = mesh.coords
    per = -(-spp // n_samp)
    return _loss_and_grad(scene, camera, key, target, mesh, n_tile, i, (j * per, per),
                          per * n_samp, mesh.samp_group, j == 0)
