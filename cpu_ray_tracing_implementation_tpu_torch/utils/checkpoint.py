"""Checkpoint / resume for long renders.

Port of ``cpu_ray_tracing_implementation_tpu/utils/checkpoint.py``. The
reference has none (its image lives in memory and is written once at the
end, src/camera.h:174,328). Rendering is spp-chunked accumulation, so the
durable state is the radiance sum, the samples done and the base seed.
Every sample is keyed by its global sample index
(``integrator.accumulate_samples``, ``render_wavefront(sample_offset=)``),
so a resumed render draws the same samples as an uninterrupted one, and
the host adds the chunk sums in the same order either way.

Checkpoints are .npz files written atomically (tmp + rename) with a
fingerprint of the render's configuration; a mismatched fingerprint
(another scene, camera, seed or integrator) is refused rather than
blended. The fingerprint hashes the port's own tensors, so a checkpoint
written by the JAX package need not load here.

Bitwise resume. Resumed equals uninterrupted bit for bit wherever a chunk's
sum is deterministic: the scan everywhere, and the wavefront on the CPU.
On the card the wavefront flushes finished paths with a float
``index_add_``, which runs as atomics in no fixed order, so there the two
agree to float32 summation order (rtol 1e-5), not bitwise.

Over a mesh (``parallel/mesh.py``) each chunk's pixels shard over the
ranks (``parallel/collectives.map_pixels``, as ``accumulate_samples_sharded``
and ``accumulate_wavefront_sharded`` shard them) and every rank holds the
whole sum. Rank 0 writes the file and every rank
waits at a barrier after each write; a resume reads the same file on every
rank. The fingerprint does not name the mesh, so a sharded checkpoint
resumes in a single-rank run and the reverse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel.collectives import barrier, map_pixels


def _leaves(obj):
    """The tensors of ``obj`` in a fixed order: dataclass fields in
    declaration order, tuples and lists in order, recursively."""
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)


def _fingerprint(scene, camera, seed: int) -> str:
    """Cheap structural hash of the render configuration: every scene and
    camera tensor (a resumed render with a moved camera must be refused,
    not blended), by its shape and its first 4,096 bytes as float64 (bool
    kept as bool), and the camera's mode, size, depth and the seed
    (``checkpoint.py:30-42`` of the JAX package)."""
    h = hashlib.sha256()
    for leaf in (*_leaves(scene), *_leaves(camera)):
        a = leaf.detach().cpu().numpy()
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a if a.dtype == bool else a.astype(np.float64))
                 .tobytes()[:4096])
    h.update(json.dumps([camera.mode, camera.width, camera.height,
                         camera.max_depth, seed]).encode())
    return h.hexdigest()[:16]


def save(path: str, accum: np.ndarray, samples_done: int, fingerprint: str):
    """Write the checkpoint atomically: a tmp file, then a rename."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, accum=accum, samples_done=samples_done, fingerprint=fingerprint)
    os.replace(tmp, path)


def load(path: str, fingerprint: str):
    """(accum, samples_done), or None when the file is absent, is for
    another configuration, or cannot be read."""
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if str(z["fingerprint"]) != fingerprint:
            print(f"[checkpoint] {path} is for a different render config; ignoring")
            return None
        return z["accum"], int(z["samples_done"])
    except Exception as e:  # noqa: BLE001  (any unreadable file starts afresh)
        print(f"[checkpoint] failed to read {path}: {e}; starting fresh")
        return None


def render_with_checkpoint(scene, camera, seed: int = 0, spp: int | None = None,
                           chunk_spp: int = 16, ckpt_path: str | None = None,
                           log=print, use_wavefront: bool = False, mesh=None,
                           batch_pixels: int | None = None) -> torch.Tensor:
    """Render in chunks of ``chunk_spp`` samples, checkpointing after each;
    resumes from ``ckpt_path`` when it holds this configuration's state.
    Returns the [H,W,3] image on the scene's device (the sum of the chunks
    over ``spp``, kept on the host as float32 between chunks).

    ``use_wavefront``: accumulate each chunk through the path-regeneration
    wavefront (``render_wavefront(sample_offset=)``) instead of the scan;
    the integrator is part of the fingerprint (``"wf-"``), so a scan
    checkpoint is refused under the wavefront. ``batch_pixels``: the
    scan's pixel batch (default ``integrator.scan_batch_pixels``), or a cap
    on the wavefront's lane pool (each rank's, over a mesh). ``mesh``
    (``parallel.mesh.Mesh``): each chunk's pixels shard over its ranks,
    every rank calling with the same arguments."""
    spp = camera.spp if spp is None else spp
    key = keys.key(seed)
    fp = _fingerprint(scene, camera, seed)
    if use_wavefront:
        fp = "wf-" + fp
    n_pix = camera.width * camera.height
    rank = 0 if mesh is None else mesh.rank

    accum = np.zeros((n_pix, 3), np.float32)
    done = 0
    if ckpt_path:
        state = load(ckpt_path, fp)
        if state is not None:
            accum, done = state
            log(f"[checkpoint] resuming at {done}/{spp} spp from {ckpt_path}")

    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=scene.device)
    scan_batch = batch_pixels or integrator.scan_batch_pixels(scene)

    def chunk(ids):
        """This rank's radiance sum of the chunk's samples at ``ids``."""
        if use_wavefront:
            return integrator.render_wavefront(
                scene, camera, key, n, pixel_ids=ids, sample_offset=done,
                lanes=integrator.wavefront_lanes(scene, ids.shape[0], batch_pixels))
        return integrator.accumulate_samples_subset(scene, camera, key, ids, done, n,
                                                    batch_pixels=scan_batch)

    while done < spp:
        n = min(chunk_spp, spp - done)
        t0 = time.perf_counter()
        part = map_pixels(mesh, pixel_ids, chunk)
        accum = accum + part.cpu().numpy()
        dt = time.perf_counter() - t0
        done += n
        log(f"[render] {done}/{spp} spp ({n_pix * n / dt / 1e6:.2f}M camera rays/s)")
        if ckpt_path:
            if rank == 0:
                save(ckpt_path, accum, done, fp)
            barrier(mesh)

    if ckpt_path and rank == 0 and os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # complete: the checkpoint is spent
    img = torch.as_tensor(accum / np.float32(spp), device=scene.device)
    return img.reshape(camera.height, camera.width, 3)
