"""The cases of ``tests/test_torch_parallel.py``, run inside two spawned
gloo ranks on the CPU (``serve``). This module imports no JAX: the ranks
load it by name, and each case returns numpy (or a dict of numpy) to the
test, which compares it with the single-process port and with JAX.
"""

from __future__ import annotations

import datetime
import os
import traceback

import torch
import torch.distributed as dist

from cpu_ray_tracing_implementation_tpu_torch.models import adaptive, catalog
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.utils import checkpoint as ckpt

# a collective that a failed rank left waiting errors out after this long
TIMEOUT_S = 120

_SCENES: dict = {}
_MESHES: dict = {}


def scene(name: str, **kw):
    """``catalog.<name>(**kw)`` on the CPU, built once per process."""
    k = (name, tuple(sorted(kw.items())))
    if k not in _SCENES:
        _SCENES[k] = getattr(catalog, name)(device="cpu", **kw)
    return _SCENES[k]


def mesh(shape=None) -> pm.Mesh:
    """The 1-D mesh over the two ranks, or the 2-D one of ``shape`` (made
    once: each rank enters the same ``new_group`` calls)."""
    if shape not in _MESHES:
        _MESHES[shape] = (pm.make_mesh(device="cpu") if shape is None
                          else pm.make_mesh_2d(shape, device="cpu"))
    return _MESHES[shape]


class _Env:
    """Environment variables set for the span of one case."""

    def __init__(self, env):
        self.env, self.old = env or {}, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def render(name, kw, how, seed=0, spp=None, shape=None, **extra):
    """A sharded render of scene ``name`` built with ``kw``: ``how`` is
    pixel, spp, 2d, wavefront or adaptive."""
    s, cam = scene(name, **kw)
    key = keys.key(seed)
    if how == "pixel":
        img = pm.render_image_sharded(s, cam, key, mesh(), spp=spp, **extra)
    elif how == "spp":
        img = pm.render_image_spp_sharded(s, cam, key, mesh(), spp=spp)
    elif how == "2d":
        img = pm.render_image_sharded_2d(s, cam, key, mesh(shape), spp=spp)
    elif how == "wavefront":
        img = pm.render_image_wavefront_sharded(s, cam, key, mesh(), spp=spp, **extra)
    elif how == "adaptive":
        img, spp_map = adaptive.render_image_adaptive(s, cam, key, mesh=mesh(),
                                                      return_spp_map=True, **extra)
        return {"img": img.numpy(), "spp_map": spp_map}
    else:
        raise ValueError(how)
    return img.numpy()


def grads(name, kw, seed, spp, shape=None):
    """Loss and gradients of the sharded training step against a black
    target, on the 1-D mesh (``shape`` None) or the 2-D one."""
    s, cam = scene(name, **kw)
    target = torch.zeros((cam.height, cam.width, 3))
    if shape is None:
        loss, (gs, gc) = pm.render_loss_and_grad_sharded(s, cam, keys.key(seed), target,
                                                         mesh(), spp=spp)
    else:
        loss, (gs, gc) = pm.render_loss_and_grad_sharded_2d(s, cam, keys.key(seed), target,
                                                            mesh(shape), spp=spp)
    return {"loss": loss.numpy(), **{f"s/{k}": v.numpy() for k, v in gs.items()},
            **{f"c/{k}": v.numpy() for k, v in gc.items()}}


class _Stop(Exception):
    pass


def checkpointed(name, kw, seed, chunk_spp, path, stop_after=None, wavefront=False):
    """``render_with_checkpoint`` over the mesh, stopped once
    ``stop_after`` chunks are in the checkpoint (returns None) or run to
    its end (returns the image and whether it resumed)."""
    s, cam = scene(name, **kw)
    logs = []

    def log(msg):
        logs.append(msg)
        n = sum(m.startswith("[render]") for m in logs)
        if stop_after is not None and n == stop_after + 1:
            raise _Stop

    try:
        img = ckpt.render_with_checkpoint(s, cam, seed=seed, chunk_spp=chunk_spp,
                                          ckpt_path=path, log=log, mesh=mesh(),
                                          use_wavefront=wavefront)
    except _Stop:
        return None
    return {"img": img.numpy(), "resumed": any("resuming" in m for m in logs)}


CASES = {"render": render, "grads": grads, "checkpointed": checkpointed}


def serve(rank: int, world: int, store: str, conn) -> None:
    """A rank's loop: join the gloo group at the ``file://`` store, then
    run each (case, env, kwargs) the pipe brings and send back ("ok",
    result) or ("error", traceback), until it brings None."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while (msg := conn.recv()) is not None:
            name, env, kw = msg
            try:
                with _Env(env):
                    conn.send(("ok", CASES[name](**kw)))
            except Exception:  # noqa: BLE001  (the test reports it)
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
