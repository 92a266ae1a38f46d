"""Carry the JAX package's state across into the port.

The tests render one scene with both packages. These helpers take the JAX
package's ``Scene`` / ``Camera`` (any object with the same attributes whose
leaves ``np.asarray`` can read) and ``jax.random.key_data(key)`` as numpy,
and build the port's objects on a given device, so both packages trace
exactly the same tables with the same key. Nothing here imports ``jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE

_ENV_TABLES = ("env_texel_p", "env_row_cdf", "env_col_cdf")


def _columns(obj, cls) -> list:
    """``obj``'s columns in ``cls``'s field order; an absent optional
    column (the volumes' mesh tables of a scene without one) stays None."""
    cols = [getattr(obj, f.name, None) for f in dataclasses.fields(cls)]
    return [None if c is None else np.asarray(c) for c in cols]


def scene_from_numpy(jscene, device=DEFAULT_DEVICE) -> sc.Scene:
    """The port's Scene holding the same tables as the JAX ``jscene``,
    its chunked tables, chunk orders, BVH trees, picture images, noise tables, sphere
    lights, mesh-volume boundaries, environment-light tables and per-vertex
    triangle attributes included (the attribute rows already lie in the
    JAX scene's pid space, which its chunk tables carry across too)."""
    arrays = {name: _columns(getattr(jscene, name), cls)
              for name, cls in sc._TABLES.items()}
    for name, cls in sc._CHUNKS.items():
        chunks = getattr(jscene, name)
        arrays[name] = None if chunks is None else _columns(chunks, cls)
        oname = name.replace("_chunks", "_chunk_order")
        order = getattr(jscene, oname)
        arrays[oname] = None if order is None else np.asarray(order, np.int32)
        tree = getattr(jscene, name.replace("_chunks", "_tree"), None)
        arrays[name.replace("_chunks", "_tree")] = None if tree is None else (
            np.asarray(tree.node_pack, np.float32), np.asarray(tree.prim_pack, np.float32),
            int(tree.max_leaf))
    off = jscene.world_offset
    sl = getattr(jscene, "sphere_lights", None)
    arrays.update(lights=np.asarray(jscene.lights, np.int32),
                  sphere_lights=None if sl is None else np.asarray(sl, np.int32),
                  images=[np.asarray(im, np.float32) for im in jscene.images],
                  world_offset=None if off is None else np.asarray(off, np.float32))
    attrs = getattr(jscene, "tri_attrs", None)
    arrays["tri_attrs"] = None if attrs is None else _columns(attrs, sc.TriAttrs)
    for name in _ENV_TABLES:
        table = getattr(jscene, name, None)
        arrays[name] = None if table is None else np.asarray(table, np.float32)
    return sc.scene_from_tables(
        arrays, device=tbl.as_device(device), background=int(jscene.background),
        tex_types_used=tuple(jscene.tex_types_used),
        mat_types_used=tuple(jscene.mat_types_used),
        has_bilinear=bool(jscene.has_bilinear),
        has_dispersion=bool(getattr(jscene, "has_dispersion", False)),
        counts=tuple(jscene.counts), world_lo=jscene.world_lo,
        world_hi=jscene.world_hi)


def camera_from_numpy(jcam, device=DEFAULT_DEVICE) -> cam_mod.Camera:
    """The port's Camera with the same parameters as the JAX ``jcam``."""
    if int(jcam.mode) not in (cam_mod.PERSPECTIVE, cam_mod.ORTHOGRAPHIC,
                              cam_mod.FISHEYE, cam_mod.LENS):
        raise ValueError(f"unknown camera mode {int(jcam.mode)}")

    device = tbl.as_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return cam_mod.Camera(
        pos=f32(jcam.pos), lookat=f32(jcam.lookat), fovy_deg=f32(jcam.fovy_deg),
        focal_length=f32(jcam.focal_length),
        ortho_viewport_h=f32(jcam.ortho_viewport_h),
        defocus_angle_deg=f32(jcam.defocus_angle_deg),
        focus_dist=f32(jcam.focus_dist), mode=int(jcam.mode),
        width=int(jcam.width), height=int(jcam.height), spp=int(jcam.spp),
        max_depth=int(jcam.max_depth), stratify=bool(jcam.stratify),
        clamp=float(jcam.clamp), rr_depth=int(getattr(jcam, "rr_depth", 0)),
        nee=bool(getattr(jcam, "nee", False)),
        qmc=bool(getattr(jcam, "qmc", False)))


def params_from_numpy(params: dict, device=DEFAULT_DEVICE) -> dict:
    """The JAX package's ``scene_params`` / ``camera_params`` dict (any
    leaves ``np.asarray`` reads) as the port's tensors on ``device``."""
    device = tbl.as_device(device)
    return {k: torch.as_tensor(np.array(v), device=device) for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """A parameter or gradient dict of either package as numpy arrays."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in params.items()}


def key_from_numpy(key_data) -> np.ndarray:
    """[2] uint32 key words from ``jax.random.key_data(key)``."""
    k = np.asarray(key_data, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"expected threefry key data of shape (2,), got {k.shape}")
    return k
