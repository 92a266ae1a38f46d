"""Batched texture evaluation over flat texture tables.

Port of ``cpu_ray_tracing_implementation_tpu/ops/textures.py`` for the
solid and checker kinds. Every kind the scene uses is evaluated for all
lanes and selected by type code (src/texture.h:9 virtual dispatch).
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

_NOT_PORTED = {
    scene_mod.TEX_PICTURE: "picture textures (ROADMAP M13)",
    scene_mod.TEX_PERLIN: "perlin textures (ROADMAP M2)",
    scene_mod.TEX_VALUE: "value-noise textures (ROADMAP M2)",
    scene_mod.TEX_WORLEY: "worley textures (ROADMAP M2)",
    scene_mod.TEX_VORONOI: "voronoi textures (ROADMAP M2)",
}


def eval_texture(scene, tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """color [R,3] for per-lane texture ids at (u, v, p).

    ``p`` arrives in the (possibly recentered) tracing frame; position-based
    textures evaluate in world space by adding Scene.world_offset back.
    """
    used = scene.tex_types_used or (scene_mod.TEX_SOLID,)
    for kind in used:
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"{_NOT_PORTED[kind]} are not ported yet")
    if scene.world_offset is not None:
        p = p + scene.world_offset[None, :]
    texs = scene.textures
    ttype = tbl.take_rows(texs.ttype, tex_id)
    color0 = tbl.take_rows(texs.color0, tex_id)
    out = color0  # TEX_SOLID result doubles as the base case

    if scene_mod.TEX_CHECKER in used:
        # 3-D position checker (src/texture.h:47-56): parity of floor(p/scale).
        # remainder, not fmod: the parity of a negative sum must match jnp.mod
        color1 = tbl.take_rows(texs.color1, tex_id)
        scale = tbl.take_rows(texs.scale, tex_id)
        ixyz = torch.floor(p / scale[..., None]).to(torch.int32)
        total = ixyz[..., 0] + ixyz[..., 1] + ixyz[..., 2]
        even = (torch.remainder(total, 2) == 0)[..., None]
        checker = torch.where(even, color0, color1)
        out = torch.where((ttype == scene_mod.TEX_CHECKER)[..., None], checker, out)
    return out
