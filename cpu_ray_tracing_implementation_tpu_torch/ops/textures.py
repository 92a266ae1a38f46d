"""Batched texture evaluation over flat texture tables.

Port of ``cpu_ray_tracing_implementation_tpu/ops/textures.py``: solid,
checker, picture and the four noise kinds (perlin marble, value, worley,
voronoi; ``ops/noise.py``). Every kind the scene uses is evaluated for all
lanes and selected by type code (src/texture.h:9 virtual dispatch).
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import noise as noise_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl


def eval_texture(scene, tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """color [R,3] for per-lane texture ids at (u, v, p).

    ``p`` arrives in the (possibly recentered) tracing frame; position-based
    textures evaluate in world space by adding Scene.world_offset back.
    """
    used = scene.tex_types_used or (scene_mod.TEX_SOLID,)
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

    if scene_mod.TEX_PICTURE in used:
        # nearest texel, v flipped, /256 (src/texture.h:68-74), or the
        # opt-in bilinear 4-tap (Textures.tfilter == 1)
        image_id = tbl.take_rows(texs.image_id, tex_id)
        pic = torch.zeros_like(color0)
        if scene.has_bilinear:
            tfil = tbl.take_rows(texs.tfilter, tex_id)
        for k, img in enumerate(scene.images):
            h, w = img.shape[0], img.shape[1]
            i = torch.clamp((w * u).to(torch.int32), 0, w - 1).long()
            j = torch.clamp((h * (1.0 - v)).to(torch.int32), 0, h - 1).long()
            texel = img[j, i] * (1.0 / 256.0)
            if scene.has_bilinear:
                x = w * u - 0.5
                y = h * (1.0 - v) - 0.5
                x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 1)
                y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 1)
                x1 = torch.clamp(x0 + 1, max=w - 1).long()
                y1 = torch.clamp(y0 + 1, max=h - 1).long()
                fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
                fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
                x0, y0 = x0.long(), y0.long()
                lerped = ((img[y0, x0] * (1 - fx) + img[y0, x1] * fx) * (1 - fy)
                          + (img[y1, x0] * (1 - fx) + img[y1, x1] * fx) * fy
                          ) * (1.0 / 256.0)
                texel = torch.where((tfil == 1)[..., None], lerped, texel)
            pic = torch.where((image_id == k)[..., None], texel, pic)
        out = torch.where((ttype == scene_mod.TEX_PICTURE)[..., None], pic, out)

    def select(kind, val):
        return torch.where((ttype == kind)[..., None], val[..., None], out)

    if scene_mod.TEX_PERLIN in used:
        # marble: .5*(1+sin(x + 70*turb7(p/scale))) (src/texture.h:85-88)
        scale = tbl.take_rows(texs.scale, tex_id)
        turb = noise_ops.perlin_turb(p / scale[..., None], scene.noise.perlin_grad,
                                     scene.noise.perlin_perm, depth=7)
        out = select(scene_mod.TEX_PERLIN, 0.5 * (1.0 + torch.sin(p[..., 0] + 70.0 * turb)))
    if scene_mod.TEX_VALUE in used:
        out = select(scene_mod.TEX_VALUE, noise_ops.value_noise(p, scene.noise.value_grid))
    if scene_mod.TEX_WORLEY in used:
        out = select(scene_mod.TEX_WORLEY, noise_ops.worley_noise(p))
    if scene_mod.TEX_VORONOI in used:
        out = select(scene_mod.TEX_VORONOI, noise_ops.voronoi_noise(p))
    return out
