"""Coherence sorting of a ray batch for the tile-packet accelerator.

Port of ``cpu_ray_tracing_implementation_tpu/ops/raysort.py``. The packet
route (``ops/packet.py``) culls chunks per tile of rays, so its gain
collapses when a tile's rays diverge: after the first diffuse bounce a
tile of camera-order lanes spans the scene in random directions. The fix,
standard in wavefront path tracers, is to re-sort the batch every bounce
by a spatial-directional key, so that neighbouring lanes are coherent
again. The key packs, most significant first,

    [6b coarse origin Morton | 3b direction octant | 15b fine origin Morton]

``coherence_keys`` computes it in int32, bit for bit the JAX package's.
``sort_rays`` permutes the batch by ``torch.sort`` of the keys (stable,
where JAX's sort is not: keys collide, so the two orders may differ among
equal keys) and returns each sorted lane's original position;
``unsort`` scatters results back to the caller's order by those
positions (JAX sorts a second time). Both are gathers and scatters that
autograd carries through.
"""

from __future__ import annotations

import torch

# sorting pays off once the scene has enough chunks for per-tile culling to
# matter and the batch is big enough to form many tiles
MIN_CHUNKS = 32
MIN_RAYS = 8192


def _part3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 7 bits of int32 ``x`` to every 3rd bit (Morton
    interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_keys(org, dirs, lo, hi) -> torch.Tensor:
    """[R] int32 sort key: coarse Morton | octant | fine Morton. ``lo`` /
    ``hi``: the world AABB that quantizes the origins ([3] tensors)."""
    ext = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((org - lo[None, :]) / ext[None, :], 0.0, 1.0 - 1e-6)
    qi = (q * 128.0).to(torch.int32)                          # [R,3] 7 bits
    m = _part3(qi[:, 0]) | (_part3(qi[:, 1]) << 1) | (_part3(qi[:, 2]) << 2)
    octant = ((dirs[:, 0] > 0).to(torch.int32) * 4
              + (dirs[:, 1] > 0).to(torch.int32) * 2
              + (dirs[:, 2] > 0).to(torch.int32))
    return ((m >> 15) << 18) | (octant << 15) | (m & 0x7FFF)


def sort_rays(keys: torch.Tensor, arrays):
    """Sort lanes by ``keys``: (the [R] or [R,k] ``arrays`` in key order,
    lane_ids [R] int32, each sorted lane's original position)."""
    _, perm = torch.sort(keys, stable=True)
    return [torch.index_select(a, 0, perm) for a in arrays], perm.to(torch.int32)


def unsort(lane_ids: torch.Tensor, arrays):
    """Inverse of ``sort_rays``: ``arrays`` ([R] or [R,k], any dtype) back
    in the caller's lane order, a scatter by ``lane_ids``."""
    idx = lane_ids.long()
    return [torch.empty_like(a).index_copy(0, idx, a) for a in arrays]
