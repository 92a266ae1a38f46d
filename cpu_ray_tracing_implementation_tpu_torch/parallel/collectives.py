"""The collectives a sharded render is built from, over a mesh's process
groups (``parallel/mesh.py``). This module imports no model, so the
integrators' own sharded branches (``models/adaptive.py``,
``utils/checkpoint.py``) use it without knowing the parallel renders.

Card tensors go to the collectives as they are, whatever the backend:
gloo takes ``all_reduce``, ``all_gather`` and ``broadcast`` on them
(``chip_smoke.py`` phase 7 probes it on the card), and NCCL needs them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (None: ``t`` itself)."""
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` (equal shapes) concatenated in rank order
    along dim 0 (None: ``t`` itself)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def barrier(mesh) -> None:
    """Every rank of the mesh waits here until all have come (None, or a
    mesh of one rank: no wait)."""
    if mesh is None or mesh.group is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def share(t: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Share ``index`` of ``parts`` of ``t``'s rows: ``t`` padded with
    zero rows (pixel 0, for ids) to a multiple of ``parts``, then split
    into equal contiguous shares."""
    per = -(-t.shape[0] // parts)
    mine = t[index * per:(index + 1) * per]
    if mine.shape[0] < per:
        mine = torch.cat([mine, mine.new_zeros((per - mine.shape[0], *t.shape[1:]))])
    return mine


def map_pixels(mesh, pixel_ids: torch.Tensor, fn, *rows) -> torch.Tensor:
    """``fn(ids, *rows)`` on this rank's share of ``pixel_ids`` (and of
    each [N, ...] tensor in ``rows``), its [share, ...] result gathered
    across the ranks into [N, ...]: the pixel-sharded building block.
    ``mesh`` None: ``fn`` on all of them, here."""
    if mesh is None:
        return fn(pixel_ids, *rows)
    out = fn(share(pixel_ids, mesh.size, mesh.rank),
             *(share(r, mesh.size, mesh.rank) for r in rows))
    return all_gather(out, mesh.group, mesh.size)[:pixel_ids.shape[0]]
