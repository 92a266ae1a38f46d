"""Roofline bounds of the closest-hit kernels, for what each call's inputs
need.

A frozen copy of the bring-up check's arithmetic (``chip_smoke.py``'s
``OPS``, ``bound`` and ``closest_bound``): the least time one H100 could
take is the larger of the bytes each input and output must move once over
3.35 TB/s and the FP32 instructions the data needs (a fused multiply-add
counted once) over 33.5e12 per second (67 TFLOP/s of FP32, NVIDIA's data
sheet for the SXM part at 700 W, counts an FMA as two operations).

- K1 (``planar_closest_kernel``): the ray rows read (origin, direction),
  the [8, R] hit rows written and the constant pack read once; 36
  instructions per (ray, live primitive).
- K3 (``cull_select_kernel``): a slab test and key, 30 instructions, per
  (live ray, box); a ray the phase loop marked done (an exhausted
  exclusion key) walks no box and is not counted.
- K4 (``visit_sweep_*``, four stage kernels): per visited (ray, slot) 16
  instructions per primitive of the chunk, 57 per primitive of each
  distinct row visited (its constants), and 30 for the edge tests of each
  (ray, primitive) whose plane t lies in [tmin, best t]. A slot counts as
  visited when its entry t lies below the call's resulting best t, and a
  pair takes the edge tests when its plane t lies at or below it: any
  correct sweep must do that much, whatever order it visits in, so this is
  a floor under the sequential sweep's count (which starts from the
  input's best t), and the share it gives a lower bound.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
OPS = {"planar_closest": 36, "cull_select": 30, "visit_sweep_planar": 16,
       "visit_sweep_planar_edges": 30, "visit_sweep_planar_row": 57}
# [8,R] ray rows K1 reads for planar tables: origin and direction
K1_RAY_ROWS = 6
# K3's exhausted key in exact mode: (+inf, 2**24); in packed mode a NaN
EXHAUSTED_ID = float(1 << 24)
# K4's table rows: corner (0:3), edge u (3:6), edge v (6:9)
CHUNK_C = 128


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_INSTR_PER_S)


def k1_bound(R: int, pack_numel: int, live: int) -> float:
    """K1 over R rays and a pack of ``live`` live primitives."""
    nbytes = 4 * (K1_RAY_ROWS * R + pack_numel + 8 * R)
    return bound_s(nbytes, R * live * OPS["planar_closest"])


def k3_bound(excl: torch.Tensor, boxes_numel: int, V: int, K_real: int) -> float:
    """K3 on [R,2] exclusion keys ``excl`` against K_real boxes, V slots."""
    R = excl.shape[0]
    thr = excl[:, 0]
    done = torch.isnan(thr) | (torch.isinf(thr) & (excl[:, 1] == EXHAUSTED_ID))
    live = int((~done).sum())
    nbytes = 4 * (8 * live + boxes_numel + 2 * R + 2 * V * R + R)
    return bound_s(nbytes, live * K_real * OPS["cull_select"])


def k4_needs(rays, ids, nears, best_t, table, tmin: float, step: int = 16_384):
    """(visited (ray, slot) pairs, distinct rows visited, (ray, primitive)
    pairs that take the edge tests) of one planar K4 call, against its
    resulting best t [R]."""
    K = table.shape[0]
    cid = ids.clamp(0, K - 1).long()
    vis = torch.nonzero(nears < best_t[:, None])
    visits = vis.shape[0]
    if not visits:
        return 0, 0, 0
    r_all, s_all = vis[:, 0], vis[:, 1]
    rows = int(torch.unique(cid[r_all, s_all]).numel())
    more = 0
    for a in range(0, visits, step):
        r, s = r_all[a:a + step], s_all[a:a + step]
        row = table[cid[r, s]]                                   # [n, F, C]
        org, dirs = rays[r, 0:3], rays[r, 3:6]
        n = torch.cross(row[:, 3:6], row[:, 6:9], dim=1)
        un = n * torch.rsqrt(torch.clamp((n * n).sum(1, keepdim=True), min=1e-30))
        d_n = (un * dirs[:, :, None]).sum(1)
        t = ((un * row[:, 0:3]).sum(1) - (un * org[:, :, None]).sum(1)) / d_n
        more += int(((d_n.abs() > 1e-20) & (t >= tmin) & (t <= best_t[r][:, None])).sum())
    return visits, rows, more


def k4_bound(rays, ids, nears, best_t, table, tmin: float) -> float:
    """K4's bound for one planar call (``k4_needs``)."""
    R, V = ids.shape
    F, C = table.shape[1], table.shape[2]
    visits, rows, more = k4_needs(rays, ids, nears, best_t, table, tmin)
    nbytes = 4 * (8 * R + 2 * R * V + 8 * R + 8 * R) + rows * 4 * F * C
    return bound_s(nbytes, visits * C * OPS["visit_sweep_planar"]
                   + rows * C * OPS["visit_sweep_planar_row"]
                   + more * OPS["visit_sweep_planar_edges"])
