"""Per-ray visit-list closest hit over chunked tables.

Port of ``cpu_ray_tracing_implementation_tpu/ops/perray.py`` (its Pallas
phase loop, ``perray.py:163-201``). Each ray gets its own front-to-back list
of the chunks its [tmin, cap] interval crosses, the batched form of the
reference's per-ray BVH descent (src/bvh_node.h:49-58):

 1. CULL + SELECT, kernel K3 (``ops/fused_select.py``): each ray's V
    nearest crossed chunks, ascending by entry t, and the entry t of the
    nearest chunk left over (``rest``).
 2. SWEEP, kernel K4 (``ops/fused_sweep.py``): each ray intersects the
    chunk rows of its V slots, front to back, tightening its best hit.
 3. Exactness: while some ray's nearest unvisited chunk could still beat
    its best hit (``any(rest < t_best)``), the next phase selects the next
    V chunks past the previous phase's last (near, id). The result equals
    the chunk-scan oracle (``ops/chunked.py``) for every ray, whatever V.

The phase condition is read on the host: one synchronisation per phase.
A ray whose ``rest`` is not below its best t after a phase gains nothing
from later phases; its exclusion key is marked exhausted, so K3 walks no
box for it (the hits and the phase count are those of the unmarked loop).
``PHASES`` counts the closest-hit calls, the phases they ran and the rays
still live in each phase.

Gradients (``perray.py:896-948``): when an input needs one, the drop-ins
go through ``PlanarClosestRay`` / ``SphereClosestRay``, the JAX package's
``planar_closest_ray`` / ``sphere_closest_ray``. Their forward is the phase
loop above, which keeps each ray's winning primitive id; their backward is
the VJP of ``replay.planar_chunks_winner`` / ``sphere_chunks_winner`` at
that id, O(R) gathers whose backward scatter-adds into the chunk tables.
Left out on purpose: the XLA near-matrix route (``_near_matrix``,
``_select_block``) and the sub-tile and quantized-row experiments (ROADMAP
M16). The other accelerators are ``ops/packet.py`` and ``ops/bvh.py``
(``intersect.accel_mode``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

INF = float("inf")

# visit slots selected per phase (the JAX package's CRT_RAYV default)
VISIT_BLOCK = 16

# closest-hit calls, the phases they ran, and the rays each phase walked
# boxes for, summed over calls (live[0]: every ray, in phase 1)
PHASES = {"calls": 0, "phases": 0, "live": []}


def reset_phases() -> None:
    PHASES["calls"] = 0
    PHASES["phases"] = 0
    PHASES["live"] = []


@dataclass(frozen=True)
class PerRayTables:
    """What the kernels read of one chunked table, built once per scene."""
    table: torch.Tensor   # [K, F, C] sweep rows (fused_sweep layout)
    boxes: torch.Tensor   # [8, Kp] chunk AABB pack (fused_select layout)


def planar_tables(chunks: ch.PlanarChunks) -> PerRayTables:
    """[K, 9, C] rows of corner, eu, ev components. ``active`` is baked in
    (inactive lanes get eu = ev = 0, so d.n == 0 and the plane test fails)
    and mat is not swept: the winner's is recovered once (_recover_mat)."""
    act = chunks.active[..., None]
    eu = torch.where(act, chunks.eu, torch.zeros_like(chunks.eu))
    ev = torch.where(act, chunks.ev, torch.zeros_like(chunks.ev))
    table = torch.cat([chunks.corner, eu, ev], dim=2).transpose(1, 2)
    return PerRayTables(table=table.contiguous(),
                        boxes=fs.pack_boxes(chunks.lo, chunks.hi))


def sphere_tables(chunks: ch.SphereChunks) -> PerRayTables:
    """[K, 7, C] rows of c0, c1 components and rad. Inactive lanes get
    rad = 0, whose discriminant is never positive (Cauchy-Schwarz)."""
    rad = torch.where(chunks.active, chunks.rad, torch.zeros_like(chunks.rad))
    table = torch.cat([chunks.c0, chunks.c1, rad[..., None]], dim=2)
    return PerRayTables(table=table.transpose(1, 2).contiguous(),
                        boxes=fs.pack_boxes(chunks.lo, chunks.hi))


def _recover_mat(chunk_mat, pid, hit):
    """[R] material of chunk-order primitive ``pid``; miss rays keep the
    chunk-scan oracle's sentinel 0 (pid is 0 on a miss, and chunk_mat[0,0]
    would leak through otherwise)."""
    mat = chunk_mat.reshape(-1)[pid.long()]
    return torch.where(hit, mat, torch.zeros_like(mat))


def _phase_loop(org, dirs, cap, tabs: PerRayTables, K_real, tmin, V,
                sweep_fn, best):
    """The exactness phase loop: K3 selects, ``sweep_fn(ids, nears, best)``
    (K4) sweeps, until no ray's ``rest`` is below its best t. Phases carry
    only the (threshold, last id) exclusion key: no [R, K] matrix."""
    rays = fs.pack_rays(org, dirs, cap)
    excl = fs.first_excl(org.shape[0], org.device)
    live = org.shape[0]
    phases = 0
    while True:
        if len(PHASES["live"]) <= phases:
            PHASES["live"].append(0)
        PHASES["live"][phases] += live
        ids, nears, rest = fs.cull_select(rays, tabs.boxes, excl, V, K_real,
                                          float(tmin))
        best = sweep_fn(ids, nears, best)
        phases += 1
        # A ray whose rest is not below its best t is done: every later
        # near is at or above rest (the next phase starts at exactly the
        # rest key), so K4 would skip all its slots and rest stays >= best.
        # Its exhausted key lets K3 walk no box for it.
        more = rest < best[:, 0]
        live = int(more.sum())
        if not live:
            break
        excl = fs.next_excl(ids, nears, ~more, float(tmin))
    PHASES["calls"] += 1
    PHASES["phases"] += phases
    return best


def _cap(org, tmax):
    return torch.broadcast_to(
        torch.as_tensor(tmax, dtype=org.dtype, device=org.device),
        org.shape[:1]).contiguous()


def _planar_forward(org, dirs, chunks, tmin, triangle, tmax, V, tabs):
    """The phase loop for a planar table: (t, (unorm, u, v, mat, pid)), no
    graph."""
    R = org.shape[0]
    K = chunks.corner.shape[0]
    tabs = planar_tables(chunks) if tabs is None else tabs
    cap = _cap(org, tmax)
    z = torch.zeros((R,), dtype=org.dtype, device=org.device)
    best0 = fsw.pack_best_planar(cap, torch.zeros_like(org), z, z,
                                 z.to(torch.int32), z.to(torch.int32))
    rays = fsw.pack_rays(org, dirs)
    best = _phase_loop(
        org, dirs, cap, tabs, K, tmin, min(V, K),
        lambda ids, nears, b: fsw.sweep(rays, ids, nears, b, tabs.table,
                                        float(tmin), triangle, False),
        best0)
    t, n, u, v, _, p = fsw.unpack_best_planar(best)
    hit = t < cap
    return torch.where(hit, t, torch.full_like(t, INF)), (
        n, u, v, _recover_mat(chunks.mat, p, hit), p)


def _sphere_forward(org, dirs, time, chunks, tmin, tmax, V, tabs):
    """The phase loop for a sphere table: (t, (center, rad, mat, pid)), no
    graph."""
    R = org.shape[0]
    K = chunks.rad.shape[0]
    tabs = sphere_tables(chunks) if tabs is None else tabs
    cap = _cap(org, tmax)
    z = torch.zeros((R,), dtype=org.dtype, device=org.device)
    best0 = fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1.0,
                                 z.to(torch.int32), z.to(torch.int32))
    rays = fsw.pack_rays(org, dirs, time)
    best = _phase_loop(
        org, dirs, cap, tabs, K, tmin, min(V, K),
        lambda ids, nears, b: fsw.sweep(rays, ids, nears, b, tabs.table,
                                        float(tmin), False, True),
        best0)
    t, ctr, rad, _, p = fsw.unpack_best_sphere(best)
    hit = t < cap
    return torch.where(hit, t, torch.full_like(t, INF)), (
        ctr, rad, _recover_mat(chunks.mat, p, hit), p)


class PlanarClosestRay(torch.autograd.Function):
    """The phase loop forward, the winner replay's VJP backward
    (``perray.py:901-923`` of the JAX package)."""

    @staticmethod
    def forward(ctx, org, dirs, corner, eu, ev, chunks, tmin, triangle, tmax,
                V, tabs):
        with torch.no_grad():
            t, (n, u, v, mat, pid) = _planar_forward(org, dirs, chunks, tmin,
                                                     triangle, tmax, V, tabs)
        ctx.save_for_backward(org, dirs, corner, eu, ev, pid)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi)
        ctx.mark_non_differentiable(mat, pid)
        return t, n, u, v, mat, pid

    @staticmethod
    def backward(ctx, g_t, g_n, g_u, g_v, _g_mat, _g_pid):
        from cpu_ray_tracing_implementation_tpu_torch.ops import replay

        *saved, pid = ctx.saved_tensors
        mat, active, lo, hi = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in saved]
            chunks = ch.PlanarChunks(corner=xs[2], eu=xs[3], ev=xs[4], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (n, u, v, _, _) = replay.planar_chunks_winner(xs[0], xs[1],
                                                             chunks, pid)
            grads = tbl.vjp((t, n, u, v), xs, (g_t, g_n, g_u, g_v))
        return (*grads, None, None, None, None, None, None)


class SphereClosestRay(torch.autograd.Function):
    """The phase loop forward, the winner replay's VJP backward
    (``perray.py:926-948`` of the JAX package)."""

    @staticmethod
    def forward(ctx, org, dirs, time, c0, c1, rad, chunks, tmin, tmax, V,
                tabs):
        with torch.no_grad():
            t, (ctr, r, mat, pid) = _sphere_forward(org, dirs, time, chunks,
                                                    tmin, tmax, V, tabs)
        ctx.save_for_backward(org, dirs, time, c0, c1, rad, pid)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi, tmin)
        ctx.mark_non_differentiable(mat, pid)
        return t, ctr, r, mat, pid

    @staticmethod
    def backward(ctx, g_t, g_ctr, g_rad, _g_mat, _g_pid):
        from cpu_ray_tracing_implementation_tpu_torch.ops import replay

        *saved, pid = ctx.saved_tensors
        mat, active, lo, hi, tmin = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in saved]
            chunks = ch.SphereChunks(c0=xs[3], c1=xs[4], rad=xs[5], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (ctr, r, _, _) = replay.sphere_chunks_winner(
                xs[0], xs[1], xs[2], chunks, pid, tmin)
            grads = tbl.vjp((t, ctr, r), xs, (g_t, g_ctr, g_rad))
        return (*grads, None, None, None, None, None)


def planar_closest_perray(org, dirs, chunks: ch.PlanarChunks, tmin,
                          triangle: bool, tmax=INF, V: int = VISIT_BLOCK,
                          tabs: PerRayTables | None = None):
    """Drop-in for ``chunked.planar_closest`` (exact; differentiable through
    ``PlanarClosestRay`` when an input needs a gradient).

    ``tmax``: scalar or per-ray [R] cap (no gradient); ``tabs``: the
    scene's cached ``planar_tables(chunks)``. Returns (t [R], (unorm [R,3],
    u [R], v [R], mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, chunks.corner, chunks.eu, chunks.ev):
        t, n, u, v, mat, pid = PlanarClosestRay.apply(
            org, dirs, chunks.corner, chunks.eu, chunks.ev, chunks, tmin,
            triangle, tmax, V, tabs)
        return t, (n, u, v, mat, pid)
    with torch.no_grad():
        return _planar_forward(org, dirs, chunks, tmin, triangle, tmax, V, tabs)


def sphere_closest_perray(org, dirs, time, chunks: ch.SphereChunks, tmin,
                          tmax=INF, V: int = VISIT_BLOCK,
                          tabs: PerRayTables | None = None):
    """Drop-in for ``chunked.sphere_closest`` (exact; differentiable through
    ``SphereClosestRay``). Returns (t [R], (center_at_t [R,3], rad [R],
    mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, time, chunks.c0, chunks.c1, chunks.rad):
        t, ctr, rad, mat, pid = SphereClosestRay.apply(
            org, dirs, time, chunks.c0, chunks.c1, chunks.rad, chunks, tmin,
            tmax, V, tabs)
        return t, (ctr, rad, mat, pid)
    with torch.no_grad():
        return _sphere_forward(org, dirs, time, chunks, tmin, tmax, V, tabs)
