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
The backward replays the exact f32 chunks whichever route ran forward.

Switches, read per call as the JAX package reads them (``perray.py:53-61,
489-506, 709-741``):

- ``CRT_RAYV``: visit slots a phase when the caller passes no ``V``
  (default ``VISIT_BLOCK`` = 16; above 32, K3's largest, the selection
  is chained, ``fused_select.cull_select``).
- ``CRT_SWEEP_Q16=1`` (planar tables only; it wins over ``CRT_SUBTILE``):
  the quantized-row sweep. The rows hold each primitive's three points as
  u16 coordinates in its chunk box's frame (``planar_q16``), and K8 tests
  the dequantized geometry exactly; the boxes and K3 are the chunk route's.
- ``CRT_SUBTILE=1`` where ``CS = CRT_SUBC`` (default 32) divides the chunk
  width (else the chunk route runs): sub-tile selection, at every such CS
  on both devices. K3 selects among
  the boxes of CS-lane slices of each chunk (``subtile_bounds``, K*G boxes,
  G = C/CS) ``V = min(ceil(CRT_RAYV_SUB / P) * P, ceil(K*G / P) * P)``
  slots a phase (P = 128/CS, ``CRT_RAYV_SUB`` default 24; 64 at CS 2 and
  128 at CS 1, chained selections of 32), and K7 sweeps one sub-tile a
  slot; pid stays the global chunk-major index.

Both are opt-in experiments the JAX package measured as no faster on its
chip (``BASELINE.md:142-191, 265-287``). Their tables are built once per
scene, beside the chunk route's (``PerRayTables.subtile`` / ``.q16``).
Left out on purpose: the XLA near-matrix route (``_near_matrix``,
``_select_block``), which the K3 phase loop replaces. The other
accelerators are ``ops/packet.py`` and ``ops/bvh.py``
(``intersect.accel_mode``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

INF = float("inf")

# visit slots selected per phase (the JAX package's CRT_RAYV default)
VISIT_BLOCK = 16
# sub-tile width and visit slots per phase (CRT_SUBC, CRT_RAYV_SUB defaults)
SUBTILE_C = 32
VISIT_BLOCK_SUB = 24
# lanes of one packed sub-tile row in the JAX package (P = LANES / CS)
LANES = 128


def visit_block() -> int:
    """Visit slots a phase: ``CRT_RAYV`` (default ``VISIT_BLOCK``)."""
    return int(os.environ.get("CRT_RAYV", str(VISIT_BLOCK)))


def subtile_c() -> int:
    """Sub-tile width ``CRT_SUBC`` (default ``SUBTILE_C``)."""
    cs = int(os.environ.get("CRT_SUBC", str(SUBTILE_C)))
    if cs < 1:
        raise ValueError(f"CRT_SUBC must be a positive width, got {cs}")
    return cs


def route(C: int, planar: bool) -> str:
    """The sweep a table of chunk width C takes: "q16" (``CRT_SWEEP_Q16=1``,
    planar only), "subtile" (``CRT_SUBTILE=1`` and ``CRT_SUBC`` divides C),
    else "chunk" (``perray.py:336-341, 443-444`` of the JAX package)."""
    if planar and os.environ.get("CRT_SWEEP_Q16", "0") == "1":
        return "q16"
    if os.environ.get("CRT_SUBTILE", "0") == "1" and C % subtile_c() == 0:
        return "subtile"
    return "chunk"


def subtile_v(KG: int, CS: int) -> int:
    """Slots a sub-tile phase selects: a multiple of P = 128/CS
    (``perray.py:667-670``)."""
    P = max(1, LANES // CS)
    vs = int(os.environ.get("CRT_RAYV_SUB", str(VISIT_BLOCK_SUB)))
    return min(-(-vs // P) * P, -(-KG // P) * P)


# closest-hit calls, the phases they ran, and the rays each phase walked
# boxes for, summed over calls (live[0]: every ray, in phase 1)
PHASES = {"calls": 0, "phases": 0, "live": []}


def reset_phases() -> None:
    PHASES["calls"] = 0
    PHASES["phases"] = 0
    PHASES["live"] = []


@dataclass(frozen=True)
class SubTileTables:
    """The sub-tile route's tables at width CS (``PerRayTables.subtile``)."""
    table: torch.Tensor   # [K*G, F, CS] sub-tile rows
    boxes: torch.Tensor   # [8, KGp] sub-tile AABB pack
    CS: int


@dataclass(frozen=True)
class Q16Tables:
    """The quantized-row route's tables (``planar_q16``)."""
    words: torch.Tensor   # [K, 5, C] int32: two u16 coordinates a word
    lo: torch.Tensor      # [K, 3] the chunk boxes' lo
    scale: torch.Tensor   # [K, 3] extent / 65535


@dataclass(frozen=True)
class PerRayTables:
    """What the kernels read of one chunked table, built once per scene;
    the opt-in routes' tables are built from ``chunks`` at their first use
    and kept here."""
    table: torch.Tensor   # [K, F, C] sweep rows (fused_sweep layout)
    boxes: torch.Tensor   # [8, Kp] chunk AABB pack (fused_select layout)
    chunks: object = field(default=None, repr=False, compare=False)
    modes: dict = field(default_factory=dict, repr=False, compare=False)

    def subtile(self, CS: int) -> SubTileTables:
        if CS not in self.modes:
            lo, hi = subtile_bounds(self.chunks, CS)
            self.modes[CS] = SubTileTables(table=subtile_rows(self.table, CS),
                                           boxes=fs.pack_boxes(lo, hi), CS=CS)
        return self.modes[CS]

    def q16(self) -> Q16Tables:
        if "q16" not in self.modes:
            self.modes["q16"] = planar_q16(self.chunks)
        return self.modes["q16"]


def planar_tables(chunks: ch.PlanarChunks) -> PerRayTables:
    """[K, 9, C] rows of corner, eu, ev components. ``active`` is baked in
    (inactive lanes get eu = ev = 0, so d.n == 0 and the plane test fails)
    and mat is not swept: the winner's is recovered once (_recover_mat)."""
    act = chunks.active[..., None]
    eu = torch.where(act, chunks.eu, torch.zeros_like(chunks.eu))
    ev = torch.where(act, chunks.ev, torch.zeros_like(chunks.ev))
    table = torch.cat([chunks.corner, eu, ev], dim=2).transpose(1, 2)
    return PerRayTables(table=table.contiguous(),
                        boxes=fs.pack_boxes(chunks.lo, chunks.hi), chunks=chunks)


def sphere_tables(chunks: ch.SphereChunks) -> PerRayTables:
    """[K, 7, C] rows of c0, c1 components and rad. Inactive lanes get
    rad = 0, whose discriminant is never positive (Cauchy-Schwarz)."""
    rad = torch.where(chunks.active, chunks.rad, torch.zeros_like(chunks.rad))
    table = torch.cat([chunks.c0, chunks.c1, rad[..., None]], dim=2)
    return PerRayTables(table=table.transpose(1, 2).contiguous(),
                        boxes=fs.pack_boxes(chunks.lo, chunks.hi), chunks=chunks)


def subtile_bounds(chunks, CS: int):
    """([K*G, 3] lo, hi) of each chunk's CS-lane slices, inactive lanes
    left out (``_subtile_bounds_planar`` / ``_sphere``, ``perray.py:509-536``):
    planar boxes take the four corners with the +-1e-4 pad of the build,
    spheres both centers +- rad."""
    K, C = chunks.mat.shape
    G = C // CS
    act = chunks.active.bool()[..., None]
    inf = torch.full((), INF, dtype=torch.float32, device=act.device)
    if isinstance(chunks, ch.SphereChunks):
        rad = torch.where(chunks.active.bool(), chunks.rad,
                          torch.zeros_like(chunks.rad))[..., None]
        lane_lo = torch.where(act, torch.minimum(chunks.c0, chunks.c1) - rad, inf)
        lane_hi = torch.where(act, torch.maximum(chunks.c0, chunks.c1) + rad, -inf)
    else:
        eu = torch.where(act, chunks.eu, torch.zeros_like(chunks.eu))
        ev = torch.where(act, chunks.ev, torch.zeros_like(chunks.ev))
        c = chunks.corner
        pts = torch.stack([c, c + eu, c + ev, c + eu + ev])
        lane_lo = torch.where(act, pts.amin(0) - 1e-4, inf)
        lane_hi = torch.where(act, pts.amax(0) + 1e-4, -inf)
    lo = lane_lo.reshape(K, G, CS, 3).amin(dim=2).reshape(K * G, 3)
    hi = lane_hi.reshape(K, G, CS, 3).amax(dim=2).reshape(K * G, 3)
    return lo, hi


def subtile_rows(table, CS: int) -> torch.Tensor:
    """[K, F, C] sweep rows -> [K*G, F, CS] sub-tile rows (``_table_sub``,
    ``perray.py:539-543``): sub-tile k*G + g holds lanes g*CS .. g*CS+CS-1
    of chunk k."""
    K, F, C = table.shape
    G = C // CS
    return (table.reshape(K, F, G, CS).permute(0, 2, 1, 3)
            .reshape(K * G, F, CS).contiguous())


def planar_q16(chunks: ch.PlanarChunks) -> Q16Tables:
    """The quantized rows (``_planar_table_q16``, ``perray.py:744-783``):
    corner, corner + eu and corner + ev as u16 coordinates in the chunk
    box's frame, round(p - lo) / scale) half to even and clipped to
    [0, 65535], packed two a word (high, low): (q0x, q0y), (q0z, q1x),
    (q1y, q1z), (q2x, q2y), (q2z, 0). Inactive lanes quantize all three
    points alike, so their edges are exactly zero and the plane test's
    |d.n| guard rejects them."""
    lo, hi = chunks.lo, chunks.hi
    ext = torch.clamp(hi - lo, min=1e-20)
    scale = ext / 65535.0
    # a true division (a Python scalar over a tensor is its reciprocal times
    # the scalar in PyTorch)
    inv = torch.full_like(ext, 65535.0) / ext
    act = chunks.active.bool()[..., None]
    p0 = chunks.corner
    p1 = p0 + torch.where(act, chunks.eu, torch.zeros_like(chunks.eu))
    p2 = p0 + torch.where(act, chunks.ev, torch.zeros_like(chunks.ev))

    def q(p):
        u = torch.clamp(torch.round((p - lo[:, None, :]) * inv[:, None, :]), 0.0,
                        65535.0)
        return u.to(torch.int64)

    q0, q1, q2 = q(p0), q(p1), q(p2)
    pairs = [(q0[..., 0], q0[..., 1]), (q0[..., 2], q1[..., 0]),
             (q1[..., 1], q1[..., 2]), (q2[..., 0], q2[..., 1]),
             (q2[..., 2], torch.zeros_like(q2[..., 2]))]
    words = torch.stack([(a << 16) | b for a, b in pairs], dim=1)   # [K, 5, C]
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return Q16Tables(words=words.to(torch.int32).contiguous(), lo=lo.contiguous(),
                     scale=scale.contiguous())


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
        with trace.span("crt.intersect.select"):
            ids, nears, rest = fs.cull_select(rays, tabs.boxes, excl, V, K_real,
                                              float(tmin))
        with trace.span("crt.intersect.sweep"):
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


def _routed(org, dirs, cap, tabs, K, tmin, V, rays, best0, planar, triangle):
    """The phase loop on the route ``route`` picks for the table: (boxes
    and rows of) the chunk route (K3 + K4), the sub-tile route (K3 on the
    sub-tile boxes + K7) or the quantized-row route (K3 + K8)."""
    C = tabs.table.shape[2]
    mode = route(C, planar)
    if mode == "subtile":
        sub = tabs.subtile(subtile_c())
        KG = sub.table.shape[0]
        V_sub = subtile_v(KG, sub.CS)
        return _phase_loop(
            org, dirs, cap, sub, KG, tmin, V_sub,
            lambda ids, nears, b: fsw.sweep_sub(rays, ids, nears, b, sub.table,
                                                float(tmin), triangle, not planar),
            best0)
    if mode == "q16":
        q = tabs.q16()
        sweep = (lambda ids, nears, b: fsw.sweep_q16(rays, ids, nears, b, q.words, q.lo,
                                                     q.scale, float(tmin), triangle))
    else:
        sweep = (lambda ids, nears, b: fsw.sweep(rays, ids, nears, b, tabs.table,
                                                 float(tmin), triangle, not planar))
    return _phase_loop(org, dirs, cap, tabs, K, tmin, min(V, K), sweep, best0)


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
    best = _routed(org, dirs, cap, tabs, K, tmin, V, rays, best0, True, triangle)
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
    best = _routed(org, dirs, cap, tabs, K, tmin, V, rays, best0, False, False)
    t, ctr, rad, _, p = fsw.unpack_best_sphere(best)
    hit = t < cap
    return torch.where(hit, t, torch.full_like(t, INF)), (
        ctr, rad, _recover_mat(chunks.mat, p, hit), p)


class PlanarClosestRay(torch.autograd.Function):
    """The phase loop forward (on the route ``route`` picks), the winner
    replay's VJP backward on the exact f32 chunks (``perray.py:901-923`` of
    the JAX package)."""

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
    """The phase loop forward (on the route ``route`` picks), the winner
    replay's VJP backward on the exact f32 chunks (``perray.py:926-948`` of
    the JAX package)."""

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
                          triangle: bool, tmax=INF, V: int | None = None,
                          tabs: PerRayTables | None = None):
    """Drop-in for ``chunked.planar_closest`` (exact, but for the opt-in
    quantized rows; differentiable through ``PlanarClosestRay`` when an
    input needs a gradient).

    ``tmax``: scalar or per-ray [R] cap (no gradient); ``V``: visit slots a
    phase of the chunk and quantized routes (default ``visit_block()``);
    ``tabs``: the scene's cached ``planar_tables(chunks)``. Returns (t [R],
    (unorm [R,3], u [R], v [R], mat [R], pid [R]))."""
    V = visit_block() if V is None else V
    if tbl.needs_grad(org, dirs, chunks.corner, chunks.eu, chunks.ev):
        t, n, u, v, mat, pid = PlanarClosestRay.apply(
            org, dirs, chunks.corner, chunks.eu, chunks.ev, chunks, tmin,
            triangle, tmax, V, tabs)
        return t, (n, u, v, mat, pid)
    with torch.no_grad():
        return _planar_forward(org, dirs, chunks, tmin, triangle, tmax, V, tabs)


def sphere_closest_perray(org, dirs, time, chunks: ch.SphereChunks, tmin,
                          tmax=INF, V: int | None = None,
                          tabs: PerRayTables | None = None):
    """Drop-in for ``chunked.sphere_closest`` (exact; differentiable through
    ``SphereClosestRay``). Returns (t [R], (center_at_t [R,3], rad [R],
    mat [R], pid [R]))."""
    V = visit_block() if V is None else V
    if tbl.needs_grad(org, dirs, time, chunks.c0, chunks.c1, chunks.rad):
        t, ctr, rad, mat, pid = SphereClosestRay.apply(
            org, dirs, time, chunks.c0, chunks.c1, chunks.rad, chunks, tmin,
            tmax, V, tabs)
        return t, (ctr, rad, mat, pid)
    with torch.no_grad():
        return _sphere_forward(org, dirs, time, chunks, tmin, tmax, V, tabs)
