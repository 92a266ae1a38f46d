"""Tile-packet culled closest hit over chunked tables, and kernel K6.

Port of ``cpu_ray_tracing_implementation_tpu/ops/packet.py``: the
reference's per-ray BVH descent (src/bvh_node.h:49-58) restructured as
packet traversal at tile granularity. Rays go in coherent tiles of
``tile`` lanes (camera rays in pixel order, or coherence-sorted by
``ops/raysort.py``). Per tile:

 1. one cull computes, for every chunk, whether any ray's [tmin, cap]
    slab interval crosses the chunk AABB and the least entry t
    (``_chunk_hits``);
 2. the crossed chunks are visited front to back (a stable argsort of the
    entry t), and the tile stops once its nearest unvisited chunk starts
    beyond every ray's running best (each ray's per-ray cap bounds miss
    rays at their scene exit and dead lanes at tmin,
    ``intersect._packet_cap``).

On the card a tile is one thread block running its own loop: kernel K6
(``csrc/packet_closest.cu``), which has no Pallas counterpart (the JAX
route is XLA). On CPU tensors the wrappers take the plain version, the
per-tile loop of JAX's ``map`` schedule (``_planar_tile`` /
``_sphere_tile``). JAX's ``lockstep`` schedule (``CRT_PACKET``) is a TPU
schedule of the same function and has no meaning for a kernel that gives
each tile its own block; it is not ported.

``LAUNCHES`` counts K6's launches. Gradients: when an input needs one,
the drop-ins go through ``PlanarClosestPacket`` / ``SphereClosestPacket``,
whose backward replays each ray's winner in O(R)
(``replay.planar_chunks_winner`` / ``sphere_chunks_winner``), as the JAX
package's custom VJP does (``packet.py:376-426``); the cap carries no
gradient.
"""

from __future__ import annotations

import math
import os

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import perray
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

INF = float("inf")

# chunks a K6 launch takes (its shared chunk keys; csrc/packet_closest.cu)
MAX_CHUNKS = 4096
# The automatic tile (CRT_TILE overrides it): the fastest on an NVIDIA H100
# 80GB HBM3 at 700 W (utils/kernel_ab.py). K6 took, at tiles of 16, 32, 64,
# 128 and 256: 0.1830, 0.1210, 0.1494, 0.2948 and 0.3691 ms at
# sphereflake's 160,000 primary rays; 0.4380, 0.3607, 0.4417, 0.7202 and
# 0.9110 ms at the same rays after one bounce, coherence-sorted; 0.5348,
# 0.2903, 0.3047, 0.3402 and 0.4022 ms at perlin_texture_ball's 360,000
# primary rays. A tile's visits run one after another, so the longest tiles
# set the end; small tiles are short and cull more closely. The closest hit
# does not depend on the tile, but for exact ties between chunks.
AUTO_TILE = 32

# kernel launches, by kernel; each wrapper adds one where it launches
LAUNCHES = {"packet_planar": 0, "packet_sphere": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _default_tile() -> int:
    """Rays per packet: ``CRT_TILE`` (read per call), else ``AUTO_TILE``."""
    return int(os.environ.get("CRT_TILE", AUTO_TILE))


def _pad_tiles(arrs, R: int, tile: int) -> list:
    """Pad the leading dim to a tile multiple with zeros and reshape to
    [G, tile, ...] (one tile at least, so an empty batch gives empty
    results)."""
    g = max(1, (R + tile - 1) // tile)
    out = []
    for a in arrs:
        pad = g * tile - R
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                                          device=a.device)])
        out.append(a.reshape((g, tile) + tuple(a.shape[1:])))
    return out


def _chunk_hits(org, dirs, lo, hi, tmin, tmax):
    """(hit_any [K], near_min [K]) of one ray tile; ``tmax`` is the per-ray
    [T] traversal cap."""
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-20, dirs, torch.full_like(dirs, 1e-20))
    t0 = (lo[None, :, :] - org[:, None, :]) * inv[:, None, :]     # [T,K,3]
    t1 = (hi[None, :, :] - org[:, None, :]) * inv[:, None, :]
    near = torch.amax(torch.minimum(t0, t1), dim=-1)               # [T,K]
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    ok = (near <= far) & (far >= tmin) & (near <= tmax[:, None])
    near_c = torch.where(ok, torch.clamp(near, min=tmin), torch.full_like(near, INF))
    return ok.any(dim=0), torch.amin(near_c, dim=0)


def _visit_order(org, dirs, lo, hi, tmin, tmax):
    """(chunk ids nearest first, their entry t ascending; +inf: no chunk)."""
    hit_any, near_c = _chunk_hits(org, dirs, lo, hi, tmin, tmax)
    keyed = torch.where(hit_any, near_c, torch.full_like(near_c, INF))
    order = torch.argsort(keyed, stable=True)
    return order.tolist(), keyed[order].tolist()


def _live(near: float, t_best: torch.Tensor) -> bool:
    """The tile's loop condition: the next chunk may still beat some ray."""
    return math.isfinite(near) and near <= float(t_best.max())


def _planar_tile(org, dirs, chunks: ch.PlanarChunks, tmin, triangle, tmax):
    """Closest planar hit of one [T] ray tile (``tmax``: per-ray [T] cap).
    Returns (t, unorm, u, v, mat, pid, visited): ``visited`` the chunk ids
    the loop tested, in order."""
    T = org.shape[0]
    C = chunks.corner.shape[1]
    order, near = _visit_order(org, dirs, chunks.lo, chunks.hi, tmin, tmax)
    t_best = tmax
    n_b = torch.zeros((T, 3), dtype=org.dtype, device=org.device)
    u_b = torch.zeros((T,), dtype=org.dtype, device=org.device)
    v_b = torch.zeros_like(u_b)
    m_b = torch.zeros((T,), dtype=torch.int32, device=org.device)
    p_b = torch.zeros_like(m_b)
    visited = []
    for k, ns in zip(order, near):
        if not _live(ns, t_best):
            break
        visited.append(k)
        ts, a, b, unorm = ch._planar_chunk_ts(
            org, dirs, chunks.corner[k], chunks.eu[k], chunks.ev[k],
            chunks.active[k], tmin, t_best, triangle)
        t_c = torch.amin(ts, dim=-1)
        idx = torch.argmin(ts, dim=-1)
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        n_b = torch.where(better[:, None], torch.index_select(unorm, 0, idx), n_b)
        u_b = torch.where(better, a.gather(1, idx[:, None])[:, 0], u_b)
        v_b = torch.where(better, b.gather(1, idx[:, None])[:, 0], v_b)
        m_b = torch.where(better, chunks.mat[k][idx], m_b)
        p_b = torch.where(better, (k * C + idx).to(torch.int32), p_b)
    t = torch.where(t_best < tmax, t_best, torch.full_like(t_best, INF))
    return t, n_b, u_b, v_b, m_b, p_b, visited


def _sphere_tile(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax):
    """Closest sphere hit of one [T] ray tile (``tmax``: per-ray [T] cap).
    Returns (t, center_at_t, rad, mat, pid, visited)."""
    T = org.shape[0]
    C = chunks.rad.shape[1]
    order, near = _visit_order(org, dirs, chunks.lo, chunks.hi, tmin, tmax)
    t_best = tmax
    ctr_b = torch.zeros((T, 3), dtype=org.dtype, device=org.device)
    rad_b = torch.ones((T,), dtype=org.dtype, device=org.device)
    m_b = torch.zeros((T,), dtype=torch.int32, device=org.device)
    p_b = torch.zeros_like(m_b)
    visited = []
    for k, ns in zip(order, near):
        if not _live(ns, t_best):
            break
        visited.append(k)
        c0, c1, rad = chunks.c0[k], chunks.c1[k], chunks.rad[k]
        ts = ch._sphere_chunk_ts(org, dirs, time, c0, c1, rad, chunks.active[k],
                                 tmin, t_best)
        t_c = torch.amin(ts, dim=-1)
        idx = torch.argmin(ts, dim=-1)
        better = t_c < t_best
        c0_w = torch.index_select(c0, 0, idx)
        c1_w = torch.index_select(c1, 0, idx)
        ctr_c = c0_w + time[:, None] * (c1_w - c0_w)
        t_best = torch.where(better, t_c, t_best)
        ctr_b = torch.where(better[:, None], ctr_c, ctr_b)
        rad_b = torch.where(better, torch.clamp(torch.index_select(rad, 0, idx),
                                                min=1e-20), rad_b)
        m_b = torch.where(better, chunks.mat[k][idx], m_b)
        p_b = torch.where(better, (k * C + idx).to(torch.int32), p_b)
    t = torch.where(t_best < tmax, t_best, torch.full_like(t_best, INF))
    return t, ctr_b, rad_b, m_b, p_b, visited


# ----------------------------------------------------------- kernel calls
def _check(name: str, x: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, fn, rays, cap, pack, lo, hi, tmin, tile, *extra):
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad(fn, rays, cap, pack)
    if rays.dim() != 2 or pack.dim() != 3:
        raise ValueError("rays must be [8,R] and pack [K,16,C]")
    R = rays.shape[1]
    K, _, C = pack.shape
    _check("rays", rays, (8, R))
    _check("cap", cap, (R,))
    _check("pack", pack, (K, fi.NROWS, C))
    _check("lo", lo, (K, 3))
    _check("hi", hi, (K, 3))
    if len({x.device for x in (rays, cap, pack, lo, hi)}) != 1:
        raise ValueError("the kernel's inputs lie on different devices")
    if not 1 <= K <= MAX_CHUNKS:
        raise ValueError(f"K6 takes 1 to {MAX_CHUNKS} chunks (its shared-memory "
                         f"sort), got {K}")
    tile = int(tile)
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    out = torch.empty((8, R), dtype=torch.float32, device=rays.device)
    pid = torch.empty((R,), dtype=torch.int32, device=rays.device)
    visits = torch.empty(((R + tile - 1) // tile,), dtype=torch.int32,
                         device=rays.device)
    lib = build.load()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = getattr(lib, fn)(rays.data_ptr(), cap.data_ptr(), R, pack.data_ptr(),
                               lo.data_ptr(), hi.data_ptr(), K, C, float(tmin), tile,
                               *extra, out.data_ptr(), pid.data_ptr(),
                               visits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {build.error_string(err)}")
    LAUNCHES[name] += 1
    return out, pid, visits


def kernel_info(kind: str, tile: int, K: int) -> dict:
    """What a K6 launch of ``kind`` ("quad", "tri" or "sphere") at this tile
    and chunk count takes on the card: registers per thread (as ``ptxas``
    counts them), threads per block, rays per thread, threads per ray and
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    info = (ctypes.c_int * 5)()
    err = build.load().crt_packet_info(("quad", "tri", "sphere").index(kind), int(tile),
                                       int(K), info)
    if err != 0:
        raise RuntimeError(f"crt_packet_info failed: {build.error_string(err)}")
    return dict(zip(("registers", "threads", "rays_per_thread", "threads_per_ray",
                     "blocks_per_sm"), info))


def packet_planar_kernel(rays, cap, pack, lo, hi, tmin: float, tile: int,
                         triangle: bool):
    """Kernel K6, planar: (hit rows [8,R] as K1's, pid [R] int32, chunks
    visited per tile [G] int32) of rays [8,R] with caps [R] against the
    [K,16,C] pack and chunk boxes lo, hi [K,3], in tiles of ``tile``."""
    return _launch("packet_planar", "crt_packet_planar", rays, cap, pack, lo, hi,
                   tmin, tile, int(bool(triangle)))


def packet_sphere_kernel(rays, cap, pack, lo, hi, tmin: float, tile: int):
    """Kernel K6, spheres: (hit rows [8,R] as K2's, pid [R], visits [G])."""
    return _launch("packet_sphere", "crt_packet_sphere", rays, cap, pack, lo, hi,
                   tmin, tile)


def planar_packet_plain(org, dirs, chunks: ch.PlanarChunks, tmin, triangle: bool,
                        tmax=INF, tile: int | None = None):
    """K6's plain version, planar, on any device: (t [R], (unorm, u, v, mat,
    pid), each tile's list of the chunk ids it visited). No graph."""
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    with torch.no_grad():
        (t, n, u, v, m, p), visited = _tiled(
            lambda o, d, c: _planar_tile(o, d, chunks, tmin, triangle, c),
            [org, dirs, perray._cap(org, tmax)], R, tile)
    return t, (n, u, v, m, p), visited


def sphere_packet_plain(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax=INF,
                        tile: int | None = None):
    """K6's plain version, spheres: (t [R], (center_at_t, rad, mat, pid),
    each tile's visit list). No graph."""
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    with torch.no_grad():
        (t, ctr, rad, m, p), visited = _tiled(
            lambda o, d, tm, c: _sphere_tile(o, d, tm, chunks, tmin, c),
            [org, dirs, time, perray._cap(org, tmax)], R, tile)
    return t, (ctr, rad, m, p), visited


def _tiled(fn, arrs, R, tile):
    """The plain version: ``fn`` over each tile of the padded arrays, the
    results flattened back to [R]; also the visit list of each tile."""
    outs, visited = [], []
    for xs in zip(*_pad_tiles(arrs, R, tile)):
        *res, vis = fn(*xs)
        outs.append(res)
        visited.append(vis)
    return [torch.cat(parts)[:R] for parts in zip(*outs)], visited


def planar_packet_hit(org, dirs, chunks: ch.PlanarChunks, tmin, triangle: bool,
                      tmax=INF, tile: int | None = None, pack=None):
    """(t [R], (unorm, u, v, mat, pid), visited): K6 on CUDA tensors (``visited``
    the [G] count of chunks each tile visited), the plain per-tile loop on
    CPU tensors (``visited`` each tile's list of chunk ids). No graph."""
    if not fi._on_card(org):
        return planar_packet_plain(org, dirs, chunks, tmin, triangle, tmax, tile)
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    cap = perray._cap(org, tmax)
    with torch.no_grad():
        if pack is None:
            pack = fi.pack_prim_constants(chunks)
        out, pid, visits = packet_planar_kernel(
            fi.pack_rays(org, dirs), cap, pack, chunks.lo.contiguous(),
            chunks.hi.contiguous(), tmin, tile, triangle)
        t = torch.where(out[fi.OUT_VALID] > 0.5, out[fi.OUT_T],
                        torch.full_like(out[fi.OUT_T], INF))
        mat = torch.round(out[fi.OUT_MAT]).to(torch.int32)
        return t, (out[fi.OUT_NX:fi.OUT_NZ + 1].T, out[fi.OUT_U], out[fi.OUT_V], mat,
                   pid), visits


def sphere_packet_hit(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax=INF,
                      tile: int | None = None, pack=None):
    """(t [R], (center_at_t, rad, mat, pid), visited) of K6 or, on CPU
    tensors, of the plain per-tile loop (see ``planar_packet_hit``)."""
    if not fi._on_card(org):
        return sphere_packet_plain(org, dirs, time, chunks, tmin, tmax, tile)
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    cap = perray._cap(org, tmax)
    with torch.no_grad():
        if pack is None:
            pack = fi.pack_sphere_constants(chunks)
        out, pid, visits = packet_sphere_kernel(
            fi.pack_rays(org, dirs, time), cap, pack, chunks.lo.contiguous(),
            chunks.hi.contiguous(), tmin, tile)
        t = torch.where(out[fi.SOUT_VALID] > 0.5, out[fi.SOUT_T],
                        torch.full_like(out[fi.SOUT_T], INF))
        mat = torch.round(out[fi.SOUT_MAT]).to(torch.int32)
        return t, (out[fi.SOUT_CX:fi.SOUT_CZ + 1].T, out[fi.SOUT_RAD], mat, pid), visits


class PlanarClosestPacket(torch.autograd.Function):
    """The packet forward, the winner replay's VJP backward
    (``packet.py:376-400`` of the JAX package)."""

    @staticmethod
    def forward(ctx, org, dirs, corner, eu, ev, chunks, tmin, triangle, tmax, tile,
                pack):
        t, (n, u, v, mat, pid), _ = planar_packet_hit(org, dirs, chunks, tmin, triangle,
                                                      tmax, tile, pack)
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
            t, (n, u, v, _, _) = replay.planar_chunks_winner(xs[0], xs[1], chunks, pid)
            grads = tbl.vjp((t, n, u, v), xs, (g_t, g_n, g_u, g_v))
        return (*grads, None, None, None, None, None, None)


class SphereClosestPacket(torch.autograd.Function):
    """The packet forward, the winner replay's VJP backward
    (``packet.py:403-426`` of the JAX package)."""

    @staticmethod
    def forward(ctx, org, dirs, time, c0, c1, rad, chunks, tmin, tmax, tile, pack):
        t, (ctr, r, mat, pid), _ = sphere_packet_hit(org, dirs, time, chunks, tmin,
                                                     tmax, tile, pack)
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
            t, (ctr, r, _, _) = replay.sphere_chunks_winner(xs[0], xs[1], xs[2], chunks,
                                                            pid, tmin)
            grads = tbl.vjp((t, ctr, r), xs, (g_t, g_ctr, g_rad))
        return (*grads, None, None, None, None, None)


def planar_closest_packet(org, dirs, chunks: ch.PlanarChunks, tmin, triangle: bool,
                          tmax=INF, tile: int | None = None, pack=None):
    """Drop-in for ``chunked.planar_closest``: K6 on CUDA tensors, the plain
    per-tile loop on CPU tensors; differentiable through
    ``PlanarClosestPacket`` when an input needs a gradient.

    ``tmax``: scalar or per-ray [R] cap (no gradient); ``pack``: the
    scene's cached ``fused_intersect.pack_prim_constants(chunks)``. Returns
    (t [R], (unorm [R,3], u [R], v [R], mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, chunks.corner, chunks.eu, chunks.ev):
        t, n, u, v, mat, pid = PlanarClosestPacket.apply(
            org, dirs, chunks.corner, chunks.eu, chunks.ev, chunks, tmin, triangle,
            tmax, tile, pack)
        return t, (n, u, v, mat, pid)
    return planar_packet_hit(org, dirs, chunks, tmin, triangle, tmax, tile, pack)[:2]


def sphere_closest_packet(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax=INF,
                          tile: int | None = None, pack=None):
    """Drop-in for ``chunked.sphere_closest`` (K6 / the plain per-tile loop;
    differentiable through ``SphereClosestPacket``). Returns (t [R],
    (center_at_t [R,3], rad [R], mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, time, chunks.c0, chunks.c1, chunks.rad):
        t, ctr, rad, mat, pid = SphereClosestPacket.apply(
            org, dirs, time, chunks.c0, chunks.c1, chunks.rad, chunks, tmin, tmax,
            tile, pack)
        return t, (ctr, rad, mat, pid)
    return sphere_packet_hit(org, dirs, time, chunks, tmin, tmax, tile, pack)[:2]
