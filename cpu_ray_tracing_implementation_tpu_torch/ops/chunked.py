"""Chunk-scan closest hit: the plain PyTorch versions of kernels K1 and K2.

Port of ``cpu_ray_tracing_implementation_tpu/ops/chunked.py:39-256``. The
primitive table is cut into K chunks of C primitives; a loop over chunks
intersects every ray with one chunk as dense [R,C] tensors, keeps the
running closest hit, and skips a chunk whose AABB no ray can reach.

``planar_closest`` and ``sphere_closest`` are what ``ops/fused_intersect``
runs for CPU tensors, and what the CUDA kernels in ``csrc/closest_hit.cu``
are compared against on the card. They are also the oracle that the
per-ray accelerator (``ops/perray.py``) is held to. Their backward (plain
autograd) is the VJP of the fused wrappers, and ``rechunk_*`` re-derives
chunked tables from dense ones for geometry gradients.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

INF = float("inf")

# primitives per chunk of a chunked table
CHUNK = 128
# tables at or below this stay on the dense single-pass path
DENSE_MAX = 512


@dataclass(frozen=True)
class PlanarChunks:
    """[K,C,...] chunk-major quad/triangle tables + chunk AABBs."""
    corner: torch.Tensor  # [K,C,3]
    eu: torch.Tensor      # [K,C,3]
    ev: torch.Tensor      # [K,C,3]
    mat: torch.Tensor     # [K,C] int32
    active: torch.Tensor  # [K,C] bool
    lo: torch.Tensor      # [K,3]
    hi: torch.Tensor      # [K,3]


@dataclass(frozen=True)
class SphereChunks:
    c0: torch.Tensor      # [K,C,3]
    c1: torch.Tensor      # [K,C,3]
    rad: torch.Tensor     # [K,C]
    mat: torch.Tensor     # [K,C] int32
    active: torch.Tensor  # [K,C] bool
    lo: torch.Tensor      # [K,3]
    hi: torch.Tensor      # [K,3]


def _chunk_cull(org, dirs, lo, hi, tmin, t_best) -> bool:
    """True if ANY ray's [tmin, t_best] interval crosses the chunk AABB."""
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-20, dirs,
                            torch.full_like(dirs, 1e-20))
    t0 = (lo[None, :] - org) * inv
    t1 = (hi[None, :] - org) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    ok = (near <= far) & (far >= tmin) & (near <= t_best)
    return bool(torch.any(ok))


def _planar_chunk_ts(org, dirs, corner, eu, ev, active, tmin, tmax, triangle):
    """[R,C] t for one chunk (inf = miss), the edge coefficients a, b, and
    the per-primitive unit normals; per-ray tmax (the running closest hit)."""
    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    d_plane = vm.dot(unorm, corner)
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)

    o_n = vm.outer_dot(org, unorm)
    d_n = vm.outer_dot(dirs, unorm)
    ok0 = torch.abs(d_n) > 1e-20
    # finite sentinel, as in the JAX package
    t = torch.where(ok0, (d_plane[None, :] - o_n)
                    / torch.where(ok0, d_n, torch.ones_like(d_n)),
                    torch.full_like(d_n, 1e30))
    # clip: the 1e30 sentinel times a sliver primitive's edge constant can
    # overflow to inf
    a = torch.clamp(vm.outer_dot(org, evw) + t * vm.outer_dot(dirs, evw)
                    - vm.dot(corner, evw)[None, :], -1e30, 1e30)
    b = torch.clamp(vm.outer_dot(org, weu) + t * vm.outer_dot(dirs, weu)
                    - vm.dot(corner, weu)[None, :], -1e30, 1e30)
    if triangle:
        interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    else:
        interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    ok = (ok0 & (t >= tmin) & (t <= tmax[:, None]) & interior
          & active[None, :])
    return torch.where(ok, t, torch.full_like(t, INF)), a, b, unorm


def _live_width(active: torch.Tensor) -> int:
    """Columns up to the last one active in any chunk. Padding sits at the
    tail of a table, so the columns past it hold no primitive that can hit,
    and skipping them leaves every result and index unchanged."""
    cols = torch.nonzero(active.any(dim=0))
    return int(cols.max()) + 1 if cols.numel() else 0


def _t_init(org, tmax) -> torch.Tensor:
    R = org.shape[0]
    tmax = torch.as_tensor(tmax, dtype=org.dtype, device=org.device)
    return torch.minimum(torch.full((R,), INF, dtype=org.dtype,
                                    device=org.device), tmax)


def planar_closest(org, dirs, chunks: PlanarChunks, tmin, triangle: bool,
                   tmax=INF):
    """Closest hit over all chunks, within [tmin, tmax].

    Returns (t [R], payload) with payload = (unorm [R,3], u [R], v [R],
    mat [R], pid [R]) of the winning primitive (zeros when t == inf);
    ``pid`` is the chunk-order primitive index (chunk*C + lane). Ties go to
    the first index, as ``jnp.argmin`` does.
    """
    R = org.shape[0]
    dev = org.device
    C = chunks.corner.shape[1]
    w = _live_width(chunks.active)
    t_init = _t_init(org, tmax)
    t_best = t_init
    n_b = torch.zeros((R, 3), dtype=org.dtype, device=dev)
    u_b = torch.zeros((R,), dtype=org.dtype, device=dev)
    v_b = torch.zeros((R,), dtype=org.dtype, device=dev)
    m_b = torch.zeros((R,), dtype=torch.int32, device=dev)
    p_b = torch.zeros((R,), dtype=torch.int32, device=dev)
    for k in range(chunks.corner.shape[0] if w else 0):
        if not _chunk_cull(org, dirs, chunks.lo[k], chunks.hi[k], tmin, t_best):
            continue
        ts, a, b, unorm = _planar_chunk_ts(
            org, dirs, chunks.corner[k, :w], chunks.eu[k, :w],
            chunks.ev[k, :w], chunks.active[k, :w], tmin, t_best, triangle)
        t_c = torch.amin(ts, dim=-1)
        idx = torch.argmin(ts, dim=-1)
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        n_b = torch.where(better[:, None], torch.index_select(unorm, 0, idx), n_b)
        u_b = torch.where(better, a.gather(1, idx[:, None])[:, 0], u_b)
        v_b = torch.where(better, b.gather(1, idx[:, None])[:, 0], v_b)
        m_b = torch.where(better, chunks.mat[k, :w][idx], m_b)
        p_b = torch.where(better, (k * C + idx).to(torch.int32), p_b)
    t = torch.where(t_best < t_init, t_best, torch.full_like(t_best, INF))
    return t, (n_b, u_b, v_b, m_b, p_b)


def _dot_ltr(a, b):
    """[R,3] x [R,3] -> [R], summed in a fixed order (torch.sum's order is
    its own, and differs between devices)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _sphere_chunk_ts(org, dirs, time, c0, c1, rad, active, tmin, tmax):
    """[R,C] t for one sphere chunk, with the moving center
    c0 + time * (c1 - c0) expanded into per-sphere constants."""
    dc = c1 - c0
    d_c = vm.outer_dot(dirs, c0) + time[:, None] * vm.outer_dot(dirs, dc)
    o_c = vm.outer_dot(org, c0) + time[:, None] * vm.outer_dot(org, dc)
    c0c0 = vm.dot(c0, c0)
    c0dc = vm.dot(c0, dc)
    dcdc = vm.dot(dc, dc)
    cc = (c0c0[None, :] + 2.0 * time[:, None] * c0dc[None, :]
          + (time * time)[:, None] * dcdc[None, :])
    # the ray-only terms are summed left to right, as kernel K2 sums them:
    # a grazing ray's root moves far with the last bit of |o|^2
    a = _dot_ltr(dirs, dirs)[:, None]
    oo = _dot_ltr(org, org)[:, None]
    b = 2.0 * (_dot_ltr(dirs, org)[:, None] - d_c)
    c = oo - 2.0 * o_c + cc - (rad * rad)[None, :]
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    in0 = (t0 >= tmin) & (t0 <= tmax[:, None])
    in1 = (t1 >= tmin) & (t1 <= tmax[:, None])
    inf = torch.full_like(t0, INF)
    t = torch.where(in0, t0, torch.where(in1, t1, inf))
    return torch.where(has & active[None, :], t, inf)


def sphere_closest(org, dirs, time, chunks: SphereChunks, tmin, tmax=INF):
    """Closest sphere hit over all chunks, within [tmin, tmax].

    Returns (t [R], payload) with payload = (center_at_t [R,3], rad [R],
    mat [R], pid [R])."""
    R = org.shape[0]
    dev = org.device
    C = chunks.rad.shape[1]
    w = _live_width(chunks.active)
    t_init = _t_init(org, tmax)
    t_best = t_init
    ctr_b = torch.zeros((R, 3), dtype=org.dtype, device=dev)
    rad_b = torch.ones((R,), dtype=org.dtype, device=dev)
    m_b = torch.zeros((R,), dtype=torch.int32, device=dev)
    p_b = torch.zeros((R,), dtype=torch.int32, device=dev)
    for k in range(chunks.rad.shape[0] if w else 0):
        if not _chunk_cull(org, dirs, chunks.lo[k], chunks.hi[k], tmin, t_best):
            continue
        c0, c1, rad = chunks.c0[k, :w], chunks.c1[k, :w], chunks.rad[k, :w]
        ts = _sphere_chunk_ts(org, dirs, time, c0, c1, rad,
                              chunks.active[k, :w], tmin, t_best)
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
        m_b = torch.where(better, chunks.mat[k, :w][idx], m_b)
        p_b = torch.where(better, (k * C + idx).to(torch.int32), p_b)
    t = torch.where(t_best < t_init, t_best, torch.full_like(t_best, INF))
    return t, (ctr_b, rad_b, m_b, p_b)


# ---------------- differentiable re-chunk (geometry gradients at scale)
# The chunk tables are a build-time gather of the dense tables into BVH
# order (models/scene.py _chunk_tables). Re-deriving them from the dense
# tables in the graph (chunked.py:245-304 of the JAX package) makes a
# chunked render differentiable in the dense geometry: the gather's
# backward scatter-adds the winner replay's chunk gradients onto the dense
# rows. The chunk AABBs follow the geometry but carry no gradient: they only
# cull, and the replay never differentiates the visit selection.

def _chunk_shape(a, K: int, C: int, order) -> torch.Tensor:
    """Gather dense rows into chunk-major [K,C,...] (zero-padded tail)."""
    n = order.shape[0]
    g = torch.index_select(a, 0, order)
    pad = K * C - n
    if pad:
        g = torch.cat([g, torch.zeros((pad,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=a.device)])
    return g.reshape((K, C) + tuple(a.shape[1:]))


def _bounds_from_lanes(lo_lane, hi_lane, active):
    """[K,3] chunk AABBs from per-lane primitive bounds; inactive lanes give
    the build's inverted-box convention (accel.chunk_bounds). Detached."""
    act = active[..., None]
    lo = torch.where(act, lo_lane, torch.full_like(lo_lane, INF)).amin(dim=1)
    hi = torch.where(act, hi_lane, torch.full_like(hi_lane, -INF)).amax(dim=1)
    return lo.detach(), hi.detach()


def rechunk_planar(chunks: PlanarChunks, corner, eu, ev, order) -> PlanarChunks:
    """PlanarChunks re-derived from dense (corner, eu, ev) tables through
    the build-time BVH order: the build's values when the dense tables are
    unchanged, differentiable otherwise. mat and active stay the build's
    (the order is fixed at build time)."""
    K, C = chunks.mat.shape
    ck = _chunk_shape(corner, K, C, order)
    euk = _chunk_shape(eu, K, C, order)
    evk = _chunk_shape(ev, K, C, order)
    pts = torch.stack([ck, ck + euk, ck + evk, ck + euk + evk])
    lo, hi = _bounds_from_lanes(pts.amin(dim=0) - 1e-4, pts.amax(dim=0) + 1e-4,
                                chunks.active)
    return dataclasses.replace(chunks, corner=ck, eu=euk, ev=evk, lo=lo, hi=hi)


def rechunk_sphere(chunks: SphereChunks, c0, c1, rad, order) -> SphereChunks:
    K, C = chunks.mat.shape
    c0k = _chunk_shape(c0, K, C, order)
    c1k = _chunk_shape(c1, K, C, order)
    rk = _chunk_shape(rad, K, C, order)
    lo, hi = _bounds_from_lanes(torch.minimum(c0k, c1k) - rk[..., None],
                                torch.maximum(c0k, c1k) + rk[..., None],
                                chunks.active)
    return dataclasses.replace(chunks, c0=c0k, c1=c1k, rad=rk, lo=lo, hi=hi)
