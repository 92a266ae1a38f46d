"""Batched ray-primitive intersection over the scene tables.

Port of ``cpu_ray_tracing_implementation_tpu/ops/intersect.py``. Each
primitive type present in the scene is intersected by one closest-hit
call, then the nearest type wins per ray and its shading attributes are
merged into one ``Hit``:

- a dense table (at most ``chunked.DENSE_MAX`` rows) by one fused call on
  its 1-chunk view (``ops/fused_intersect.py``: kernel K1 for quads and
  triangles, K2 for spheres; the plain chunk scan on CPU tensors);
- a chunked table by the accelerator ``CRT_ACCEL`` names (``accel_mode``,
  default ``auto``: a table of at least ``RAY_MIN_CHUNKS`` chunks takes
  ``ray``, a smaller one ``packet``, ``intersect.py:45-64`` of the JAX
  package), each ray capped at its exit from the scene's AABB:
  ``ray`` the per-ray visit lists (``ops/perray.py``: kernels K3 and K4),
  ``packet`` the tile-packet cull (``ops/packet.py``: kernel K6), ``bvh``
  the per-ray BVH traversal oracle (``ops/bvh.py``, plain PyTorch, where
  the scene has a tree), and ``pallas`` / ``chunked`` the chunk scan over
  the whole table (K1 / K2 on the card, the plain scan on CPU tensors).

On the packet route a large batch is coherence-sorted first
(``_sort_wanted``, ``ops/raysort.py``) and its results scattered back to
the caller's lane order. Every route is differentiable: the fused
wrappers and the accelerators are ``torch.autograd.Function``s (chunk-scan
VJP and winner replay). ``sphere_shading`` / ``quad_shading`` /
``tri_shading`` give the differentiable hit of one known winner per ray,
for ``ops/replay.py``.
Per-vertex triangle attributes (``scene.tri_attrs``) are interpolated at
the payload's barycentric (a, b) through the winner's pid: K1's pid
output on a dense table, the accelerator's (K4's, K6's) on a chunked one.

Constant-density volumes (``volume_sample``) are sampled against the
closest surface of every table, as the reference's ``constant_medium``
(src/volumne.h): box, sphere and triangle-mesh boundaries.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import bvh
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import packet, perray, raysort
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.sampling import PI

INF = float("inf")
BIG = 1e30

# auto: tables with at least this many chunks take the per-ray accelerator,
# smaller ones the tile-packet cull (the JAX package's threshold, measured
# on its chip: intersect.py:57-61)
RAY_MIN_CHUNKS = 256


def accel_mode() -> str:
    """The chunked tables' accelerator (``CRT_ACCEL``, read per call):
    ``auto`` (by table size, ``_auto_mode``), ``ray``, ``packet``, ``bvh``,
    ``pallas`` or ``chunked``."""
    return os.environ.get("CRT_ACCEL", "auto")


def _auto_mode(n_chunks: int) -> str:
    return "ray" if n_chunks >= RAY_MIN_CHUNKS else "packet"


def _chunk_counts(scene) -> list:
    return [int(c.mat.shape[0]) for c in
            (scene.sphere_chunks, scene.quad_chunks, scene.tri_chunks) if c is not None]


def _mode(n_chunks: int) -> str:
    mode = accel_mode()
    return _auto_mode(n_chunks) if mode == "auto" else mode


@dataclass(frozen=True)
class Hit:
    valid: torch.Tensor   # [R] bool
    t: torch.Tensor       # [R]
    p: torch.Tensor       # [R,3]
    normal: torch.Tensor  # [R,3] face-forward unit normal
    front: torch.Tensor   # [R] bool (dot(ray_dir, outward_normal) < 0)
    u: torch.Tensor       # [R]
    v: torch.Tensor       # [R]
    mat: torch.Tensor     # [R] int32


def sphere_uv(n: torch.Tensor):
    """Spherical UV from the unit outward normal (src/sphere.h:90-95).

    AD-safe, as the JAX package's ``intersect.py:141-161``: arccos has an
    infinite derivative at +-1 and atan2 no partials at (0, 0). Geometry
    gradients reach this on lanes that a later select masks, and a masked
    lane's zero cotangent times an infinite partial is NaN, which the
    table's scatter-add then spreads. The guarded branches substitute
    constants, so the values are unchanged (arccos(+-1) and atan2(0, 0) + pi
    come out exactly)."""
    y = torch.clamp(-n[..., 1], -1.0, 1.0)
    mid = torch.abs(y) < 1.0
    theta = torch.where(mid, torch.arccos(torch.where(mid, y, torch.zeros_like(y))),
                        torch.where(y >= 1.0, torch.zeros_like(y),
                                    torch.full_like(y, PI)))
    nz, nx = -n[..., 2], n[..., 0]
    # atan2 of (+-0, +-0) is defined as 0 here, as in the JAX package
    deg = (nz == 0.0) & (nx == 0.0)
    phi = torch.where(deg, torch.zeros_like(nz),
                      torch.atan2(torch.where(deg, torch.zeros_like(nz), nz),
                                  torch.where(deg, torch.ones_like(nx), nx))) + PI
    return phi / (2.0 * PI), theta / PI


def sphere_shading(org, dirs, time, sph, idx, t):
    """(p, normal, front, u, v, mat) of sphere ``idx[r]`` hit by ray r at
    ``t[r]``, differentiable (``intersect.py:164-184``). The outward normal
    uses the time-lerped center."""
    c0 = tbl.take_rows(sph.c0, idx)
    c1 = tbl.take_rows(sph.c1, idx)
    center = c0 + time[:, None] * (c1 - c0)
    rad = tbl.take_rows(sph.rad, idx)
    p = org + t[:, None] * dirs
    # 1e-12, not 1e-20: the division's backward squares the denominator,
    # and (1e-20)^2 underflows to 0 in f32 on lanes whose gathered radius is
    # 0 (another type won), giving 0/0 = NaN; real radii are far larger
    outward = (p - center) / torch.clamp(rad, min=1e-12)[:, None]
    front = vm.dot(dirs, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    u, v = sphere_uv(outward)
    return p, normal, front, u, v, tbl.take_rows(sph.mat, idx)


def quad_shading(org, dirs, qds, idx, t):
    """(p, normal, front, u, v, mat) of quad ``idx[r]`` at ``t[r]``
    (``intersect.py:244-259``), differentiable."""
    corner = tbl.take_rows(qds.corner, idx)
    eu = tbl.take_rows(qds.eu, idx)
    ev = tbl.take_rows(qds.ev, idx)
    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    p = org + t[:, None] * dirs
    q = p - corner
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    u = vm.dot(w, vm.cross(q, ev))
    v = vm.dot(w, vm.cross(eu, q))
    front = vm.dot(dirs, unorm) < 0.0
    normal = torch.where(front[:, None], unorm, -unorm)
    return p, normal, front, u, v, tbl.take_rows(qds.mat, idx)


def tri_shading(org, dirs, tri, idx, t, attrs=None):
    """(p, normal, front, u, v, mat) of triangle ``idx[r]`` at ``t[r]``,
    differentiable (``intersect.py:271-298``). Without ``attrs``: the flat
    geometric normal and no UV, as the reference (src/triangle.h:27-40);
    with ``attrs`` (``scene.TriAttrs``, rows indexed by ``idx``): the
    attributes interpolated at the hit's barycentric (a, b)."""
    v0 = tbl.take_rows(tri.v0, idx)
    e1 = tbl.take_rows(tri.v1, idx) - v0
    e2 = tbl.take_rows(tri.v2, idx) - v0
    outward = vm.normalize(vm.cross(e1, e2))
    p = org + t[:, None] * dirs
    front = vm.dot(dirs, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    mat = tbl.take_rows(tri.mat, idx)
    if attrs is None:
        zero = torch.zeros_like(t)
        return p, normal, front, zero, zero, mat
    # (a, b) by the edge-coefficient construction of the plane test:
    # a = q.(ev x w), b = q.(w x eu), q = p - v0
    n = vm.cross(e1, e2)
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    q = p - v0
    a = vm.dot(q, vm.cross(e2, w))
    b = vm.dot(q, vm.cross(w, e1))
    normal, u, v = interpolate_tri_attrs(attrs, idx, a, b, normal)
    return p, normal, front, u, v, mat


def interpolate_tri_attrs(attrs, pid, a, b, geo_normal):
    """(normal, u, v) from per-vertex attributes at barycentric (a, b)
    (``intersect.py:300-320``). The smooth normal is flipped into the
    hemisphere of the face-forwarded geometric normal, so back faces shade
    consistently; a triangle without normals keeps the geometric one.
    ``normalize`` is safe at zero, so a degenerate blend (or a row of
    zeros under a lane another type won) gives no NaN to a gradient."""
    w0 = (1.0 - a - b)[:, None]
    ns = vm.normalize(w0 * tbl.take_rows(attrs.n0, pid)
                      + a[:, None] * tbl.take_rows(attrs.n1, pid)
                      + b[:, None] * tbl.take_rows(attrs.n2, pid))
    ns = torch.where(vm.dot(ns, geo_normal)[:, None] < 0.0, -ns, ns)
    normal = torch.where(tbl.take_rows(attrs.smooth, pid)[:, None], ns, geo_normal)
    uv = (w0 * tbl.take_rows(attrs.uv0, pid)
          + a[:, None] * tbl.take_rows(attrs.uv1, pid)
          + b[:, None] * tbl.take_rows(attrs.uv2, pid))
    return normal, uv[:, 0], uv[:, 1]


def _finite_or_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def mesh_span(org, dirs, vols):
    """([R, V] entry, [R, V] exit): the least and the greatest t at which
    each ray's whole line (t in [-BIG, BIG]) crosses each mesh volume's
    boundary triangles, BIG and -BIG where it crosses none (the JAX
    package's ``_planar_ts`` with ``triangle=True`` and its [R, V, MT]
    ownership reduction, ``intersect.py:364-379``). Computed in slices of
    rays, so that the [rays, V, MT] intermediate stays ~16 M elements at a
    boundary of the Fox's size."""
    v0, e1, e2 = vols.mesh_v0, vols.mesh_e1, vols.mesh_e2
    n = vm.cross(e1, e2)
    unorm = vm.normalize(n)
    d_plane = vm.dot(unorm, v0)
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    evw = vm.cross(e2, w)
    weu = vm.cross(w, e1)
    c_a, c_b = vm.dot(v0, evw), vm.dot(v0, weu)
    n_v, n_t = int(vols.kind.shape[0]), int(v0.shape[0])
    own = vols.mesh_vid[None, :] == torch.arange(
        n_v, device=org.device, dtype=torch.int32)[:, None]          # [V,MT]
    step = max(1, (1 << 24) // (n_v * n_t))
    t1s, t2s = [], []
    for s in range(0, org.shape[0], step):
        o, d = org[s:s + step], dirs[s:s + step]
        d_n = vm.outer_dot(d, unorm)
        hit_plane = torch.abs(d_n) > 1e-20
        t = torch.where(hit_plane, (d_plane[None, :] - vm.outer_dot(o, unorm))
                        / torch.where(hit_plane, d_n, torch.ones_like(d_n)),
                        torch.full_like(d_n, BIG))
        a = vm.outer_dot(o, evw) + t * vm.outer_dot(d, evw) - c_a[None, :]
        b = vm.outer_dot(o, weu) + t * vm.outer_dot(d, weu) - c_b[None, :]
        ok = (hit_plane & (t >= -BIG) & (t <= BIG) & (a >= 0.0) & (b >= 0.0)
              & (a + b <= 1.0) & vols.mesh_active[None, :])
        sel = own[None] & ok[:, None, :]                              # [r,V,MT]
        t3 = t[:, None, :]
        t1s.append(torch.amin(torch.where(sel, t3, torch.full_like(t3, BIG)), dim=-1))
        t2s.append(torch.amax(torch.where(sel, t3, torch.full_like(t3, -BIG)), dim=-1))
    return (t1s[0], t2s[0]) if len(t1s) == 1 else (torch.cat(t1s), torch.cat(t2s))


def volume_sample(org, dirs, vols, tmin, t_surface, u_vol):
    """Stochastic volume hits clipped by the closest surface (src/volumne.h,
    ``intersect.py:324-400`` of the JAX package). Returns (t_v [R], vidx
    [R], valid [R]); ``u_vol`` is [R, V] uniforms, one per volume."""
    # the ray in each volume's object frame (row vector times object->world)
    rel = org[:, None, :] - vols.center[None, :, :]      # [R,V,3]
    ol = torch.einsum("rvk,vkl->rvl", rel, vols.rot)
    dl = torch.einsum("rk,vkl->rvl", dirs, vols.rot)

    # entry and exit of the whole line (negative t allowed: the reference
    # probes with interval::universe first, src/volumne.h:21-22); box: a
    # slab test against [-half, half]
    half = vols.half[None]
    ok = torch.abs(dl) > 1e-12
    dl_safe = torch.where(ok, dl, torch.ones_like(dl))
    inside = torch.abs(ol) <= half
    big = torch.full_like(dl, BIG)
    lo = torch.where(ok, (-half - ol) / dl_safe, torch.where(inside, -big, big))
    hi = torch.where(ok, (half - ol) / dl_safe, torch.where(inside, big, -big))
    t1 = torch.amax(torch.minimum(lo, hi), dim=-1)
    t2 = torch.amin(torch.maximum(lo, hi), dim=-1)

    # sphere: the quadratic's two roots
    a = vm.dot(dirs, dirs)[:, None]
    b = 2.0 * vm.dot(dirs[:, None, :], rel)
    c = vm.dot(rel, rel) - (vols.half[..., 0] ** 2)[None, :]
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    big = torch.full_like(disc, BIG)
    t1_sph = torch.where(has, (-b - sq) / (2.0 * a), big)
    t2_sph = torch.where(has, (-b + sq) / (2.0 * a), -big)
    is_box = (vols.kind == 0)[None, :]
    t1 = torch.where(is_box, t1, t1_sph)
    t2 = torch.where(is_box, t2, t2_sph)

    # mesh: [min t, max t] over the volume's boundary triangles along the
    # whole line, exact for closed convex boundaries (the reference's own
    # assumption)
    if vols.mesh_v0 is not None:
        t1_mesh, t2_mesh = mesh_span(org, dirs, vols)
        is_mesh = (vols.kind == 2)[None, :]
        t1 = torch.where(is_mesh, t1_mesh, t1)
        t2 = torch.where(is_mesh, t2_mesh, t2)

    # clamp to [tmin, closest surface] (src/volumne.h:25-29)
    t1c = torch.clamp(t1, min=tmin)
    t2c = torch.minimum(t2, t_surface[:, None])
    span_ok = (t1c < t2c) & vols.active[None, :]
    dlen = vm.length(dirs)[:, None]
    dist_inside = (t2c - t1c) * dlen
    # -log(U)/rho scatter distance (src/volumne.h:36); U == 0 gives no hit
    hit_dist = vols.neg_inv_density[None, :] * torch.log(torch.clamp(u_vol, min=1e-38))
    vhit = span_ok & (hit_dist <= dist_inside)
    t_v = torch.where(vhit, t1c + hit_dist / dlen, torch.full_like(t1c, INF))
    t_best, vidx = torch.min(t_v, dim=-1)
    return t_best, vidx, torch.isfinite(t_best)


def _packet_cap(scene, org, dirs, active, tmax, tmin):
    """Per-ray traversal cap of the accelerators: a ray's closest hit cannot
    lie beyond its exit from the scene AABB, so miss rays stop there
    instead of riding t = inf through every chunk; terminated lanes
    (``active`` False) get cap = tmin and visit next to nothing. A pure
    bound: every true hit lies strictly inside it (intersect.py:433-451)."""
    cap = torch.broadcast_to(torch.as_tensor(tmax, dtype=org.dtype,
                                             device=org.device), org.shape[:1])
    if scene.world_lo is not None:
        lo = org.new_tensor(scene.world_lo)
        hi = org.new_tensor(scene.world_hi)
        inv = 1.0 / torch.where(torch.abs(dirs) > 1e-20, dirs,
                                torch.full_like(dirs, 1e-20))
        t0 = (lo[None, :] - org) * inv
        t1 = (hi[None, :] - org) * inv
        far = torch.amin(torch.maximum(t0, t1), dim=-1)
        cap = torch.minimum(torch.clamp(far, min=tmin) * 1.0001 + 1e-3, cap)
    if active is not None:
        cap = torch.where(active, cap, torch.full_like(cap, tmin))
    return cap.detach()


def _sort_wanted(scene, n_rays: int) -> bool:
    """Coherence-sort the batch before intersecting? (``intersect.py:403-431``
    of the JAX package.) ``CRT_SORT=off`` never, ``on`` for any chunked
    scene; ``auto``: not on the per-ray route (its visit lists share nothing
    across a tile), else once the scene has ``raysort.MIN_CHUNKS`` chunks
    and the batch ``raysort.MIN_RAYS`` rays."""
    mode = os.environ.get("CRT_SORT", "auto")
    if mode == "off" or scene.world_lo is None:
        return False
    kmax = max(_chunk_counts(scene), default=0)
    if mode == "on":
        return kmax > 0
    if _mode(kmax) == "ray":
        return False
    return kmax >= raysort.MIN_CHUNKS and n_rays >= raysort.MIN_RAYS


def intersect_brute(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                    active=None):
    """Closest hit across all primitive tables and volumes -> Hit.
    ``u_vol``: [R, V] volume uniforms; ``active``: optional [R] mask of the
    lanes whose result matters (the accelerators cap the others at tmin).

    Where ``_sort_wanted``, the lanes are intersected in coherence-sorted
    order (dead lanes last, whose tiles then visit nothing) and the results
    scattered back to the caller's order (``intersect.py:454-503`` of the
    JAX package)."""
    if not _sort_wanted(scene, org.shape[0]):
        return _intersect_core(scene, org, dirs, time, tmin, u_vol, tmax, active)
    keys = raysort.coherence_keys(org, dirs, org.new_tensor(scene.world_lo),
                                  org.new_tensor(scene.world_hi))
    if active is not None:
        keys = torch.where(active, keys, torch.full_like(keys, 0x40000000))
    tmax_arr = torch.is_tensor(tmax) and tmax.dim() == 1
    ins = [org, dirs, time, u_vol]
    if tmax_arr:
        ins.append(tmax)
    if active is not None:
        ins.append(active)
    s, lane_ids = raysort.sort_rays(keys, ins)
    h = _intersect_core(scene, s[0], s[1], s[2], tmin, s[3],
                        s[4] if tmax_arr else tmax,
                        s[-1] if active is not None else None)
    valid, t, p, normal, front, u, v, mat = raysort.unsort(
        lane_ids, [h.valid, h.t, h.p, h.normal, h.front, h.u, h.v, h.mat])
    return Hit(valid=valid, t=t, p=p, normal=normal, front=front, u=u, v=v, mat=mat)


def _intersect_core(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                    active=None):
    """Closest hit in the caller's lane order. ``scene.counts`` is static,
    so primitive types the scene does not contain are skipped."""
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]
    inf_t = torch.full((R,), INF, dtype=org.dtype, device=org.device)

    def capped():
        return _packet_cap(scene, org, dirs, active, tmax, tmin)

    def planar_path(fam: str, tri_flag: bool, with_pid: bool = False):
        """A chunked planar table through its accelerator
        (``intersect.py:526-600`` of the JAX package): (t, (unorm, u, v,
        mat, pid)); the chunk scan's pid only ``with_pid``."""
        chs = getattr(scene, f"{fam}_chunks")
        mode = _mode(int(chs.mat.shape[0]))
        if mode == "ray":
            return perray.planar_closest_perray(org, dirs, chs, tmin, tri_flag, capped(),
                                                tabs=getattr(scene, f"{fam}_perray"))
        if mode == "packet":
            return packet.planar_closest_packet(org, dirs, chs, tmin, tri_flag, capped(),
                                                pack=getattr(scene, f"{fam}_pack"))
        tree = getattr(scene, f"{fam}_tree")
        if mode == "bvh" and tree is not None:
            return bvh.planar_closest_bvh(org, dirs, chs, tree, tmin, tri_flag, tmax)
        return fi.planar_closest_fused(org, dirs, chs, tmin, tri_flag, tmax,
                                       pack=getattr(scene, f"{fam}_pack"),
                                       with_pid=with_pid)

    t_s = t_q = t_t = inf_t
    sph_payload = quad_payload = tri_payload = None
    if scene.sphere_chunks is not None:
        chs = scene.sphere_chunks
        mode = _mode(int(chs.mat.shape[0]))
        if mode == "ray":
            t_s, sph_payload = perray.sphere_closest_perray(
                org, dirs, time, chs, tmin, capped(), tabs=scene.sphere_perray)
        elif mode == "packet":
            t_s, sph_payload = packet.sphere_closest_packet(
                org, dirs, time, chs, tmin, capped(), pack=scene.sphere_pack)
        elif mode == "bvh" and scene.sphere_tree is not None:
            t_s, sph_payload = bvh.sphere_closest_bvh(org, dirs, time, chs,
                                                      scene.sphere_tree, tmin, tmax)
        else:
            t_s, sph_payload = fi.sphere_closest_fused(org, dirs, time, chs, tmin, tmax,
                                                       pack=scene.sphere_pack)
    elif n_sph:
        view, pack = scene.fused_view("sphere")
        t_s, sph_payload = fi.sphere_closest_fused(org, dirs, time, view,
                                                   tmin, tmax, pack=pack)
    if scene.quad_chunks is not None:
        t_q, quad_payload = planar_path("quad", False)
    elif n_quad:
        view, pack = scene.fused_view("quad")
        t_q, quad_payload = fi.planar_closest_fused(org, dirs, view, tmin,
                                                    False, tmax, pack=pack)
    if scene.tri_chunks is not None:
        # with attributes, the winner's pid names the row to interpolate
        t_t, tri_payload = planar_path("tri", True,
                                       with_pid=scene.tri_attrs is not None)
    elif n_tri:
        # with attributes, K1's pid output names the row to interpolate
        view, pack = scene.fused_view("tri")
        t_t, tri_payload = fi.planar_closest_fused(
            org, dirs, view, tmin, True, tmax, pack=pack,
            with_pid=scene.tri_attrs is not None)

    t_v = inf_t
    if n_vol:
        t_surface = torch.minimum(torch.minimum(t_s, t_q), t_t)
        t_v, i_v, _ = volume_sample(org, dirs, scene.volumes, tmin, t_surface, u_vol)
    t_all = torch.stack([t_s, t_q, t_t, t_v], dim=-1)     # [R,4]
    which = torch.argmin(t_all, dim=-1)           # 0 sph, 1 quad, 2 tri, 3 vol
    t = torch.amin(t_all, dim=-1)
    valid = torch.isfinite(t)

    p = org + _finite_or_zero(t)[:, None] * dirs
    normal = org.new_tensor([1.0, 0.0, 0.0]).expand(R, 3)
    front = torch.ones((R,), dtype=torch.bool, device=org.device)
    uu = torch.zeros((R,), dtype=org.dtype, device=org.device)
    vv = torch.zeros((R,), dtype=org.dtype, device=org.device)
    mat = torch.zeros((R,), dtype=torch.int32, device=org.device)

    def merge(cond, attrs):
        nonlocal normal, front, uu, vv, mat
        n_k, f_k, u_k, v_k, m_k = attrs
        normal = torch.where(cond[:, None], n_k, normal)
        front = torch.where(cond, f_k, front)
        uu = torch.where(cond, u_k, uu)
        vv = torch.where(cond, v_k, vv)
        mat = torch.where(cond, m_k, mat)

    def planar_attrs(payload, zero_uv, tri_attrs=None):
        """(normal, front, u, v, mat) from a planar payload; triangles
        carry no UV in the reference (src/triangle.h). ``tri_attrs``: the
        per-vertex attribute table, interpolated at the payload's
        barycentric (u, v) through the winner's pid (its last field); a
        miss's pid 0 is merged away below."""
        unorm, u_k, v_k, m_k = payload[:4]
        front_k = vm.dot(dirs, unorm) < 0.0
        normal_k = torch.where(front_k[:, None], unorm, -unorm)
        if tri_attrs is not None:
            normal_k, u_k, v_k = interpolate_tri_attrs(tri_attrs, payload[4], u_k,
                                                       v_k, normal_k)
        elif zero_uv:
            u_k = torch.zeros_like(u_k)
            v_k = torch.zeros_like(v_k)
        return normal_k, front_k, u_k, v_k, m_k

    if sph_payload is not None:
        center, rad_w, m_w = sph_payload[:3]
        pk = org + _finite_or_zero(t_s)[:, None] * dirs
        outward = (pk - center) / rad_w[:, None]
        front_k = vm.dot(dirs, outward) < 0.0
        normal_k = torch.where(front_k[:, None], outward, -outward)
        u_k, v_k = sphere_uv(outward)
        merge(which == 0, (normal_k, front_k, u_k, v_k, m_w))
    if quad_payload is not None:
        merge(which == 1, planar_attrs(quad_payload, zero_uv=False))
    if tri_payload is not None:
        merge(which == 2, planar_attrs(tri_payload, zero_uv=True,
                                       tri_attrs=scene.tri_attrs))
    if n_vol:
        # the volume record: an arbitrary normal and front face
        # (src/volumne.h:42-43), the medium's material
        mat = torch.where(which == 3, tbl.take_rows(scene.volumes.mat, i_v), mat)

    return Hit(valid=valid, t=t, p=p, normal=normal, front=front, u=uu,
               v=vv, mat=torch.where(valid, mat, torch.zeros_like(mat)))
