"""Winner replay: the intersection of the gradient path.

Port of ``cpu_ray_tracing_implementation_tpu/ops/replay.py``. Intersection
splits into

 1. ``winner_pack``, the decision: one int32 per lane, the winner's type
    in the top bits and its dense row index below (-1 = miss). On the card
    kernels K1 and K2 decide and write the winner's lane index (their pid
    output); on the CPU the plain chunk scan does. Both work on the dense
    tables' 1-chunk views, which pad after row N, so a view's lane index
    is the dense row index. No graph.
 2. ``replay_hit``, the value: gather the winning primitive's parameters
    and re-intersect just that one, differentiably, in O(R).

min/argmin route gradients to the winning primitive only, so replaying the
winner gives the same derivative as differentiating the whole sweep. The
values differ from the forward render's in ulps (the replay's direct
|o - c|^2 form, the shading functions' own u, v), so the gradient path
uses it and the forward render does not.

``Tape`` keeps the decisions of a render (one [R] int32 per sample and
bounce) so that a second pass can replay them with autograd on and launch
no kernel: the port's counterpart of the JAX package's per-sample
``jax.checkpoint`` saving only these ids (``integrator.py:391-415``).

``planar_chunks_winner`` / ``sphere_chunks_winner`` are the per-winner
forms of the chunk scan that the per-ray accelerator's backward
differentiates (``ops/perray.py``); a chunked table's per-vertex
attributes are interpolated at the replayed (a, b) through the same pid
(``intersect._intersect_core``), so their gradient reaches the geometry
through it. A volume winner replays its entry
point and the -ln(U)/rho distance (``_volume_t_one``); the decision,
which volume scattered the ray before any surface, is part of the saved
id. Under next-event estimation a bounce intersects twice (the path's ray,
then the shadow ray), and the tape keeps both decisions in that order.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

INF = float("inf")

TYPE_SPH, TYPE_QUAD, TYPE_TRI, TYPE_VOL = 0, 1, 2, 3
_SHIFT = 28
_IDX_MASK = (1 << _SHIFT) - 1


def supported(scene) -> bool:
    """Replay covers dense scene tables; a scene with a chunked table takes
    the accelerator's own replay backward (``ops/perray.py``) instead."""
    return (scene.sphere_chunks is None and scene.quad_chunks is None
            and scene.tri_chunks is None)


def winner_pack(scene, org, dirs, time, tmin, u_vol, tmax=INF) -> torch.Tensor:
    """[R] int32: (type << 28) | dense row index of the closest hit, -1 on a
    miss. First index wins a tie, within a table and across types; a
    volume wins where its sampled scatter lies before every surface."""
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]
    with torch.no_grad():
        inf_t = torch.full((R,), INF, dtype=org.dtype, device=org.device)
        zero_i = torch.zeros((R,), dtype=torch.int32, device=org.device)
        t_s = t_q = t_t = inf_t
        i_s = i_q = i_t = zero_i
        if n_sph:
            view, pack = scene.sphere_view
            t_s, i_s = fi.sphere_winner(org, dirs, time, view, tmin, tmax, pack)
        if n_quad:
            view, pack = scene.quad_view
            t_q, i_q = fi.planar_winner(org, dirs, view, tmin, False, tmax, pack)
        if n_tri:
            view, pack = scene.tri_view
            t_t, i_t = fi.planar_winner(org, dirs, view, tmin, True, tmax, pack)
        t_v, i_v = inf_t, zero_i
        if n_vol:
            t_surface = torch.minimum(torch.minimum(t_s, t_q), t_t)
            t_v, i_v, _ = isect.volume_sample(org, dirs, scene.volumes, tmin,
                                              t_surface, u_vol)
            i_v = i_v.to(torch.int32)
        t_all = torch.stack([t_s, t_q, t_t, t_v], dim=-1)
        which = torch.argmin(t_all, dim=-1).to(torch.int32)
        idx = torch.stack([i_s, i_q, i_t, i_v], dim=-1).gather(
            1, which[:, None].long())[:, 0]
        packed = (which << _SHIFT) | idx
        hit = torch.isfinite(torch.amin(t_all, dim=-1))
        return torch.where(hit, packed, torch.full_like(packed, -1))


def _sphere_t_one(org, dirs, time, sph, idx, tmin, tmax):
    """[R] t of ray r against sphere idx[r]: the src/sphere.h:40-74
    quadratic with the time-lerped center, in the direct |o - c|^2 form."""
    c0 = tbl.take_rows(sph.c0, idx)
    c1 = tbl.take_rows(sph.c1, idx)
    rad = tbl.take_rows(sph.rad, idx)
    oc = org - (c0 + time[:, None] * (c1 - c0))
    # a dead lane's zero-length direction makes 1/2a infinite in the
    # backward, and its zero cotangent times that is NaN in every geometry
    # gradient; live lanes have |d| ~ 1, where the clamp changes nothing
    a = torch.clamp(vm.dot(dirs, dirs), min=1e-20)
    b = 2.0 * vm.dot(dirs, oc)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    inf = torch.full_like(t0, INF)
    t = torch.where((t0 >= tmin) & (t0 <= tmax), t0,
                    torch.where((t1 >= tmin) & (t1 <= tmax), t1, inf))
    return torch.where(has, t, inf)


def _planar_t_one(org, dirs, corner, eu, ev, idx):
    """[R] plane-equation t of ray r against planar primitive idx[r]
    (src/quad.h:36-44; the interior test is part of the saved decision)."""
    c = tbl.take_rows(corner, idx)
    unorm = vm.normalize(vm.cross(tbl.take_rows(eu, idx), tbl.take_rows(ev, idx)))
    d_n = vm.dot(dirs, unorm)
    ok = torch.abs(d_n) > 1e-20
    return torch.where(ok, vm.dot(c - org, unorm)
                       / torch.where(ok, d_n, torch.ones_like(d_n)),
                       torch.full_like(d_n, INF))


def _volume_t_one(org, dirs, vols, idx, u_vol, tmin):
    """[R] scatter t of ray r inside volume idx[r]: the boundary's entry,
    then the -ln(U)/rho distance (src/volumne.h:25-36;
    ``replay.py:148-190`` of the JAX package). Whether the exit clamp cut
    the span is part of the saved decision; the value needs only the entry.
    A mesh volume's entry is the least t over its own boundary triangles,
    as ``intersect.volume_sample`` has it (``intersect.mesh_span``). The JAX
    package's replay takes the sphere branch for a mesh row (a unit sphere
    about the centroid, ROADMAP F6); the port does not copy that."""
    center = tbl.take_rows(vols.center, idx)
    half = tbl.take_rows(vols.half, idx)
    kind = tbl.take_rows(vols.kind, idx)
    nid = tbl.take_rows(vols.neg_inv_density, idx)
    rot = tbl.take_rows(vols.rot.reshape(-1, 9), idx).reshape(-1, 3, 3)

    rel = org - center
    ol = torch.einsum("rk,rkl->rl", rel, rot)
    dl = torch.einsum("rk,rkl->rl", dirs, rot)
    ok = torch.abs(dl) > 1e-12
    dl_safe = torch.where(ok, dl, torch.ones_like(dl))
    inside = torch.abs(ol) <= half
    big = torch.full_like(dl, isect.BIG)
    lo = torch.where(ok, (-half - ol) / dl_safe, torch.where(inside, -big, big))
    hi = torch.where(ok, (half - ol) / dl_safe, torch.where(inside, big, -big))
    t1_box = torch.amax(torch.minimum(lo, hi), dim=-1)

    a = vm.dot(dirs, dirs)
    b = 2.0 * vm.dot(dirs, rel)
    c = vm.dot(rel, rel) - half[:, 0] ** 2
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t1_sph = torch.where(has, (-b - sq) / (2.0 * a), torch.full_like(disc, isect.BIG))

    t1 = torch.where(kind == 0, t1_box, t1_sph)
    if vols.mesh_v0 is not None:
        t1_mesh = isect.mesh_span(org, dirs, vols)[0].gather(1, idx[:, None].long())[:, 0]
        t1 = torch.where(kind == 2, t1_mesh, t1)
    t1c = torch.clamp(t1, min=tmin)
    u_w = u_vol.gather(1, idx[:, None].long())[:, 0]
    # the floor stays a normal float32: log(0) = -inf would make the
    # non-volume lanes' 0 * -inf a NaN (``replay.py:189`` of the JAX package)
    hit_dist = nid * torch.log(torch.clamp(u_w, min=1e-30))
    return t1c + hit_dist / torch.clamp(vm.length(dirs), min=1e-20)


def replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax=INF) -> isect.Hit:
    """Differentiable Hit from the packed winner ids: O(R) gathers and one
    re-intersection per lane, no [R, N] intermediate."""
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]
    valid = packed >= 0
    safe = torch.where(valid, packed, torch.zeros_like(packed))
    which = safe >> _SHIFT
    idx = (safe & _IDX_MASK).long()

    def rows(cond):
        """The winner's row on the type's lanes, row 0 elsewhere: an index
        of another type's table can lie past this one's end."""
        return torch.where(cond, idx, torch.zeros_like(idx))

    t = torch.zeros((R,), dtype=org.dtype, device=org.device)
    normal = org.new_tensor([1.0, 0.0, 0.0]).expand(R, 3)
    front = torch.ones((R,), dtype=torch.bool, device=org.device)
    uu = torch.zeros((R,), dtype=org.dtype, device=org.device)
    vv = torch.zeros((R,), dtype=org.dtype, device=org.device)
    mat = torch.zeros((R,), dtype=torch.int32, device=org.device)

    def merge_t(cond, t_k):
        """Winner-masked t. Lanes another type won are zeroed outright, not
        only de-inf'd: their replayed t can be a finite sentinel near 1e30,
        and t * dirs would overflow p to inf in this type's shading, where
        inf - inf = NaN poisons the geometry gradients."""
        nonlocal t
        t_k = torch.where(cond & torch.isfinite(t_k), t_k, torch.zeros_like(t_k))
        t = torch.where(cond, t_k, t)
        return t_k

    def merge(cond, attrs):
        nonlocal normal, front, uu, vv, mat
        _, n_k, f_k, u_k, v_k, m_k = attrs
        normal = torch.where(cond[:, None], n_k, normal)
        front = torch.where(cond, f_k, front)
        uu = torch.where(cond, u_k, uu)
        vv = torch.where(cond, v_k, vv)
        mat = torch.where(cond, m_k, mat)

    if n_sph:
        cond = valid & (which == TYPE_SPH)
        i_k = rows(cond)
        t_m = merge_t(cond, _sphere_t_one(org, dirs, time, scene.spheres, i_k,
                                          tmin, tmax))
        merge(cond, isect.sphere_shading(org, dirs, time, scene.spheres, i_k, t_m))
    if n_quad:
        cond = valid & (which == TYPE_QUAD)
        i_k = rows(cond)
        q = scene.quads
        t_m = merge_t(cond, _planar_t_one(org, dirs, q.corner, q.eu, q.ev, i_k))
        merge(cond, isect.quad_shading(org, dirs, q, i_k, t_m))
    if n_tri:
        cond = valid & (which == TYPE_TRI)
        i_k = rows(cond)
        tr = scene.tris
        t_m = merge_t(cond, _planar_t_one(org, dirs, tr.v0, tr.v1 - tr.v0,
                                          tr.v2 - tr.v0, i_k))
        merge(cond, isect.tri_shading(org, dirs, tr, i_k, t_m,
                                      attrs=scene.tri_attrs))
    if n_vol:
        cond = valid & (which == TYPE_VOL)
        i_k = rows(cond)
        merge_t(cond, _volume_t_one(org, dirs, scene.volumes, i_k, u_vol, tmin))
        # the volume record: an arbitrary normal and front face
        # (src/volumne.h:42-43)
        mat = torch.where(cond, tbl.take_rows(scene.volumes.mat, i_k), mat)

    p = org + t[:, None] * dirs
    return isect.Hit(valid=valid, t=torch.where(valid, t, torch.full_like(t, INF)),
                     p=p, normal=normal, front=front, u=uu, v=vv,
                     mat=torch.where(valid, mat, torch.zeros_like(mat)))


# ------------------------------------------------- chunked-table replay VJPs
def planar_chunks_winner(org, dirs, chunks, pid):
    """Differentiable (t, (unorm [R,3], a [R], b [R], mat [R], pid [R])) of
    chunk-order primitive ``pid[r]`` against ray r: the per-winner form of
    ``chunked._planar_chunk_ts`` (the same guards and sentinels; the
    interior and range tests are part of the saved decision)."""
    K, C = chunks.corner.shape[:2]
    corner = tbl.take_rows(chunks.corner.reshape(K * C, 3), pid)
    eu = tbl.take_rows(chunks.eu.reshape(K * C, 3), pid)
    ev = tbl.take_rows(chunks.ev.reshape(K * C, 3), pid)
    mat = tbl.take_rows(chunks.mat.reshape(K * C), pid)

    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    d_n = vm.dot(dirs, unorm)
    ok = torch.abs(d_n) > 1e-20
    t = torch.where(ok, vm.dot(corner - org, unorm)
                    / torch.where(ok, d_n, torch.ones_like(d_n)),
                    torch.full_like(d_n, 1e30))
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)
    q = org + t[:, None] * dirs - corner
    a = torch.clamp(vm.dot(q, evw), -1e30, 1e30)
    b = torch.clamp(vm.dot(q, weu), -1e30, 1e30)
    return t, (unorm, a, b, mat, pid)


def sphere_chunks_winner(org, dirs, time, chunks, pid, tmin):
    """Differentiable (t, (center_at_t [R,3], rad [R], mat [R], pid [R]))
    of chunk-order sphere ``pid[r]``. The winner's root is t0 when t0 >=
    tmin, else t1 (a winner with t0 in range always took t0)."""
    K, C = chunks.rad.shape
    c0 = tbl.take_rows(chunks.c0.reshape(K * C, 3), pid)
    c1 = tbl.take_rows(chunks.c1.reshape(K * C, 3), pid)
    rad = tbl.take_rows(chunks.rad.reshape(K * C), pid)
    mat = tbl.take_rows(chunks.mat.reshape(K * C), pid)

    center = c0 + time[:, None] * (c1 - c0)
    oc = org - center
    a = torch.clamp(vm.dot(dirs, dirs), min=1e-20)
    b = 2.0 * vm.dot(dirs, oc)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    t = torch.where(t0 >= tmin, t0, t1)
    # 1e-12: (1e-20)^2 underflows to 0 in f32 in the division's backward
    return t, (center, torch.clamp(rad, min=1e-12), mat, pid)


def intersect_replay(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                     active=None) -> isect.Hit:
    """Drop-in for ``ops.intersect.intersect_brute`` on the gradient path:
    the kernels' decision and the differentiable replay of each winner.
    ``active`` only caps the accelerators' traversal and is unused here."""
    del active
    packed = winner_pack(scene, org, dirs, time, tmin, u_vol, tmax)
    return replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax)


class Tape:
    """The winner ids of a replay render, in the order it intersects.

    ``record`` is an intersector (the signature of ``intersect_replay``)
    that decides with the kernels and keeps each bounce's ids; ``play``
    replays them in the same order, launching no kernel. A render that
    records and one that plays back with the same scene, camera, key and
    sample order compute the same values."""

    def __init__(self):
        self._ids: list = []
        self._next = 0

    def __len__(self) -> int:
        return len(self._ids)

    def record(self, scene, org, dirs, time, tmin, u_vol, tmax=INF, active=None):
        del active
        packed = winner_pack(scene, org, dirs, time, tmin, u_vol, tmax)
        self._ids.append(packed)
        return replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax)

    def play(self, scene, org, dirs, time, tmin, u_vol, tmax=INF, active=None):
        del active
        if self._next >= len(self._ids):
            raise IndexError("the tape holds no more winner ids: the play-back "
                             "render intersects more often than the recording")
        packed = self._ids[self._next]
        self._ids[self._next] = None  # each bounce is played once
        self._next += 1
        return replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax)
