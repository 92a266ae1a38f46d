"""Per-ray stackless BVH traversal: the ``CRT_ACCEL=bvh`` oracle.

Port of ``cpu_ray_tracing_implementation_tpu/ops/bvh.py``, the batched
form of the reference's recursive BVH descent (src/bvh_node.h:49-58 with
the slab test of src/aabb.h:28-33). The tree is threaded with hit and
miss links (``utils/accel.threaded_links``), so a ray's traversal state
is one node index:

    next = aabb_hit ? hit_link[node] : miss_link[node]

Every step gathers each ray's node row and, at a leaf, its <= max_leaf
primitive rows, and tests them; the closest hit so far bounds the slab
test (near <= t_best). The loop runs on the host until every ray has
reached the sentinel: one synchronisation per step. It is an oracle and
an option, not a default route: the JAX package measured it ~4x slower
than the chunk scan on its chip, and it stays plain PyTorch here, as the
XLA code it mirrors is.

Primitive rows follow the kernels' constant packs (``fused_intersect``'s
``ROW_*`` for planar, ``SROW_*`` for spheres), in BVH depth-first order,
the chunk tables' order, with the global chunk-order index in the spare
row ``ROW_PID``. A leaf's test sums its products left to right, as the
chunk scan does, so a hit's t is bitwise the plain chunk scan's (and on
spheres kernel K2's). Gradients: the traversal decides and gives the values;
the backward is autograd through the plain chunk scan on the same
primitives (``PlanarClosestBVH`` / ``SphereClosestBVH``,
``bvh.py:297-344`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.utils import accel

INF = float("inf")
BIG = 1e30

# node pack rows ([N,16] float32; ints exact below 2^24)
NODE_LO = 0       # 0:3 aabb lo
NODE_HI = 3       # 3:6 aabb hi
NODE_HIT = 6      # hit link
NODE_MISS = 7     # miss link
NODE_FIRST = 8    # leaf: first primitive row in prim_pack
NODE_COUNT = 9    # leaf: primitive count (0 = internal)
NODE_ROWS = 16

# the spare prim-pack row that carries the global (chunk-order) primitive
# index; both constant layouts leave rows 14-15 unused
ROW_PID = 14


@dataclass(frozen=True)
class BVHTree:
    """Threaded BVH and flat primitive constants, both row-gatherable.
    ``prim_pack`` rows are in the chunk tables' order, so ``leaf_first``
    indexes both."""
    node_pack: torch.Tensor  # [N, 16] f32
    prim_pack: torch.Tensor  # [P + max_leaf, 16] f32 (tail rows inactive)
    max_leaf: int = 8


def _prim_rows(prim_pack: torch.Tensor, max_leaf: int) -> torch.Tensor:
    """The flat pack with its pid row set and ``max_leaf`` inactive rows
    appended (a leaf's last gathers may run past the table)."""
    rows = prim_pack.detach().clone()
    rows[:, ROW_PID] = torch.arange(rows.shape[0], dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, rows.new_zeros((max_leaf, rows.shape[1]))])


def build_tree(nodes: np.ndarray, prim_pack: torch.Tensor, max_leaf: int) -> BVHTree:
    """The traversal tree from the native builder's node array
    (native/bvh_builder.cc layout) and a [P, 16] primitive constant pack in
    the same (BVH depth-first) primitive order, on the pack's device."""
    n = len(nodes)
    hit_link, miss_link, leaf_first, leaf_count = accel.threaded_links(nodes)
    pack = np.zeros((n, NODE_ROWS), np.float32)
    pack[:, NODE_LO:NODE_LO + 3] = nodes[:, 0:3]
    pack[:, NODE_HI:NODE_HI + 3] = nodes[:, 3:6]
    pack[:, NODE_HIT] = hit_link
    pack[:, NODE_MISS] = miss_link
    pack[:, NODE_FIRST] = leaf_first
    pack[:, NODE_COUNT] = leaf_count
    return BVHTree(node_pack=torch.as_tensor(pack, device=prim_pack.device),
                   prim_pack=_prim_rows(prim_pack, max_leaf), max_leaf=int(max_leaf))


def refresh_tree(tree: BVHTree, prim_pack: torch.Tensor) -> BVHTree:
    """``tree`` with its primitive rows rebuilt from an updated [P, 16]
    pack: the nodes (the build-time boxes) stay, as the chunk order does."""
    return dataclasses.replace(tree, prim_pack=_prim_rows(prim_pack, tree.max_leaf))


def flatten_chunk_pack(pack: torch.Tensor) -> torch.Tensor:
    """[K, 16, C] chunk-major constant pack -> [K*C, 16] row-gatherable."""
    k, nrows, c = pack.shape
    return pack.transpose(1, 2).reshape(k * c, nrows)


def _slab(org, dirs, lo, hi, tmin, t_best):
    """Per-ray AABB slab test bounded by the running closest hit."""
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-20, dirs, torch.full_like(dirs, 1e-20))
    t0 = (lo - org) * inv
    t1 = (hi - org) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (near <= far) & (far >= tmin) & (near <= t_best)


# a leaf's products are summed left to right, as the chunk scan's
# ``outer_dot`` and ``_dot_ltr`` sum them, so its test rounds as the plain
# chunk scan's (and kernel K2's) does
_dot = ch._dot_ltr


def _traverse(org, dirs, tree: BVHTree, tmin, tmax, leaf_fn, payload):
    """The shared traversal loop. ``leaf_fn(row, lane_ok, t_best, payload)``
    tests one gathered primitive row [R, 16] against every ray and returns
    (t_best, payload) updated where it beat the running hit."""
    R = org.shape[0]
    n_nodes = tree.node_pack.shape[0]
    t_init = ch._t_init(org, tmax)
    t_best = t_init
    node = torch.zeros((R,), dtype=torch.int64, device=org.device)
    it = 0
    while it < n_nodes + 1 and bool((node < n_nodes).any()):
        alive = node < n_nodes
        row = tree.node_pack[torch.clamp(node, max=n_nodes - 1)]      # [R,16]
        hit_box = alive & _slab(org, dirs, row[:, NODE_LO:NODE_LO + 3],
                                row[:, NODE_HI:NODE_HI + 3], tmin, t_best)
        count = row[:, NODE_COUNT].to(torch.int64)
        first = row[:, NODE_FIRST].to(torch.int64)
        at_leaf = hit_box & (count > 0)
        last = tree.prim_pack.shape[0] - 1
        for j in range(tree.max_leaf):
            prow = tree.prim_pack[torch.clamp(first + j, max=last)]
            t_best, payload = leaf_fn(prow, at_leaf & (j < count), t_best, payload)
        nxt = torch.where(hit_box, row[:, NODE_HIT], row[:, NODE_MISS]).to(torch.int64)
        node = torch.where(alive, nxt, torch.full_like(node, n_nodes))
        it += 1
    return torch.where(t_best < t_init, t_best, torch.full_like(t_best, INF)), payload


def _planar_bvh(org, dirs, tree: BVHTree, tmin, triangle: bool, tmax=INF):
    """(t [R], (unorm [R,3], u [R], v [R], mat [R] int32, pid [R] int32))
    by traversal; the contract of ``chunked.planar_closest``. No graph."""
    R = org.shape[0]

    def leaf_fn(row, lane_ok, t_best, payload):
        n_b, u_b, v_b, m_b, p_b = payload
        unorm = row[:, fi.ROW_UNORM:fi.ROW_UNORM + 3]
        evw = row[:, fi.ROW_EVW:fi.ROW_EVW + 3]
        weu = row[:, fi.ROW_WEU:fi.ROW_WEU + 3]
        d_n = _dot(dirs, unorm)
        o_n = _dot(org, unorm)
        ok0 = torch.abs(d_n) > 1e-20
        t = torch.where(ok0, (row[:, fi.ROW_DPLANE] - o_n)
                        / torch.where(ok0, d_n, torch.ones_like(d_n)),
                        torch.full_like(d_n, BIG))
        a = torch.clamp(_dot(org, evw) + t * _dot(dirs, evw) - row[:, fi.ROW_CA],
                        -BIG, BIG)
        b = torch.clamp(_dot(org, weu) + t * _dot(dirs, weu) - row[:, fi.ROW_CB],
                        -BIG, BIG)
        if triangle:
            interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
        else:
            interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        better = (lane_ok & (row[:, fi.ROW_ACTIVE] > 0.5) & ok0 & interior
                  & (t >= tmin) & (t < t_best))
        return (torch.where(better, t, t_best),
                (torch.where(better[:, None], unorm, n_b),
                 torch.where(better, a, u_b),
                 torch.where(better, b, v_b),
                 torch.where(better, row[:, fi.ROW_MAT], m_b),
                 torch.where(better, row[:, ROW_PID], p_b)))

    z = torch.zeros((R,), dtype=org.dtype, device=org.device)
    t, (n, u, v, m, p) = _traverse(org, dirs, tree, tmin, tmax, leaf_fn,
                                   (torch.zeros_like(org), z, z, z, z))
    return t, (n, u, v, torch.round(m).to(torch.int32), torch.round(p).to(torch.int32))


def _sphere_bvh(org, dirs, time, tree: BVHTree, tmin, tmax=INF):
    """(t [R], (center_at_t [R,3], rad [R], mat [R], pid [R])) by traversal;
    the contract of ``chunked.sphere_closest``. No graph."""
    R = org.shape[0]
    a_q = _dot(dirs, dirs)               # quadratic coefficients, ray-only
    oo = _dot(org, org)
    do = _dot(dirs, org)
    a_safe = torch.clamp(a_q, min=1e-20)

    def leaf_fn(row, lane_ok, t_best, payload):
        ctr_b, rad_b, m_b, p_b = payload
        c0 = row[:, fi.SROW_C0:fi.SROW_C0 + 3]
        dc = row[:, fi.SROW_DC:fi.SROW_DC + 3]
        d_c = _dot(dirs, c0) + time * _dot(dirs, dc)
        o_c = _dot(org, c0) + time * _dot(org, dc)
        cc = (row[:, fi.SROW_C0C0] + 2.0 * time * row[:, fi.SROW_C0DC]
              + time * time * row[:, fi.SROW_DCDC])
        b = 2.0 * (do - d_c)
        c = oo - 2.0 * o_c + cc - row[:, fi.SROW_RAD2]
        disc = b * b - 4.0 * a_q * c
        has = disc > 0.0
        sqrtd = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
        t0 = (-b - sqrtd) / (2.0 * a_safe)
        t1 = (-b + sqrtd) / (2.0 * a_safe)
        in0 = (t0 >= tmin) & (t0 < t_best)
        in1 = (t1 >= tmin) & (t1 < t_best)
        t = torch.where(in0, t0, torch.where(in1, t1, torch.full_like(t0, BIG)))
        better = (lane_ok & (row[:, fi.SROW_ACTIVE] > 0.5) & has & (in0 | in1)
                  & (t < t_best))
        ctr = c0 + time[:, None] * dc
        return (torch.where(better, t, t_best),
                (torch.where(better[:, None], ctr, ctr_b),
                 torch.where(better, torch.clamp(row[:, fi.SROW_RAD], min=1e-20), rad_b),
                 torch.where(better, row[:, fi.SROW_MAT], m_b),
                 torch.where(better, row[:, ROW_PID], p_b)))

    z = torch.zeros((R,), dtype=org.dtype, device=org.device)
    t, (ctr, rad, m, p) = _traverse(org, dirs, tree, tmin, tmax, leaf_fn,
                                    (torch.zeros_like(org), z + 1.0, z, z))
    return t, (ctr, rad, torch.round(m).to(torch.int32), torch.round(p).to(torch.int32))


def traversal_stats(org, dirs, tree: BVHTree, tmin, tmax=INF):
    """Diagnostics: (iterations, node_visits [R] int32, leaf_visits [R]
    int32) of a traversal that skips the leaves' tests (so no t tightening:
    an upper bound on the visit counts)."""
    R = org.shape[0]
    n_nodes = tree.node_pack.shape[0]
    t_best = ch._t_init(org, tmax)
    node = torch.zeros((R,), dtype=torch.int64, device=org.device)
    nv = torch.zeros((R,), dtype=torch.int32, device=org.device)
    lv = torch.zeros_like(nv)
    it = 0
    while it < n_nodes + 1 and bool((node < n_nodes).any()):
        alive = node < n_nodes
        row = tree.node_pack[torch.clamp(node, max=n_nodes - 1)]
        hit_box = alive & _slab(org, dirs, row[:, NODE_LO:NODE_LO + 3],
                                row[:, NODE_HI:NODE_HI + 3], tmin, t_best)
        nxt = torch.where(hit_box, row[:, NODE_HIT], row[:, NODE_MISS]).to(torch.int64)
        node = torch.where(alive, nxt, torch.full_like(node, n_nodes))
        nv = nv + alive.to(torch.int32)
        lv = lv + (hit_box & (row[:, NODE_COUNT] > 0)).to(torch.int32)
        it += 1
    return it, nv, lv


# ------------------------------------------------------------- autodiff glue
class PlanarClosestBVH(torch.autograd.Function):
    """Traversal forward, chunk-scan VJP backward: autograd through the
    plain ``chunked.planar_closest`` on the saved inputs."""

    @staticmethod
    def forward(ctx, org, dirs, corner, eu, ev, chunks, tree, tmin, triangle, tmax):
        with torch.no_grad():
            t, (n, u, v, mat, pid) = _planar_bvh(org, dirs, tree, tmin, triangle, tmax)
        ctx.save_for_backward(org, dirs, corner, eu, ev)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi, tmin, triangle,
                    tmax)
        ctx.mark_non_differentiable(mat, pid)
        return t, n, u, v, mat, pid

    @staticmethod
    def backward(ctx, g_t, g_n, g_u, g_v, _g_mat, _g_pid):
        mat, active, lo, hi, tmin, triangle, tmax = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            chunks = ch.PlanarChunks(corner=xs[2], eu=xs[3], ev=xs[4], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (n, u, v, _, _) = ch.planar_closest(xs[0], xs[1], chunks, tmin,
                                                   triangle, tmax=tmax)
            grads = tbl.vjp((t, n, u, v), xs, (g_t, g_n, g_u, g_v))
        return (*grads, None, None, None, None, None)


class SphereClosestBVH(torch.autograd.Function):
    """Traversal forward, chunk-scan VJP backward for spheres."""

    @staticmethod
    def forward(ctx, org, dirs, time, c0, c1, rad, chunks, tree, tmin, tmax):
        with torch.no_grad():
            t, (ctr, r, mat, pid) = _sphere_bvh(org, dirs, time, tree, tmin, tmax)
        ctx.save_for_backward(org, dirs, time, c0, c1, rad)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi, tmin, tmax)
        ctx.mark_non_differentiable(mat, pid)
        return t, ctr, r, mat, pid

    @staticmethod
    def backward(ctx, g_t, g_ctr, g_rad, _g_mat, _g_pid):
        mat, active, lo, hi, tmin, tmax = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            chunks = ch.SphereChunks(c0=xs[3], c1=xs[4], rad=xs[5], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (ctr, r, _, _) = ch.sphere_closest(xs[0], xs[1], xs[2], chunks, tmin,
                                                  tmax=tmax)
            grads = tbl.vjp((t, ctr, r), xs, (g_t, g_ctr, g_rad))
        return (*grads, None, None, None, None)


def planar_closest_bvh(org, dirs, chunks: ch.PlanarChunks, tree: BVHTree, tmin,
                       triangle: bool, tmax=INF):
    """Drop-in for ``chunked.planar_closest`` by traversal of ``tree`` (the
    same primitives as ``chunks``, which the backward differentiates).
    Returns (t [R], (unorm [R,3], u [R], v [R], mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, chunks.corner, chunks.eu, chunks.ev):
        t, n, u, v, mat, pid = PlanarClosestBVH.apply(
            org, dirs, chunks.corner, chunks.eu, chunks.ev, chunks, tree, tmin,
            triangle, tmax)
        return t, (n, u, v, mat, pid)
    with torch.no_grad():
        return _planar_bvh(org, dirs, tree, tmin, triangle, tmax)


def sphere_closest_bvh(org, dirs, time, chunks: ch.SphereChunks, tree: BVHTree, tmin,
                       tmax=INF):
    """Drop-in for ``chunked.sphere_closest`` by traversal of ``tree``.
    Returns (t [R], (center_at_t [R,3], rad [R], mat [R], pid [R]))."""
    if tbl.needs_grad(org, dirs, time, chunks.c0, chunks.c1, chunks.rad):
        t, ctr, rad, mat, pid = SphereClosestBVH.apply(
            org, dirs, time, chunks.c0, chunks.c1, chunks.rad, chunks, tree, tmin, tmax)
        return t, (ctr, rad, mat, pid)
    with torch.no_grad():
        return _sphere_bvh(org, dirs, time, tree, tmin, tmax)
