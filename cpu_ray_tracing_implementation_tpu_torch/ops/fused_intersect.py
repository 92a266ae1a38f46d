"""Fused closest-hit: wrappers of the CUDA kernels K1 (planar) and K2 (sphere).

Port of ``cpu_ray_tracing_implementation_tpu/ops/pallas_intersect.py``.
The whole intersect + select of a bounce is one kernel call per primitive
type, with no [R,N] intermediate in device memory (``csrc/closest_hit.cu``).

Layouts are the JAX package's: rays go in as [8, R] (rows: org xyz, dir
xyz, time, pad), primitive constants as a [K, 16, C] pack, and the hit
leaves as [8, R] (planar rows: t, normal xyz, u, v, mat, valid; sphere
rows: t, center xyz at ray time, rad, mat, valid, pad).

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``ops/chunked.py``); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per kernel.

Gradients. The kernels write outputs with no graph, so a raw kernel call
refuses inputs that need a gradient. The drop-ins ``planar_closest_fused``
/ ``sphere_closest_fused`` are ``torch.autograd.Function``s when an input
needs one: the kernel (or, on the CPU, the plain scan) decides and gives
the values; the backward is autograd through the plain chunk scan on the
saved inputs, as the JAX package's Pallas wrappers do (the oracle route of
``models/diff.py``). The gradient path's own route decides with the
kernels' pid output (``planar_winner`` / ``sphere_winner``) and replays
the winner (``ops/replay.py``).
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm

BIG = 1e30
INF = float("inf")

# prim-constant pack rows (planar)
ROW_UNORM = 0     # 0:3   plane unit normal
ROW_EVW = 3       # 3:6   ev x w   (a = q . evw)
ROW_WEU = 6       # 6:9   w x eu   (b = q . weu)
ROW_DPLANE = 9    # unorm . corner
ROW_CA = 10       # corner . evw
ROW_CB = 11       # corner . weu
ROW_ACTIVE = 12   # 1.0 / 0.0
ROW_MAT = 13      # material id as f32
NROWS = 16        # padded

# planar output rows
OUT_T = 0
OUT_NX, OUT_NZ = 1, 3
OUT_U, OUT_V = 4, 5
OUT_MAT = 6
OUT_VALID = 7

# sphere constant pack rows
SROW_C0 = 0       # 0:3
SROW_DC = 3       # 3:6  c1 - c0 (motion)
SROW_C0C0 = 6
SROW_C0DC = 7
SROW_DCDC = 8
SROW_RAD2 = 9
SROW_RAD = 10
SROW_ACTIVE = 11
SROW_MAT = 12
SNROWS = 16

# sphere output rows
SOUT_T = 0
SOUT_CX, SOUT_CZ = 1, 3
SOUT_RAD = 4
SOUT_MAT = 5
SOUT_VALID = 6

# kernel launches, by kernel; each wrapper adds one where it launches
LAUNCHES = {"planar_closest": 0, "sphere_closest": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_prim_constants(chunks: ch.PlanarChunks) -> torch.Tensor:
    """[K, NROWS, C] constant pack from chunk-major planar tables."""
    corner, eu, ev = chunks.corner, chunks.eu, chunks.ev      # [K,C,3]
    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[..., None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)
    K, C = corner.shape[0], corner.shape[1]
    pack = torch.zeros((K, NROWS, C), dtype=torch.float32, device=corner.device)
    pack[:, ROW_UNORM:ROW_UNORM + 3] = unorm.transpose(1, 2)
    pack[:, ROW_EVW:ROW_EVW + 3] = evw.transpose(1, 2)
    pack[:, ROW_WEU:ROW_WEU + 3] = weu.transpose(1, 2)
    pack[:, ROW_DPLANE] = vm.dot(unorm, corner)
    pack[:, ROW_CA] = vm.dot(corner, evw)
    pack[:, ROW_CB] = vm.dot(corner, weu)
    pack[:, ROW_ACTIVE] = chunks.active.to(torch.float32)
    pack[:, ROW_MAT] = chunks.mat.to(torch.float32)
    return pack


def pack_sphere_constants(chunks: ch.SphereChunks) -> torch.Tensor:
    """[K, SNROWS, C] constant pack from chunk-major sphere tables."""
    c0, c1, rad = chunks.c0, chunks.c1, chunks.rad      # [K,C,3], [K,C]
    dc = c1 - c0
    K, C = rad.shape
    pack = torch.zeros((K, SNROWS, C), dtype=torch.float32, device=rad.device)
    pack[:, SROW_C0:SROW_C0 + 3] = c0.transpose(1, 2)
    pack[:, SROW_DC:SROW_DC + 3] = dc.transpose(1, 2)
    pack[:, SROW_C0C0] = vm.dot(c0, c0)
    pack[:, SROW_C0DC] = vm.dot(c0, dc)
    pack[:, SROW_DCDC] = vm.dot(dc, dc)
    pack[:, SROW_RAD2] = rad * rad
    pack[:, SROW_RAD] = rad
    pack[:, SROW_ACTIVE] = chunks.active.to(torch.float32)
    pack[:, SROW_MAT] = chunks.mat.to(torch.float32)
    return pack


# ----------------------------------------------------------- kernel calls
def _check(name: str, x: torch.Tensor, rows: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.shape[-2 if x.dim() == 3 else 0] != rows:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{rows} rows")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, fn, rays, pack, tmin, tmax, with_pid, *extra):
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad(fn, rays, pack)
    _check("rays", rays, 8)
    _check("pack", pack, NROWS)
    if rays.dim() != 2 or pack.dim() != 3:
        raise ValueError("rays must be [8,R] and pack [K,16,C]")
    if pack.device != rays.device:
        raise ValueError("rays and pack lie on different devices")
    R = rays.shape[1]
    K, _, C = pack.shape
    out = torch.empty((8, R), dtype=torch.float32, device=rays.device)
    pid = (torch.empty((R,), dtype=torch.int32, device=rays.device)
           if with_pid else None)
    lib = build.load()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = getattr(lib, fn)(rays.data_ptr(), R, pack.data_ptr(), K, C,
                               float(tmin), float(min(tmax, BIG)), *extra,
                               out.data_ptr(),
                               None if pid is None else pid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {build.error_string(err)}")
    LAUNCHES[name] += 1
    return (out, pid) if with_pid else out


def planar_closest_kernel(rays: torch.Tensor, pack: torch.Tensor, tmin: float,
                          tmax: float = BIG, triangle: bool = False,
                          with_pid: bool = False):
    """Kernel K1: [8,R] hit rows of rays [8,R] against pack [K,16,C]; with
    ``with_pid`` also the [R] int32 chunk-order index of each winner."""
    return _launch("planar_closest", "crt_planar_closest", rays, pack, tmin,
                   tmax, with_pid, int(bool(triangle)))


def sphere_closest_kernel(rays: torch.Tensor, pack: torch.Tensor, tmin: float,
                          tmax: float = BIG, with_pid: bool = False):
    """Kernel K2: [8,R] hit rows of rays [8,R] against pack [K,16,C]; with
    ``with_pid`` also the [R] int32 chunk-order index of each winner."""
    return _launch("sphere_closest", "crt_sphere_closest", rays, pack, tmin,
                   tmax, with_pid)


def pack_rays(org, dirs, time=None) -> torch.Tensor:
    """[8,R] ray rows (org xyz, dir xyz, time, pad)."""
    R = org.shape[0]
    rays = torch.zeros((8, R), dtype=torch.float32, device=org.device)
    rays[0:3] = org.T
    rays[3:6] = dirs.T
    if time is not None:
        rays[6] = time
    return rays


def _scalar_tmax(tmax) -> float:
    if torch.is_tensor(tmax) and tmax.dim() > 0:
        raise ValueError("the fused kernels take a scalar tmax")
    return float(tmax)


def _on_card(x: torch.Tensor) -> bool:
    """A CPU tensor takes the plain version; any other launches the kernel
    (whose wrapper raises on what is not a CUDA tensor)."""
    return x.device.type != "cpu"


def _planar_hit(org, dirs, chunks, tmin, triangle, tmax, pack, with_pid):
    """(t [R], (unorm, u, v, mat), pid or None) of K1 or, on CPU tensors,
    of the plain chunk scan; no graph either way."""
    with torch.no_grad():
        if not _on_card(org):
            t, (n, u, v, mat, pid) = ch.planar_closest(org, dirs, chunks, tmin,
                                                       triangle, tmax=tmax)
            return t, (n, u, v, mat), pid
        if pack is None:
            pack = pack_prim_constants(chunks)
        out = planar_closest_kernel(pack_rays(org, dirs), pack, tmin,
                                    _scalar_tmax(tmax), triangle, with_pid)
        out, pid = out if with_pid else (out, None)
        t = torch.where(out[OUT_VALID] > 0.5, out[OUT_T],
                        torch.full_like(out[OUT_T], INF))
        mat = torch.round(out[OUT_MAT]).to(torch.int32)
        return t, (out[OUT_NX:OUT_NZ + 1].T, out[OUT_U], out[OUT_V], mat), pid


def _sphere_hit(org, dirs, time, chunks, tmin, tmax, pack, with_pid):
    """(t [R], (center_at_t, rad, mat), pid or None) of K2 or, on CPU
    tensors, of the plain chunk scan; no graph either way."""
    with torch.no_grad():
        if not _on_card(org):
            t, (ctr, rad, mat, pid) = ch.sphere_closest(org, dirs, time, chunks,
                                                        tmin, tmax=tmax)
            return t, (ctr, rad, mat), pid
        if pack is None:
            pack = pack_sphere_constants(chunks)
        out = sphere_closest_kernel(pack_rays(org, dirs, time), pack, tmin,
                                    _scalar_tmax(tmax), with_pid)
        out, pid = out if with_pid else (out, None)
        t = torch.where(out[SOUT_VALID] > 0.5, out[SOUT_T],
                        torch.full_like(out[SOUT_T], INF))
        mat = torch.round(out[SOUT_MAT]).to(torch.int32)
        return t, (out[SOUT_CX:SOUT_CZ + 1].T, out[SOUT_RAD], mat), pid


class _PlanarClosest(torch.autograd.Function):
    """Kernel K1 forward, chunk-scan VJP backward: autograd through the
    plain closest hit on the saved (org, dirs, chunk tables), as the JAX
    package's ``pallas_intersect.py:203-225`` does. The remat-everything
    VJP oracle of ``models/diff.py``."""

    @staticmethod
    def forward(ctx, org, dirs, corner, eu, ev, chunks, tmin, triangle, tmax,
                pack, with_pid):
        t, (n, u, v, mat), pid = _planar_hit(org, dirs, chunks, tmin, triangle,
                                             tmax, pack, with_pid)
        ctx.save_for_backward(org, dirs, corner, eu, ev)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi, tmin,
                    triangle, tmax)
        if not with_pid:
            ctx.mark_non_differentiable(mat)
            return t, n, u, v, mat
        ctx.mark_non_differentiable(mat, pid)
        return t, n, u, v, mat, pid

    @staticmethod
    def backward(ctx, g_t, g_n, g_u, g_v, _g_mat, _g_pid=None):
        mat, active, lo, hi, tmin, triangle, tmax = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            chunks = ch.PlanarChunks(corner=xs[2], eu=xs[3], ev=xs[4], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (n, u, v, _, _) = ch.planar_closest(xs[0], xs[1], chunks, tmin,
                                                   triangle, tmax=tmax)
            grads = tbl.vjp((t, n, u, v), xs, (g_t, g_n, g_u, g_v))
        return (*grads, None, None, None, None, None, None)


class _SphereClosest(torch.autograd.Function):
    """Kernel K2 forward, chunk-scan VJP backward (see _PlanarClosest)."""

    @staticmethod
    def forward(ctx, org, dirs, time, c0, c1, rad, chunks, tmin, tmax, pack):
        t, (ctr, r, mat), _ = _sphere_hit(org, dirs, time, chunks, tmin, tmax,
                                          pack, False)
        ctx.save_for_backward(org, dirs, time, c0, c1, rad)
        ctx.args = (chunks.mat, chunks.active, chunks.lo, chunks.hi, tmin,
                    tmax)
        ctx.mark_non_differentiable(mat)
        return t, ctr, r, mat

    @staticmethod
    def backward(ctx, g_t, g_ctr, g_rad, _g_mat):
        mat, active, lo, hi, tmin, tmax = ctx.args
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            chunks = ch.SphereChunks(c0=xs[3], c1=xs[4], rad=xs[5], mat=mat,
                                     active=active, lo=lo, hi=hi)
            t, (ctr, r, _, _) = ch.sphere_closest(xs[0], xs[1], xs[2], chunks,
                                                  tmin, tmax=tmax)
            grads = tbl.vjp((t, ctr, r), xs, (g_t, g_ctr, g_rad))
        return (*grads, None, None, None, None)


def planar_closest_fused(org, dirs, chunks: ch.PlanarChunks, tmin,
                         triangle: bool, tmax=BIG, pack=None,
                         with_pid: bool = False):
    """Drop-in for ``chunked.planar_closest``: kernel K1 on CUDA tensors,
    the plain chunk scan on CPU tensors. Differentiable: when an input
    needs a gradient the call goes through ``_PlanarClosest`` (chunk-scan
    VJP), so the card and the CPU give the same gradients.

    Returns (t [R], (unorm [R,3], u [R], v [R], mat [R])), and with
    ``with_pid`` (t, (unorm, u, v, mat, pid [R] int32)): the winner's
    chunk-order index k*C + lane from K1's pid output (0 on a miss; the
    dense row on a 1-chunk view), which per-vertex triangle attributes
    read; under autograd a non-differentiable output. ``pack``: the
    precomputed ``pack_prim_constants(chunks)``."""
    if tbl.needs_grad(org, dirs, chunks.corner, chunks.eu, chunks.ev):
        t, *rest = _PlanarClosest.apply(
            org, dirs, chunks.corner, chunks.eu, chunks.ev, chunks, tmin,
            triangle, tmax, pack, with_pid)
        return t, tuple(rest)
    t, payload, pid = _planar_hit(org, dirs, chunks, tmin, triangle, tmax, pack,
                                  with_pid)
    return t, (*payload, pid) if with_pid else payload


def sphere_closest_fused(org, dirs, time, chunks: ch.SphereChunks, tmin,
                         tmax=BIG, pack=None):
    """Drop-in for ``chunked.sphere_closest``: kernel K2 on CUDA tensors,
    the plain chunk scan on CPU tensors; differentiable as
    ``planar_closest_fused`` is.

    Returns (t [R], (center_at_t [R,3], rad [R], mat [R]))."""
    if tbl.needs_grad(org, dirs, time, chunks.c0, chunks.c1, chunks.rad):
        t, ctr, rad, mat = _SphereClosest.apply(
            org, dirs, time, chunks.c0, chunks.c1, chunks.rad, chunks, tmin,
            tmax, pack)
        return t, (ctr, rad, mat)
    return _sphere_hit(org, dirs, time, chunks, tmin, tmax, pack, False)[:2]


def planar_winner(org, dirs, chunks: ch.PlanarChunks, tmin, triangle: bool,
                  tmax=BIG, pack=None):
    """The decision alone, for the winner replay (``ops/replay.py``):
    (t [R], pid [R] int32) of K1 with its pid output, or of the plain chunk
    scan on CPU tensors; pid is the chunk-order index k*C + lane (0 on a
    miss), the dense row index on a 1-chunk view. No graph."""
    t, _, pid = _planar_hit(org, dirs, chunks, tmin, triangle, tmax, pack, True)
    return t, pid


def sphere_winner(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax=BIG,
                  pack=None):
    """(t [R], pid [R] int32) of K2 with its pid output, or of the plain
    chunk scan on CPU tensors (see ``planar_winner``)."""
    t, _, pid = _sphere_hit(org, dirs, time, chunks, tmin, tmax, pack, True)
    return t, pid


# ----------------------------------------------- dense (small-scene) entry
# Small scenes (<= chunked.DENSE_MAX primitives per type, e.g. the Cornell
# box's 18 quads) keep dense [N] tables. These views reshape a dense table
# as ONE chunk padded to a multiple of 128 with inactive rows, so the same
# kernels serve the small-scene path.

def _one_chunk(vec3s, scalars, lo_pts, hi_pts, active):
    """([1,C,...] vec3 list, [1,C] scalar list, lo [1,3], hi [1,3])."""
    N = active.shape[0]
    C = -(-N // 128) * 128

    def pad(x):
        z = torch.zeros((C - N,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        return torch.cat([x, z])[None]

    v3 = [pad(x) for x in vec3s]
    sc = [pad(x) for x in scalars]
    m = active[:, None]
    inf = torch.full((1, 3), INF, device=active.device)
    lo = torch.stack([torch.where(m, p, inf).amin(0) for p in lo_pts]).amin(0)
    hi = torch.stack([torch.where(m, p, -inf).amax(0) for p in hi_pts]).amax(0)
    return v3, sc, lo[None], hi[None]


def dense_planar_view(corner, eu, ev, mat, active) -> ch.PlanarChunks:
    """1-chunk PlanarChunks view of a dense quad/triangle table."""
    pts = [corner, corner + eu, corner + ev, corner + eu + ev]
    v3, sc, lo, hi = _one_chunk([corner, eu, ev], [mat, active], pts, pts,
                                active)
    return ch.PlanarChunks(corner=v3[0], eu=v3[1], ev=v3[2], mat=sc[0],
                           active=sc[1], lo=lo, hi=hi)


def dense_quad_view(quads) -> ch.PlanarChunks:
    return dense_planar_view(quads.corner, quads.eu, quads.ev, quads.mat,
                             quads.active)


def dense_tri_view(tris) -> ch.PlanarChunks:
    """Triangles in (corner, eu, ev) form: eu = v1 - v0, ev = v2 - v0,
    interior test a + b <= 1."""
    return dense_planar_view(tris.v0, tris.v1 - tris.v0, tris.v2 - tris.v0,
                             tris.mat, tris.active)


def dense_sphere_view(sph) -> ch.SphereChunks:
    r3 = sph.rad[:, None]
    v3, sc, lo, hi = _one_chunk(
        [sph.c0, sph.c1], [sph.rad, sph.mat, sph.active],
        [sph.c0 - r3, sph.c1 - r3], [sph.c0 + r3, sph.c1 + r3], sph.active)
    return ch.SphereChunks(c0=v3[0], c1=v3[1], rad=sc[0], mat=sc[1],
                           active=sc[2], lo=lo, hi=hi)
