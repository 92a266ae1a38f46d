"""A plain path tracer over a scene description: the benchmark's reference.

Semantics (the estimator the port states for these scenes):

- camera: a perspective pinhole (Shirley's camera, ``src/camera.h:21-50``),
  pixel ``i * W + j`` jittered by uniforms 0 and 1 of its camera slots; its
  position, look-at, field of view and focal length are tensors, so a
  gradient step differentiates them;
- closest hit over quads and triangles in [1e-3, inf), by the plane test:
  ``t = (n.c - n.o) / n.d``, then the edge coefficients ``a``, ``b`` of the
  hit point inside the quad (both in [0, 1]) or triangle (``a + b <= 1``);
  on a tie a quad wins;
- a miss adds the background, a front-facing hit of a diffuse light adds
  its emission, both times the path's throughput, and ends the path;
- a lambertian hit scatters by the one-sample mixture of the cosine
  density about the face-forward normal and the lights' solid-angle
  density (``src/camera.h:193-241``, ``src/pdf.h``), the throughput times
  the albedo times cos/pi over the mixture density;
- a pixel's value is the mean of its samples.

Random numbers follow ``rng.py``: sample ``s`` of a render keyed ``key``
takes ``fold_in(key, s)``, split into a camera key and a path key; the
camera's five slots hash the pixel id with the camera key's seed words,
and bounce ``b``'s nine slots with those of ``fold_in(path key, b)``.
Slots: 1, 2 the cosine direction; 3 the mixture's pick (light below 0.5);
4, 5 the point on the light; 8 the light's index.

Triangles are found through groups of ``GROUP`` triangles in Morton order
of their centroids, each with a padded bounding box: a ray tests the
groups its box slab test admits, nearest entry first, until the next
entry lies beyond its best hit. Everything runs in ``dtype``; the control
of the benchmark's check runs it in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import rng

T_MIN = 1e-3
NSLOT = 9
CAM_SLOTS = 5
GROUP = 64
# (sample, pixel) paths traced together, and rays per slab-test block
LANE_BLOCK = 1 << 20
RAY_BLOCK = 8192
# groups a ray tests per step of its nearest-first walk
WALK_STEP = 4


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a) + 1e-12)[..., None]


def _safe_div(num, den):
    ok = den.abs() > 1e-20
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


class Planar:
    """Plane-test constants of planar primitives (corner, edges u and v)."""

    def __init__(self, corner, eu, ev):
        n = _cross(eu, ev)
        nn = _dot(n, n)
        self.unorm = _normalize(n)
        self.area = torch.sqrt(nn)
        w = n / torch.clamp(nn, min=1e-20)[..., None]
        self.evw = _cross(ev, w)
        self.weu = _cross(w, eu)
        self.corner, self.eu, self.ev = corner, eu, ev
        self.dplane = _dot(self.unorm, corner)
        self.ca = _dot(corner, self.evw)
        self.cb = _dot(corner, self.weu)

    def take(self, idx):
        """Constants of primitives ``idx`` (any shape): (unorm, dplane, evw,
        weu, ca, cb)."""
        return (self.unorm[idx], self.dplane[idx], self.evw[idx], self.weu[idx],
                self.ca[idx], self.cb[idx])


def plane_ts(org, dirs, consts, tmax, triangle: bool, active=None):
    """[B, P] hit t of rays [B,3] against primitives whose constants are
    [P, ...] (shared) or [B, P, ...] (per ray); inf where the ray misses or
    the hit lies outside [T_MIN, tmax [B]]."""
    un, dp, evw, weu, ca, cb = consts
    o, d = org[:, None, :], dirs[:, None, :]
    o_n, d_n = _dot(o, un), _dot(d, un)
    ok0 = d_n.abs() > 1e-20
    big = torch.full_like(d_n, 1e30)
    t = torch.where(ok0, (dp - o_n) / torch.where(ok0, d_n, torch.ones_like(d_n)), big)
    a = torch.clamp(_dot(o, evw) + t * _dot(d, evw) - ca, -1e30, 1e30)
    b = torch.clamp(_dot(o, weu) + t * _dot(d, weu) - cb, -1e30, 1e30)
    inside = (a >= 0) & (b >= 0) & ((a + b <= 1) if triangle else ((a <= 1) & (b <= 1)))
    ok = ok0 & (t >= T_MIN) & (t <= tmax[:, None]) & inside
    if active is not None:
        ok = ok & active
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _morton(q: np.ndarray) -> np.ndarray:
    """Interleaved bits of three 10-bit integer coordinates [N,3]."""
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1).astype(np.int64) << (3 * bit + ax)
    return code


class TriGroups:
    """Triangles in groups of ``GROUP`` along the Morton curve of their
    centroids, each group with a padded bounding box."""

    def __init__(self, verts: np.ndarray, dtype, device):
        T = len(verts)
        cent = verts.astype(np.float64).mean(axis=1)
        lo, hi = cent.min(0), cent.max(0)
        q = ((cent - lo) / np.maximum(hi - lo, 1e-9) * 1023).astype(np.int64)
        order = np.argsort(_morton(q), kind="stable")
        NG = -(-T // GROUP)
        pad = NG * GROUP - T
        v = verts[order].astype(np.float32)
        self.index = torch.as_tensor(np.concatenate([order, np.zeros(pad, np.int64)]),
                                     device=device)
        self.active = torch.as_tensor(np.arange(NG * GROUP) < T, device=device)
        v = np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) if pad else v
        gv = v.reshape(NG, GROUP * 3, 3).astype(np.float64)
        ext = float(np.max(verts.max(axis=(0, 1)) - verts.min(axis=(0, 1))))
        eps = 1e-5 * ext + 1e-3
        self.lo = torch.as_tensor(gv.min(1) - eps, dtype=dtype, device=device)
        self.hi = torch.as_tensor(gv.max(1) + eps, dtype=dtype, device=device)
        vt = torch.as_tensor(v, device=device).to(dtype)
        self.planar = Planar(vt[:, 0], vt[:, 1] - vt[:, 0], vt[:, 2] - vt[:, 0])

    def closest(self, org, dirs):
        """(t [R], triangle index [R]; -1 on a miss)."""
        R = org.shape[0]
        t_all = torch.full((R,), math.inf, dtype=org.dtype, device=org.device)
        i_all = torch.full((R,), -1, dtype=torch.int64, device=org.device)
        lanes = torch.arange(GROUP, device=org.device)
        for s in range(0, R, RAY_BLOCK):
            o, d = org[s:s + RAY_BLOCK], dirs[s:s + RAY_BLOCK]
            inv = 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))
            near = far = None
            for ax in range(3):
                t0 = (self.lo[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
                t1 = (self.hi[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
                lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
                near = lo_t if near is None else torch.maximum(near, lo_t)
                far = hi_t if far is None else torch.minimum(far, hi_t)
            ok = (near <= far) & (far >= T_MIN)
            near = torch.where(ok, torch.clamp(near, min=T_MIN), torch.full_like(near, math.inf))
            ns, order = torch.sort(near, dim=1)
            n_hit = int(torch.isfinite(ns).sum(1).max())
            best = torch.full((o.shape[0],), math.inf, dtype=o.dtype, device=o.device)
            bidx = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
            for j in range(0, n_hit, WALK_STEP):
                rows = torch.nonzero(ns[:, j] < best)[:, 0]
                if rows.numel() == 0:
                    break
                g = order[rows, j:j + WALK_STEP]                        # [n, S]
                prim = (g[:, :, None] * GROUP + lanes).reshape(len(rows), -1)
                ts = plane_ts(o[rows], d[rows], self.planar.take(prim), best[rows],
                              True, self.active[prim])
                m, am = ts.min(1)
                upd = m < best[rows]
                r = rows[upd]
                best[r] = m[upd]
                bidx[r] = self.index[prim[upd, am[upd]]]
            t_all[s:s + RAY_BLOCK] = best
            i_all[s:s + RAY_BLOCK] = bidx
        return t_all, i_all


class RefScene:
    """The description's tables in ``dtype`` on ``device``; ``color`` [M,3]
    and ``background`` [3] are the differentiable leaves."""

    def __init__(self, desc, dtype=torch.float32, device="cpu"):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
        self.dtype, self.device = dtype, device
        self.is_light = torch.tensor([k == "diffuse_light" for k, _ in desc.materials],
                                     device=device)
        self.is_lambert = torch.tensor([k == "lambertian" for k, _ in desc.materials],
                                       device=device)
        self.color = f([c for _, c in desc.materials])
        self.background = None if desc.background is None else f(desc.background)
        self.n_quad = len(desc.quad_mat)
        if self.n_quad:
            self.quads = Planar(f(desc.quad_corner), f(desc.quad_u), f(desc.quad_v))
            self.quad_mat = torch.as_tensor(desc.quad_mat, device=device)
        self.tris = TriGroups(desc.tri_verts, dtype, device) if len(desc.tri_verts) else None
        if self.tris is not None:
            self.tri_mat = torch.as_tensor(desc.tri_mat, device=device)
            vt = f(desc.tri_verts)
            self.tri_unorm = _normalize(_cross(vt[:, 1] - vt[:, 0], vt[:, 2] - vt[:, 0]))
        lid = torch.as_tensor(desc.lights, dtype=torch.int64, device=device)
        self.n_lights = len(desc.lights)
        if self.n_lights:
            self.light = Planar(self.quads.corner[lid], self.quads.eu[lid], self.quads.ev[lid])

    def intersect(self, org, dirs):
        """(valid, t, unit normal (not face-forwarded), material) of each
        ray's closest hit."""
        R = org.shape[0]
        inf = torch.full((R,), math.inf, dtype=org.dtype, device=org.device)
        t_q, t_t = inf, inf
        nrm = torch.zeros_like(org)
        mat = torch.zeros((R,), dtype=torch.int64, device=org.device)
        if self.tris is not None:
            t_t, i_t = self.tris.closest(org, dirs)
            hit = i_t >= 0
            it = torch.where(hit, i_t, torch.zeros_like(i_t))
            nrm = torch.where(hit[:, None], self.tri_unorm[it], nrm)
            mat = torch.where(hit, self.tri_mat[it], mat)
        if self.n_quad:
            tq = plane_ts(org, dirs, self.quads.take(slice(None)), inf, False)
            t_q, i_q = tq.min(1)
            q = (t_q <= t_t) & torch.isfinite(t_q)
            nrm = torch.where(q[:, None], self.quads.unorm[i_q], nrm)
            mat = torch.where(q, self.quad_mat[i_q], mat)
        t = torch.minimum(t_q, t_t)
        return torch.isfinite(t), t, nrm, mat

    def light_pdf(self, p, d):
        """Solid-angle density of the light sampler in direction ``d`` from
        ``p``: the mean over the light quads of dist^2 / (|cos| * area)
        where the ray meets the quad."""
        L = self.light
        o_n, d_n = _dot(p[:, None], L.unorm), _dot(d[:, None], L.unorm)
        ok0 = d_n.abs() > 1e-20
        t = torch.where(ok0, (L.dplane - o_n) / torch.where(ok0, d_n, torch.ones_like(d_n)),
                        torch.full_like(d_n, 1e30))
        a = _dot(p[:, None], L.evw) + t * _dot(d[:, None], L.evw) - L.ca
        b = _dot(p[:, None], L.weu) + t * _dot(d[:, None], L.weu) - L.cb
        ok = ok0 & (t >= T_MIN) & (t < 1e29) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        ts = torch.where(ok, t, torch.ones_like(t))
        dist2 = ts * ts * _dot(d, d)[:, None]
        cos = _dot(_normalize(d)[:, None], L.unorm).abs()
        pdf = torch.where(ok, _safe_div(dist2, cos * L.area), torch.zeros_like(t))
        return pdf.sum(1) / self.n_lights


def _unit_sphere(u1, u2):
    c = 1.0 - 2.0 * u1
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([s * torch.cos(phi), c, s * torch.sin(phi)], -1)


def _cosine_pdf(n, d):
    return torch.clamp(_dot(_normalize(d), n) / math.pi, min=0.0)


CAMERA_LEAVES = ("pos", "lookat", "fovy_deg", "focal_length")


def camera_leaves(cam: dict, dtype, device, grad: bool = False) -> dict:
    """The pinhole camera's parameters as tensors in ``dtype``: the leaves a
    gradient step differentiates when ``grad``."""
    return {k: torch.tensor(cam[k], dtype=torch.float64, device=device).to(dtype)
            .requires_grad_(grad) for k in CAMERA_LEAVES}


def camera_rays(cam: dict, W: int, H: int, ids, u, dtype):
    """(origin, direction) of pinhole rays through pixels ``ids``; ``cam``
    holds ``camera_leaves``."""
    dev = ids.device
    pos, look, focal = cam["pos"], cam["lookat"], cam["focal_length"]
    theta = cam["fovy_deg"] * (math.pi / 180.0)
    d = _normalize(look - pos)
    right = _normalize(_cross(d, torch.tensor([0.0, 1.0, 0.0], device=dev).to(dtype)))
    up = _cross(right, d)
    vh = 2.0 * torch.tan(theta / 2.0) * focal
    vw = vh * (W / H)
    du, dv = (vw / W) * right, (-vh / H) * up
    i = torch.div(ids, W, rounding_mode="floor").to(dtype)
    j = torch.remainder(ids, W).to(dtype)
    jx = (j + (u[:, 0] - 0.5))[:, None]
    iy = (i + (u[:, 1] - 0.5))[:, None]
    dir00 = focal * d - vw / 2.0 * right + vh / 2.0 * up + 0.5 * (du + dv)
    dirs = dir00 + jx * du + iy * dv
    return pos.expand(dirs.shape), dirs


def image_height(W: int, aspect: float) -> int:
    return max(1, int(W / aspect))


def sample_words(key, samples, max_depth):
    """([S,2], [S,D,2]) int64 seed words of the camera and of each bounce
    of the samples ``samples`` of a render keyed ``key``."""
    cam, path = [], []
    for s in samples:
        kc, kp = rng.split(rng.fold_in(key, s))
        cam.append(rng.bits(kc))
        path.append([rng.bits(rng.fold_in(kp, b)) for b in range(max_depth)])
    return torch.tensor(cam, dtype=torch.int64), torch.tensor(path, dtype=torch.int64)


def trace(sc: RefScene, cam: dict, W: int, H: int, ids, sample_of, cam_w, path_w,
          max_depth: int):
    """Radiance [N,3] of the paths of pixels ``ids`` [N], path n drawing its
    seed words from row ``sample_of[n]`` of ``cam_w`` / ``path_w``; ``cam``
    holds ``camera_leaves``."""
    dt, dev = sc.dtype, sc.device
    cw, pw = cam_w.to(dev)[sample_of], path_w.to(dev)[sample_of]
    u = rng.uniforms(cw[:, 0], cw[:, 1], ids, CAM_SLOTS).to(dt)
    org, dirs = camera_rays(cam, W, H, ids, u, dt)
    N = ids.shape[0]
    rad = torch.zeros((N, 3), dtype=dt, device=dev)
    lane = torch.arange(N, device=dev)
    thr = torch.ones((N, 3), dtype=dt, device=dev)
    for b in range(max_depth):
        if lane.numel() == 0:
            break
        u = rng.uniforms(pw[lane, b, 0], pw[lane, b, 1], ids[lane], NSLOT).to(dt)
        valid, t, unorm, mat = sc.intersect(org, dirs)
        p = org + torch.where(valid, t, torch.zeros_like(t))[:, None] * dirs
        front = _dot(dirs, unorm) < 0
        n = torch.where(front[:, None], unorm, -unorm)
        col = sc.color[mat]
        emit = (valid & sc.is_light[mat] & front)[:, None]
        contrib = torch.where(emit, thr * col, torch.zeros_like(thr))
        if sc.background is not None:
            contrib = torch.where(valid[:, None], contrib, thr * sc.background)
        rad = rad.index_add(0, lane, contrib)
        go = torch.nonzero(valid & sc.is_lambert[mat])[:, 0]
        if go.numel() == 0:
            break
        n, p, col, u, thr, lane = n[go], p[go], col[go], u[go], thr[go], lane[go]
        s = n + _unit_sphere(u[:, 1], u[:, 2])
        cos_dir = _normalize(torch.where((_dot(s, s) < 1e-12)[:, None], n, s))
        if sc.n_lights:
            L = sc.light
            li = torch.clamp((u[:, 8] * sc.n_lights).to(torch.int64), max=sc.n_lights - 1)
            ldir = L.corner[li] + u[:, 4:5] * L.eu[li] + u[:, 5:6] * L.ev[li] - p
            new = torch.where((u[:, 3] < 0.5)[:, None], ldir, cos_dir)
            pdf = 0.5 * _cosine_pdf(n, new) + 0.5 * sc.light_pdf(p, new)
        else:
            new = cos_dir
            pdf = _cosine_pdf(n, new)
        thr = thr * col * _safe_div(_cosine_pdf(n, new), pdf)[:, None]
        org, dirs = p, new
    return rad


def _paths(n_pix: int, spp: int):
    """(sample, first pixel, pixels) blocks of at most LANE_BLOCK paths."""
    per = max(1, LANE_BLOCK // max(n_pix, 1))
    for s0 in range(0, spp, per):
        yield range(s0, min(spp, s0 + per))


def render(desc, width: int, spp: int, max_depth: int, key, pixel_ids=None,
           dtype=torch.float32, device="cpu", sc: RefScene | None = None):
    """[N,3] float32: the mean over ``spp`` samples of pixels ``pixel_ids``
    (all pixels, row-major, when None) of the render keyed ``key``."""
    H = image_height(width, desc.camera["aspect"])
    sc = sc or RefScene(desc, dtype, device)
    cam = camera_leaves(desc.camera, dtype, device)
    ids = (torch.arange(width * H, device=device) if pixel_ids is None
           else torch.as_tensor(pixel_ids, device=device).to(torch.int64))
    cam_w, path_w = sample_words(key, range(spp), max_depth)
    acc = None
    with torch.no_grad():
        for block in _paths(ids.shape[0], spp):
            S = len(block)
            rows = torch.arange(block.start, block.stop, device=device).repeat_interleave(
                ids.shape[0])
            rad = trace(sc, cam, width, H, ids.repeat(S), rows, cam_w, path_w, max_depth)
            for k in range(S):
                part = rad[k * ids.shape[0]:(k + 1) * ids.shape[0]]
                acc = part if acc is None else acc + part
    return (acc / spp).float()


def loss_and_grads(desc, width: int, spp: int, max_depth: int, key, target,
                   dtype=torch.float32, device="cpu"):
    """(loss, {"color": [M,3], "background": [3] or None, "camera": {leaf:
    gradient}}): the mean squared error of the ``spp``-sample render against
    ``target`` [H,W,3] and its gradient in each material's color, the
    background color and each of the camera's ``CAMERA_LEAVES``. Gradients
    flow through ray generation and every hit point and sampled light
    direction that depends on it; which primitive a ray hits carries none
    (no silhouette term)."""
    H = image_height(width, desc.camera["aspect"])
    sc = RefScene(desc, dtype, device)
    sc.color.requires_grad_(True)
    if sc.background is not None:
        sc.background.requires_grad_(True)
    cam = camera_leaves(desc.camera, dtype, device, grad=True)
    ids = torch.arange(width * H, device=device)
    cam_w, path_w = sample_words(key, range(spp), max_depth)
    acc = None
    for block in _paths(ids.shape[0], spp):
        S = len(block)
        rows = torch.arange(block.start, block.stop, device=device).repeat_interleave(
            ids.shape[0])
        rad = trace(sc, cam, width, H, ids.repeat(S), rows, cam_w, path_w, max_depth)
        for k in range(S):
            part = rad[k * ids.shape[0]:(k + 1) * ids.shape[0]]
            acc = part if acc is None else acc + part
    img = (acc / spp).reshape(H, width, 3)
    diff = img - target.to(device=device, dtype=dtype)
    loss = torch.mean(diff * diff)
    leaves = [sc.color] + [cam[k] for k in CAMERA_LEAVES]
    leaves += [sc.background] if sc.background is not None else []
    grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
    out = {"color": grads[0], "camera": dict(zip(CAMERA_LEAVES, grads[1:5])),
           "background": grads[5] if sc.background is not None else None}
    return float(loss.detach()), out
