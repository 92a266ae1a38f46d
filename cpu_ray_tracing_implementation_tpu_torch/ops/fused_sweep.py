"""Per-ray visit-list sweep: the wrappers of CUDA kernels K4, K7 and K8.

Port of ``cpu_ray_tracing_implementation_tpu/ops/pallas_sweep.py``. For
each ray and each of its V visit slots, the chunk row that the slot names
is read from the [K, F, C] sweep table and its C primitives are
intersected; the first-index minimum replaces the running best hit when
``t_c < t_best`` and the slot's entry t is below ``t_best`` too. The
kernel (``csrc/visit_sweep.cu``) works per visited slot: each slot's
minimum against the input best, one chunk row per block, then the slots
folded in order per ray; ``sweep_fold_plain`` is that decomposition in
plain PyTorch, bit for bit ``sweep_plain``'s result. The best hit travels
as one [R, 8] f32 matrix:

- planar (F = 9 rows: corner, eu, ev): t, unit normal xyz, u, v, mat, pid;
- sphere (F = 7 rows: c0, c1, rad): t, center xyz at ray time, rad, 0,
  mat, pid.

pid = chunk id * C + lane, carried in f32 (exact below 2^24). The mat
column passes through untouched: the winner's material is recovered once
after the phase loop (``ops/perray.py``). Inactive lanes are baked into
the table (eu = ev = 0, rad = 0), so they never hit.

Rounding: the plain version runs one PyTorch operation per arithmetic
step; the kernel writes the same steps with ``__fmul_rn``/``__fadd_rn``
(never contracted into a multiply-add) and the ``rsqrtf`` that
``torch.rsqrt`` runs on the card, so both round alike.

Two opt-in routes of ``ops/perray.py`` sweep other rows:

- K7 (``sweep_sub``, ``CRT_SUBTILE``): sub-tile rows [K*G, F, CS], any CS
  dividing 128 (passed to one kernel instance a row kind at run time), one
  sub-tile a slot; pid = sub-tile id * CS + lane, the global chunk-major
  index. Its stages bucket the visits by chunk and serve a chunk's
  sub-tiles from its constants derived once (C entry
  ``crt_subtile_sweep``). Its plain version is ``sweep_plain`` at that
  width.
- K8 (``sweep_q16``, ``CRT_SWEEP_Q16``, planar; K4's count, scatter and
  fold and a tile stage of its own, C entry ``crt_visit_sweep``): rows of
  5 x 128 u32 words holding the u16 coordinates of each primitive's three
  points in its chunk box's frame (``ops/perray.py:planar_q16``),
  dequantized per row (``dequant_q16``) and then tested as K4 tests a
  float row, except that a ray skips each group of 32 primitives whose
  padded box it does not enter (``q16_group_boxes``, ``q16_group_slab``:
  the kernel's boxes and slab test in PyTorch, for the tests). Its plain
  version is ``sweep_q16_plain``.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts
kernel launches, one key a kernel.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

BIG = 1e30
INF = float("inf")

PLANAR_ROWS = 9
SPHERE_ROWS = 7

# K4, K7 (sub-tile rows), K8 (quantized rows)
LAUNCHES = {"visit_sweep": 0, "visit_sweep_sub": 0, "visit_sweep_q16": 0}
# the chunk width; K7's sub-tile widths divide it
CHUNK_C = 128
Q16_WORDS = 5
# K8's group boxes (csrc/visit_sweep.cu, "K8"): primitives a group, the
# pad's unit u, and the 1/sin of the edges' angle above which a group is
# never skipped
Q16_GROUP = 32
Q16_PAD = 2.0 ** -24
Q16_MAX_SKEW = 8192.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_rays(org, dirs, time=None) -> torch.Tensor:
    """[R, 8] ray rows: org xyz, dir xyz, time (0 without), pad."""
    R = org.shape[0]
    rays = torch.zeros((R, 8), dtype=torch.float32, device=org.device)
    rays[:, 0:3] = org
    rays[:, 3:6] = dirs
    if time is not None:
        rays[:, 6] = time
    return rays


def pack_best_planar(t, n, u, v, mat, pid) -> torch.Tensor:
    """Planar best hit -> [R, 8] (t nx ny nz u v mat pid)."""
    return torch.stack([t, n[:, 0], n[:, 1], n[:, 2], u, v,
                        mat.to(t.dtype), pid.to(t.dtype)], dim=1)


def unpack_best_planar(pk):
    """[R, 8] -> (t, n [R,3], u, v, mat int32, pid int32)."""
    return (pk[:, 0], pk[:, 1:4], pk[:, 4], pk[:, 5],
            torch.round(pk[:, 6]).to(torch.int32),
            torch.round(pk[:, 7]).to(torch.int32))


def pack_best_sphere(t, center, rad, mat, pid) -> torch.Tensor:
    """Sphere best hit -> [R, 8] (t cx cy cz rad 0 mat pid)."""
    return torch.stack([t, center[:, 0], center[:, 1], center[:, 2], rad,
                        torch.zeros_like(t), mat.to(t.dtype),
                        pid.to(t.dtype)], dim=1)


def unpack_best_sphere(pk):
    """[R, 8] -> (t, center [R,3], rad, mat int32, pid int32)."""
    return (pk[:, 0], pk[:, 1:4], pk[:, 4],
            torch.round(pk[:, 6]).to(torch.int32),
            torch.round(pk[:, 7]).to(torch.int32))


# -------------------------------------------------------- plain version
def _dot3(ax, ay, az, b):
    """[R,C] dot of per-lane component planes with a per-ray [R,3] vector,
    summed left to right."""
    return ax * b[:, 0:1] + ay * b[:, 1:2] + az * b[:, 2:3]


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _planar_slot(org, dirs, row, tmin, t_best, triangle):
    """[R, C] candidate t (inf = miss), edge coefficients a, b and the
    unit normal planes, for each ray against its gathered row [R, 9, C]
    (pallas_sweep.py:94-140, op for op)."""
    cx, cy, cz = row[:, 0], row[:, 1], row[:, 2]
    eux, euy, euz = row[:, 3], row[:, 4], row[:, 5]
    evx, evy, evz = row[:, 6], row[:, 7], row[:, 8]

    nx, ny, nz = _cross3(eux, euy, euz, evx, evy, evz)
    nn = nx * nx + ny * ny + nz * nz
    # torch.rsqrt runs CUDA's rsqrtf on a CUDA tensor; the kernel calls the
    # same function
    inv_len = torch.rsqrt(torch.clamp(nn, min=1e-30))
    unx, uny, unz = nx * inv_len, ny * inv_len, nz * inv_len
    d_plane = unx * cx + uny * cy + unz * cz
    inv_nn = 1.0 / torch.clamp(nn, min=1e-20)
    wx, wy, wz = nx * inv_nn, ny * inv_nn, nz * inv_nn
    ewx, ewy, ewz = _cross3(evx, evy, evz, wx, wy, wz)        # ev x w
    wex, wey, wez = _cross3(wx, wy, wz, eux, euy, euz)        # w x eu

    o_n = _dot3(unx, uny, unz, org)
    d_n = _dot3(unx, uny, unz, dirs)
    ok0 = torch.abs(d_n) > 1e-20
    t = torch.where(ok0, (d_plane - o_n) / torch.where(ok0, d_n, torch.ones_like(d_n)),
                    torch.full_like(d_n, BIG))
    a = torch.clamp(_dot3(ewx, ewy, ewz, org) + t * _dot3(ewx, ewy, ewz, dirs)
                    - (ewx * cx + ewy * cy + ewz * cz), -BIG, BIG)
    b = torch.clamp(_dot3(wex, wey, wez, org) + t * _dot3(wex, wey, wez, dirs)
                    - (wex * cx + wey * cy + wez * cz), -BIG, BIG)
    if triangle:
        interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    else:
        interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    ok = ok0 & (t >= tmin) & (t <= t_best[:, None]) & interior
    return torch.where(ok, t, torch.full_like(t, INF)), (unx, uny, unz, a, b)


def _sphere_slot(org, dirs, time, row, tmin, t_best):
    """[R, C] sphere t against each ray's gathered row [R, 7, C], and the
    center-at-time and radius planes (pallas_sweep.py:143-172)."""
    c0x, c0y, c0z = row[:, 0], row[:, 1], row[:, 2]
    c1x, c1y, c1z = row[:, 3], row[:, 4], row[:, 5]
    rad = row[:, 6]
    tt = time[:, None]
    ctx = c0x + tt * (c1x - c0x)
    cty = c0y + tt * (c1y - c0y)
    ctz = c0z + tt * (c1z - c0z)
    ocx = org[:, 0:1] - ctx
    ocy = org[:, 1:2] - cty
    ocz = org[:, 2:3] - ctz
    d0, d1, d2 = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    a_q = d0 * d0 + d1 * d1 + d2 * d2
    b_q = 2.0 * (d0 * ocx + d1 * ocy + d2 * ocz)
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b_q * b_q - 4.0 * a_q * c_q
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t0 = (-b_q - sq) / (2.0 * a_q)
    t1 = (-b_q + sq) / (2.0 * a_q)
    tb = t_best[:, None]
    in0 = (t0 >= tmin) & (t0 <= tb)
    in1 = (t1 >= tmin) & (t1 <= tb)
    inf = torch.full_like(t0, INF)
    t = torch.where(in0, t0, torch.where(in1, t1, inf))
    return torch.where(has, t, inf), (ctx, cty, ctz, rad)


def sweep_plain(rays, ids, nears, best, table, tmin: float, triangle: bool,
                sphere: bool, stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch K4 (and K7, whose rows are narrower): the updated
    [R, 8] best. Every slot is computed for every ray and masked, as in
    the Pallas kernel, so nothing waits on the host. ``stats``, when given,
    gains ``"visits"``: the (ray, slot) pairs whose entry t was below the
    running best (what the kernel reads and intersects; it synchronises
    once per slot)."""
    K, _, C = table.shape
    return _sweep_rows_plain(rays, ids, nears, best, K, C, table.__getitem__, tmin,
                             triangle, sphere, stats)


def dequant_q16(words, lo, scale) -> torch.Tensor:
    """[..., 5, C] u16-pair words (int32) and their chunks' [..., 3] lo and
    scale -> the [..., 9, C] float row (corner, eu, ev): corner = lo + q0 *
    scale, edges (q1 - q0) * scale and (q2 - q0) * scale per axis, each
    product and sum rounded on its own (K8 dequantizes with the same
    operations)."""
    hi16 = ((words >> 16) & 0xFFFF).to(torch.float32)
    lo16 = (words & 0xFFFF).to(torch.float32)
    q = torch.stack([hi16, lo16], dim=-2).flatten(-3, -2)       # [..., 10, C]
    q0, q1, q2 = q[..., 0:3, :], q[..., 3:6, :], q[..., 6:9, :]
    s = scale[..., :, None]
    return torch.cat([lo[..., :, None] + q0 * s, (q1 - q0) * s, (q2 - q0) * s], dim=-2)


def sweep_q16_plain(rays, ids, nears, best, words, lo, scale, tmin: float,
                    triangle: bool) -> torch.Tensor:
    """Plain PyTorch K8: ``sweep_plain``'s planar sweep over quantized rows
    [K, 5, C], each gathered row dequantized (``dequant_q16``) before the
    test."""
    K, _, C = words.shape
    return _sweep_rows_plain(rays, ids, nears, best, K, C,
                             lambda i: dequant_q16(words[i], lo[i], scale[i]), tmin,
                             triangle, False)


def q16_group_boxes(words, lo, scale, pad: float = Q16_PAD, triangle: bool = True):
    """K8's group boxes of quantized rows [K, 5, C] (int32 words, [K, 3]
    lo and scale), built with the kernel's operations (for the tests and
    chip_smoke.py; the kernel builds its own) -> (blo [K, G, 3], bhi
    [K, G, 3], A [K, G, 3], C [K, G, 3], live [K, G] bool), G = C /
    Q16_GROUP: the integer min and max per axis of each group's u16 points
    (quads with their fourth corner q1 + q2 - q0), over the primitives
    whose normal is not zero (``live``: a group that has one), dequantized
    as lo + q * scale. A ray whose origin's largest |component| is R tests
    them padded on axis i by C_i + A_i R (the note in csrc/visit_sweep.cu:
    ``pad`` u times the group's maxima of 64 S (r_i + s_i) + S nu_i + 128
    and, with B, of (64 S (r_i + s_i) + 8 S nu_i) L); C = inf where a
    primitive's S = |eu| |ev| / |n| exceeds ``Q16_MAX_SKEW`` or its |n|^2
    lies below 1e-20 (never skipped). ``pad`` 0 pads nothing, not even
    those groups."""
    K, _, C = words.shape
    group = Q16_GROUP
    G = C // group
    q = torch.stack([(words >> 16) & 0xFFFF, words & 0xFFFF], dim=-2).flatten(-3, -2)
    q0, q1, q2 = q[:, 0:3], q[:, 3:6], q[:, 6:9]                       # [K, 3, C]
    pts = torch.stack([q0, q1, q2] if triangle else [q0, q1, q2, q1 + q2 - q0])
    x = dequant_q16(words, lo, scale)
    eu, ev = x[:, 3:6], x[:, 6:9]
    n = torch.stack(_cross3(eu[:, 0], eu[:, 1], eu[:, 2], ev[:, 0], ev[:, 1], ev[:, 2]), 1)
    live = (n != 0).any(1)                                             # [K, C]
    nn = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    uu = eu[:, 0] * eu[:, 0] + eu[:, 1] * eu[:, 1] + eu[:, 2] * eu[:, 2]
    vv = ev[:, 0] * ev[:, 0] + ev[:, 1] * ev[:, 1] + ev[:, 2] * ev[:, 2]
    ratio = uu * vv / nn
    # beyond the skew limit, or |n|^2 below the 1e-20 that w = n / |n|^2
    # clamps it to (the primitive is then hit scaled up about its corner)
    ill = live & (~(ratio <= Q16_MAX_SKEW * Q16_MAX_SKEW) | (nn < 1e-20))
    ok = (live & ~ill)[:, None]
    skew = torch.sqrt(torch.fmax(ratio, torch.ones_like(ratio)))[:, None]
    lu, lv, ln = (torch.sqrt(y)[:, None] for y in (uu, vv, nn))
    srs = skew * (eu.abs() / lu + ev.abs() / lv)                       # [K, 3, C]
    snu = skew * (n.abs() / ln)
    zero = torch.zeros_like(srs)
    ta = torch.where(ok, 64.0 * srs + snu + 128.0, zero)
    td = torch.where(ok, (64.0 * srs + 8.0 * snu) * (lu + lv), zero)
    a_max = ta.reshape(K, 3, G, group).amax(-1).transpose(1, 2)        # [K, G, 3]
    d_max = td.reshape(K, 3, G, group).amax(-1).transpose(1, 2)
    big = torch.full_like(q0, 1 << 30)
    qlo = torch.where(live[:, None], pts.amin(0), big).reshape(K, 3, G, group).amin(-1)
    qhi = torch.where(live[:, None], pts.amax(0), -big).reshape(K, 3, G, group).amax(-1)
    blo = (lo[:, :, None] + qlo.to(torch.float32) * scale[:, :, None]).transpose(1, 2)
    bhi = (lo[:, :, None] + qhi.to(torch.float32) * scale[:, :, None]).transpose(1, 2)
    B = torch.maximum(lo.abs().amax(-1, keepdim=True),
                      torch.maximum(blo.abs(), bhi.abs()).amax(-1))[..., None]
    A = pad * a_max
    Cp = pad * (a_max * B + d_max)
    if pad > 0:
        g_ill = ill.reshape(K, G, group).any(-1)[..., None]
        A = torch.where(g_ill, torch.zeros_like(A), A)
        Cp = torch.where(g_ill, torch.full_like(Cp, INF), Cp)
    return (blo.contiguous(), bhi.contiguous(), A.contiguous(), Cp.contiguous(),
            live.reshape(K, G, group).any(-1))


def q16_group_slab(rays, blo, bhi, A, C):
    """K8's slab test, with the kernel's operations, of each ray [R, 8]
    against G padded group boxes gathered per ray (blo, bhi, A, C
    [R, G, 3]) -> (entry, exit) [R, G]. A lane enters a group when exit >=
    tmin and entry <= its limit; every candidate t of the group's
    primitives lies in [entry, exit] (the note in csrc/visit_sweep.cu)."""
    o = rays[:, None, 0:3]
    d = rays[:, 3:6]
    ro = torch.fmax(o[..., 0].abs(), torch.fmax(o[..., 1].abs(), o[..., 2].abs()))
    # 1/d in IEEE division (a Python scalar over a tensor would be its
    # reciprocal times the scalar); +-inf for a zero or subnormal component
    inv = torch.where(d.abs() >= 2.0 ** -126, torch.ones_like(d) / d,
                      torch.copysign(torch.full_like(d, INF), d))[:, None, :]
    pad = C + A * ro[..., None]
    t0 = ((blo - pad) - o) * inv
    t1 = ((bhi + pad) - o) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    entry = torch.fmax(near[..., 0], torch.fmax(near[..., 1], near[..., 2]))
    exit_ = torch.fmin(far[..., 0], torch.fmin(far[..., 1], far[..., 2]))
    return entry, exit_


def _sweep_rows_plain(rays, ids, nears, best, K, C, gather, tmin, triangle, sphere,
                      stats=None):
    """The sequential sweep over rows ``gather(chunk ids [R]) -> [R, F, C]``."""
    R, V = ids.shape
    org, dirs, time = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    ids = torch.clamp(ids, 0, K - 1)
    lane = torch.arange(C, device=rays.device)[None, :]
    best = best.clone()
    for s in range(V):
        t_b = best[:, 0]
        ns = nears[:, s]
        row = gather(ids[:, s])                               # [R, F, C]
        if sphere:
            ts, planes = _sphere_slot(org, dirs, time, row, tmin, t_b)
        else:
            ts, planes = _planar_slot(org, dirs, row, tmin, t_b, triangle)
        t_c = torch.amin(ts, dim=1)
        idx = torch.amin(torch.where(ts == t_c[:, None], lane,
                                     torch.full_like(lane, C)), dim=1)

        def sel(plane):
            return plane.gather(1, idx[:, None])[:, 0]

        better = (t_c < t_b) & (ns < t_b)
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + int((ns < t_b).sum())
        if sphere:
            ctx, cty, ctz, rad = planes
            cols = [sel(ctx), sel(cty), sel(ctz),
                    torch.clamp(sel(rad), min=1e-20), best[:, 5]]
        else:
            cols = [sel(p) for p in planes]
        pid = ids[:, s].to(torch.float32) * C + idx.to(torch.float32)
        new = torch.stack([t_c] + cols + [best[:, 6], pid], dim=1)
        best = torch.where(better[:, None], new, best)
    return best


def _slot_ts(org, dirs, time, row, tmin, t_lim, triangle, sphere):
    if sphere:
        return _sphere_slot(org, dirs, time, row, tmin, t_lim)
    return _planar_slot(org, dirs, row, tmin, t_lim, triangle)


def _first_min(ts):
    """Row minimum of [n, C] candidate t and its first lane."""
    C = ts.shape[1]
    lane = torch.arange(C, device=ts.device)[None, :]
    t_c = torch.amin(ts, dim=1)
    idx = torch.amin(torch.where(ts == t_c[:, None], lane, torch.full_like(lane, C)),
                     dim=1)
    return t_c, idx


def sweep_fold_plain(rays, ids, nears, best, table, tmin: float, triangle: bool,
                     sphere: bool) -> torch.Tensor:
    """``sweep_plain``'s result by the kernel's decomposition (for the
    tests): every slot whose near is below the INPUT best t gets its row's
    first-index minimum (t, lane) with candidates limited to that input t;
    then each ray folds its slots in order (accept when t_s < t_run and
    near_s < t_run) and the winner's columns are derived again from its
    (chunk, lane). Equal to ``sweep_plain`` bit for bit: see the exactness
    note in ``csrc/visit_sweep.cu``."""
    K, _, C = table.shape
    R, V = ids.shape
    org, dirs, time = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    ids = torch.clamp(ids, 0, K - 1)
    t_in = best[:, 0]
    t_s = torch.full((R, V), INF, dtype=torch.float32, device=rays.device)
    lane_s = torch.zeros((R, V), dtype=torch.int64, device=rays.device)
    for s in range(V):
        vis = nears[:, s] < t_in
        ts, _ = _slot_ts(org[vis], dirs[vis], time[vis], table[ids[vis, s]], tmin,
                         t_in[vis], triangle, sphere)
        t_s[vis, s], lane_s[vis, s] = _first_min(ts)
    t_run = t_in.clone()
    win = torch.full((R,), -1, dtype=torch.int64, device=rays.device)
    for s in range(V):
        better = (nears[:, s] < t_run) & (t_s[:, s] < t_run)
        t_run = torch.where(better, t_s[:, s], t_run)
        win = torch.where(better, s, win)
    out = best.clone()
    r = torch.nonzero(win >= 0)[:, 0]
    cid = ids[r, win[r]]
    lane = lane_s[r, win[r]]
    _, planes = _slot_ts(org[r], dirs[r], time[r], table[cid], tmin, t_run[r],
                         triangle, sphere)

    def sel(plane):
        return plane.gather(1, lane[:, None])[:, 0]

    if sphere:
        ctx, cty, ctz, rad = planes
        cols = [sel(ctx), sel(cty), sel(ctz), torch.clamp(sel(rad), min=1e-20),
                best[r, 5]]
    else:
        cols = [sel(p) for p in planes]
    pid = cid.to(torch.float32) * C + lane.to(torch.float32)
    out[r] = torch.stack([t_run[r]] + cols + [best[r, 6], pid], dim=1)
    return out


# ---------------------------------------------------------- kernel call
def scratch_ints(R: int, V: int, K: int) -> int:
    """int32 scratch of one kernel call (``csrc/visit_sweep.cu``'s
    layout): (t, lane) per slot, the visit list, the per-chunk counts and
    a ticket, the bucket and tile offsets (K chunks: K7's buckets too)."""
    return 3 * R * V + 3 * K + 3


def q16_scratch_ints(R: int, V: int, K: int) -> int:
    """The int32 K8 adds after ``scratch_ints``: up to 3 to reach a 16-byte
    boundary, each row's constants [3, 128] and group boxes [4, 3] as
    float4 and a flag per group, and each tile's (chunk, first slot, slots,
    0) as int4, at most R*V/32 + K tiles (its row stage's output)."""
    return (3 + K * (3 * CHUNK_C * 4 + (CHUNK_C // Q16_GROUP) * (3 * 4 + 1))
            + 4 * (R * V // 32 + K))


def _launch(kid, name, rays, ids, nears, best, table, tmin, triangle, sphere,
            frames=None, shift=None, stages=4):
    """Check one call's inputs and launch ``name`` on CUDA tensors -> the
    updated [R, 8] best: K4 or K8 (``frames``), or K7 on sub-tile rows of
    128 >> ``shift`` lanes, its first ``stages`` stages."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad(f"crt_{name}", rays, nears, best, table, *(frames or ()))
    K, F, C = table.shape
    R, V = ids.shape
    tbl.check_cuda("rays", rays, torch.float32, (R, 8))
    tbl.check_cuda("ids", ids, torch.int32, (R, V))
    tbl.check_cuda("nears", nears, torch.float32, (R, V))
    tbl.check_cuda("best", best, torch.float32, (R, 8))
    tbl.check_cuda("table", table, torch.int32 if frames else torch.float32, (K, F, C))
    for label, x in zip(("lo", "scale"), frames or ()):
        tbl.check_cuda(label, x, torch.float32, (K, 3))
    if R * V >= 2**31:
        raise ValueError(f"{kid} indexes slots with int32: R*V = {R * V} is too many")
    devs = {x.device for x in (rays, ids, nears, best, table, *(frames or ()))}
    if len(devs) != 1:
        raise ValueError("the sweep's inputs lie on different devices")
    out = torch.empty((R, 8), dtype=torch.float32, device=rays.device)
    buckets = K if shift is None else K >> shift
    extra = q16_scratch_ints(R, V, K) if frames else 0
    scratch = torch.empty((scratch_ints(R, V, buckets) + extra,), dtype=torch.int32,
                          device=rays.device)
    lib = build.load()
    ptrs = (rays.data_ptr(), ids.data_ptr(), nears.data_ptr(), best.data_ptr(),
            table.data_ptr())
    flags = (float(tmin), int(bool(triangle)), int(bool(sphere)))
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        if shift is not None:
            err = lib.crt_subtile_sweep(*ptrs, R, V, K, shift, *flags,
                                        scratch.data_ptr(), out.data_ptr(), stages, stream)
        else:
            lo, scale = (x.data_ptr() for x in frames) if frames else (None, None)
            err = lib.crt_visit_sweep(*ptrs, lo, scale, R, V, K, C, *flags,
                                      int(frames is not None), scratch.data_ptr(),
                                      out.data_ptr(), stages, stream)
    if err != 0:
        raise RuntimeError(f"crt_{name} launch failed: {build.error_string(err)}")
    LAUNCHES[name] += 1
    return out


def _rows(sphere: bool) -> int:
    return SPHERE_ROWS if sphere else PLANAR_ROWS


def sweep_kernel(rays, ids, nears, best, table, tmin: float, triangle: bool,
                 sphere: bool) -> torch.Tensor:
    """Kernel K4 on CUDA tensors -> the updated [R, 8] best."""
    if tuple(table.shape[1:]) != (_rows(sphere), CHUNK_C):
        raise ValueError(f"K4 takes [K, {_rows(sphere)}, {CHUNK_C}] tables, got "
                         f"{tuple(table.shape)}")
    return _launch("K4", "visit_sweep", rays, ids, nears, best, table, tmin, triangle,
                   sphere)


def sweep_sub_kernel(rays, ids, nears, best, table, tmin: float, triangle: bool,
                     sphere: bool, stages: int = 4) -> torch.Tensor:
    """Kernel K7 on CUDA tensors: the sweep over sub-tile rows [K*G, F, CS]
    (whole chunks: G = 128/CS rows each) -> the updated [R, 8] best.
    ``stages`` below 4 runs the memset and only that many of its stages,
    leaving the result unwritten: only to time the stages apart
    (``utils/profiling.sweep_stage_ms``)."""
    KG, F, CS = table.shape
    if F != _rows(sphere) or CS < 1 or CHUNK_C % CS or KG % (CHUNK_C // CS):
        raise ValueError(f"K7 takes [K*G, {_rows(sphere)}, CS] tables, CS dividing "
                         f"{CHUNK_C} and G = {CHUNK_C}/CS rows a chunk, got "
                         f"{tuple(table.shape)}")
    return _launch("K7", "visit_sweep_sub", rays, ids, nears, best, table, tmin,
                   triangle, sphere, shift=(CHUNK_C // CS).bit_length() - 1,
                   stages=stages)


def sweep_q16_kernel(rays, ids, nears, best, words, lo, scale, tmin: float,
                     triangle: bool, stages: int = 4) -> torch.Tensor:
    """Kernel K8 on CUDA tensors: the planar sweep over quantized rows
    [K, 5, 128] int32 with their chunks' lo and scale [K, 3] -> the updated
    [R, 8] best. ``stages`` below 4 runs the memset and only that many of
    its stages, leaving the result unwritten: only to time the stages apart
    (``utils/profiling.sweep_stage_ms``)."""
    if tuple(words.shape[1:]) != (Q16_WORDS, 128):
        raise ValueError(f"K8 takes [K, {Q16_WORDS}, 128] word tables, got "
                         f"{tuple(words.shape)}")
    return _launch("K8", "visit_sweep_q16", rays, ids, nears, best, words, tmin,
                   triangle, False, frames=(lo, scale), stages=stages)


def sweep(rays, ids, nears, best, table, tmin: float, triangle: bool,
          sphere: bool) -> torch.Tensor:
    """One V-slot sweep -> the updated [R, 8] best: kernel K4 on CUDA
    tensors, the plain version on CPU tensors. ``rays`` [R,8]
    (``pack_rays``), ``ids`` [R,V] int32 (clipped to [0, K-1] here),
    ``nears`` [R,V] ascending entry t, ``best`` [R,8], ``table`` [K,F,C].
    V and C come from the shapes."""
    if rays.device.type == "cpu":
        return sweep_plain(rays, ids, nears, best, table, tmin, triangle,
                           sphere)
    return sweep_kernel(rays, ids, nears, best, table, tmin, triangle, sphere)


def sweep_sub(rays, ids, nears, best, table, tmin: float, triangle: bool,
              sphere: bool) -> torch.Tensor:
    """One sweep over sub-tile rows [K*G, F, CS] (``ids`` name sub-tiles)
    -> the updated [R, 8] best: kernel K7 on CUDA tensors, ``sweep_plain``
    on CPU tensors."""
    if rays.device.type == "cpu":
        return sweep_plain(rays, ids, nears, best, table, tmin, triangle, sphere)
    return sweep_sub_kernel(rays, ids, nears, best, table, tmin, triangle, sphere)


def sweep_q16(rays, ids, nears, best, words, lo, scale, tmin: float,
              triangle: bool) -> torch.Tensor:
    """One planar sweep over quantized rows -> the updated [R, 8] best:
    kernel K8 on CUDA tensors, ``sweep_q16_plain`` on CPU tensors."""
    if rays.device.type == "cpu":
        return sweep_q16_plain(rays, ids, nears, best, words, lo, scale, tmin, triangle)
    return sweep_q16_kernel(rays, ids, nears, best, words, lo, scale, tmin, triangle)
