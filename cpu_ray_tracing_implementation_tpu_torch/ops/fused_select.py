"""Fused per-ray chunk cull + top-V select: the wrapper of CUDA kernel K3.

Port of ``cpu_ray_tracing_implementation_tpu/ops/pallas_select.py``. Each
ray is slab-tested against all K chunk AABBs and the V nearest crossed
chunks are selected, ascending by (entry t, chunk id), without an [R, K]
matrix in device memory (``csrc/cull_select.cu``).

Phase semantics (the per-ray accelerator's exactness loop,
``ops/perray.py``): a phase excludes everything at or below its
predecessor's last selected key (thr, last id), so consecutive phases
partition the whole ordered visit list. A ray the loop no longer needs
gets an exhausted key (``next_excl(..., done)``), which excludes every
box: the kernel walks no box for it and returns exhausted slots, as the
plain version does.

Packed mode (the default, needs tmin > 0) selects on one int32 key
(near's f32 bits with the low IDB bits cleared | chunk id): the nears it
returns are rounded down by the stolen bits, which only ever makes the
phase loop do more work, never less. An exhausted slot returns NaN. Exact
mode selects on (near, id) lexicographically with a first-index tie-break
and returns +inf (and id 0) for an exhausted slot.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version ``cull_select_plain``; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

BIG = 1e30
INF = float("inf")
MASKV = 0x7FFFFFFF        # above every real key
# the visit-block sizes the kernel is built for (ops/perray.py takes min(V,
# K), V = 16 by default, CRT_RAYV, or 24 on the sub-tile route); a larger
# block (the sub-tile route's 64 at CRT_SUBC=2, 128 at 1) chains selections
# of at most V_MAX slots (``cull_select``)
V_MAX = 32
# exact mode's exhausted last id: past every chunk id (ids travel as f32,
# exact below 2^24), so (+inf, EXHAUSTED_ID) excludes every box
EXHAUSTED_ID = float(1 << 24)

LAUNCHES = {"cull_select": 0}


def reset_launches() -> None:
    LAUNCHES["cull_select"] = 0


def id_bits(Kp: int) -> int:
    """Low key bits holding the chunk id (packed mode)."""
    return max(11, (Kp - 1).bit_length())


def pack_rays(org, dirs, cap) -> torch.Tensor:
    """[R, 8] ray rows: org xyz, dir xyz, cap (the per-ray traversal
    bound), pad."""
    R = org.shape[0]
    rays = torch.zeros((R, 8), dtype=torch.float32, device=org.device)
    rays[:, 0:3] = org
    rays[:, 3:6] = dirs
    rays[:, 6] = cap
    return rays


def pack_boxes(lo, hi) -> torch.Tensor:
    """[8, Kp] AABB pack (rows lo xyz, hi xyz, pad), chunks padded to a
    multiple of 128 with inverted boxes that never cull in."""
    K = lo.shape[0]
    Kp = -(-K // 128) * 128
    pack = torch.full((8, Kp), BIG, dtype=torch.float32, device=lo.device)
    pack[0:3, :K] = lo.T
    pack[3:6, :K] = hi.T
    pack[3:6, K:] = -BIG
    return pack


def first_excl(R: int, device) -> torch.Tensor:
    """[R, 2] phase-1 exclusion key (threshold -BIG, last id -1): exclude
    nothing."""
    excl = torch.empty((R, 2), dtype=torch.float32, device=device)
    excl[:, 0] = -BIG
    excl[:, 1] = -1.0
    return excl


def packed_mode(tmin: float, packed: bool = True) -> bool:
    """Whether K3 selects on packed keys: asked for, and tmin > 0 (a packed
    key's near must be non-negative)."""
    return bool(packed) and float(tmin) > 0.0


def next_excl(ids, nears, done=None, tmin=None, packed: bool = True) -> torch.Tensor:
    """[R, 2] exclusion key of the phase after one that returned (ids,
    nears): its last selected (near, id). Rows where the [R] bool ``done``
    holds get the exhausted key, which excludes every box, so the kernel
    walks no box for them: a NaN threshold in packed mode, +inf with last
    id ``EXHAUSTED_ID`` in exact mode (``tmin`` and ``packed`` as given to
    the phase's ``cull_select``, which picks the mode by ``packed_mode``)."""
    excl = torch.stack([nears[:, -1], ids[:, -1].to(torch.float32)], dim=1)
    if done is not None:
        thr, last = ((float("nan"), -1.0) if packed_mode(tmin, packed)
                     else (INF, EXHAUSTED_ID))
        excl[:, 0].masked_fill_(done, thr)
        excl[:, 1].masked_fill_(done, last)
    return excl


# -------------------------------------------------------- plain version
def _near_matrix(rays, boxes, K_real: int, tmin: float) -> torch.Tensor:
    """[R, Kp] entry t of each ray into each box, +inf where its [tmin, cap]
    interval misses (pallas_select.py:48-67, op for op)."""
    R, Kp = rays.shape[0], boxes.shape[1]
    near = torch.full((R, Kp), -BIG, dtype=torch.float32, device=rays.device)
    far = torch.full((R, Kp), BIG, dtype=torch.float32, device=rays.device)
    for a in range(3):
        o = rays[:, a:a + 1]
        d = rays[:, 3 + a:4 + a]
        inv = 1.0 / torch.where(torch.abs(d) > 1e-20, d,
                                torch.full_like(d, 1e-20))
        t0 = (boxes[a:a + 1, :] - o) * inv
        t1 = (boxes[3 + a:4 + a, :] - o) * inv
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    cap = rays[:, 6:7]
    col = torch.arange(Kp, device=rays.device)[None, :]
    ok = (near <= far) & (far >= tmin) & (near <= cap) & (col < K_real)
    return torch.where(ok, torch.clamp(near, min=tmin),
                       torch.full_like(near, INF))


def cull_select_plain(rays, boxes, excl, V: int, K_real: int, tmin: float,
                      packed: bool = True):
    """Plain PyTorch K3: the Pallas kernel's V selection rounds over the
    [R, Kp] near matrix. Returns (ids [R,V] int32, nears [R,V] f32,
    rest [R] f32)."""
    packed = packed_mode(tmin, packed)
    R, Kp = rays.shape[0], boxes.shape[1]
    nearm = _near_matrix(rays, boxes, K_real, tmin)
    col = torch.arange(Kp, dtype=torch.int32, device=rays.device)[None, :]
    thr = excl[:, 0:1]
    lid = excl[:, 1:2].to(torch.int32)
    ids = torch.empty((R, V), dtype=torch.int32, device=rays.device)
    nears = torch.empty((R, V), dtype=torch.float32, device=rays.device)

    if packed:
        hmask = -(1 << id_bits(Kp))
        key = (nearm.view(torch.int32) & hmask) | col
        thr_bits = ((torch.clamp(thr, min=0.0).view(torch.int32) & hmask)
                    | torch.clamp(lid, min=0))
        excl_key = torch.where(
            thr >= 0.0, thr_bits,
            torch.where(torch.isnan(thr), torch.full_like(thr_bits, MASKV),
                        torch.zeros_like(thr_bits)))
        maskv = torch.full_like(key, MASKV)
        key = torch.where(key <= excl_key, maskv, key)
        for v in range(V):
            m = torch.amin(key, dim=1, keepdim=True)
            ids[:, v:v + 1] = m & ~hmask
            nears[:, v:v + 1] = (m & hmask).view(torch.float32)
            key = torch.where(key == m, maskv, key)
        rest = (torch.amin(key, dim=1) & hmask).view(torch.float32)
        return ids, nears, rest

    visited = (nearm < thr) | ((nearm == thr) & (col <= lid))
    inf = torch.full_like(nearm, INF)
    nearm = torch.where(visited, inf, nearm)
    for v in range(V):
        m = torch.amin(nearm, dim=1, keepdim=True)
        idx = torch.amin(torch.where(nearm == m, col, torch.full_like(col, Kp)),
                         dim=1, keepdim=True)
        ids[:, v:v + 1] = idx
        nears[:, v:v + 1] = m
        nearm = torch.where(col == idx, inf, nearm)
    return ids, nears, torch.amin(nearm, dim=1)


# ---------------------------------------------------------- kernel call
def check_v(V: int) -> None:
    """Raise for a visit block the kernel is not built for (``cull_select``
    chains larger ones)."""
    if not (1 <= V <= V_MAX):
        raise ValueError(f"K3 is built for V in 1..{V_MAX}, got {V}")


def cull_select_kernel(rays, boxes, excl, V: int, K_real: int, tmin: float,
                       packed: bool = True):
    """Kernel K3 on CUDA tensors: rays [R,8], boxes [8,Kp], excl [R,2]
    f32 -> (ids [R,V] int32, nears [R,V] f32, rest [R] f32)."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad("crt_cull_select", rays, boxes, excl)
    packed = packed_mode(tmin, packed)
    R, Kp = rays.shape[0], boxes.shape[1]
    tbl.check_cuda("rays", rays, torch.float32, (R, 8))
    tbl.check_cuda("boxes", boxes, torch.float32, (8, Kp))
    tbl.check_cuda("excl", excl, torch.float32, (R, 2))
    check_v(V)
    if Kp % 128 or not (0 < K_real <= Kp):
        raise ValueError(f"boxes must hold K_real={K_real} chunks padded to a "
                         f"multiple of 128, got {Kp}")
    if rays.device != boxes.device or rays.device != excl.device:
        raise ValueError("rays, boxes and excl lie on different devices")
    ids = torch.empty((R, V), dtype=torch.int32, device=rays.device)
    nears = torch.empty((R, V), dtype=torch.float32, device=rays.device)
    rest = torch.empty((R,), dtype=torch.float32, device=rays.device)
    lib = build.load()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.crt_cull_select(rays.data_ptr(), boxes.data_ptr(),
                                  excl.data_ptr(), R, Kp, K_real, V,
                                  float(tmin), int(bool(packed)),
                                  id_bits(Kp), ids.data_ptr(),
                                  nears.data_ptr(), rest.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crt_cull_select launch failed: "
                           f"{build.error_string(err)}")
    LAUNCHES["cull_select"] += 1
    return ids, nears, rest


def cull_select(rays, boxes, excl, V: int, K_real: int, tmin: float,
                packed: bool = True):
    """(ids [R,V] int32, nears [R,V] f32 ascending, rest [R] f32): kernel
    K3 on CUDA tensors, the plain version on CPU tensors.

    ``rays``: [R,8] (``pack_rays``); ``boxes``: [8,Kp] (``pack_boxes``);
    ``excl``: [R,2] (threshold, last id as f32), ``first_excl`` for phase
    1, ``next_excl`` after. ``rest`` is the nearest chunk left unselected.

    V above ``V_MAX`` runs ceil(V / V_MAX) selections of at most V_MAX
    slots, each from the exclusion key of the one before, the rays it left
    exhausted marked done; the ids and nears are concatenated and ``rest``
    is the last one's. That is one selection at V bit for bit: a selection
    excludes exactly the keys at or below its predecessor's last, which are
    the ones already taken, and an exhausted ray's later slots are
    exhausted either way.
    """
    if V < 1:
        raise ValueError(f"K3 selects V >= 1 slots, got {V}")
    select = cull_select_plain if rays.device.type == "cpu" else cull_select_kernel
    sizes = [V_MAX] * ((V - 1) // V_MAX)
    sizes.append(V - sum(sizes))
    parts = []
    for v in sizes:
        if parts:
            ids, nears, _ = parts[-1]
            last = nears[:, -1]
            done = torch.isnan(last) if packed_mode(tmin, packed) else torch.isposinf(last)
            excl = next_excl(ids, nears, done, tmin, packed)
        parts.append(select(rays, boxes, excl, v, K_real, tmin, packed))
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1), parts[-1][2])
