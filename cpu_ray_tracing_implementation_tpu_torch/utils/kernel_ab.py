"""Kernels K1, K2, K4, K5, K6, K7, K8 and K9 of other checkouts of the port
beside this one's, held to one another and timed in turns on one GPU; and,
with ``--walls``, the packet-routed renders' walls the same way.

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.kernel_ab [--only PREFIX[,PREFIX]] ROOT [ROOT ...]
    python -m cpu_ray_tracing_implementation_tpu_torch.utils.kernel_ab --walls ROOT [ROOT ...]

ROOT is the root of another checkout (the parent commit, for example,
unpacked with ``git archive`` into the gitignored ``_scratch/``) whose
``fused_intersect`` has ``planar_closest_kernel`` and
``sphere_closest_kernel``, whose ``fused_sweep`` has ``sweep_kernel``,
``sweep_sub_kernel`` and ``sweep_q16_kernel``, whose ``packet`` has
``packet_planar_kernel`` and ``packet_sphere_kernel``, whose
``gather_probe`` has ``gather_sum_kernel``, whose ``fused_scatter`` (if
any) has ``scatter``, and whose ``profiling`` has
``cuda_ms``. This package makes the inputs and saves
them under ``build/`` (``--only K6`` keeps the cases whose label starts
with "K6", and makes no other case's inputs; ``--only K4,K7,K8`` those of
the three sweeps):

- ``CASES``, K1 on cornell_box's 1-chunk view, K2 on three_material_ball's
  and random_motion_ball's: 512*512 primary rays of the scene's camera and
  rays leaving their hits in random directions (``profiling.camera_rays``
  and ``secondary``);
- K4 on the lists and input best of the per-ray phase
  loop (``profiling.sweep_phases``): the colonnade's (200x200) primary
  rays at phases 1, 2 (the rays phase 1 left done marked exhausted) and 3,
  its secondary rays (leaving the primary hits in random directions, a
  tenth dead) at phase 1, sphereflake's 160,000 primary rays, and 40,000
  random rays against a random table of 6,000 moving spheres in 47 chunks;
- K7 on the sub-tile route's phase-1 lists and input best (the same loop
  under ``CRT_SUBTILE=1``): the colonnade's primary rays at CS 32 (8,060
  sub-tile boxes, V 24) and CS 16 (16,120, V 24), and sphereflake's
  primary rays at CS 32 (232 boxes; ``CRT_ACCEL=ray``); K8 on the
  colonnade's phase-1 lists of K4 over its quantized rows;
- K6 on the packet route's rays with their caps (``profiling.scene_rays``,
  ``intersect._packet_cap``): sphereflake's 160,000 primary rays, the
  same rays after one bounce, coherence-sorted (``raysort``), and
  perlin_texture_ball's 360,000 primary rays (quads), each at
  ``packet.AUTO_TILE`` and ``TILES`` (sphereflake's primary rays at
  2,048 too), and the 576-triangle Fox stand-in's primary and secondary
  rays (written with ``procgen.write_gltf`` as ``chip_smoke.py`` writes
  it) at ``packet.AUTO_TILE``;
- K9 (``SCATTER_CASE``) on the arguments of the Cornell box's second
  ``materials.scatter`` call at the scan cell's 600x600, one sample (a
  checkout without ``ops/fused_scatter.py`` skips it).

Then one process per turn, in the order this checkout, the others, the
others reversed, this one, imports the package of its own checkout (which
builds its own kernels), launches its kernels on those inputs (K1 and K2
with and without pid) and times each case with CUDA events (K1 and K2 at
their primary rays; K4, K7, K8 and K5 also by stage, from torch.profiler's
device time of their memset and kernels over 10 calls, each stage
with the kernels it counted (K8's row stage q16_derive and its tile
stage q16_sweep_tile; K5's row_sums and fold stages, or the first
kernel's one gather_sum_kernel), after every other timing of the turn;
K5 and K9 with their shares of the bound; K6 with its visits per tile, mean and max, and its
registers per thread and resident blocks per SM: ``packet.kernel_info``,
or, for a checkout without it, the same CUDA queries on its
``csrc/packet_closest.cu`` built into a probe). A checkout's first turn
prints the registers, spills and shared memory of its K4 and K8 tile
kernels and K8's row stage from its build's ``-Xptxas -v`` report. Every turn's outputs (all
8 rows or columns, the pid, and K6's visits) must equal the first turn's
bit for bit: the ones that differ are printed. K5's outputs are held to
the first turn's at the probe's measure (max |a - b| / (|b| + 1) <= 1e-5:
two designs sum each ray's 22,528 floats in f64 in other orders and round
once, so a few outputs may differ in their last bit), and the count of
bit-unequal outputs is printed. Prints the card's name and
power limit, then one line per turn and case.

``--walls``: each turn renders, after a 1-spp warm-up of each scene, the
packet-routed workloads of ``chip_smoke.py`` (``WALLS``: the sphereflake
wavefront and scan at 400x400x50 depth 5, perlin_texture_ball at
600x600x32 depth 5, textured_fox at 600x600x100 and glass_fox at
600x600x200 depth 5 on the 576-triangle stand-in) and prints each wall;
each image's mean must be within 2e-3 of the first turn's (the golden
atol), and the values whose bits differ are printed.
"""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TMIN = 1e-3
# (label, catalog scene, kernel)
CASES = (("K1 cornell_box", "cornell_box", "planar_closest"),
         ("K2 three_material_ball", "three_material_ball", "sphere_closest"),
         ("K2 random_motion_ball", "random_motion_ball", "sphere_closest"))
# the 576-triangle Fox stand-in (chip_smoke.py's FOX_STANDINS["fox576"] and
# FOX_NODE): an ellipsoid of 24 segments and 13 rings
FOX_MESH = (24, 13)
FOX_NODE = {"mesh": 0, "translation": [0.0, 45.0, 0.0],
            "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [1.2, 1.0, 1.2]}
# K7's widths on the colonnade (the default CRT_SUBC first, then the width
# at which its old count left shared memory)
SUB_TIMED = (32, 16)
# the tiles K6 is timed at on sphereflake's primary and secondary rays and
# perlin's primary rays besides packet.AUTO_TILE (and 2,048, JAX's, on
# sphereflake's primary rays)
TILES = (128, 256, 512)
# K5's stages: the row sums and the fold; gather_sum_kernel is the first
# kernel's one stage
GATHER_STAGES = ("row_sums", "fold", "gather_sum")
# (label, catalog scene, spp, wavefront): the packet-routed renders --walls
# times, at chip_smoke.py's sizes (perlin's 500 spp cut to its 32)
WALLS = (("sphereflake wavefront", "sphereflake", None, True),
         ("sphereflake scan", "sphereflake", None, False),
         ("perlin_texture_ball", "perlin_texture_ball", 32, False),
         ("textured_fox", "textured_fox", None, False),
         ("glass_fox", "glass_fox", None, False))


def sweep_inputs(dev, only: tuple = ("",)) -> dict:
    """{label: inputs}: the sweep cases whose label starts with one of
    ``only``, K4's and K7's (rays, ids, nears, best, table, triangle,
    sphere), K8's (rays, ids, nears, best, words, lo, scale, triangle)."""
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
    from cpu_ray_tracing_implementation_tpu_torch.ops import perray
    from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
        scene_rays, secondary, sweep_phases)

    def want(kid):
        return wanted(kid, only)

    gen = torch.Generator().manual_seed(1)
    out = {}
    scene, cam = catalog.sponza(device=dev)
    tabs, K = scene.tri_perray, scene.tri_chunks.corner.shape[0]
    org, dirs, time, cap = scene_rays(scene, cam, gen)
    rays, calls = sweep_phases(org, dirs, time, cap, tabs, K, TMIN, True, False)
    if want("K4"):
        for p, call in enumerate(calls[:3]):
            out[f"K4 colonnade primary, phase {p + 1}"] = (rays, *call, tabs.table, True,
                                                           False)
    if want("K8"):
        q = tabs.q16()
        out["K8 colonnade primary, phase 1"] = (rays, *calls[0], q.words, q.lo, q.scale,
                                                True)
    if want("K7"):
        for CS in SUB_TIMED:
            r7, c7 = sweep_phases(org, dirs, time, cap, tabs, K, TMIN, True, False, CS)
            out[f"K7 colonnade primary, CS {CS}, phase 1"] = (r7, *c7[0],
                                                              tabs.subtile(CS).table,
                                                              True, False)
    if want("K4"):
        t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True, cap,
                                            tabs=tabs)
        o2, d2 = secondary(org, dirs, t, gen)
        alive = (torch.rand(org.shape[0], generator=gen) > 0.1).to(dev)
        cap2 = isect._packet_cap(scene, o2, d2, alive, float("inf"), TMIN)
        rays, calls = sweep_phases(o2, d2, time, cap2, tabs, K, TMIN, True, False)
        out["K4 colonnade secondary, phase 1"] = (rays, *calls[0], tabs.table, True, False)

    scene, cam = catalog.sphereflake(device=dev)
    tabs, K = scene.sphere_perray, scene.sphere_chunks.rad.shape[0]
    sf_rays = scene_rays(scene, cam, gen)
    if want("K4"):
        rays, calls = sweep_phases(*sf_rays, tabs, K, TMIN, False, True)
        out["K4 sphereflake primary, phase 1"] = (rays, *calls[0], tabs.table, False, True)
    if want("K7"):
        rays, calls = sweep_phases(*sf_rays, tabs, K, TMIN, False, True, SUB_TIMED[0])
        out[f"K7 sphereflake primary, CS {SUB_TIMED[0]}, phase 1"] = (
            rays, *calls[0], tabs.subtile(SUB_TIMED[0]).table, False, True)
    if not want("K4"):
        return {k: v for k, v in out.items() if k.startswith(only)}

    rng = np.random.default_rng(2)
    b = SceneBuilder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.7, 0.7, 0.7))]
    for i, c in enumerate(rng.uniform(-30, 30, (6000, 3))):
        b.moving_sphere(c, c + rng.normal(0, 0.2, 3), rng.uniform(0.2, 1.2), mats[i % 2])
    scene = b.build(dev)
    tabs, K = scene.sphere_perray, scene.sphere_chunks.rad.shape[0]
    n = 40_000
    o = (torch.rand(n, 3, generator=gen) * 70 - 35).to(dev)
    d = torch.randn(n, 3, generator=gen).to(dev)
    tm = torch.rand(n, generator=gen).to(dev)
    cap = isect._packet_cap(scene, o, d, None, float("inf"), TMIN)
    rays, calls = sweep_phases(o, d, tm, cap, tabs, K, TMIN, False, True)
    out["K4 random 6000 spheres, phase 1"] = (rays, *calls[0], tabs.table, False, True)
    return {k: v for k, v in out.items() if k.startswith(only)}


def sweep_call(fsw, label: str, args: tuple):
    """A call of the sweep kernel (``fsw``'s K4, K7 or K8, by the label's
    first two characters) on a case's inputs."""
    kernel, n = {"K4": (fsw.sweep_kernel, 5), "K7": (fsw.sweep_sub_kernel, 5),
                 "K8": (fsw.sweep_q16_kernel, 7)}[label[:2]]
    return lambda: kernel(*args[:n], TMIN, *args[n:])


@contextlib.contextmanager
def fox_assets():
    """$CRT_ASSETS at a temporary directory holding the Fox stand-in, while
    the scenes inside build."""
    saved = os.environ.get("CRT_ASSETS")
    with tempfile.TemporaryDirectory() as root:
        write_fox(root)
        os.environ["CRT_ASSETS"] = root
        try:
            yield
        finally:
            if saved is None:
                del os.environ["CRT_ASSETS"]
            else:
                os.environ["CRT_ASSETS"] = saved


def write_fox(root: str) -> None:
    """The 576-triangle Fox stand-in as ``root``/Fox/glTF/Fox.gltf."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import procgen

    pos, nrm, uv, idx = procgen.ellipsoid_mesh(*FOX_MESH)
    procgen.write_gltf(os.path.join(root, "Fox", "glTF", "Fox.gltf"), pos, idx, nrm, uv,
                       png=procgen.checker_png(), image_in="data", nodes=[FOX_NODE])


def packet_inputs(dev) -> dict:
    """{label: (kind, rays [8,R], cap [R], pack, lo, hi, tiles)}: K6's
    cases, labels starting with "K6"."""
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
    from cpu_ray_tracing_implementation_tpu_torch.ops import packet, raysort
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
        scene_rays, secondary)

    gen = torch.Generator().manual_seed(12)
    tile = packet.AUTO_TILE
    tiles = tuple(sorted({tile, *TILES}))
    out = {}
    sf, cam = catalog.sphereflake(device=dev)
    c = sf.sphere_chunks
    box = (c.lo.contiguous(), c.hi.contiguous())
    org, dirs, time_, cap = scene_rays(sf, cam, gen)
    out["K6 sphereflake primary"] = ("sphere", fi.pack_rays(org, dirs, time_), cap,
                                     sf.sphere_pack, *box, tiles + (2048,))
    t = packet.sphere_packet_hit(org, dirs, time_, c, TMIN, cap, tile)[0]
    o2, d2 = secondary(org, dirs, t, gen)
    lo, hi = org.new_tensor(sf.world_lo), org.new_tensor(sf.world_hi)
    (o2, d2, t2), _ = raysort.sort_rays(raysort.coherence_keys(o2, d2, lo, hi),
                                        [o2, d2, time_])
    cap2 = isect._packet_cap(sf, o2, d2, None, float("inf"), TMIN)
    out["K6 sphereflake secondary, coherence-sorted"] = (
        "sphere", fi.pack_rays(o2, d2, t2), cap2, sf.sphere_pack, *box, tiles)
    scene, cam = catalog.perlin_texture_ball(spp=1, device=dev)
    c = scene.quad_chunks
    org, dirs, _, cap = scene_rays(scene, cam, gen)
    out["K6 perlin_texture_ball primary"] = ("quad", fi.pack_rays(org, dirs), cap,
                                             scene.quad_pack, c.lo.contiguous(),
                                             c.hi.contiguous(), tiles)
    with fox_assets():
        scene, cam = catalog.textured_fox(device=dev)
    c = scene.tri_chunks
    org, dirs, _, cap = scene_rays(scene, cam, gen)
    for which in ("primary", "secondary"):
        out[f"K6 576-triangle Fox stand-in {which}"] = (
            "tri", fi.pack_rays(org, dirs), cap, scene.tri_pack, c.lo.contiguous(),
            c.hi.contiguous(), (tile,))
        t = packet.planar_packet_hit(org, dirs, c, TMIN, True, cap, tile)[0]
        org, dirs = secondary(org, dirs, t, gen)
        cap = isect._packet_cap(scene, org, dirs, None, float("inf"), TMIN)
    return out


def wanted(kid: str, only: tuple) -> bool:
    """Whether some case of kernel ``kid`` (e.g. "K7") has a label that
    starts with one of the prefixes ``only``."""
    return any(kid.startswith(o) or o.startswith(kid) for o in only)


def make_inputs(path: Path, only: tuple = ("",)) -> None:
    """Save {label: (primary rays [8,R], secondary rays [8,R], pack)}, the
    sweep cases' and the packet cases' inputs, those whose label starts
    with one of ``only``."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
        camera_rays, secondary)

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda", 0)
    inputs = {}
    for label, name, kernel in CASES:
        if not label.startswith(only):
            continue
        scene, org, dirs, time = camera_rays(name, gen, dev)
        if kernel == "planar_closest":
            view, pack = scene.quad_view
            t = ch.planar_closest(org, dirs, view, TMIN, False)[0]
        else:
            view, pack = scene.sphere_view
            t = ch.sphere_closest(org, dirs, time, view, TMIN)[0]
        o2, d2 = secondary(org, dirs, t, gen)
        inputs[label] = (fi.pack_rays(org, dirs, time), fi.pack_rays(o2, d2, time), pack)
    if any(wanted(kid, only) for kid in ("K4", "K7", "K8")):
        inputs.update(sweep_inputs(dev, only))
    if wanted("K6", only):
        inputs.update(packet_inputs(dev))
    if wanted("K5", only):
        inputs.update(gather_inputs(dev))
    if wanted("K9", only):
        inputs.update(scatter_inputs(dev))
    torch.save(inputs, path)


def gather_inputs(dev) -> dict:
    """{label: (ids, table, bound ms, bound term)}: K5's cases, the probe's
    rays on each of ``gather_probe.TABLE_ROWS``, made as
    ``gather_probe.measure`` makes them (seed 0), with this checkout's
    bound; prints each case's named rows and bound."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe, profiling

    R, _, V, rowf = gather_probe.DEFAULTS
    out = {}
    for K in gather_probe.TABLE_ROWS:
        gen = torch.Generator(device=dev).manual_seed(0)
        table = torch.randn((K, rowf), generator=gen, device=dev)
        ids = torch.randint(0, K, (R, V), generator=gen, device=dev, dtype=torch.int32)
        named = gather_probe.named_rows(ids, K)
        b = gather_probe.bound(R, V, rowf, named, profiling.HBM_BYTES_PER_S,
                               profiling.FP32_INSTR_PER_S)
        label = f"K5 {R} rays, {K * rowf * 4 / 1e6:.1f} MB table, K {K}"
        print(f"{label}: {V} slots, {named} rows named, bound {b[0]:.4f} ms ({b[1]})",
              flush=True)
        out[label] = (ids, table, *b)
    return out


# K9's case: the Cornell box at the scan cell's 600x600, the second bounce
# of one sample (rays leaving the first hits)
SCATTER_CASE = ("K9 cornell_box 600x600, bounce 1", "cornell_box", 600, 1)
# K9 against its plain version: atol / rtol of new_dir and weight, and the
# share of lanes that may lie beyond them (each where light_pdf's edge test
# rounds apart)
SCATTER_TOL = dict(atol=1e-5, rtol=1e-4)
SCATTER_OUTLIERS = 1e-4
# a lane is at a light's edge when the ray meets the plane this near (in
# units of the quad's edges) to an edge, or the sphere this near its rim
EDGE_EPS = 1e-4


def scatter_calls(scene, cam, key) -> list:
    """[(hit, ray_dir, u, ior_shift, pre)]: the arguments of each
    ``materials.scatter`` call (one a bounce) of a render of ``cam`` under
    no_grad, in bounce order; ``u`` cut to the NSLOT slots the scatter
    reads, as K9 takes it."""
    from cpu_ray_tracing_implementation_tpu_torch.models import integrator
    from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops

    calls = []
    inner = mat_ops.scatter

    def record(scene_, hit, ray_dir, u, ior_shift=None, pre=None):
        calls.append((hit, ray_dir, u[:, :mat_ops.NSLOT], ior_shift, pre))
        return inner(scene_, hit, ray_dir, u, ior_shift, pre)

    mat_ops.scatter = record
    try:
        with torch.no_grad():
            integrator.render_image(scene, cam, key)
    finally:
        mat_ops.scatter = inner
    return calls


def scatter_bytes(R: int, dispersive: bool) -> int:
    """The bytes K9 must move for R hits (``csrc/scatter.cu``): 119 a ray,
    4 more under dispersion."""
    return R * (119 + 4 * dispersive)


def near_light_edge(scene, p, d) -> torch.Tensor:
    """[R] bool: the rays (p, d) that meet some light's boundary within
    EDGE_EPS, in float64: a quad light's edge or its plane at t = 1e-3, a
    sphere light's rim. There light_pdf's edge test can round either way."""
    p, d = p.double(), d.double()
    near = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    inside = lambda v: (v > -EDGE_EPS) & (v < 1 + EDGE_EPS)
    edge = lambda v: torch.minimum(v.abs(), (v - 1).abs()) < EDGE_EPS
    for q in scene.lights.tolist():
        c, eu, ev = (getattr(scene.quads, f)[q].double() for f in ("corner", "eu", "ev"))
        n = torch.linalg.cross(eu, ev)
        w = n / (n @ n)
        denom = d @ n
        t = ((c - p) @ n) / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = p + t[:, None] * d - c
        a, b = x @ torch.linalg.cross(ev, w), x @ torch.linalg.cross(w, eu)
        near |= inside(a) & inside(b) & (edge(a) | edge(b) | ((t - 1e-3).abs() < EDGE_EPS))
    if scene.sphere_lights is not None:
        for i in scene.sphere_lights.tolist():
            c, rad = scene.spheres.c0[i].double(), float(scene.spheres.rad[i])
            ud = d / d.norm(dim=1, keepdim=True)
            dc = c - p
            proj = (dc * ud).sum(1)
            # the ray's squared distance from the center against rad^2
            miss = (dc * dc).sum(1) - proj * proj - rad * rad
            near |= miss.abs() < EDGE_EPS * rad * rad
    return near


def scatter_check(scene, calls) -> dict:
    """K9 against its plain version on the card, call by call: continues
    must be equal; new_dir and weight within SCATTER_TOL but on at most a
    SCATTER_OUTLIERS share of the lanes, each at a light's edge. Returns
    {"lanes", "bit_equal" (lanes whose outputs equal the plain version's
    bit for bit), "outliers" [(call, lane)], "max_abs_err", "ok"}."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter
    from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops

    lanes = bit_equal = 0
    outliers, max_err, ok = [], 0.0, True
    with torch.no_grad():
        for i, (hit, ray_dir, u, ior_shift, pre) in enumerate(calls):
            got = fused_scatter.scatter(scene, hit, ray_dir, u, ior_shift, *pre)
            ref = mat_ops.scatter_plain(scene, hit, ray_dir, u, ior_shift, pre)
            ok &= torch.equal(got[2], ref[2])
            same = torch.ones_like(ref[2])
            close = torch.ones_like(ref[2])
            for g, r in zip(got[:2], ref[:2]):
                same &= (g.view(torch.int32) == r.view(torch.int32)).all(1)
                close &= ((g - r).abs() <= SCATTER_TOL["atol"]
                          + SCATTER_TOL["rtol"] * r.abs()).all(1)
                max_err = max(max_err, float((g - r).abs().max()))
            far = ~close
            if bool(far.any()):
                edge = (near_light_edge(scene, hit.p, got[0])
                        | near_light_edge(scene, hit.p, ref[0]))
                ok &= bool(edge[far].all())
                outliers += [(i, lane) for lane in far.nonzero()[:, 0].tolist()]
            lanes += ref[2].shape[0]
            bit_equal += int(same.sum())
    ok &= len(outliers) <= SCATTER_OUTLIERS * lanes
    return {"lanes": lanes, "bit_equal": bit_equal, "outliers": outliers,
            "max_abs_err": max_err, "ok": bool(ok)}


def scatter_inputs(dev) -> dict:
    """{label: (the kernel's arguments as a dict of tensors, bound ms,
    bound term)}: K9's case, made with this checkout's package."""
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.ops import keys
    from cpu_ray_tracing_implementation_tpu_torch.utils import profiling

    label, name, width, bounce = SCATTER_CASE
    scene, cam = catalog.SCENES[name](width=width, spp=1, device=dev)
    hit, ray_dir, u, ior_shift, (mt, atten) = scatter_calls(scene, cam, keys.key(0))[bounce]
    args = {"p": hit.p, "normal": hit.normal, "front": hit.front, "valid": hit.valid,
            "mat": hit.mat, "ray_dir": ray_dir, "u": u, "mt": mt, "atten": atten,
            "lights": scene.lights, "corner": scene.quads.corner, "eu": scene.quads.eu,
            "ev": scene.quads.ev, "c0": scene.spheres.c0, "rad": scene.spheres.rad,
            **{f: getattr(scene.materials, f)
               for f in ("fuzz", "ior", "dispersion", "smoothness", "spec_prob")}}
    nbytes = scatter_bytes(hit.p.shape[0], ior_shift is not None)
    bound_ms = nbytes / profiling.HBM_BYTES_PER_S * 1e3
    print(f"{label}: {hit.p.shape[0]} rays, bound {bound_ms:.4f} ms (bytes)", flush=True)
    return {label: (args, bound_ms, "bytes")}


def scatter_turn(root: str, label: str, case: tuple, outs: dict) -> None:
    """K9 of the checkout at ``root`` on its saved case, timed; a checkout
    without it is skipped."""
    from types import SimpleNamespace as NS

    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import cuda_ms
    try:
        from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter
    except ImportError:
        print(f"{label}, {root}: no K9", flush=True)
        return
    a, bound_ms, bound_by = case
    scene = NS(lights=a["lights"], sphere_lights=None, n_sphere_lights=0,
               quads=NS(corner=a["corner"], eu=a["eu"], ev=a["ev"]),
               spheres=NS(c0=a["c0"], rad=a["rad"]),
               materials=NS(**{f: a[f] for f in ("fuzz", "ior", "dispersion",
                                                 "smoothness", "spec_prob")}))
    hit = NS(**{f: a[f] for f in ("p", "normal", "front", "valid", "mat")})
    call = lambda: fused_scatter.scatter(scene, hit, a["ray_dir"], a["u"], None, a["mt"],
                                         a["atten"])
    outs[label] = call()
    ms = cuda_ms(call)
    print(f"{label}, {root}: {ms:.4f} ms, share of the bound {bound_ms:.4f} ms "
          f"({bound_by}) {bound_ms / ms:.3f}", flush=True)


def turn(root: str, inputs: Path, outputs: Path) -> None:
    """One turn, in a process of its own: the kernels of the checkout at
    ``root`` on the saved inputs. Saves their outputs; prints the times."""
    sys.path[0] = root
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
    from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import cuda_ms

    build.load()  # the first turn of a checkout builds it: its ptxas report
    for line in ptxas_lines(build.last_build.get("log", "")):
        print(f"{root}: {line}", flush=True)
    saved = torch.load(inputs)
    outs = {}
    for label, name, kernel in CASES:
        if label not in saved:
            continue
        launch = getattr(fi, f"{kernel}_kernel")
        primary, second, pack = saved[label]
        for which, rays in (("primary", primary), ("secondary", second)):
            outs[f"{label} {which}"] = (launch(rays, pack, TMIN)[0],
                                        *launch(rays, pack, TMIN, with_pid=True))
        ms = cuda_ms(lambda: launch(primary, pack, TMIN))
        ms_pid = cuda_ms(lambda: launch(primary, pack, TMIN, with_pid=True))
        print(f"{label} primary, {primary.shape[1]} rays, {root}: {ms:.4f} ms, "
              f"with pid {ms_pid:.4f} ms", flush=True)
    sweeps = [k for k in saved if k[:2] in ("K4", "K7", "K8")]
    for label in sweeps:
        args = saved[label]
        call = sweep_call(fsw, label, args)
        outs[label] = (call(),)
        ms = cuda_ms(call)
        visits = int((args[2] < args[3][:, :1]).sum())
        print(f"{label}, {args[1].shape[0]} rays, {visits} visited slots, {root}: "
              f"{ms:.4f} ms", flush=True)
    for label in (k for k in saved if k.startswith("K6")):
        packet_turn(root, label, saved[label], outs)
    gathers = [k for k in saved if k.startswith("K5")]
    for label in gathers:
        ids, table, bound_ms, bound_by = saved[label]
        call = lambda: gather_probe.gather_sum_kernel(ids, table)
        outs[label] = (call(),)
        ms = cuda_ms(call)
        print(f"{label}, {root}: {ms:.4f} ms, share of the bound {bound_ms:.4f} ms "
              f"({bound_by}) {bound_ms / ms:.3f}", flush=True)
    for label in (k for k in saved if k.startswith("K9")):
        scatter_turn(root, label, saved[label], outs)
    # last: the profiler slows what runs after it in its process
    for label in sweeps:
        us = stage_us(sweep_call(fsw, label, saved[label]))
        print(f"{label}, {root}, by stage: {stage_text(*us)}", flush=True)
    for label in gathers:
        ids, table = saved[label][:2]
        us = stage_us(lambda: gather_probe.gather_sum_kernel(ids, table), GATHER_STAGES)
        print(f"{label}, {root}, by stage: {stage_text(*us)}", flush=True)
    torch.save(outs, outputs)


# a sweep kernel's memset and kernels, each named by its stage (K8's row
# stage, q16_derive, runs between its scatter and tile stages)
SWEEP_STAGES = ("memset", "count", "scatter", "derive", "tile", "fold")


def stage_us(call, stages=SWEEP_STAGES, n=10) -> tuple[dict, dict]:
    """({stage: device us a call}, {stage: the kernels counted to it}) of a
    sweep kernel (K4, K7 or K8), or of K5 with ``GATHER_STAGES``, over
    ``n`` calls under torch.profiler, each kernel (its name without
    namespaces, return type and arguments) counted to the first of
    ``stages`` it names (K8's row and tile stages are ``q16_derive`` and
    ``q16_sweep_tile``, K4's tile stage ``visit_sweep_tile``)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = dict.fromkeys(stages, 0.0)
    names = {s: set() for s in stages}
    for e in prof.key_averages():
        name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
        stage = next((s for s in stages if s in name.lower()), None)
        if stage and e.self_device_time_total > 0:
            out[stage] += e.self_device_time_total / n
            names[stage].add(name.split("<")[0])
    return out, {s: "+".join(sorted(v)) for s, v in names.items()}


def stage_text(us: dict, names: dict) -> str:
    """``stage_us``'s result as text: "tile (q16_sweep_tile) 60.12 us, ..."."""
    return ", ".join(f"{s} ({names[s]}) {t:.2f} us" if names.get(s) else f"{s} {t:.2f} us"
                     for s, t in us.items())


def ptxas_lines(log: str,
                kernels=("visit_sweep_tile", "q16_sweep_tile", "q16_derive")) -> list[str]:
    """Registers, spills and shared memory of the ``kernels`` instances
    from an ``nvcc -Xptxas -v`` log: one line each, the template's bool
    arguments in angle brackets."""
    out, current, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            args = re.findall(r"Lb(\d)E", m.group(1).split(name)[1].split("Ev")[0]) if name else []
            current = f"{name}<{','.join(args)}>" if name else None
            spill = ""
        elif current and "spill" in line:
            spill = line.strip()
        elif current and "Used" in line and "registers" in line:
            out.append(f"{current}: {line.split(':', 1)[1].strip()}; {spill}")
            current = None
    return out


def packet_turn(root: str, label: str, case: tuple, outs: dict) -> None:
    """K6 of the checkout at ``root`` on one case, at each of its tiles."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import packet
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import cuda_ms

    kind, rays, cap, pack, lo, hi, tiles = case
    for tile in tiles:
        if kind == "sphere":
            launch = lambda: packet.packet_sphere_kernel(rays, cap, pack, lo, hi, TMIN, tile)
        else:
            launch = lambda: packet.packet_planar_kernel(rays, cap, pack, lo, hi, TMIN, tile,
                                                         kind == "tri")
        outs[f"{label}, tile {tile}"] = launch()
        ms = cuda_ms(launch)
        v = outs[f"{label}, tile {tile}"][2].float()
        info = packet_info(root, kind, tile, pack.shape[0])
        print(f"{label}, {rays.shape[1]} rays, tile {tile}, {root}: {ms:.4f} ms; visits "
              f"{int(v.sum())} (per tile {float(v.mean()):.2f}, max {int(v.max())}); "
              f"{info['registers']} registers, {info['threads']} threads, "
              f"{info['rays_per_thread']} rays a thread, {info['threads_per_ray']} threads "
              f"a ray, {info['blocks_per_sm']} blocks per SM",
              flush=True)


# the old K6 (one ray a thread, blocks of 256) seen through the CUDA
# queries: its source's kernels, included into a probe
PROBE = r"""
#include "%s"
extern "C" int k6_probe(int kind, int K, int* info) {
  cudaFuncAttributes a;
  int blocks = 0;
  const size_t smem = (size_t)next_pow2(K) * 8;
  cudaError_t e;
  if (kind == 2) {
    e = cudaFuncGetAttributes(&a, packet_sphere_kernel);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, packet_sphere_kernel, PK_THREADS, smem);
  } else if (kind == 1) {
    e = cudaFuncGetAttributes(&a, packet_planar_kernel<true>);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, packet_planar_kernel<true>, PK_THREADS, smem);
  } else {
    e = cudaFuncGetAttributes(&a, packet_planar_kernel<false>);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, packet_planar_kernel<false>, PK_THREADS, smem);
  }
  info[0] = a.numRegs; info[1] = PK_THREADS; info[2] = 1; info[3] = 1; info[4] = blocks;
  return (int)e;
}
"""


def packet_info(root: str, kind: str, tile: int, K: int) -> dict:
    """``packet.kernel_info`` of the checkout at ``root``, or, where its
    package has none, the probe built from its source."""
    import ctypes

    from cpu_ray_tracing_implementation_tpu_torch.kernels import build
    from cpu_ray_tracing_implementation_tpu_torch.ops import packet

    if hasattr(packet, "kernel_info"):
        return packet.kernel_info(kind, tile, K)
    lib = build.BUILD_DIR / "k6_probe.so"
    if not lib.exists():
        src = build.BUILD_DIR / "k6_probe.cu"
        src.write_text(PROBE % (build.CSRC / "packet_closest.cu"))
        subprocess.run([build._nvcc(), *build.FLAGS, "-Xcompiler", "-fPIC", "-shared",
                        "-o", str(lib), str(src)], check=True)
    probe = ctypes.CDLL(str(lib))
    probe.k6_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info = (ctypes.c_int * 5)()
    if probe.k6_probe(("quad", "tri", "sphere").index(kind), K, info) != 0:
        raise RuntimeError("k6_probe failed")
    return dict(zip(("registers", "threads", "rays_per_thread", "threads_per_ray",
                     "blocks_per_sm"), info))


def differences(got: dict, ref: dict) -> list[str]:
    """The (case, output) whose bits differ from the reference's; K5's
    outputs, those beyond the probe's measure (each case's bit-unequal
    outputs printed)."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe

    out = []
    for case, outs in got.items():
        if case.startswith("K5"):
            err = gather_probe.rel_err(outs[0], ref[case][0])
            print(f"  {case}: {gather_probe.bit_unequal(outs[0], ref[case][0])} of "
                  f"{outs[0].shape[0]} outputs bit-unequal to the first turn's, rel err "
                  f"{err:.3g}", flush=True)
            out += [f"{case} out"] if not err <= 1e-5 else []
            continue
        names = (("rows", "pid", "visits") if case.startswith("K6") else
                 ("new_dir", "weight", "continues") if case.startswith("K9") else
                 ("out", "out with pid", "pid"))
        out += [f"{case} {n}" for n, x, y in zip(names, outs, ref[case])
                if not torch.equal(x.view(torch.uint8), y.view(torch.uint8))]
    return out


def walls_turn(root: str, outputs: Path) -> None:
    """One --walls turn, in a process of its own: the WALLS renders of the
    checkout at ``root``. Saves the images; prints the walls."""
    sys.path[0] = root
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
    from cpu_ray_tracing_implementation_tpu_torch.ops import keys

    imgs = {}
    for label, name, spp, wavefront in WALLS:
        with fox_assets():
            scene, cam = catalog.SCENES[name](device="cuda")
        cam = cam.replace(spp=spp or cam.spp)
        render = integrator.render_image_wavefront if wavefront else integrator.render_image
        render(scene, cam.replace(spp=1), keys.key(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[label] = render(scene, cam, keys.key(0))
        torch.cuda.synchronize()
        print(f"{label} {cam.width}x{cam.height}x{cam.spp} depth {cam.max_depth}, "
              f"{root}: {time.perf_counter() - t0:.3f} s", flush=True)
    torch.save(imgs, outputs)


def image_differences(got: dict, ref: dict) -> list[str]:
    """The walls' images whose means differ from the reference's by more
    than the golden atol 2e-3 (two tiles may order chunks at an exact tie
    apart); prints for each image the pixels whose bits differ and the
    largest difference (the wavefront's flush adds with atomics)."""
    out = []
    for label, img in got.items():
        d = (img - ref[label]).abs()
        print(f"  {label}: {int((img.view(torch.int32) != ref[label].view(torch.int32)).sum())} "
              f"values differ in their bits from the first turn's, max abs diff "
              f"{float(d.max()):.3g}, means {float(img.mean()):.6f} / "
              f"{float(ref[label].mean()):.6f}", flush=True)
        if abs(float(img.mean()) - float(ref[label].mean())) > 2e-3:
            out.append(f"{label} image mean")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--turn"]:
        turn(argv[1], Path(argv[2]), Path(argv[3]))
        return 0
    if argv[:1] == ["--walls-turn"]:
        walls_turn(argv[1], Path(argv[2]))
        return 0
    walls = argv[:1] == ["--walls"]
    only = tuple(argv[1].split(",")) if argv[:1] == ["--only"] else ("",)
    argv = argv[1:] if walls else argv[2:] if only != ("",) else argv
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    own = str(Path(__file__).resolve().parents[2])
    work = Path(own) / "cpu_ray_tracing_implementation_tpu_torch" / "build"
    work.mkdir(exist_ok=True)
    inputs = work / "kernel_ab_inputs.pt"
    if not walls:
        make_inputs(inputs, only)
    others = [str(Path(r).resolve()) for r in argv]
    ref = None
    differ = 0
    for i, root in enumerate([own, *others, *others[::-1], own]):
        outputs = work / f"kernel_ab_outputs_{i}.pt"
        args = ["--walls-turn", root] if walls else ["--turn", root, str(inputs)]
        subprocess.run([sys.executable, __file__, *args, str(outputs)], check=True,
                       cwd=root)
        got = torch.load(outputs)
        outputs.unlink()
        if ref is None:
            ref = got
        for d in (image_differences if walls else differences)(got, ref):
            differ += 1
            print(f"{root}: {d} differs from the first turn's", flush=True)
    if not walls:
        inputs.unlink()
    print(f"kernel_ab: {differ} outputs differ from the first turn's")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
