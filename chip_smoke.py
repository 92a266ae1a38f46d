#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the CUDA kernels from ``cpu_ray_tracing_implementation_tpu_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card: K1
   (planar closest hit) in quad and triangle mode and K2 (sphere closest
   hit), at the main path's shapes (512*512 rays against the 1-chunk views
   of cornell_box and three_material_ball, primary and secondary rays) and
   on random 700-primitive, 6-chunk tables. Equal hit masks and materials;
   t within rtol 1e-4 / atol 1e-4; every other output row (K1: normal, u,
   v; K2: center, rad) within atol 1e-3. Kernel and plain times from CUDA
   events.
3. Main path, checked: both scenes at the golden workload (16 px, 4 spp,
   depth 3, key 42; image mean within 2e-3 of tests/test_golden.py), and
   the C++ reference parity gates of tests/test_parity.py (cornell_box 300
   px 16 spp: PSNR > 30 dB, mean rel err < 0.04; three_material_ball 320 px
   16 spp: > 38 dB, < 0.02).
4. Main path, full workload: cornell_box at 512x512, 256 spp, depth 8.
   The image must be finite; prints seconds and camera rays/s.
5. Kernel launch counts over phases 3-4 (reset just before phase 3): both
   kernels must have launched.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without
printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.kernels import build
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, film, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import keys

TMIN = 1e-3
R_MAIN = 512 * 512
GOLDEN_MEANS = {"cornell_box": 0.160999, "three_material_ball": 0.563181}
PARITY = {"cornell_box": (300, 16, 4, 30.0, 0.04),
          "three_material_ball": (320, 16, 4, 38.0, 0.02)}
KERNELS = {
    "planar_closest": ("K1", "cpu_ray_tracing_implementation_tpu/ops/pallas_intersect.py:81"),
    "sphere_closest": ("K2", "cpu_ray_tracing_implementation_tpu/ops/pallas_intersect.py:267"),
}
SOURCE = "cpu_ray_tracing_implementation_tpu_torch/csrc/closest_hit.cu"


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Device ms per call of ``fn``, from CUDA events. The card first spins
    for ~50 ms, so the host queues every call before the first runs and a
    call that does not synchronise is timed on the card alone, not at the
    host's launch rate. A call that synchronises (the plain versions' chunk
    cull) still pays its host time."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ------------------------------------------------------------ phase 2
def random_planar(gen, dev, K=6, C=128, n=700):
    corner = torch.rand(K * C, 3, generator=gen) * 20 - 10
    eu = torch.randn(K * C, 3, generator=gen)
    ev = torch.randn(K * C, 3, generator=gen)
    act = torch.arange(K * C) < n
    mat = (torch.arange(K * C) % 3).to(torch.int32)
    pts = torch.stack([corner, corner + eu, corner + ev, corner + eu + ev])
    inf = torch.tensor(float("inf"))
    lo = torch.where(act[:, None], pts.amin(0), inf).reshape(K, C, 3).amin(1)
    hi = torch.where(act[:, None], pts.amax(0), -inf).reshape(K, C, 3).amax(1)
    return ch.PlanarChunks(*[x.to(dev) for x in (
        corner.reshape(K, C, 3), eu.reshape(K, C, 3), ev.reshape(K, C, 3),
        mat.reshape(K, C), act.reshape(K, C), lo, hi)])


def random_spheres(gen, dev, K=6, C=128, n=700):
    c0 = torch.rand(K * C, 3, generator=gen) * 20 - 10
    c1 = c0 + 0.3 * torch.randn(K * C, 3, generator=gen)
    rad = torch.rand(K * C, generator=gen) * 0.8 + 0.05
    act = torch.arange(K * C) < n
    mat = (torch.arange(K * C) % 3).to(torch.int32)
    inf = torch.tensor(float("inf"))
    lo = torch.where(act[:, None], torch.minimum(c0, c1) - rad[:, None], inf)
    hi = torch.where(act[:, None], torch.maximum(c0, c1) + rad[:, None], -inf)
    return ch.SphereChunks(*[x.to(dev) for x in (
        c0.reshape(K, C, 3), c1.reshape(K, C, 3), rad.reshape(K, C),
        mat.reshape(K, C), act.reshape(K, C), lo.reshape(K, C, 3).amin(1),
        hi.reshape(K, C, 3).amax(1))])


def camera_rays(name, gen, dev):
    """R_MAIN primary rays of the scene's camera at width 512 (rows past
    the image continue its ray grid), and secondary rays leaving their
    first hits in random directions."""
    scene, cam = catalog.SCENES[name](width=512, spp=1, device=dev)
    ids = torch.arange(R_MAIN, dtype=torch.int32, device=dev)
    u = torch.rand(R_MAIN, cam_mod.N_CAM_SLOTS, generator=gen).to(dev)
    org, dirs, time = cam_mod.generate_rays(cam, ids, u)
    return scene, org.contiguous(), dirs, time


def secondary(org, dirs, t, gen):
    p = org + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * dirs
    return p, torch.randn(org.shape, generator=gen).to(org.device)


# payload fields before mat: the kernel wrappers' (t, (*fields, mat)); the
# plain versions add a primitive id after mat, which is not compared
PLANAR_FIELDS = ("normal", "u", "v")
SPHERE_FIELDS = ("center", "rad")


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def compare(label, got, ref, fields):
    """Hold a kernel's (t, payload) against its plain version's: equal hit
    masks and materials, t within rtol 1e-4 / atol 1e-4, every other
    payload field within atol 1e-3. Returns the largest abs error."""
    t, payload = got
    t_r, payload_r = ref
    valid = torch.isfinite(t_r)
    if not torch.equal(torch.isfinite(t), valid):
        raise AssertionError(f"{label}: hit masks differ in "
                             f"{int((torch.isfinite(t) != valid).sum())} rays")
    m, m_r = payload[len(fields)][valid], payload_r[len(fields)][valid]
    if not torch.equal(m, m_r):
        raise AssertionError(f"{label}: materials differ in {int((m != m_r).sum())} rays")
    torch.testing.assert_close(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    err = {"t": max_abs(t[valid], t_r[valid])}
    for i, name in enumerate(fields):
        x, x_r = payload[i][valid], payload_r[i][valid]
        torch.testing.assert_close(x, x_r, rtol=0, atol=1e-3,
                                   msg=lambda m, n=name: f"{label}: {n}: {m}")
        err[name] = max_abs(x, x_r)
    log(f"  {label}: rays {t.shape[0]} hits {int(valid.sum())} max abs err {err}")
    return max(err.values())


def phase_kernels(dev):
    gen = torch.Generator().manual_seed(0)
    errs = {"planar_closest": 0.0, "sphere_closest": 0.0}
    times = {}

    def planar_case(label, org, dirs, view, pack, tri, timed=False):
        got = fi.planar_closest_fused(org, dirs, view, TMIN, tri, pack=pack)
        ref = ch.planar_closest(org, dirs, view, TMIN, tri)
        errs["planar_closest"] = max(errs["planar_closest"],
                                     compare(label, got, ref, PLANAR_FIELDS))
        if timed:
            rays = fi.pack_rays(org, dirs)
            times["planar_closest"] = (
                cuda_ms(lambda: fi.planar_closest_kernel(rays, pack, TMIN, triangle=tri)),
                cuda_ms(lambda: ch.planar_closest(org, dirs, view, TMIN, tri)),
                cuda_ms(lambda: fi.planar_closest_fused(org, dirs, view, TMIN, tri,
                                                        pack=pack)))
        return ref

    def sphere_case(label, org, dirs, time, view, pack, timed=False):
        got = fi.sphere_closest_fused(org, dirs, time, view, TMIN, pack=pack)
        ref = ch.sphere_closest(org, dirs, time, view, TMIN)
        errs["sphere_closest"] = max(errs["sphere_closest"],
                                     compare(label, got, ref, SPHERE_FIELDS))
        if timed:
            rays = fi.pack_rays(org, dirs, time)
            times["sphere_closest"] = (
                cuda_ms(lambda: fi.sphere_closest_kernel(rays, pack, TMIN)),
                cuda_ms(lambda: ch.sphere_closest(org, dirs, time, view, TMIN)),
                cuda_ms(lambda: fi.sphere_closest_fused(org, dirs, time, view, TMIN,
                                                        pack=pack)))
        return ref

    scene, org, dirs, _ = camera_rays("cornell_box", gen, dev)
    view, pack = scene.quad_view
    ref = planar_case("K1 quad, cornell view, primary", org, dirs, view, pack,
                      False, timed=True)
    o2, d2 = secondary(org, dirs, ref[0], gen)
    planar_case("K1 quad, cornell view, secondary", o2, d2, view, pack, False)
    planar_case("K1 tri, cornell view as triangles, primary", org, dirs, view,
                pack, True)
    planar_case("K1 tri, cornell view as triangles, secondary", o2, d2, view,
                pack, True)

    scene, org, dirs, time = camera_rays("three_material_ball", gen, dev)
    view, pack = scene.sphere_view
    ref = sphere_case("K2, three_material_ball view, primary", org, dirs, time,
                      view, pack, timed=True)
    o2, d2 = secondary(org, dirs, ref[0], gen)
    sphere_case("K2, three_material_ball view, secondary", o2, d2, time, view, pack)

    org = (torch.rand(R_MAIN, 3, generator=gen) * 24 - 12).to(dev)
    dirs = torch.randn(R_MAIN, 3, generator=gen).to(dev)
    time = torch.rand(R_MAIN, generator=gen).to(dev)
    chunks = random_planar(gen, dev)
    pack = fi.pack_prim_constants(chunks)
    planar_case("K1 quad, random 700 in 6 chunks", org, dirs, chunks, pack, False)
    planar_case("K1 tri, random 700 in 6 chunks", org, dirs, chunks, pack, True)
    chunks = random_spheres(gen, dev)
    sphere_case("K2, random 700 in 6 chunks", org, dirs, time, chunks,
                fi.pack_sphere_constants(chunks))
    torch.cuda.synchronize()
    return errs, times


# ------------------------------------------------------------ phases 3-4
def psnr_gate(name, dev):
    width, spp, f, min_psnr, max_rel = PARITY[name]
    ref = np.load(f"tests/data/parity_{name}.npz")["ref_ds"].astype(np.float64)
    scene, cam = catalog.SCENES[name](width=width, spp=spp, device=dev)
    t0 = time.perf_counter()
    img = integrator.render_image(scene, cam, keys.key(0))
    ours = np.clip(film.linear_to_gamma(img).cpu().numpy(), 0.0, 1.0)
    secs = time.perf_counter() - t0
    h, w = (ours.shape[0] // f) * f, (ours.shape[1] // f) * f
    a = ours[:h, :w].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))
    if a.shape != ref.shape:
        raise AssertionError(f"{name}: downsampled shape {a.shape} != {ref.shape}")
    psnr = 10.0 * np.log10(1.0 / max(float(np.mean((a - ref) ** 2)), 1e-12))
    rel = abs(ours.mean() - ref.mean()) / ref.mean()
    log(f"  parity {name} {width}px {spp}spp: PSNR {psnr:.3f} dB (gate > {min_psnr}), "
        f"mean rel err {rel:.5f} (gate < {max_rel}), {secs:.2f} s")
    if not (psnr > min_psnr and rel < max_rel):
        raise AssertionError(f"{name}: parity gate failed")


def golden(name, dev):
    scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=dev)
    img = integrator.render_image(scene, cam, keys.key(42))
    mean = float(img.mean())
    log(f"  golden {name}: mean {mean:.6f} (recorded {GOLDEN_MEANS[name]}, atol 2e-3)")
    if not (torch.isfinite(img).all() and abs(mean - GOLDEN_MEANS[name]) <= 2e-3):
        raise AssertionError(f"{name}: golden mean off")


def full_workload(dev):
    scene, cam = catalog.cornell_box(width=512, spp=256, max_depth=8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = integrator.render_image(scene, cam, keys.key(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if img.shape != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("full render: wrong shape or non-finite values")
    rays = cam.width * cam.height * cam.spp
    log(f"  cornell_box 512x512 256spp depth 8: {secs:.3f} s, "
        f"{rays / secs / 1e6:.3f} M camera rays/s, mean {float(img.mean()):.6f}")
    return secs, rays / secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 1: build kernels")
    t0 = time.perf_counter()
    build.load()
    log(f"  built {build.library_path().name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build['seconds']:.2f} s, cached {build.last_build['cached']})")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    log("phase 2: kernels against their plain versions")
    errs, times = phase_kernels(dev)

    log("phase 3: main path, checked (launch counts reset)")
    fi.reset_launches()
    for name in sorted(GOLDEN_MEANS):
        golden(name, dev)
    for name in sorted(PARITY):
        psnr_gate(name, dev)

    log("phase 4: main path, full workload")
    full_secs, rays_per_s = full_workload(dev)
    launches = dict(fi.LAUNCHES)
    log(f"phase 5: launches over phases 3-4: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    kernels = []
    for name, (kid, replaces) in KERNELS.items():
        ms, plain_ms, wrapped_ms = times[name]
        log(f"  {kid} {name} at {R_MAIN} rays: kernel {ms:.4f} ms, with the "
            f"wrapper's packing {wrapped_ms:.4f} ms, plain {plain_ms:.4f} ms")
        kernels.append({"name": f"{kid} {name}", "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms})
    log(f"full workload: {full_secs:.3f} s, {rays_per_s:.1f} camera rays/s; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(gpu_name_and_power())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
