"""Where the time goes in the port's renders on one GPU.

Counterpart of ``cpu_ray_tracing_implementation_tpu/utils/profiling.py``
for the port. Run on a machine with an NVIDIA GPU::

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.profiling [WORKLOAD]

``cornell`` (the default) renders cornell_box at 512x512, depth 8;
``colonnade`` renders catalog.sponza (the 258k-triangle colonnade) at
200x200, depth 5; ``cornell_grad`` takes ``diff.loss_and_grads`` of
cornell_box at 512x512, depth 8 (the winner-replay route), one sample;
``colonnade_wavefront`` and ``sphereflake_wavefront`` render the colonnade
(200x200) and sphereflake (400x400, 7,381 spheres), depth 5, through the
path-regeneration wavefront at its automatic lane pool, and also print
the loop iterations per render, the kernels per iteration and the host
synchronisations per iteration (the loop's condition and each per-ray
selection phase's live count); ``cornell_sphere_light_nee`` renders
cornell_box_with_sphere_light at its own 600x600, depth 4, with
next-event estimation and Russian roulette from bounce 3 (its shadow rays
launch K1 and K2 a second time in every bounce but the last);
``dispersion_prism`` renders that scene at its own 400x400, depth 6 (a
hero wavelength per path, K1 for the three light strips and K2 for the
glass sphere every bounce); ``sunlit_spheres_nee`` renders sunlit_spheres
at its own 400 px wide (aspect 1.78), depth 5, with next-event estimation
(the importance-sampled sky as the only light: K2 twice in every bounce
but the last, no K1); ``cornell_qmc`` is ``cornell`` under ``camera.qmc``
(Owen-scrambled Sobol uniforms in place of the hash stream).
``sweep_stages`` times kernels K4, K7 and K8 alone on
``utils/kernel_ab.py``'s sweep inputs: CUDA events per call and
torch.profiler's device time per stage kernel (memset, count, scatter,
tile, fold). Each other workload runs ``spp`` samples after a 2-sample warm-up: three times on the host
clock, then under ``torch.profiler`` and ``trace.recording()``, so that the
port's own spans (``utils/trace.py``: entry, pass, sample, bounce and its
stages, the per-ray route's select and sweep, wavefront iteration) are
ranges of the profile. The kernels
autograd's backward launches from its own thread fall in no range of the
main thread and are counted apart. It prints the wall seconds of both
runs, the device time summed over kernels, kernels per bounce, the device
busy share, the top kernels by device time, each span's count, host
seconds and the device time of the kernels launched inside it,
the wrapper calls, device kernels and device time of kernels K1-K4, K6
and K9 (K4 runs four kernels a call), and the per-ray selection phases
per bounce.
Last it times three more unprofiled runs: what the profiler leaves behind
on later launches of these host-bound paths, and then one more under
``trace.recording()`` alone, which counts the host synchronisations that
PyTorch's operations make by span (per bounce or per loop iteration).

For any render, ``RenderStats`` times named phases with their camera rays
(``Phase``: seconds and rays/s; the clock stops after a synchronise when
the work is on the card), and ``device_trace(dir)`` writes a
``torch.profiler`` Chrome trace of what it wraps, the port's spans in it
(a no-op when ``dir`` is None): the CLI's ``--profile``
(``utils/profiling.py:19-62`` of the JAX package).

``cuda_ms`` and the card's peak rates are shared with ``chip_smoke.py``
and ``utils/gather_probe.py``; ``camera_rays`` and ``secondary``, the rays
at which K1 and K2 are timed, with ``chip_smoke.py`` and
``utils/kernel_ab.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

import torch

from cpu_ray_tracing_implementation_tpu_torch.kernels import build
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter as fsc
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, packet, perray
from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe, trace

@dataclasses.dataclass
class Phase:
    name: str
    seconds: float = 0.0
    rays: int = 0

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0


@dataclasses.dataclass
class RenderStats:
    """Wall seconds and camera rays per named phase of one render.
    ``device``: where the render's tensors lie; on a card each phase's
    clock stops only after ``torch.cuda.synchronize``, since its launches
    return before the work is done."""

    device: object = None
    phases: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            p = self.phases.setdefault(name, Phase(name))
            p.seconds += time.perf_counter() - t0
            p.rays += rays

    def summary(self) -> str:
        lines = []
        for p in self.phases.values():
            rate = f" ({p.mrays_per_s:.2f}M rays/s)" if p.rays else ""
            lines.append(f"  {p.name:<22} {p.seconds:8.3f}s{rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the host and, where there is one, the
    card, written as ``log_dir/trace.json`` (Chrome trace format) when
    ``log_dir`` is set; a no-op otherwise. The port's spans are recorded
    inside it (``trace.recording()``), so the trace names the layers."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof, trace.recording():
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] device trace written to {path}")


# the card's peak rates (H100 SXM data sheet): 3.35 TB/s of HBM and 67
# TFLOP/s of FP32, which counts a fused multiply-add as two operations, so
# FP32 instructions of any kind issue at half that rate
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12

# name -> (catalog scene, its arguments, samples profiled, gradient or not,
# wavefront or scan, camera fields replaced)
WORKLOADS = {
    "cornell": (catalog.cornell_box, dict(width=512, max_depth=8), 8, False, False, {}),
    "colonnade": (catalog.sponza, dict(width=200, max_depth=5), 4, False, False, {}),
    "cornell_grad": (catalog.cornell_box, dict(width=512, max_depth=8), 1, True,
                     False, {}),
    "colonnade_wavefront": (catalog.sponza, dict(width=200, max_depth=5), 4, False,
                            True, {}),
    "sphereflake_wavefront": (catalog.sphereflake, dict(width=400, max_depth=5), 4,
                              False, True, {}),
    "cornell_sphere_light_nee": (catalog.cornell_box_with_sphere_light,
                                 dict(width=600, max_depth=4), 8, False, False,
                                 dict(nee=True, rr_depth=3)),
    "dispersion_prism": (catalog.dispersion_prism, dict(width=400, max_depth=6), 8,
                         False, False, {}),
    "sunlit_spheres_nee": (catalog.sunlit_spheres, dict(width=400, max_depth=5), 8,
                           False, False, dict(nee=True)),
    "cornell_qmc": (catalog.cornell_box, dict(width=512, max_depth=8), 8, False,
                    False, dict(qmc=True)),
}
TOP = 20  # kernels listed by device time
REPEATS = 3  # unprofiled runs before the profiled one, and after it
KERNELS = {"planar_closest": "planar_closest_kernel",
           "sphere_closest": "sphere_closest_kernel",
           "cull_select": "cull_select_kernel",
           "visit_sweep": "visit_sweep_",   # its four stage kernels
           "packet_planar": "packet_kernel<(anonymous namespace)::Planar",
           "packet_sphere": "packet_kernel<(anonymous namespace)::Sphere",
           "scatter": "scatter_mixture_kernel"}


def launches() -> dict:
    return {**fi.LAUNCHES, **fs.LAUNCHES, **fsw.LAUNCHES, **packet.LAUNCHES,
            **gather_probe.LAUNCHES, **fsc.LAUNCHES}


def reset_counts() -> None:
    fi.reset_launches()
    fsc.reset_launches()
    fs.reset_launches()
    fsw.reset_launches()
    packet.reset_launches()
    gather_probe.reset_launches()
    perray.reset_phases()
    integrator.reset_wavefront()


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


def camera_rays(name, gen, dev, n=512 * 512):
    """(scene, org, dirs, time): ``n`` primary rays of the catalog scene's
    camera at width 512 (rows past the image continue its ray grid)."""
    scene, cam = catalog.SCENES[name](width=512, spp=1, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    u = torch.rand(n, cam_mod.N_CAM_SLOTS, generator=gen).to(dev)
    org, dirs, time = cam_mod.generate_rays(cam, ids, u)
    return scene, org.contiguous(), dirs, time


def scene_rays(scene, cam, gen):
    """(org, dirs, time, cap): one primary camera ray per pixel of ``cam``
    and its traversal cap."""
    n = cam.width * cam.height
    ids = torch.arange(n, dtype=torch.int32, device=scene.device)
    u = torch.rand(n, cam_mod.N_CAM_SLOTS, generator=gen).to(scene.device)
    org, dirs, time = cam_mod.generate_rays(cam, ids, u)
    org = org.contiguous()
    return org, dirs, time, isect._packet_cap(scene, org, dirs, None, float("inf"), 1e-3)


def sweep_phases(org, dirs, time, cap, tabs, K, tmin, triangle, sphere, CS=None):
    """(rays, [(ids, nears, best), ...]): the [R, 8] rays K4 takes and the
    lists and input best of each of its calls in the per-ray phase loop
    (``perray._phase_loop`` itself, its sweep recorded), phase 1 first.
    With ``CS``, the sub-tile route's at that width: K3 on the boxes of
    ``tabs.subtile(CS)`` at ``perray.subtile_v`` slots, K7's calls."""
    rays = fsw.pack_rays(org, dirs, time if sphere else None)
    z = torch.zeros_like(cap)
    best = (fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
            if sphere else
            fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int()))
    calls = []
    if CS is None:
        sel, V, sweep_rows = tabs, min(perray.VISIT_BLOCK, K), fsw.sweep
    else:
        sel = tabs.subtile(CS)
        K = sel.table.shape[0]
        V, sweep_rows = perray.subtile_v(K, CS), fsw.sweep_sub

    def sweep(ids, nears, b):
        calls.append((ids, nears, b))
        return sweep_rows(rays, ids, nears, b, sel.table, tmin, triangle, sphere)

    perray._phase_loop(org, dirs, cap, sel, K, tmin, V, sweep, best)
    return rays, calls


def kernel_name(key: str) -> str:
    """A profiler key's kernel name, without its namespaces, return type and
    arguments."""
    return key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def sweep_stage_ms(launch) -> dict:
    """{stage: ms} of one K7 or K8 call from CUDA events: ``launch(n)`` runs
    the memset and the first n stages (``fused_sweep.sweep_sub_kernel``'s
    or ``sweep_q16_kernel``'s ``stages``); the memset alone, then each
    stage added in turn, the differences of the cumulative times. The
    stages are ``kernel_ab.SWEEP_STAGES`` but K8's row stage, "derive",
    which its "tile" holds here."""
    from cpu_ray_tracing_implementation_tpu_torch.utils.kernel_ab import SWEEP_STAGES

    names = [s for s in SWEEP_STAGES if s != "derive"]
    cum = [cuda_ms(lambda n=n: launch(n)) for n in range(len(names))]
    return {s: cum[i] - (cum[i - 1] if i else 0.0) for i, s in enumerate(names)}


def sweep_stages() -> int:
    """K4, K7 and K8 on each of kernel_ab's sweep inputs: the time of a call
    (CUDA events) and each stage kernel's and the memset's device time (10
    calls under torch.profiler)."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import kernel_ab

    for label, args in kernel_ab.sweep_inputs(torch.device("cuda", 0)).items():
        call = kernel_ab.sweep_call(fsw, label, args)
        ms = cuda_ms(call)
        print(f"{label}: {1e3 * ms:.2f} us a call; "
              + kernel_ab.stage_text(*kernel_ab.stage_us(call)), flush=True)
    return 0


def secondary(org, dirs, t, gen):
    """Rays leaving the hits at ``t`` (the origin on a miss) in random
    directions."""
    p = org + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * dirs
    return p, torch.randn(org.shape, generator=gen).to(org.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "cornell"
    if name not in WORKLOADS and name != "sweep_stages":
        print(f"profiling: unknown workload {name!r}; one of {sorted(WORKLOADS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    build.load()
    if name == "sweep_stages":
        return sweep_stages()
    dev = torch.device("cuda", 0)
    make, kwargs, spp, grad, wavefront, cam_kw = WORKLOADS[name]
    scene, cam = make(spp=spp, device=dev, **kwargs)
    cam = cam.replace(**cam_kw)
    bounces = spp * cam.max_depth
    target = torch.zeros((cam.height, cam.width, 3), device=dev)

    def run(n):
        if grad:
            diff.loss_and_grads(scene, cam, keys.key(1), target, n)
        elif wavefront:
            integrator.render_image_wavefront(scene, cam, keys.key(1), spp=n)
        else:
            integrator.render_image(scene, cam, keys.key(1), spp=n)

    def timed():
        t0 = time.perf_counter()
        run(spp)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def walls():
        ws = sorted(timed() for _ in range(REPEATS))
        return ws[REPEATS // 2], ", ".join(f"{w:.4f}" for w in ws)

    run(2)
    torch.cuda.synchronize()
    wall, before = walls()

    reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, trace.recording() as rec:
        t0 = time.perf_counter()
        run(spp)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    cuda = torch.autograd.DeviceType.CUDA
    spans = {s.name for s in rec.spans}
    events = prof.key_averages()
    kern = sorted(((e.key, e.count, e.self_device_time_total) for e in events
                   if e.device_type == cuda and e.key not in spans),
                  key=lambda k: -k[2])
    dev_s = sum(k[2] for k in kern) / 1e6
    n_kern = sum(k[1] for k in kern)
    print(f"{name} {cam.width}x{cam.height} depth {cam.max_depth}, {spp} spp"
          f"{' fwd+bwd (diff.loss_and_grads)' if grad else ''}"
          f"{' wavefront' if wavefront else ''}"
          + "".join(f", {k}={v}" for k, v in cam_kw.items()) + ": wall "
          f"{wall:.4f} s unprofiled (median of {before}), {wall_prof:.4f} s profiled")
    print(f"device kernel time {dev_s:.4f} s over {n_kern} kernels"
          + ("" if wavefront else f" ({n_kern / bounces:.1f} per bounce)")
          + "; busy share "
          f"{dev_s / wall:.4f} of the unprofiled wall, "
          f"{dev_s / wall_prof:.4f} of the profiled")
    counts = launches()
    for kname, symbol in KERNELS.items():
        hits = [k for k in kern if symbol in k[0]]
        n = sum(k[1] for k in hits)
        us = sum(k[2] for k in hits)
        calls = counts[kname]
        print(f"{kname}: {calls} calls ({calls / bounces:.3f} per bounce), {n} device "
              f"kernels, device {us / 1e3:.4f} ms"
              + (f", {us / max(calls, 1):.2f} us a call, {us / 1e6 / dev_s:.4f} of "
                 "device time" if n else ""))
    if perray.PHASES["calls"]:
        print(f"per-ray closest-hit calls {perray.PHASES['calls']}, selection "
              f"phases {perray.PHASES['phases']}, "
              f"{perray.PHASES['phases'] / perray.PHASES['calls']:.3f} per call")
    if wavefront:
        its = integrator.WAVEFRONT["iterations"]
        n_pix = cam.width * cam.height
        print(f"wavefront: lane pool {integrator.wavefront_lanes(scene, n_pix) or n_pix}"
              f", {its} loop iterations per render, {n_kern / its:.1f} kernels per "
              f"iteration, {(its + perray.PHASES['phases']) / its:.3f} host "
              "synchronisations per iteration (the loop condition and one per "
              "selection phase)")
    print("top kernels (name, count, device us, share of device time):")
    for key, count, us in kern[:TOP]:
        print(f"  {key[:100]:100} {count:7d} {us:10.1f} {us / 1e6 / dev_s:.4f}")
    print("spans (count, host s, device s of the kernels launched inside on the "
          "span's thread):")
    device_s = {}
    for e in events:
        if e.key in spans and e.device_type != cuda:
            print(f"  {e.key:26} {e.count:6d} host {e.cpu_time_total / 1e6:.4f} "
                  f"device {e.device_time_total / 1e6:.4f}")
            device_s[e.key] = e.device_time_total / 1e6
    if grad:
        # autograd runs the backward's kernels on its own thread, outside
        # every span of the main thread: the rest of the device time
        top = device_s.get("crt.grad_step", 0.0)
        print(f"  autograd backward (no span): device {dev_s - top:.4f}")
    wall_after, after = walls()
    print(f"wall unprofiled after the profiler: {wall_after:.4f} s (median of "
          f"{after}), against {wall:.4f} s before it")
    reset_counts()
    with trace.recording() as rec:
        run(spp)
        torch.cuda.synchronize()
    syncs = collections.Counter()
    for s in rec.spans:
        syncs[s.name] += s.syncs
    n_sync = sum(syncs.values()) + rec.outside
    its = integrator.WAVEFRONT["iterations"] if wavefront else 0
    print(f"host synchronisations PyTorch reports in one more run: {n_sync} "
          + (f"({n_sync / its:.3f} per loop iteration)" if its else
             f"({n_sync / bounces:.3f} per bounce)") + "; by span: "
          + ", ".join(f"{k} {v}" for k, v in syncs.most_common() if v)
          + f", outside every span {rec.outside}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
