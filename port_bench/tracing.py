"""Instrumentation of a traced run, all of it from outside the port.

- ``stage_ranges``: a ``record_function`` range around each stage function
  of the port (the module attributes are swapped for the profiled slice
  only, and restored after), so that every idle gap of the device can be
  named by what the host was doing;
- ``kernel_calls``: the inputs of each call to the closest-hit kernel
  wrappers (K1, K3, K4), kept for their roofline bounds;
- ``count_syncs``: the host synchronisations PyTorch reports in its
  synchronisation debug mode;
- ``summarize``: the profiled slice's kernels, busy time, idle gaps by host
  range, and the bound and device time of the closest-hit kernels.
"""

from __future__ import annotations

import contextlib
import re
import warnings

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import replay

from port_bench import roofline

REQUEST = "request"
# (module, function, range): the entry's passes, a bounce's stages, the
# per-ray accelerator's calls
STAGES = (
    (diff, "_forward_pass", "forward pass"),
    (diff, "_backward_pass", "backward pass"),
    (isect, "intersect_brute", "intersect"),
    (fs, "cull_select", "select"),
    (fsw, "sweep", "sweep"),
    (integrator, "background_color", "background"),
    (mat_ops, "mat_rows", "mat_rows"),
    (mat_ops, "emitted", "emitted"),
    (mat_ops, "scatter", "scatter"),
    (integrator, "_per_ray_uniforms", "uniforms"),
    (cam_mod, "generate_rays", "raygen"),
    (replay, "winner_pack", "decide"),
    (replay, "replay_hit", "replay"),
)
RANGES = {REQUEST} | {label for _, _, label in STAGES}
# kernel base names of the closest-hit kernels the roofline reads
ISECT_KERNELS = {"planar_closest_kernel", "cull_select_kernel", "visit_sweep_count",
                 "visit_sweep_scatter", "visit_sweep_tile", "visit_sweep_fold"}


@contextlib.contextmanager
def _swapped(pairs):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, wrap in pairs:
            setattr(mod, name, wrap)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _ranged(fn, label):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def stage_ranges():
    with _swapped([(m, n, _ranged(getattr(m, n), label)) for m, n, label in STAGES]):
        yield


@contextlib.contextmanager
def kernel_calls(calls: list):
    """Append (kind, inputs, output) of every K1, K3 and K4 call to
    ``calls``; the tensors are kept as they are (none is written later)."""
    k1, k3, k4 = fi.planar_closest_kernel, fs.cull_select_kernel, fsw.sweep_kernel

    def k1_wrap(rays, pack, *a, **kw):
        calls.append(("K1", (rays.shape[1], pack), None))
        return k1(rays, pack, *a, **kw)

    def k3_wrap(rays, boxes, excl, V, K_real, *a, **kw):
        calls.append(("K3", (excl, boxes.numel(), V, K_real), None))
        return k3(rays, boxes, excl, V, K_real, *a, **kw)

    def k4_wrap(rays, ids, nears, best, table, tmin, triangle, sphere):
        out = k4(rays, ids, nears, best, table, tmin, triangle, sphere)
        if not sphere:
            calls.append(("K4", (rays, ids, nears, table, float(tmin)), out))
        return out

    with _swapped([(fi, "planar_closest_kernel", k1_wrap),
                   (fs, "cull_select_kernel", k3_wrap),
                   (fsw, "sweep_kernel", k4_wrap)]):
        yield


def bounds_s(calls: list) -> float:
    """Summed roofline bound (s) of the recorded kernel calls."""
    live_of = {}
    total = 0.0
    for kind, args, out in calls:
        if kind == "K1":
            R, pack = args
            key = pack.data_ptr()
            if key not in live_of:
                live_of[key] = int(pack[:, fi.ROW_ACTIVE].sum())
            total += roofline.k1_bound(R, pack.numel(), live_of[key])
        elif kind == "K3":
            total += roofline.k3_bound(*args)
        else:
            rays, ids, nears, table, tmin = args
            total += roofline.k4_bound(rays, ids, nears, out[:, 0], table, tmin)
    return total


def count_syncs(fn) -> int:
    """Host synchronisations PyTorch's operations make while ``fn`` runs
    (its synchronisation debug mode warns once for each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def kernel_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> dict:
    """What the profiled slice shows: kernels launched, device busy seconds
    (the union of every device operation's interval), device time by
    kernel, idle seconds by the host range the gap fell in, the host
    seconds of each range, and the device seconds of the closest-hit
    kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if e.name not in RANGES:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in RANGES:
            host.append((e.time_range.start, e.time_range.end, e.name))
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    busy = _merge([(s, e) for s, e, _ in dev])
    by_kernel, isect_us = {}, 0.0
    for s, e, n in kernels:
        base = kernel_name(n)
        by_kernel[base] = by_kernel.get(base, 0.0) + (e - s)
        if base in ISECT_KERNELS:
            isect_us += e - s
    host.sort(key=lambda h: h[1] - h[0])
    idle = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = next((n for s, e, n in host if s <= mid <= e), "outside every range")
        idle[name] = idle.get(name, 0.0) + (s1 - e0)
    ranges = {}
    for s, e, n in host:
        ranges[n] = ranges.get(n, 0.0) + (e - s)
    rank = lambda d: sorted(([k, v / 1e6] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"kernels": len(kernels), "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_ops": rank(by_kernel), "idle_gaps": rank(idle),
            "range_s": {k: v / 1e6 for k, v in ranges.items()},
            "isect_device_s": isect_us / 1e6}
