"""Instrumentation of a traced run, all of it from outside the port.

- ``stage_ranges``: a ``record_function`` range around each stage function
  of the port (the module attributes are swapped for the profiled slice
  only, and restored after), so that every idle gap of the device can be
  named by what the host was doing;
- ``kernel_calls``: what each call of a kernel wrapper that a roofline
  file names (``rooflines/<id>.py``) needs for its bound;
  ``roofline_table`` sums each id's bound, device seconds and calls;
- ``count_syncs``: the host synchronisations PyTorch reports in its
  synchronisation debug mode;
- ``summarize``: the profiled slice's kernels, busy time, device time by
  kernel and idle gaps by host range;
- ``span_table``: the port's own spans (``utils/trace.py``) of a slice
  recorded under a profiler, by name, per request.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import re
import warnings
from pathlib import Path

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import replay
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

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
ROOFLINES = Path(__file__).resolve().parent / "rooflines"
# what PyTorch's synchronisation debug mode says at each synchronisation;
# turning the mode on first in a process warns once more, a notice that
# is not one
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# the prefix of every span name of the port, and its recording of them
SPAN_PREFIX = "crt."
recording = trace.recording


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


def roofline_files() -> dict:
    """{id: module} of every ``rooflines/<id>.py``."""
    return {p.stem: importlib.import_module(f"port_bench.rooflines.{p.stem}")
            for p in sorted(ROOFLINES.glob("*.py")) if p.stem != "__init__"}


def _recorded(fn, rid: str, mod, calls: list):
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        rec = mod.record(bound.arguments, out)
        if rec is not None:
            calls.append((rid, rec))
        return out
    return wrapper


@contextlib.contextmanager
def kernel_calls(calls: list):
    """Append (id, record) of every call to a function that a roofline
    file wraps to ``calls``; the tensors are kept as they are (none is
    written later)."""
    pairs = []
    for rid, mod in roofline_files().items():
        target = importlib.import_module(mod.MODULE)
        pairs.append((target, mod.ATTR, _recorded(getattr(target, mod.ATTR), rid, mod, calls)))
    with _swapped(pairs):
        yield


def roofline_table(calls: list, kernel_s: dict) -> dict:
    """{id: {"bound_s", "device_s", "calls"}} of every roofline file: the
    summed bound of its recorded calls, the device seconds of its kernels
    (``kernel_s``: seconds by kernel base name) and the calls counted."""
    files = roofline_files()
    table = {rid: {"bound_s": 0.0, "calls": 0,
                   "device_s": sum(kernel_s.get(k, 0.0) for k in mod.KERNELS)}
             for rid, mod in files.items()}
    for rid, rec in calls:
        table[rid]["bound_s"] += files[rid].bound_s(rec)
        table[rid]["calls"] += 1
    return table


def count_syncs(fn) -> int:
    """Host synchronisations PyTorch's operations make while ``fn`` runs
    (its synchronisation debug mode warns once for each, with
    ``SYNC_MESSAGE``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(str(w.message).startswith(SYNC_MESSAGE) for w in caught)


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
    seconds of each range."""
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
    by_kernel = {}
    for s, e, n in kernels:
        base = kernel_name(n)
        by_kernel[base] = by_kernel.get(base, 0.0) + (e - s)
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
            "kernel_s": {k: v / 1e6 for k, v in by_kernel.items()}}


FIGURES = ("count", "host_s", "self_s", "idle_s", "kernels", "syncs",
           "tree_idle_s", "tree_kernels", "tree_syncs")


def _innermost(spans: list, times: list) -> list:
    """The span open innermost at each of ``times`` (ns), or None; the
    spans nest properly (one thread, one request at a time)."""
    spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    order = sorted(range(len(times)), key=times.__getitem__)
    out, stack, i = [None] * len(times), [], 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i].start_ns <= t:
            while stack and stack[-1].end_ns < spans[i].start_ns:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def span_table(prof, rec, cuda: bool) -> dict:
    """The spans of the requests that ``rec`` (``trace.recording()``)
    holds, recorded under the profiler session ``prof``: {span name: the
    mean per request of ``FIGURES``}, and under ``"requests"`` their
    ``count`` and, per request, the ``launch_calls`` the trace holds (the
    CUDA runtime's launch events: a witness that no kernel was lost) and
    the idle seconds and kernels that fell in none of the spans
    (``outside_idle_s``, ``outside_kernels``).

    - ``count``; ``host_s``, the spans' summed durations; ``self_s``, less
      the time their child spans cover;
    - ``idle_s``: each gap between the device's busy intervals (the union
      of every device operation, a span's own ``record_function`` copy on
      the device left out) goes to the innermost span open on the
      requests' thread at the gap's midpoint;
    - ``kernels``: each kernel (no memory copy or set) goes to the
      innermost span open at its launch call, the CUDA runtime event that
      carries its correlation id;
    - ``syncs``: the synchronisations counted while the span was innermost;
    - ``tree_*``: the same three over the span and every span below it.

    Without a card (``cuda`` False) idle seconds and kernels are None, and
    syncs where the recording counted none (``rec.counts_syncs``)."""
    entries = {}
    for s in rec.spans:
        if s.request and s.request not in entries:
            entries[s.request] = s
    spans = [s for s in rec.spans if s.request and s.thread == entries[s.request].thread]
    n_req = max(len(entries), 1)
    own = {s.id: {"idle_s": 0.0, "kernels": 0, "syncs": s.syncs} for s in spans}
    outside = {"idle_s": 0.0, "kernels": 0}
    calls = 0
    if cuda:
        dev = torch.autograd.DeviceType.CUDA
        launch, busy, kernels = {}, [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == dev:
                if name.startswith(SPAN_PREFIX) or name in RANGES:
                    continue
                busy.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                if not name.startswith(("Memcpy", "Memset")):
                    kernels.append(e.correlation_id())
            elif name.startswith(("cuda", "cuLaunch")):
                launch[e.correlation_id()] = e.start_ns()
                calls += name.startswith(("cudaLaunch", "cuLaunch"))
        merged = _merge(busy)
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
        for (e0, s1), s in zip(gaps, _innermost(spans, [0.5 * (e0 + s1) for e0, s1 in gaps])):
            (own[s.id] if s is not None else outside)["idle_s"] += (s1 - e0) / 1e9
        times = [launch.get(c, -1) for c in kernels]
        for s in _innermost(spans, times):
            (own[s.id] if s is not None else outside)["kernels"] += 1
    tree = {i: dict(o) for i, o in own.items()}
    child_s = dict.fromkeys(own, 0)
    for s in reversed(spans):
        if s.parent in tree:
            for k in ("idle_s", "kernels", "syncs"):
                tree[s.parent][k] += tree[s.id][k]
            child_s[s.parent] += s.end_ns - s.start_ns
    table = {}
    for s in spans:
        row = table.setdefault(s.name, dict.fromkeys(FIGURES, 0))
        dur = s.end_ns - s.start_ns
        row["count"] += 1
        row["host_s"] += dur / 1e9
        row["self_s"] += (dur - child_s[s.id]) / 1e9
        for k in ("idle_s", "kernels", "syncs"):
            row[k] += own[s.id][k]
            row["tree_" + k] += tree[s.id][k]
    unread = () if cuda else ("idle_s", "kernels", "tree_idle_s", "tree_kernels")
    if not rec.counts_syncs:
        unread += ("syncs", "tree_syncs")
    for row in table.values():
        for k in FIGURES:
            row[k] = None if k in unread else row[k] / n_req
    table["requests"] = {"count": len(entries),
                         "launch_calls": calls / n_req if cuda else None,
                         **{f"outside_{k}": (v / n_req if cuda else None)
                            for k, v in outside.items()}}
    return table
