"""One run of one cell: set-up, the measured window, the traced extras,
the check, and the result's line.

Everything that belongs to one configuration, traffic mix, metric or cell
is found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json``
(the file its entry names), ``traffic/<mix>.json``, ``metrics/<metric>.py``
(a reader with ``read(run) -> float | None``) and ``limits/<cell>.json``
(the limit of each number the check compares). A configuration's scene is
built, on the port's side and on the reference's, by the family it names
(``families/``), and a kernel's roofline is read by its file
(``rooflines/<id>.py``).

A traffic mix names the entry a request runs (``program.ENTRIES``: scan,
wavefront, grad) and its sizes: ``width``, ``spp``, ``max_depth``, and
``check_pixels`` (the pixels of a render the check compares, drawn from
the seed; 0 for all), ``profile_requests`` (the requests of each of a
traced run's two profiled slices) and, for a gradient step,
``target_scale`` (the target image is uniform in [0, target_scale), drawn
from the seed). It may add ``camera`` (options of the family's
``build_camera``) and ``entry_options`` (keyword parameters of the entry);
``load_cell`` refuses one that the camera or entry does not take or that
the family's reference does not implement. Requests run back to back in
one closed loop; request ``i`` is keyed by ``fold_in(key(seed), i)``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from port_bench import check, families
from port_bench.reference import rng

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
WARMUP_INDEX = 0xFFFFFFFF


@dataclasses.dataclass
class Cell:
    name: str
    kind: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def check_options(config: dict, traffic: dict, where: str) -> None:
    """Raise, naming the key, where the traffic's ``camera`` or
    ``entry_options`` hold an option that the family's ``build_camera`` or
    the entry does not take, or that the family's reference does not
    implement; and where the family has no files."""
    from port_bench import program

    family = families.name_of(config)
    prog, ref = families.program(family), families.reference(family)
    for group, takes, implements, by in (
            ("camera", prog.CAMERA_OPTIONS, ref.CAMERA_OPTIONS,
             f"family {family!r}'s build_camera"),
            ("entry_options", program.entry_options(traffic["entry"]), ref.ENTRY_OPTIONS,
             f"entry {traffic['entry']!r}")):
        for key in traffic.get(group, {}):
            if key not in takes:
                raise ValueError(f"{where}: {group} option {key!r} is not taken by {by} "
                                 f"(it takes {sorted(takes)})")
            if key not in implements:
                raise ValueError(f"{where}: {group} option {key!r} is not implemented by "
                                 f"reference/{family}.py (it implements {sorted(implements)})")


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    if manifest is None:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; one of {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{name}.json"
    config = json.loads((ROOT / conf["file"]).read_text())
    check_options(config, traffic, f"workload {name!r} (traffic {w['traffic']!r})")
    return Cell(name=name, kind=traffic["entry"],
                config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if _listed(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _listed(m, name)],
                limits=json.loads(limits_file.read_text()) if limits_file.exists() else {})


def load_reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or where there is
    none, that of its base name, up to its last dot (``device_idle.render``
    reads ``metrics/device_idle.py``). The manifest's ``workloads`` decide
    which cells report it."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = BENCH / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def base_key(seed: int):
    """The run's key: ``key(seed)`` for seeds below 2**32, the high words
    folded in above."""
    seed = int(seed)
    k = rng.key(seed & rng.M32)
    return rng.fold_in(k, seed >> 32) if seed >> 32 else k


@dataclasses.dataclass
class Run:
    """What the readers read (``metrics/*.py``)."""
    rays_per_request: int
    setup_s: float
    window_s: float
    walls: list
    memory_peak_bytes: int
    syncs: int | None = None
    profile: dict | None = None
    profile_rays: int = 0
    profile_wall_s: float = 0.0
    # {roofline id: {"bound_s", "device_s", "calls"}} (``tracing.roofline_table``)
    rooflines: dict = dataclasses.field(default_factory=dict)
    # {span name: figures per request} of the second slice (``tracing.span_table``),
    # and the seconds that slice took, its reading included
    spans: dict | None = None
    spans_s: float = 0.0

    @property
    def rays(self) -> int:
        return len(self.walls) * self.rays_per_request

    def roofline_share(self, ids) -> float | None:
        """Percent: the summed bound of roofline ids ``ids`` over their
        summed device seconds; None where their kernels did not run."""
        bound_s = device_s = 0.0
        for i in ids:  # added in turn, as the calls' bounds were
            if i in self.rooflines:
                bound_s += self.rooflines[i]["bound_s"]
                device_s += self.rooflines[i]["device_s"]
        if not device_s:
            return None
        return 100.0 * bound_s / device_s

    def p90(self) -> float:
        w = sorted(self.walls)
        return w[0] if len(w) < 2 else statistics.quantiles(w, n=10, method="inclusive")[-1]


def build(config: dict, traffic: dict, device, scene_overrides: dict | None = None):
    """(family, description, scene, leaves, camera) of a configuration at a
    traffic mix's sizes, built by the configuration's family
    (``families/<family>.py``) with the mix's ``camera`` options."""
    family = families.name_of(config)
    side = families.program(family)
    desc = side.describe(config, scene_overrides)
    scene, leaves = side.build_scene(desc, device)
    camera = side.build_camera(desc, traffic["width"], traffic["spp"], traffic["max_depth"],
                               device, **traffic.get("camera", {}))
    return family, desc, scene, leaves, camera


def make_target(seed: int, H: int, W: int, traffic: dict, device):
    """A gradient step's target image [H,W,3], uniform in [0,
    ``target_scale``), drawn from ``seed`` on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.rand((H, W, 3), generator=gen, device=device) * traffic["target_scale"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
        overrides: dict | None = None) -> tuple[dict, list]:
    """(the result's line as a dict, the check's lines). ``t0``: the
    process's start on ``time.perf_counter``'s clock. ``overrides``:
    ``{"scene": {...}, "traffic": {...}}`` for small test runs only."""
    from port_bench import program

    t0 = time.perf_counter() if t0 is None else t0
    times = {"imports_s": time.perf_counter() - t0}
    overrides = overrides or {}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    kind = traffic["entry"]
    entry = program.ENTRIES[kind]
    entry_options = traffic.get("entry_options", {})
    key0 = base_key(seed)
    W, spp = traffic["width"], traffic["spp"]
    family, desc, scene, leaves, camera = build(cell.config, traffic, device,
                                                overrides.get("scene"))
    H = camera.height
    target = make_target(seed, H, W, traffic, device) if kind == "grad" else None
    _sync(device)
    times["scene_s"] = time.perf_counter() - t0 - times["imports_s"]

    def request(i):
        return entry(scene, camera, rng.fold_in(key0, i), target, **entry_options)

    request(WARMUP_INDEX)
    _sync(device)
    setup_s = time.perf_counter() - t0
    times["warmup_s"] = setup_s - times["imports_s"] - times["scene_s"]

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # the check's request, drawn from the seed by reservoir sampling: only
    # its answer is kept, so the window's peak holds no other request's
    pick = np.random.default_rng(int(seed) & 0x7FFFFFFFFFFFFFFF)
    kept, j, walls = None, 0, []
    start = time.perf_counter()
    while True:
        i = len(walls)
        a = time.perf_counter()
        got = request(i)
        _sync(device)
        b = time.perf_counter()
        walls.append(b - a)
        if pick.random() * (i + 1) < 1.0:
            kept, j = got, i
        del got
        if b - start >= seconds:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    res = Run(rays_per_request=W * H * spp, setup_s=setup_s, window_s=window_s,
              walls=walls, memory_peak_bytes=peak)

    n = len(walls)
    times.update(setup_s=setup_s, window_s=window_s)
    if trace:
        a = time.perf_counter()
        _traced(res, request, n, device, traffic)
        times["traced_s"] = time.perf_counter() - a
        times["spans_s"] = res.spans_s

    # the check: the kept request of the window, its pixels drawn from the seed
    pixels = check.check_pixels(W * H, traffic.get("check_pixels", 0),
                                int(pick.integers(1 << 62)))
    if kind in check.RENDER_KINDS:
        answer = kept.detach().float().cpu()
    else:
        answer = (float(kept[0]), {k: v.detach().float().cpu() for k, v in kept[1].items()})
    if target is not None:
        target = target.cpu()
    del kept, scene, camera
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    a = time.perf_counter()
    numbers = check.reference_numbers(kind, family, desc, traffic, rng.fold_in(key0, j),
                                      answer, pixels, target, leaves, device=device)
    times["check_s"] = time.perf_counter() - a
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = load_reader(m["name"]).read(res)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=res.profile["busy_s"], window_s=res.profile_wall_s)
    out = {"correct": ok, "attempted": n, "failed": 0 if ok else 1, "metrics": metrics,
           "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": res.profile["device_ops"],
                            "idle_gaps": res.profile["idle_gaps"]}
    out["checks"] = checks
    lines = [" ".join(f"{k} {v:.3f}" for k, v in times.items())]
    for name, row in (res.spans or {}).items():
        lines.append(f"span {name} " + " ".join(f"{k} {v!r}" for k, v in row.items()))
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return out, lines


def _traced(res: Run, request, n: int, device, traffic: dict) -> None:
    """After the window: one request under the synchronisation debug mode,
    then the profiled slice, ranges and kernel calls recorded, and read;
    then a second profiled slice of as many requests, keyed past the
    first, under the port's span recording (``Run.spans``)."""
    from port_bench import tracing

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        res.syncs = tracing.count_syncs(lambda: request(n))
    k = int(traffic.get("profile_requests", 2))
    calls = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if is_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with tracing.stage_ranges(), tracing.kernel_calls(calls), \
            torch.profiler.profile(activities=acts) as prof:
        a = time.perf_counter()
        for i in range(k):
            with torch.profiler.record_function(tracing.REQUEST):
                request(n + 1 + i)
                _sync(device)
        res.profile_wall_s = time.perf_counter() - a
    res.profile_rays = k * res.rays_per_request
    res.profile = tracing.summarize(prof)
    res.rooflines = tracing.roofline_table(calls, res.profile["kernel_s"])
    del prof, calls

    _sync(device)
    a = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof, tracing.recording() as rec:
        for i in range(k):
            request(n + 1 + k + i)
            _sync(device)
    res.spans = tracing.span_table(prof, rec, is_cuda)
    res.spans_s = time.perf_counter() - a


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.split("\n")[0].strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out or None
