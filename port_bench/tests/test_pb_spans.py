"""The port's spans against the benchmark's own ranges and counts. On the
CPU: no span name is one of ``tracing.RANGES``, so the benchmark's ranges
read as before. On the card: per request of each cell at a reduced size,
the synchronisations counted by span add up to ``tracing.count_syncs``'s,
none outside every span; and a span holds the device interval of the work
it waited for.

    python3 -m pytest -q -m cuda port_bench/tests/test_pb_spans.py
"""

import json
import subprocess
import sys
import warnings

import pytest
import torch

from port_bench import harness, program, scenes, tracing
from port_bench.reference import rng
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 3_000_000_019
REDUCED = {"render": {"width": 48, "spp": 4}, "grad": {"width": 48, "spp": 2}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def _request(cell, dev):
    c = harness.load_cell(cell, MANIFEST)
    tr = {**c.traffic, **REDUCED["grad" if c.kind == "grad" else "render"]}
    desc = scenes.describe(c.config)
    scene, _, _ = program.build_scene(desc, dev)
    cam = program.build_camera(desc, tr["width"], tr["spp"], tr["max_depth"], dev)
    target = harness.make_target(SEED, cam.height, tr["width"], tr, dev) if c.kind == "grad" \
        else None
    key0 = harness.base_key(SEED)

    def request(i):
        return program.ENTRIES[c.kind](scene, cam, rng.fold_in(key0, i), target)
    request(harness.WARMUP_INDEX)
    torch.cuda.synchronize(dev)
    # the debug mode's one-time notice, which count_syncs would count as a
    # synchronisation of the first request it watches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    return request


SLEEP = """
import torch
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

dev = torch.device("cuda", 0)
torch.ones(1, device=dev).sum()
torch.cuda.synchronize(dev)
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof, trace.recording() as rec:
    with trace.span("crt.sleep"):
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize(dev)
t0 = prof.profiler.kineto_results.trace_start_ns()
cuda = torch.autograd.DeviceType.CUDA
names = [e.name for e in prof.events() if e.device_type == cuda]
sleeps = [e for e in prof.events() if e.device_type == cuda and "spin_kernel" in e.name]
assert len(sleeps) == 1, names
k = sleeps[0]
(s,) = rec.spans
assert s.start_ns <= t0 + k.time_range.start * 1e3, (s.start_ns - t0, k.time_range.start)
assert t0 + k.time_range.end * 1e3 <= s.end_ns, (s.end_ns - t0, k.time_range.end)
print("held")
"""


@pytest.mark.cuda
def test_span_holds_the_device_work_it_waited_for(dev):
    """In a process of its own: a profiler session after others in one
    process has been seen to return no device events at all."""
    out = subprocess.run([sys.executable, "-c", SLEEP], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split()[-1:] == ["held"], out.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_syncs_by_span_add_up(cell, dev):
    request = _request(cell, dev)
    for i in range(2):
        n = tracing.count_syncs(lambda: request(i))
        with trace.recording() as rec:
            request(i)
            torch.cuda.synchronize(dev)
        assert rec.counts_syncs and rec.outside == 0
        assert sum(s.syncs for s in rec.spans) == n > 0
        assert len(rec.requests()) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_span_names_are_not_the_benchmarks_ranges(cell):
    c = harness.load_cell(cell, MANIFEST)
    tr = {**c.traffic, "width": 8, "spp": 2, "max_depth": 2}
    desc = scenes.describe(c.config)
    scene, _, _ = program.build_scene(desc, "cpu")
    cam = program.build_camera(desc, tr["width"], tr["spp"], tr["max_depth"], "cpu")
    target = harness.make_target(SEED, cam.height, tr["width"], tr, "cpu") \
        if c.kind == "grad" else None
    with trace.recording() as rec:
        program.ENTRIES[c.kind](scene, cam, harness.base_key(SEED), target)
    names = {s.name for s in rec.spans}
    assert "crt.bounce" in names and all(n.startswith("crt.") for n in names)
    assert not names & tracing.RANGES
