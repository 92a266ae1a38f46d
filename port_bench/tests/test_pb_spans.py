"""The port's spans against the benchmark's own ranges and counts. On the
CPU: no span name is one of ``tracing.RANGES``, so the benchmark's ranges
read as before; ``tracing.span_table``'s counts and host seconds, and its
attribution of idle gaps and kernels on a made-up trace. On the card: per
request of each cell at a reduced size, the synchronisations counted by
span add up to ``tracing.count_syncs``'s, none outside every span, and so
do the span table's; its kernels add up to the slice's launch calls; and
a span holds the device interval of the work it waited for.

    python3 -m pytest -q -m cuda port_bench/tests/test_pb_spans.py
"""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from port_bench import harness, program, tracing
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
    _, _, scene, _, cam = harness.build(c.config, tr, dev)
    target = harness.make_target(SEED, cam.height, tr["width"], tr, dev) if c.kind == "grad" \
        else None
    key0 = harness.base_key(SEED)

    def request(i):
        return program.ENTRIES[c.kind](scene, cam, rng.fold_in(key0, i), target)
    request(harness.WARMUP_INDEX)
    torch.cuda.synchronize(dev)
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
    _, _, scene, _, cam = harness.build(c.config, tr, "cpu")
    target = harness.make_target(SEED, cam.height, tr["width"], tr, "cpu") \
        if c.kind == "grad" else None
    with trace.recording() as rec:
        program.ENTRIES[c.kind](scene, cam, harness.base_key(SEED), target)
    names = {s.name for s in rec.spans}
    assert "crt.bounce" in names and all(n.startswith("crt.") for n in names)
    assert not names & tracing.RANGES


ADDS_UP = """
import json, sys
import torch
from port_bench import tracing
from port_bench.tests.test_pb_spans import _request

dev = torch.device("cuda", 0)
request = _request(sys.argv[1], dev)
n = tracing.count_syncs(lambda: request(1))
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof, tracing.recording() as rec:
    request(1)
    torch.cuda.synchronize(dev)
print(json.dumps({"count_syncs": n, "table": tracing.span_table(prof, rec, True)}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_span_table_adds_up(cell, dev):
    """The first request a process watches (the debug mode's one-time
    notice is no synchronisation): the table's syncs add up to
    ``count_syncs``'s, and its kernels, none outside every span, to the
    trace's launch calls. In a process of its own, as above."""
    out = subprocess.run([sys.executable, "-c", ADDS_UP, cell], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.split("\n")[-2])
    n, table = got["count_syncs"], got["table"]
    req = table.pop("requests")
    assert req["count"] == 1 and req["outside_kernels"] == 0
    assert sum(r["syncs"] for r in table.values()) == n > 0
    assert sum(r["kernels"] for r in table.values()) == req["launch_calls"] > 0
    top = "crt.grad_step" if "crt.grad_step" in table else "crt.render"
    assert table[top]["tree_syncs"] == n and table[top]["tree_kernels"] == req["launch_calls"]
    assert 0 < table[top]["tree_idle_s"] < table[top]["host_s"]


def _recorded_render():
    from cpu_ray_tracing_implementation_tpu_torch.utils import trace

    c = harness.load_cell("cornell-scan-render", MANIFEST)
    tr = {**c.traffic, "width": 8, "spp": 2, "max_depth": 2}
    _, _, scene, _, cam = harness.build(c.config, tr, "cpu")
    key0 = harness.base_key(SEED)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, trace.recording() as rec:
        for i in range(2):
            program.ENTRIES["scan"](scene, cam, rng.fold_in(key0, i), None)
    return prof, rec


def test_span_table_on_the_cpu():
    """Counts and host seconds per span, per request of two; without a
    card no idle seconds, kernels or syncs."""
    prof, rec = _recorded_render()
    table = tracing.span_table(prof, rec, False)
    assert table.pop("requests") == {"count": 2, "launch_calls": None, "outside_idle_s": None,
                                     "outside_kernels": None}
    spans = rec.spans
    assert table["crt.render"]["count"] == 1 and table["crt.sample"]["count"] == 2
    for name, row in table.items():
        mine = [s for s in spans if s.name == name]
        assert row["count"] == len(mine) / 2
        assert row["host_s"] == pytest.approx(sum(s.end_ns - s.start_ns for s in mine) / 2e9)
        kids = [c for s in mine for c in spans if c.parent == s.id]
        assert row["self_s"] == pytest.approx(row["host_s"] - sum(
            c.end_ns - c.start_ns for c in kids) / 2e9)
        assert 0 <= row["self_s"] <= row["host_s"]
        assert {row[k] for k in tracing.FIGURES[3:]} == {None}


def _event(name, start, dur, corr, cuda):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           correlation_id=lambda: corr, device_type=lambda: dev)


def test_span_table_attributes_gaps_and_kernels():
    """A made-up request: entry A [0, 100] holds B [10, 50] and C [60, 90].
    Device: a copy [12, 14] launched at 11 in B, a kernel [25, 30]
    launched at 20 in B, a kernel [70, 80] launched at 65 in C, a kernel
    with no launch call found, and B's own range on the device (left out).
    Gaps: (14, 25) mid 19.5 in B, (30, 70) mid 50 in B (ends are in),
    (80, 200) mid 140 outside; a host span of request 0 is left out."""
    from cpu_ray_tracing_implementation_tpu_torch.utils.trace import Span

    spans = [Span("crt.a", 1, 0, 1, 7, 0, 100), Span("crt.b", 2, 1, 1, 7, 10, 50, syncs=2),
             Span("crt.c", 3, 1, 1, 7, 60, 90, syncs=1), Span("crt.x", 4, 0, 0, 7, 0, 300)]
    events = [_event("cudaMemcpyAsync", 11, 1, 5, False), _event("Memcpy HtoD", 12, 2, 5, True),
              _event("cudaLaunchKernel", 20, 1, 6, False), _event("k_one", 25, 5, 6, True),
              _event("cudaLaunchKernel", 65, 1, 7, False), _event("k_two", 70, 10, 7, True),
              _event("k_lost", 200, 1, 99, True), _event("crt.b", 10, 40, 0, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    rec = SimpleNamespace(spans=spans, counts_syncs=True)
    t = tracing.span_table(prof, rec, True)
    assert t["crt.b"]["idle_s"] == pytest.approx((11 + 40) / 1e9)
    assert t["crt.c"]["idle_s"] == 0 and t["crt.a"]["idle_s"] == 0
    assert t["requests"] == {"count": 1, "launch_calls": 2,
                             "outside_idle_s": pytest.approx(120 / 1e9), "outside_kernels": 1}
    assert (t["crt.b"]["kernels"], t["crt.c"]["kernels"], t["crt.a"]["kernels"]) == (1, 1, 0)
    assert (t["crt.a"]["syncs"], t["crt.a"]["tree_syncs"], t["crt.a"]["tree_kernels"]) == (0, 3, 2)
    assert t["crt.a"]["tree_idle_s"] == pytest.approx(51 / 1e9)
    assert t["crt.a"]["self_s"] == pytest.approx(30 / 1e9)
    assert "crt.x" not in t
