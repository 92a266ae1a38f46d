"""The port's spans (``utils/trace.py``): nothing while off and the same
image either way, the span tree of a render and of a gradient step, and
the spans on the profiler's clock."""

import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

SPP, DEPTH = 2, 2
BOUNCE = ["crt.uniforms", "crt.intersect", "crt.background", "crt.mat_rows",
          "crt.emitted", "crt.scatter"]
SCATTER = ["crt.scatter.lobes", "crt.scatter.light_sample", "crt.scatter.light_pdf"]
# with no gradient asked for, the scatter takes the fused route (kernel K9 on
# the card, its plain version, with the same three spans, on the CPU)
FUSED = "crt.scatter.fused"


def _cornell(width=8):
    return catalog.cornell_box(width=width, spp=SPP, max_depth=DEPTH, device="cpu")


def _children(rec):
    kids = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _check_sample(sample, kids, fused=True):
    """A sample: raygen, then a bounce per depth with its stages, and the
    scatter's three children, under the fused route's span when
    ``fused``."""
    assert [c.name for c in kids[sample.id]] == ["crt.raygen"] + ["crt.bounce"] * DEPTH
    for bounce in kids[sample.id][1:]:
        stages = kids[bounce.id]
        assert [c.name for c in stages] == BOUNCE
        scatter = stages[-1]
        if fused:
            assert [c.name for c in kids[scatter.id]] == [FUSED]
            scatter = kids[scatter.id][0]
        assert [c.name for c in kids[scatter.id]] == SCATTER


def _check_closed(rec):
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns and s.syncs == 0
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert p.request == s.request and p.thread == s.thread


def test_off_records_nothing_and_changes_no_pixel():
    scene, cam = _cornell()
    assert trace.span("crt.bounce") is trace.span("crt.sample") is trace._OFF
    assert trace.entry("crt.render") is trace._OFF
    off = integrator.render_image(scene, cam, keys.key(5))
    with trace.recording() as rec:
        on = integrator.render_image(scene, cam, keys.key(5))
    assert torch.equal(off, on) and rec.spans
    assert trace.span("crt.bounce") is trace._OFF
    with trace.recording() as rec:
        integrator.render_image(scene, cam, keys.key(5))
    n = len(rec.spans)
    integrator.render_image(scene, cam, keys.key(5))
    assert len(rec.spans) == n
    # no CUDA device here: nothing counted
    assert not rec.counts_syncs and rec.outside == 0


def test_render_span_tree():
    scene, cam = _cornell()
    with trace.recording() as rec:
        integrator.render_image(scene, cam, keys.key(0))
        integrator.render_image(scene, cam, keys.key(1))
    _check_closed(rec)
    reqs = rec.requests()
    assert sorted(reqs) == [1, 2]
    kids = _children(rec)
    for rid, spans in reqs.items():
        names = [s.name for s in spans]
        assert names[0] == "crt.render" and spans[0].parent == 0
        assert names.count("crt.render") == 1
        assert names.count("crt.sample") == SPP
        assert names.count("crt.bounce") == SPP * DEPTH
        samples = kids[spans[0].id]
        assert [s.name for s in samples] == ["crt.sample"] * SPP
        for sample in samples:
            _check_sample(sample, kids)
    assert len(rec.spans) == 2 * (1 + SPP * (2 + DEPTH * (2 + len(BOUNCE) + len(SCATTER))))


def test_grad_step_span_tree():
    scene, cam = _cornell()
    target = torch.zeros((cam.height, cam.width, 3))
    with trace.recording() as rec:
        diff.loss_and_grads(scene, cam, keys.key(0), target, SPP)
    _check_closed(rec)
    assert list(rec.requests()) == [1]
    kids = _children(rec)
    step = rec.spans[0]
    assert step.name == "crt.grad_step" and step.parent == 0
    assert [c.name for c in kids[step.id]] == ["crt.forward", "crt.backward"]
    fwd, bwd = kids[step.id]
    assert [c.name for c in kids[fwd.id]] == ["crt.sample"] * SPP
    assert [c.name for c in kids[bwd.id]] == ["crt.sample", "crt.autograd"] * SPP
    # the forward pass (no grad) takes the fused scatter, the backward's
    # re-render with autograd the differentiable one
    for sample in kids[fwd.id]:
        _check_sample(sample, kids)
    for sample in kids[bwd.id][::2]:
        _check_sample(sample, kids, fused=False)
    assert sum(s.name == "crt.bounce" for s in rec.spans) == 2 * SPP * DEPTH
    assert sum(s.name == FUSED for s in rec.spans) == SPP * DEPTH


def test_nested_entry_keeps_the_outer_request():
    scene, cam = _cornell()
    with trace.recording() as rec:
        with trace.entry("crt.render"):
            integrator.render_image(scene, cam, keys.key(0))
        integrator.render_image(scene, cam, keys.key(0))
        with trace.span("crt.sample"):
            pass
    renders = [s for s in rec.spans if s.name == "crt.render"]
    assert [s.request for s in renders] == [1, 1, 2]
    assert renders[1].parent == renders[0].id
    assert rec.spans[-1].request == 0 and rec.spans[-1].parent == 0
    with pytest.raises(RuntimeError):
        with trace.recording(), trace.recording():
            pass


def test_wavefront_spans_an_iteration_each():
    scene, cam = _cornell()
    integrator.reset_wavefront()
    with trace.recording() as rec:
        integrator.render_image_wavefront(scene, cam, keys.key(0))
    _check_closed(rec)
    its = integrator.WAVEFRONT["iterations"]
    names = [s.name for s in rec.spans]
    assert names[0] == "crt.render" and names.count("crt.render") == 1
    assert names.count("crt.iteration") == its >= DEPTH
    assert names.count("crt.intersect") == names.count("crt.uniforms") == its
    assert names.count("crt.raygen") == its + 1


def test_spans_sit_on_the_profilers_clock():
    """Each span's recorded interval inside its profiler event's, to 20 us
    (the clock is read after the range opens and before it closes), and
    each span's start within 100 us of the event's, but for at most one: a
    stall of a loaded host between the two reads moves one span, not the
    clock. The first ``record_function`` of a process pays a one-time
    set-up of ~1 ms, taken before the profiled render."""
    scene, cam = _cornell()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts), torch.profiler.record_function("warm"):
        pass
    with torch.profiler.profile(activities=acts) as prof, trace.recording() as rec:
        integrator.render_image(scene, cam, keys.key(0))
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith("crt.")),
                    key=lambda e: e.time_range.start)
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [e.name for e in events] == [s.name for s in spans]
    offsets = []
    for e, s in zip(events, spans):
        start_ns = t0 + round(e.time_range.start * 1000)
        end_ns = t0 + round(e.time_range.end * 1000)
        assert start_ns - 20_000 <= s.start_ns <= s.end_ns <= end_ns + 20_000, s.name
        offsets.append(abs(s.start_ns - start_ns))
    late = [(s.name, o) for s, o in zip(spans, offsets) if o >= 100_000]
    assert len(late) <= 1, late
