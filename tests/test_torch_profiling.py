"""The port's profiling entry point: a CPU render under the profiler and
``trace.recording()`` records one range per span of the port's code, for
the Cornell, gradient, colonnade and wavefront workloads."""

import time

import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, perray, replay
from cpu_ray_tracing_implementation_tpu_torch.utils import profiling, trace

ACTS = [torch.profiler.ProfilerActivity.CPU]


def _profiled(fn):
    """(what ``fn`` returns, {range: count} of the profile, the recording)."""
    with torch.profiler.profile(activities=ACTS) as prof, trace.recording() as rec:
        out = fn()
    return out, {e.key: e.count for e in prof.key_averages()}, rec


def test_stage_ranges_record_and_restore():
    """The spans are ranges of the profile, and no module attribute is
    swapped to make them."""
    before = isect.intersect_brute
    scene, cam = catalog.cornell_box(width=8, spp=1, max_depth=2,
                                      device="cpu")
    img, counts, rec = _profiled(lambda: integrator.render_image(scene, cam, keys.key(0)))
    assert bool(torch.isfinite(img).all())
    assert isect.intersect_brute is before
    # one camera pass, then intersect and scatter once per bounce
    assert counts["crt.render"] == counts["crt.sample"] == counts["crt.raygen"] == 1
    assert counts["crt.intersect"] == counts["crt.bounce"] == cam.max_depth
    assert counts["crt.scatter"] == counts["crt.scatter.light_pdf"] == cam.max_depth
    # a range for every span recorded, and nothing else named as the spans
    names = [s.name for s in rec.spans]
    assert {n: names.count(n) for n in names} == {k: v for k, v in counts.items()
                                                  if k.startswith("crt.")}


def test_colonnade_ranges_the_per_ray_accelerator(monkeypatch):
    """The colonnade workload at a CPU size: each bounce's intersect range
    holds at least one select and one sweep range (one per phase). At 8 px
    its 71 chunks take the packet route under ``auto``; the full workload's
    2,015 take the per-ray route, asked for here (``CRT_ACCEL=ray``)."""
    monkeypatch.setenv("CRT_ACCEL", "ray")
    scene, cam = catalog.sponza(width=8, spp=1, max_depth=2, device="cpu")
    assert scene.tri_chunks is not None
    profiling.reset_counts()
    img, counts, _ = _profiled(lambda: integrator.render_image(scene, cam, keys.key(0)))
    assert bool(torch.isfinite(img).all())
    assert counts["crt.intersect"] == cam.max_depth == perray.PHASES["calls"]
    assert counts["crt.intersect.select"] == counts["crt.intersect.sweep"] >= cam.max_depth
    assert counts["crt.intersect.select"] == perray.PHASES["phases"]
    # CPU tensors take the plain versions: no kernel launched
    assert set(profiling.launches().values()) == {0}


def test_kernel_name_strips_namespace_and_arguments():
    key = ("void (anonymous namespace)::visit_sweep_tile<false, true>(float const*, "
           "int2*)")
    assert profiling.kernel_name(key) == "visit_sweep_tile<false, true>"


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    assert profiling.main([]) == 2
    assert profiling.main(["colonnade"]) == 2
    assert profiling.main(["sweep_stages"]) == 2
    assert profiling.main(["nope"]) == 2


def test_gradient_ranges_split_the_passes(monkeypatch):
    """The cornell_grad workload at a CPU size: one forward-pass range (which
    decides every bounce's winner) and one backward-pass range (which
    replays them and decides none), a re-render and an autograd range a
    sample."""
    scene, cam = catalog.cornell_box(width=8, spp=2, max_depth=2, device="cpu")
    assert profiling.WORKLOADS["cornell_grad"][3]
    target = torch.zeros((cam.height, cam.width, 3))
    calls = {"winner_pack": [], "replay_hit": []}
    for name, at in calls.items():
        def counted(*a, _fn=getattr(replay, name), _at=at, **kw):
            _at.append(time.time_ns())
            return _fn(*a, **kw)
        monkeypatch.setattr(replay, name, counted)
    (loss, _), counts, rec = _profiled(
        lambda: diff.loss_and_grads(scene, cam, keys.key(0), target, 2))
    assert bool(torch.isfinite(loss))
    assert counts["crt.grad_step"] == counts["crt.forward"] == counts["crt.backward"] == 1
    assert counts["crt.sample"] == 2 * 2 and counts["crt.autograd"] == 2
    assert counts["crt.intersect"] == 2 * 2 * cam.max_depth
    assert len(rec.requests()) == 1
    # every decision is the forward pass's; both passes replay
    (fwd,) = [s for s in rec.spans if s.name == "crt.forward"]
    assert len(calls["winner_pack"]) == 2 * cam.max_depth
    assert all(fwd.start_ns <= t <= fwd.end_ns for t in calls["winner_pack"])
    assert len(calls["replay_hit"]) == 2 * 2 * cam.max_depth


@pytest.mark.parametrize("name", ["colonnade_wavefront", "sphereflake_wavefront"])
def test_wavefront_workloads_count_iterations(name, monkeypatch):
    """The wavefront workloads at a CPU size: one intersect range per loop
    iteration, each iteration's per-ray phases counted (the per-ray route
    asked for: at 8 px both scenes take the packet route under ``auto``),
    and no GPU needed to refuse."""
    monkeypatch.setenv("CRT_ACCEL", "ray")
    make, kwargs, spp, grad, wavefront, cam_kw = profiling.WORKLOADS[name]
    assert wavefront and not grad and kwargs["max_depth"] == 5 and not cam_kw
    scene, cam = make(width=8, spp=2, max_depth=2, device="cpu")
    profiling.reset_counts()
    img, counts, _ = _profiled(
        lambda: integrator.render_image_wavefront(scene, cam, keys.key(0)))
    assert bool(torch.isfinite(img).all())
    its = integrator.WAVEFRONT["iterations"]
    assert integrator.WAVEFRONT["renders"] == 1 and its >= cam.max_depth
    assert counts["crt.iteration"] == counts["crt.intersect"] == its
    assert its == perray.PHASES["calls"]
    assert counts["crt.intersect.select"] == perray.PHASES["phases"] >= its
    # raygen once before the loop and once per iteration (the refill)
    assert counts["crt.raygen"] == its + 1
    if not torch.cuda.is_available():
        assert profiling.main([name]) == 2


def test_sweep_phases_records_the_phase_loop():
    """``sweep_phases`` (the K4 inputs kernel_ab and chip_smoke.py time):
    one recorded call per selection phase of the per-ray loop, phase 1 from
    the caps, each later phase from the best its predecessor returned, and
    the last sweep's result the loop's closest hit."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw

    scene, cam = catalog.sponza(width=8, spp=1, max_depth=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    org, dirs, time, cap = profiling.scene_rays(scene, cam, gen)
    tabs, K = scene.tri_perray, scene.tri_chunks.corner.shape[0]
    perray.reset_phases()
    rays, calls = profiling.sweep_phases(org, dirs, time, cap, tabs, K, 1e-3, True, False)
    assert len(calls) == perray.PHASES["phases"] >= 1
    assert torch.equal(calls[0][2][:, 0], cap)
    for (ids, nears, best), (_, _, after) in zip(calls, calls[1:]):
        assert torch.equal(after, fsw.sweep(rays, ids, nears, best, tabs.table, 1e-3,
                                            True, False))
    ids, nears, best = calls[-1]
    last = fsw.sweep(rays, ids, nears, best, tabs.table, 1e-3, True, False)
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, 1e-3, True, cap,
                                        tabs=tabs)
    hit = last[:, 0] < cap
    assert torch.equal(torch.where(hit, last[:, 0], torch.full_like(cap, float("inf"))), t)


def test_sweep_phases_records_the_subtile_phase_loop(monkeypatch):
    """``sweep_phases`` at a sub-tile width (the K7 inputs kernel_ab times):
    K3 on the CS 8 boxes at ``subtile_v`` slots, one recorded K7 call per
    phase, each later phase from the best its predecessor returned, and
    the last one's result the sub-tile route's closest hit."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw

    scene, cam = catalog.sponza(width=8, spp=1, max_depth=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    org, dirs, time, cap = profiling.scene_rays(scene, cam, gen)
    tabs, K = scene.tri_perray, scene.tri_chunks.corner.shape[0]
    sub = tabs.subtile(8)
    perray.reset_phases()
    rays, calls = profiling.sweep_phases(org, dirs, time, cap, tabs, K, 1e-3, True, False,
                                         CS=8)
    assert len(calls) == perray.PHASES["phases"] >= 1
    assert calls[0][0].shape[1] == perray.subtile_v(sub.table.shape[0], 8) == 32
    for (ids, nears, best), (_, _, after) in zip(calls, calls[1:]):
        assert torch.equal(after, fsw.sweep_sub(rays, ids, nears, best, sub.table, 1e-3,
                                                True, False))
    ids, nears, best = calls[-1]
    last = fsw.sweep_sub(rays, ids, nears, best, sub.table, 1e-3, True, False)
    monkeypatch.setenv("CRT_SUBTILE", "1")
    monkeypatch.setenv("CRT_SUBC", "8")
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, 1e-3, True, cap,
                                        tabs=tabs)
    hit = last[:, 0] < cap
    assert torch.equal(torch.where(hit, last[:, 0], torch.full_like(cap, float("inf"))), t)
