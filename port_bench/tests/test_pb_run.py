"""Whole runs of each cell at a tiny size on the CPU: the result's line,
the check agreeing with the port, and the check failing the faults a cell
can have and the bfloat16 control.

The look for a card is skipped (``harness.run`` is called with the CPU),
and the port takes its plain versions of the kernels. Besides the cells of
``BENCHMARK.json``, two test cells render the procedural colonnade hall
(``fixtures/colonnade_hall.json``, no configuration of the benchmark) at
313 chunks, so that the per-ray route, the reference's triangles and the
per-ray kernels' bounds stay tested.
"""

import json
from pathlib import Path

import pytest
import torch

from port_bench import check, harness
from port_bench.reference import rng
from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
HALL = json.loads((Path(__file__).parent / "fixtures" / "colonnade_hall.json").read_text())
# test cells on the hall: their entry, and the metrics of the kind of cell
HALL_CELLS = {"hall-wavefront-render": ("wavefront", "render_rays_per_s"),
              "hall-grad-step": ("grad", "grad_rays_per_s")}
HALL_LIMITS = {"image_mae_rel": 0.02, "loss_rel": 0.025, "grad_rel": 0.03}
CELLS = [w["name"] for w in MANIFEST["workloads"]] + list(HALL_CELLS)
SEED = 2**31 + 977
SMALL = {"render": {"width": 16, "spp": 4, "max_depth": 3, "check_pixels": 0},
         "grad": {"width": 12, "spp": 4, "max_depth": 3}}


def load(cell) -> harness.Cell:
    if cell not in HALL_CELLS:
        return harness.load_cell(cell, MANIFEST)
    entry, rate = HALL_CELLS[cell]
    suffix = ".grad" if entry == "grad" else ".render"
    return harness.Cell(
        name=cell, kind=entry, config=HALL,
        traffic={"entry": entry, "width": 16, "spp": 4, "max_depth": 3,
                 "target_scale": 0.5, "profile_requests": 1},
        end_to_end=[m for m in MANIFEST["end_to_end"] if m["name"] in (rate, "setup_s")],
        per_layer=[m for m in MANIFEST["per_layer"] if m["name"].endswith(suffix)],
        limits={k: v for k, v in HALL_LIMITS.items()
                if (k == "image_mae_rel") != (entry == "grad")})


def small(cell):
    c = load(cell)
    ov = {"traffic": SMALL["grad" if c.kind == "grad" else "render"]}
    if c.config["meshes"]:
        ov["scene"] = {"target_tris": 40_000}  # 313 chunks: the per-ray route
    return c, ov


def _run(cell, trace=False):
    c, ov = small(cell)
    return harness.run(c, SEED, 0.2, trace, device="cpu", overrides=ov)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    out, lines = _run(cell, trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["attempted"] >= 1 and out["failed"] == 0 and out["correct"] is True
    c = load(cell)
    wanted = {m["name"]: m["unit"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) <= set(wanted)
    for name, m in out["metrics"].items():
        assert m["unit"] == wanted[name] and isinstance(m["value"], float)
    if not trace:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    else:
        assert "breakdown" in out and "busy_s" in out["device"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert lines[-len(out["checks"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in out["checks"].items()]
    json.dumps(out)


def _stale(fn):
    """A request that returns the previous request's answer: its state
    left unchanged."""
    last = []

    def wrapped(*a, **kw):
        got = fn(*a, **kw)
        if not last:
            last.append(got)
        out, last[0] = last[0], got
        return out
    return wrapped


def _half_render(fn):
    def wrapped(scene, camera, key, spp=None, **kw):
        return fn(scene, camera, key, spp=max(1, camera.spp // 2), **kw)
    return wrapped


def _altered_render(fn):
    def wrapped(*a, **kw):
        img = fn(*a, **kw).clone()
        img[: max(1, img.shape[0] // 8)] *= 1.5
        return img
    return wrapped


def _half_grad(fn):
    def wrapped(scene, camera, key, target, spp, **kw):
        return fn(scene, camera, key, target, max(1, spp // 2), **kw)
    return wrapped


def _altered_grad(fn):
    def wrapped(*a, **kw):
        loss, (gs, gc) = fn(*a, **kw)
        g = gs["tex_color0"].clone()
        g[g.norm(dim=1).argmax()] *= 1.5
        return loss, ({**gs, "tex_color0": g}, gc)
    return wrapped


def _camera_grad_zero(fn):
    """A step that leaves out the camera's gradients."""
    def wrapped(*a, **kw):
        loss, (gs, gc) = fn(*a, **kw)
        return loss, (gs, {k: torch.zeros_like(v) for k, v in gc.items()})
    return wrapped


FAULTS = {"stale": (_stale, _stale), "half": (_half_render, _half_grad),
          "altered": (_altered_render, _altered_grad), "no_camera_grad": (None, _camera_grad_zero)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS
                                         if load(c).kind == "grad" or FAULTS[f][0]])
def test_faults_fail_the_check(cell, fault, monkeypatch):
    kind = load(cell).kind
    if kind == "grad":
        monkeypatch.setattr(diff, "loss_and_grads", FAULTS[fault][1](diff.loss_and_grads))
    else:
        name = "render_image" if kind == "scan" else "render_image_wavefront"
        monkeypatch.setattr(integrator, name, FAULTS[fault][0](getattr(integrator, name)))
    out, _ = _run(cell)
    assert out["correct"] is False and out["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference in bfloat16, put in the program's place."""
    c, ov = small(cell)
    tr = {**c.traffic, **ov["traffic"]}
    family, desc, _, leaves, cam = harness.build(c.config, tr, "cpu", ov.get("scene"))
    H = cam.height
    target = harness.make_target(SEED, H, tr["width"], tr, "cpu") if c.kind == "grad" else None
    nums = check.control_numbers(c.kind, family, desc, tr,
                                 rng.fold_in(harness.base_key(SEED), 0), None, target, leaves,
                                 dtype=torch.bfloat16)
    assert any(v > c.limits[k] for k, v in nums.items())


def test_reference_imports_nothing_of_the_port():
    import ast

    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        tops = {n.split(".")[0] for n in names}
        assert tops <= {"__future__", "math", "numpy", "torch", "port_bench"}, path
        assert all(n.startswith("port_bench.reference") for n in names
                   if n.split(".")[0] == "port_bench"), path
