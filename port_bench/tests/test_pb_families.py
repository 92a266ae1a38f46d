"""Configuration families on the CPU: a family found only on a search path
runs a whole cell; a misspelled family or an option that the camera, the
entry or the reference does not take is refused before any request; and
both Cornell cells, at a reduced size, build and check bit for bit as
before families were looked up (``fixtures/parent_cornell.json``, made
by the code this replaced: a sha256 of each tensor, and the numbers)."""

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import check, families, harness, program
from port_bench.reference import rng

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
FIXTURES = Path(__file__).parent / "fixtures"
PARENT = json.loads((FIXTURES / "parent_cornell.json").read_text())
CORNELL = json.loads((harness.BENCH / "configs" / "cornell_box.json").read_text())
SEED = 2**31 + 977


def digest(x) -> str:
    """sha256 over the dtypes, shapes and bytes of every tensor and array
    in ``x`` (dataclasses, dicts, lists walked), and the repr of the rest."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes() if t.dtype != torch.bfloat16
                     else t.float().numpy().tobytes())
        elif isinstance(v, np.ndarray):
            h.update(f"{v.dtype}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                h.update(f.name.encode())
                walk(getattr(v, f.name))
        elif isinstance(v, dict):
            for k in sorted(v):
                h.update(repr(k).encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(f"{type(v).__name__}{len(v)}".encode())
            for e in v:
                walk(e)
        else:
            h.update(repr(v).encode())
    walk(x)
    return h.hexdigest()[:32]


@pytest.mark.parametrize("cell", ["cornell-scan-render", "cornell-grad-step"])
def test_cornell_cells_as_before_families(cell):
    want = PARENT[cell]
    c = harness.load_cell(cell, MANIFEST)
    tr = {**c.traffic, **want["traffic"]}
    family, desc, scene, leaves, cam = harness.build(c.config, tr, "cpu")
    assert family == "planar"
    assert digest(desc) == want["description"]
    assert digest(scene) == want["scene"]
    assert leaves == {"tex_rows": want["leaves"][0], "bg_row": want["leaves"][1]}
    assert digest(cam) == want["camera"]
    H, W, spp, D = cam.height, cam.width, tr["spp"], tr["max_depth"]
    target = harness.make_target(SEED, H, W, tr, "cpu") if c.kind == "grad" else None
    key = rng.fold_in(harness.base_key(SEED), 0)
    pixels = check.check_pixels(W * H, tr.get("check_pixels", 0), SEED)
    answer = program.ENTRIES[c.kind](scene, cam, key, target)
    ref = families.reference(family)
    if c.kind == "grad":
        answer = (float(answer[0]), {k: v.detach().float().cpu() for k, v in answer[1].items()})
        plain = ref.loss_and_grads(desc, W, spp, D, key, target)
    else:
        answer = answer.detach().float().cpu()
        plain = ref.render(desc, W, spp, D, key, pixel_ids=pixels)
    assert digest(answer) == want["answer"]
    assert digest(plain) == want["reference"]
    assert check.reference_numbers(c.kind, family, desc, tr, key, answer, pixels, target,
                                   leaves) == want["check"]
    assert check.control_numbers(c.kind, family, desc, tr, key, pixels, target,
                                 leaves) == want["control"]


TWIN_PROGRAM = """from port_bench.families.planar import (  # noqa: F401
    CAMERA_OPTIONS, build_camera, build_scene, describe)
"""
TWIN_REFERENCE = """from port_bench.reference.planar import (  # noqa: F401
    CAMERA_OPTIONS, ENTRY_OPTIONS, expected_leaves, leaf_shapes, loss_and_grads, render)
"""


@pytest.mark.parametrize("cell,size", [
    ("cornell-scan-render", {"width": 16, "spp": 4, "max_depth": 3, "check_pixels": 0}),
    ("cornell-grad-step", {"width": 12, "spp": 4, "max_depth": 3})])
def test_family_on_a_search_path_runs_a_cell(cell, size, tmp_path, monkeypatch):
    """A family whose two files lie only under a test's directory, named by
    the configuration alone, runs a whole cell through ``harness.run``."""
    (tmp_path / "families").mkdir()
    (tmp_path / "reference").mkdir()
    (tmp_path / "families" / "planar_twin.py").write_text(TWIN_PROGRAM)
    (tmp_path / "reference" / "planar_twin.py").write_text(TWIN_REFERENCE)
    conf = tmp_path / "cornell_twin.json"
    conf.write_text(json.dumps({**CORNELL, "family": "planar_twin"}))
    monkeypatch.setattr(families, "PATH", [tmp_path] + families.PATH)
    manifest = {**MANIFEST, "configs": [{**MANIFEST["configs"][0], "file": str(conf)}]}
    try:
        c = harness.load_cell(cell, manifest)
        out, lines = harness.run(c, SEED, 0.2, False, device="cpu",
                                 overrides={"traffic": size})
        for side in ("families", "reference"):
            mod = sys.modules[f"port_bench.{side}.planar_twin"]
            assert Path(mod.__file__).parent == tmp_path / side
    finally:
        for side in ("families", "reference"):
            sys.modules.pop(f"port_bench.{side}.planar_twin", None)
    assert out["correct"] is True, lines


REFUSED = {
    "misspelled family": ({"family": "planer"}, {}, "planer"),
    "unknown camera option": ({}, {"camera": {"qmcc": True}}, "qmcc"),
    "unknown entry option": ({}, {"entry_options": {"geometri": True}}, "geometri"),
    "camera option the reference lacks": ({}, {"camera": {"qmc": True}},
                                          "'qmc' is not implemented by reference/planar.py"),
    "entry option the reference lacks": ({}, {"entry_options": {"geometry": True}},
                                         "'geometry' is not implemented by reference/planar.py"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_load_cell_refuses(case, tmp_path, monkeypatch):
    config, options, said = REFUSED[case]
    (tmp_path / "traffic").mkdir()
    traffic = {"entry": "grad", "width": 12, "spp": 2, "max_depth": 2, "target_scale": 0.5,
               **options}
    (tmp_path / "traffic" / "mix.json").write_text(json.dumps(traffic))
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({**CORNELL, **config}))
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    manifest = {"configs": [{"name": "conf", "file": str(conf)}],
                "workloads": [{"name": "cell", "config": "conf", "traffic": "mix", "chips": 1}],
                "end_to_end": [], "per_layer": []}
    with pytest.raises((KeyError, ValueError), match=said):
        harness.load_cell("cell", manifest)


def test_options_reach_the_camera_and_the_entry(monkeypatch):
    """A family's build_camera sets the options it takes; the entry gets
    ``entry_options`` as keywords; with none, the calls are as before."""
    side = families.program("planar")
    desc = side.describe(CORNELL)
    plain = side.build_camera(desc, 8, 2, 2, "cpu")
    assert (plain.qmc, plain.rr_depth) == (False, 0)
    cam = side.build_camera(desc, 8, 2, 2, "cpu", qmc=True, rr_depth=2)
    assert (cam.qmc, cam.rr_depth) == (True, 2)
    with pytest.raises(TypeError, match="qmcc"):
        side.build_camera(desc, 8, 2, 2, "cpu", qmcc=True)
    assert program.entry_options("grad") == ("geometry",)
    assert program.entry_options("scan") == program.entry_options("wavefront") == ()
