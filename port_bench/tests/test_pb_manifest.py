"""BENCHMARK.json against the contract's names and units, and every
configuration, traffic mix, metric and limit found by its name."""

import json
import re

import pytest

from port_bench import families, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["port_bench"]
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        # every cell it lists reports the end-to-end metric it moves
        moved = next(e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    c = harness.load_cell(cell, MANIFEST)
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    assert c.kind in ("scan", "wavefront", "grad")
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    assert conf["file"].startswith("port_bench/configs/") and _line(conf["source"])
    assert conf["source"].startswith("https://")
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert "assumed" in data and data["precision"] == "float32"
    desc = families.program(families.name_of(data)).describe(data, {"target_tris": 2000})
    assert len(desc.lights) >= 1 and len(desc.materials) >= 2
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
