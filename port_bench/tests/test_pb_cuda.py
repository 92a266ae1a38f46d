"""On the card: each cell's whole run at a reduced size (the kernels K1,
K3 and K4 on its route, the traced extras, the check), and the bfloat16
control failing the check. Run on a machine with an NVIDIA GPU:

    python3 -m pytest -q -m cuda port_bench/tests/test_pb_cuda.py
"""

import json

import pytest
import torch

from port_bench import check, harness
from port_bench.reference import rng

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 3_000_000_019
REDUCED = {"render": {"width": 48, "spp": 4}, "grad": {"width": 48, "spp": 2}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def _reduced(cell):
    c = harness.load_cell(cell, MANIFEST)
    return c, {"traffic": REDUCED["grad" if c.kind == "grad" else "render"]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    dev = _card()
    c, ov = _reduced(cell)
    out, lines = harness.run(c, SEED, 1.0, True, device=dev, overrides=ov)
    assert out["correct"] is True, lines
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    roof = [v["value"] for k, v in out["metrics"].items() if "_roofline" in k]
    assert roof and all(0 < r <= 105 for r in roof)
    assert len(out["breakdown"]["device_ops"]) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    dev = _card()
    c, ov = _reduced(cell)
    tr = {**c.traffic, **ov["traffic"]}
    family, desc, _, leaves, cam = harness.build(c.config, tr, dev)
    H = cam.height
    target = harness.make_target(SEED, H, tr["width"], tr, dev) if c.kind == "grad" else None
    pixels = check.check_pixels(tr["width"] * H, tr.get("check_pixels", 0), SEED)
    nums = check.control_numbers(c.kind, family, desc, tr,
                                 rng.fold_in(harness.base_key(SEED), 0), pixels, target, leaves,
                                 device=dev)
    assert any(v > c.limits[k] for k, v in nums.items())
