"""The port's command line (``cli.py``), tiled render and render stats.

``cli.validate_flags`` gives ``render.py``'s answer on every combination of
the flags it reads, and both parsers take the same flags; a config saved
with ``--save-config`` renders the same image through ``--config``;
``--list`` lists the catalog; a 16 px render runs on the CPU
(``main(argv, device="cpu")``). ``integrator.render_image_tiled`` is
bitwise the untiled render with a short tail tile; ``RenderStats`` sums
its phases; ``device_trace`` writes a trace only when given a directory.
A mesh, the CLI and ``multihost`` build on the card unless told
``device="cpu"``, and raise on a host without one.
"""

import argparse
import itertools
import json
import os

import numpy as np
import pytest
import torch

import render
from cpu_ray_tracing_implementation_tpu_torch import cli
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.parallel import multihost
from cpu_ray_tracing_implementation_tpu_torch.utils import exr, image_io, profiling

SMALL = ["--width", "16", "--spp", "2", "--max-depth", "2"]


def test_parsers_take_the_same_flags():
    dests = lambda p: sorted((a.dest, tuple(a.option_strings)) for a in p._actions)
    assert dests(cli.build_parser()) == dests(render.build_parser())
    assert cli.CONFIG_KEYS == render.CONFIG_KEYS


def test_validate_flags_matches_render_py():
    combos = itertools.product((None, "c.npz"), (None, 0.05),
                               ("auto", "on", "off", True, False), (None, 64),
                               (False, True))
    n_err = 0
    for ckpt_, adapt, wf, tile, sharded in combos:
        ns = argparse.Namespace(checkpoint=ckpt_, adaptive=adapt, wavefront=wf,
                                tile_pixels=tile, sharded=sharded)
        assert cli.validate_flags(ns) == render.validate_flags(ns), vars(ns)
        n_err += cli.validate_flags(ns) is not None
    assert 0 < n_err < 80


def test_list(capsys):
    assert cli.main(["--list"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == list(catalog.SCENES)


def test_config_round_trip_renders_the_same(tmp_path, capsys):
    cfg, a, b = (str(tmp_path / n) for n in ("c.json", "a.png", "b.png"))
    assert cli.main(["cornell_box", *SMALL, "--seed", "3", "--tonemap", "aces",
                     "--save-config", cfg, "-o", a], device="cpu") == 0
    saved = json.load(open(cfg))
    assert saved["width"] == 16 and saved["seed"] == 3 and saved["tonemap"] == "aces"
    # the config fills every flag not typed; a typed flag wins
    assert cli.main(["--config", cfg, "-o", b], device="cpu") == 0
    assert np.array_equal(image_io.load_image(a), image_io.load_image(b))
    assert cli.main(["--config", cfg, "--seed", "4", "-o", b], device="cpu") == 0
    assert not np.array_equal(image_io.load_image(a), image_io.load_image(b))
    assert "Done in" in capsys.readouterr().out


def test_cli_render_on_the_cpu(tmp_path):
    out = str(tmp_path / "c.exr")
    assert cli.main(["cornell_box", *SMALL, "--tile-pixels", "100", "-o", out],
                    device="cpu") == 0
    scene, cam = catalog.cornell_box(width=16, spp=2, max_depth=2, device="cpu")
    ref = integrator.render_image(scene, cam, keys.key(0)).numpy()
    np.testing.assert_array_equal(exr.read_exr(out)[..., :3], ref)   # linear radiance
    # --sharded in a job of one rank renders on one device, the same image
    sh = str(tmp_path / "s.exr")
    assert cli.main(["cornell_box", *SMALL, "--sharded", "-o", sh], device="cpu") == 0
    np.testing.assert_array_equal(exr.read_exr(sh), exr.read_exr(out))
    with pytest.raises(SystemExit):  # a combination that does not compose
        cli.main(["cornell_box", *SMALL, "--adaptive", "0.1", "--tile-pixels", "8"],
                 device="cpu")


def test_render_image_tiled_is_bitwise():
    scene, cam = catalog.cornell_box(width=15, spp=3, max_depth=3, device="cpu")
    ref = integrator.render_image(scene, cam, keys.key(1))
    # 225 pixels in tiles of 64: the last tile holds 33
    img = integrator.render_image_tiled(scene, cam, keys.key(1), tile_pixels=64)
    assert torch.equal(img, ref)
    assert torch.equal(integrator.render_image_tiled(scene, cam, keys.key(1)), ref)


def test_render_stats_sum_phases(tmp_path):
    stats = profiling.RenderStats(device="cpu")
    for _ in range(2):
        with stats.phase("render", rays=1000):
            torch.ones(64).sum()
    with stats.phase("denoise"):
        pass
    p = stats.phases["render"]
    assert p.rays == 2000 and p.seconds > 0
    assert p.mrays_per_s == pytest.approx(2000 / p.seconds / 1e6)
    assert stats.phases["denoise"].rays == 0 and stats.phases["denoise"].mrays_per_s >= 0
    assert "render" in stats.summary() and "M rays/s" in stats.summary()
    with profiling.device_trace(None):
        pass
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_no_card_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_mesh_2d()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["cornell_box", *SMALL, "-o", "unused.png"])
    assert pm.make_mesh(device="cpu").size == 1
