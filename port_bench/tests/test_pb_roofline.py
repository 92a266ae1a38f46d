"""The roofline copy's counts at recorded shapes."""

import pytest
import torch

from port_bench import roofline


def test_k1_bound_cornell_view():
    # 512*512 rays against one chunk of 128 lanes, 18 live quads: operations bound
    R, live, numel = 512 * 512, 18, 16 * 128
    ops = R * live * 36
    assert roofline.k1_bound(R, numel, live) == pytest.approx(ops / 33.5e12)
    assert roofline.k1_bound(R, numel, live) == pytest.approx(5.0712e-6, rel=1e-4)


def test_k3_bound_counts_live_rays_only():
    excl = torch.zeros((1000, 2))
    excl[:400, 0] = float("nan")                 # done rays, packed mode
    excl[400:500, 0] = float("inf")
    excl[400:500, 1] = float(1 << 24)           # done rays, exact mode
    b = roofline.k3_bound(excl, 8 * 2048, 16, 2015)
    assert b == pytest.approx(max(4 * (8 * 500 + 8 * 2048 + 2000 + 32000 + 1000) / 3.35e12,
                                  500 * 2015 * 30 / 33.5e12))


def test_k4_needs_on_one_triangle():
    # one chunk of 128 lanes, lane 0 the triangle z = 5 over x, y in [0, 1]
    table = torch.zeros((2, 9, 128))
    table[0, 0:3, 0] = torch.tensor([0.0, 0.0, 5.0])
    table[0, 3:6, 0] = torch.tensor([1.0, 0.0, 0.0])
    table[0, 6:9, 0] = torch.tensor([0.0, 1.0, 0.0])
    rays = torch.zeros((3, 8))
    rays[:, 0:3] = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.0], [0.2, 0.2, 10.0]])
    rays[:, 3:6] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    ids = torch.tensor([[0, 1], [1, 0], [0, 1]], dtype=torch.int32)
    nears = torch.tensor([[4.9, 6.0], [1.0, 4.9], [1e30, 1e30]])
    best_t = torch.tensor([5.0, 5.0, 1e30])
    # ray 0 visits chunk 0 (4.9 < 5); ray 1 visits chunks 1 and 0; ray 2 none
    visits, rows, more = roofline.k4_needs(rays, ids, nears, best_t, table, 1e-3)
    assert (visits, rows, more) == (3, 2, 2)
    b = roofline.k4_bound(rays, ids, nears, best_t, table, 1e-3)
    ops = visits * 128 * 16 + rows * 128 * 57 + more * 30
    nbytes = 4 * (8 * 3 + 2 * 3 * 2 + 8 * 3 + 8 * 3) + rows * 4 * 9 * 128
    assert b == pytest.approx(max(nbytes / 3.35e12, ops / 33.5e12))


def _recorded_inputs():
    """One K1 pack (two chunks, 18 and 5 live lanes), K3's exclusion keys
    and K4's one-triangle table above, as recorded calls take them."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi

    g = torch.Generator().manual_seed(7)
    pack = torch.rand((2, 16, 128), generator=g)
    pack[:, fi.ROW_ACTIVE] = 0.0
    pack[0, fi.ROW_ACTIVE, :18] = 1.0
    pack[1, fi.ROW_ACTIVE, :5] = 1.0
    excl = torch.zeros((1000, 2))
    excl[:400, 0] = float("nan")
    excl[400:500, 0] = float("inf")
    excl[400:500, 1] = float(1 << 24)
    table = torch.zeros((2, 9, 128))
    table[0, 0:3, 0] = torch.tensor([0.0, 0.0, 5.0])
    table[0, 3:6, 0] = torch.tensor([1.0, 0.0, 0.0])
    table[0, 6:9, 0] = torch.tensor([0.0, 1.0, 0.0])
    rays = torch.zeros((3, 8))
    rays[:, 0:3] = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.0], [0.2, 0.2, 10.0]])
    rays[:, 3:6] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    ids = torch.tensor([[0, 1], [1, 0], [0, 1]], dtype=torch.int32)
    nears = torch.tensor([[4.9, 6.0], [1.0, 4.9], [1e30, 1e30]])
    best = torch.zeros((3, 8))
    best[:, 0] = torch.tensor([5.0, 5.0, 1e30])
    return pack, excl, table, rays, ids, nears, best


def _fakes(monkeypatch):
    """The three wrapped kernel functions replaced by fakes that return
    K4's best, so that ``kernel_calls`` can wrap them on the CPU."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw

    pack, excl, table, rays, ids, nears, best = _recorded_inputs()

    def k1(rays, pack, tmin, tmax=1e30, triangle=False, with_pid=False):
        return None

    def k3(rays, boxes, excl, V, K_real, tmin, packed=True):
        return None

    def k4(rays, ids, nears, best_in, table, tmin, triangle, sphere):
        return best

    monkeypatch.setattr(fi, "planar_closest_kernel", k1)
    monkeypatch.setattr(fs, "cull_select_kernel", k3)
    monkeypatch.setattr(fsw, "sweep_kernel", k4)
    return fi, fs, fsw, (k1, k3, k4)


def _calls(fi, fs, fsw):
    """The recorded list's calls, through the module attributes: K1 twice,
    K3, then K4 (a planar and a sphere call, the sphere call not counted)."""
    pack, excl, table, rays, ids, nears, best = _recorded_inputs()
    fi.planar_closest_kernel(torch.zeros((8, 512 * 512)), pack, 1e-3)
    fi.planar_closest_kernel(torch.zeros((8, 1000)), pack, 1e-3, triangle=True)
    fs.cull_select_kernel(torch.zeros((1000, 8)), torch.zeros((8, 2048)), excl, 16, 2015, 1e-3)
    fsw.sweep_kernel(rays, ids, nears, best, table, 1e-3, True, False)
    fsw.sweep_kernel(rays, ids, nears, best, table, 1e-3, False, True)


def test_registry_gives_the_parent_isect_bound(monkeypatch):
    """``rooflines/k1.py``, ``k3.py`` and ``k4.py`` on one recorded call
    list sum to the bound that the code they replaced gave on it
    (``fixtures/parent_cornell.json``), bit for bit, and the wrapped
    functions are restored after the slice."""
    import json
    from pathlib import Path

    from port_bench import harness, tracing

    parent = json.loads((Path(__file__).parent / "fixtures" / "parent_cornell.json")
                        .read_text())["isect_bound_s"]
    calls = []
    fi, fs, fsw, fakes = _fakes(monkeypatch)
    with tracing.kernel_calls(calls):
        _calls(fi, fs, fsw)
    assert [rid for rid, _ in calls] == ["k1", "k1", "k3", "k4"]
    table = tracing.roofline_table(calls, {"planar_closest_kernel": 2e-5,
                                           "visit_sweep_tile": 1e-5, "visit_sweep_fold": 1e-6})
    assert table["k1"]["bound_s"] + table["k3"]["bound_s"] + table["k4"]["bound_s"] == parent
    assert [table[i]["calls"] for i in ("k1", "k3", "k4")] == [2, 1, 1]
    assert table["k1"]["device_s"] == 2e-5 and table["k4"]["device_s"] == 1e-5 + 1e-6
    run = harness.Run(1, 0.0, 1.0, [1.0], 0, rooflines=table)
    assert run.roofline_share(("k1", "k3", "k4")) == 100.0 * parent / (2e-5 + 1e-5 + 1e-6)
    assert run.roofline_share(("k6",)) is None


def test_kernel_calls_restores_the_wrapped_functions(monkeypatch):
    from port_bench import tracing

    calls = []
    fi, fs, fsw, fakes = _fakes(monkeypatch)
    with tracing.kernel_calls(calls):
        assert fi.planar_closest_kernel is not fakes[0]
    assert (fi.planar_closest_kernel, fs.cull_select_kernel, fsw.sweep_kernel) == fakes
    _calls(fi, fs, fsw)
    assert calls == []


def test_roofline_files_name_the_ports_functions():
    import importlib

    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from port_bench import tracing
    from port_bench.rooflines import k1

    files = tracing.roofline_files()
    assert set(files) >= {"k1", "k3", "k4"}
    for mod in files.values():
        assert callable(getattr(importlib.import_module(mod.MODULE), mod.ATTR))
        assert mod.KERNELS and callable(mod.record) and callable(mod.bound_s)
    assert k1.ROW_ACTIVE == fi.ROW_ACTIVE
