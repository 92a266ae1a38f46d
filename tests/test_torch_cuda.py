"""The CUDA kernels K1-K9 on the card, against their plain versions, and
the gradient path through them.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are chip_smoke.py's. K1, K2: equal hit masks and materials, t
within rtol 1e-4 / atol 1e-4, every other payload field (normal, u, v;
center, rad) within atol 1e-3. K3: ids, nears and rest bit-equal. K4,
K7, K8: all 8 columns bit for bit (the kernels round as their plain
versions do). K1 / K2 pid output: equal to the plain versions' pid.
K5: max |a - b| / (|b| + 1) <= 1e-5. K6 (the tile-packet closest hit):
K2's rounding on spheres, so masks, pids, materials and each tile's visit
count equal the plain version's and t is within rtol 1e-4; planar, K1's
tolerances on rays whose pid agrees, pids equal but for near-ties.
K9 (one bounce's scatter): continues equal;
new_dir and weight within atol 1e-5 / rtol 1e-4 but on at most 1 lane in
10,000, each where light_pdf's edge test rounds apart
(``kernel_ab.scatter_check``). Gradients (the JAX package's
replay-against-remat tolerances): loss rtol 1e-4, scene rtol 2e-3 / atol
1e-5, camera rtol 5e-3 / atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_sweep_cases as cases

from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter as fsc
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, packet, perray
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe, kernel_ab

pytestmark = pytest.mark.cuda

TMIN = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _t(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def _planar_chunks(rng, dev, K=6, C=128, n=700, holes=False):
    """The first n of K*C random primitives active or, with ``holes``, a
    random half of each chunk with lane 0 dead and lane C-1 live."""
    corner = rng.uniform(-10, 10, (K * C, 3)).astype(np.float32)
    eu = rng.normal(size=(K * C, 3)).astype(np.float32)
    ev = rng.normal(size=(K * C, 3)).astype(np.float32)
    act = np.arange(K * C) < n
    if holes:
        act = rng.uniform(size=(K, C)) < 0.5
        act[:, 0], act[:, -1] = False, True
        act = act.reshape(-1)
    pts = np.stack([corner, corner + eu, corner + ev, corner + eu + ev])
    lo = np.where(act[:, None], pts.min(0), np.inf).reshape(K, C, 3).min(1)
    hi = np.where(act[:, None], pts.max(0), -np.inf).reshape(K, C, 3).max(1)
    return ch.PlanarChunks(
        corner=_t(corner.reshape(K, C, 3), dev), eu=_t(eu.reshape(K, C, 3), dev),
        ev=_t(ev.reshape(K, C, 3), dev),
        mat=_t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C), dev),
        active=_t(act.reshape(K, C), dev), lo=_t(lo.astype(np.float32), dev),
        hi=_t(hi.astype(np.float32), dev))


def _sphere_chunks(rng, dev, K=6, C=128, n=700, holes=False):
    """The first n of K*C random moving spheres active or, with ``holes``,
    a random half of each chunk with lane 0 dead and lane C-1 live."""
    c0 = rng.uniform(-10, 10, (K * C, 3)).astype(np.float32)
    c1 = (c0 + 0.3 * rng.normal(size=(K * C, 3))).astype(np.float32)
    rad = rng.uniform(0.05, 0.85, K * C).astype(np.float32)
    act = np.arange(K * C) < n
    if holes:
        act = rng.uniform(size=(K, C)) < 0.5
        act[:, 0], act[:, -1] = False, True
        act = act.reshape(-1)
    lo = np.where(act[:, None], np.minimum(c0, c1) - rad[:, None], np.inf)
    hi = np.where(act[:, None], np.maximum(c0, c1) + rad[:, None], -np.inf)
    return ch.SphereChunks(
        c0=_t(c0.reshape(K, C, 3), dev), c1=_t(c1.reshape(K, C, 3), dev),
        rad=_t(rad.reshape(K, C), dev),
        mat=_t((np.arange(K * C) % 3).astype(np.int32).reshape(K, C), dev),
        active=_t(act.reshape(K, C), dev),
        lo=_t(lo.reshape(K, C, 3).min(1).astype(np.float32), dev),
        hi=_t(hi.reshape(K, C, 3).max(1).astype(np.float32), dev))


def _rays(rng, dev, n):
    org = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    return _t(org, dev), _t(dirs, dev), _t(time, dev)


def _check(got, ref, payload_atol):
    t, payload = got
    t_r, payload_r = ref
    valid = torch.isfinite(t_r)
    assert int(valid.sum()) > 100
    assert torch.equal(torch.isfinite(t), valid)
    assert torch.equal(payload[-1][valid], payload_r[-1][valid])      # mat
    torch.testing.assert_close(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    for x, x_r in zip(payload[:-1], payload_r[:-1]):
        torch.testing.assert_close(x[valid], x_r[valid], rtol=0, atol=payload_atol)


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
@pytest.mark.parametrize("triangle", [False, True], ids=["quad", "tri"])
def test_planar_kernel_matches_plain(dev, triangle, holes):
    rng = np.random.default_rng(6)
    chunks = _planar_chunks(rng, dev, holes=holes)
    org, dirs, _ = _rays(rng, dev, 20000)
    fi.reset_launches()
    got = fi.planar_closest_fused(org, dirs, chunks, TMIN, triangle)
    assert fi.LAUNCHES == {"planar_closest": 1, "sphere_closest": 0}
    ref = ch.planar_closest(org, dirs, chunks, TMIN, triangle)
    torch.cuda.synchronize()
    # the plain version also returns the primitive id, which the kernel lacks
    _check(got, (ref[0], ref[1][:4]), 1e-3)


def test_sphere_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    chunks = _sphere_chunks(rng, dev)
    org, dirs, time = _rays(rng, dev, 20000)
    fi.reset_launches()
    got = fi.sphere_closest_fused(org, dirs, time, chunks, TMIN)
    assert fi.LAUNCHES == {"planar_closest": 0, "sphere_closest": 1}
    ref = ch.sphere_closest(org, dirs, time, chunks, TMIN)
    torch.cuda.synchronize()
    _check(got, (ref[0], ref[1][:3]), 1e-3)


def _motion_ball_rays(dev, n, seed):
    """random_motion_ball's 1-chunk sphere view (337 live lanes of 384) and
    n rays: half from its camera, half leaving the spheres' neighbourhood
    in random directions, with motion-blur times."""
    scene, cam = catalog.random_motion_ball(width=64, spp=1, device=dev)
    rng = np.random.default_rng(seed)
    org = rng.uniform((-12, 0, -12), (12, 2, 12), (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    half = n // 2
    org[:half] = cam.pos.cpu().numpy()
    dirs[:half] = (cam.lookat.cpu().numpy() - org[:half]
                   + rng.normal(size=(half, 3)) * 3.0)
    time = rng.uniform(0, 1, n).astype(np.float32)
    view, pack = scene.sphere_view
    return view, pack, _t(org, dev), _t(dirs, dev), _t(time, dev)


@pytest.mark.parametrize("table", ["motion_ball", "holes"])
def test_sphere_kernel_matches_plain_on_the_redesigned_paths(dev, table):
    """K2 on random_motion_ball's view (three 128-lane slices, the last
    one 81 live) and on a holed table (lane 0 of each chunk dead, lane 127
    live), without and with its pid output."""
    if table == "motion_ball":
        view, pack, org, dirs, time = _motion_ball_rays(dev, 20000, 8)
        assert view.rad.shape == (1, 384) and int(view.active.sum()) == 337
    else:
        rng = np.random.default_rng(9)
        view = _sphere_chunks(rng, dev, holes=True)
        pack = None
        org, dirs, time = _rays(rng, dev, 20000)
    fi.reset_launches()
    got = fi.sphere_closest_fused(org, dirs, time, view, TMIN, pack=pack)
    t, pid = fi.sphere_winner(org, dirs, time, view, TMIN, pack=pack)
    assert fi.LAUNCHES == {"planar_closest": 0, "sphere_closest": 2}
    ref = ch.sphere_closest(org, dirs, time, view, TMIN)
    torch.cuda.synchronize()
    _check(got, (ref[0], ref[1][:3]), 1e-3)
    assert torch.equal(t, got[0])
    assert torch.equal(pid, ref[1][3])


@pytest.mark.parametrize("n_rays", [1, 77, 128, 129, 255, 257, 511, 513])
def test_sphere_kernel_ragged_ray_counts(dev, n_rays):
    """R not a multiple of K2's block of 512 rays (128 threads, four rays
    each): every ray's t, payload and pid equal the plain version's."""
    view, pack, org, dirs, time = _motion_ball_rays(dev, n_rays, n_rays)
    t, (ctr, rad, mat) = fi.sphere_closest_fused(org, dirs, time, view, TMIN,
                                                 pack=pack)
    _, pid = fi.sphere_winner(org, dirs, time, view, TMIN, pack=pack)
    t_r, (ctr_r, rad_r, mat_r, pid_r) = ch.sphere_closest(org, dirs, time, view, TMIN)
    assert t.shape == (n_rays,)
    assert torch.equal(torch.isfinite(t), torch.isfinite(t_r))
    hit = torch.isfinite(t_r)
    torch.testing.assert_close(t[hit], t_r[hit], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ctr[hit], ctr_r[hit], rtol=0, atol=1e-3)
    torch.testing.assert_close(rad[hit], rad_r[hit], rtol=0, atol=1e-3)
    assert torch.equal(mat[hit], mat_r[hit]) and torch.equal(pid, pid_r)


@pytest.mark.parametrize("n_rays", [1, 77, 128, 129])
def test_ragged_ray_counts(dev, n_rays):
    """R not a multiple of the kernel's block of 128 rays."""
    rng = np.random.default_rng(n_rays)
    chunks = _planar_chunks(rng, dev, K=2, n=200)
    org, dirs, _ = _rays(rng, dev, n_rays)
    got = fi.planar_closest_fused(org, dirs, chunks, TMIN, False)
    ref = ch.planar_closest(org, dirs, chunks, TMIN, False)
    assert got[0].shape == (n_rays,)
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pack = torch.zeros((1, 16, 128), device=dev)
    rays = torch.zeros((8, 256), device=dev)
    with pytest.raises(TypeError, match="float32"):
        fi.planar_closest_kernel(rays.double(), pack, TMIN)
    with pytest.raises(ValueError, match="contiguous"):
        fi.planar_closest_kernel(torch.zeros((256, 8), device=dev).T, pack, TMIN)
    with pytest.raises(ValueError, match="rows"):
        fi.sphere_closest_kernel(rays[:7], pack, TMIN)


@pytest.mark.parametrize("name,golden", [("cornell_box", 0.160999),
                                         ("three_material_ball", 0.563181),
                                         ("random_motion_ball", 0.426140),
                                         ("sponza", 0.402695)])
def test_golden_render_on_card(dev, name, golden):
    """The main path on the card launches its kernels and gives the golden
    workload's mean (tests/test_golden.py, atol 2e-3)."""
    scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=dev)
    fi.reset_launches()
    fs.reset_launches()
    fsw.reset_launches()
    packet.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - golden) <= 2e-3
    kernel = ("sphere_closest" if name in ("three_material_ball", "random_motion_ball")
              else "planar_closest")
    assert fi.LAUNCHES[kernel] == cam.spp * cam.max_depth
    if name == "sponza":   # the light quad on K1, the 71 triangle chunks on K6
        assert packet.LAUNCHES["packet_planar"] == cam.spp * cam.max_depth
        assert fs.LAUNCHES["cull_select"] == 0 and fsw.LAUNCHES["visit_sweep"] == 0


def _boxes_and_rays(rng, dev, K=300, R=5000):
    c = rng.normal(0, 6.0, (K, 3))
    half = rng.uniform(0.1, 1.5, (K, 3))
    boxes = fs.pack_boxes(_t((c - half).astype(np.float32), dev),
                          _t((c + half).astype(np.float32), dev))
    org, dirs, _ = _rays(rng, dev, R)
    cap = _t(rng.uniform(1.0, 40.0, R).astype(np.float32), dev)
    cap[:100] = TMIN                      # dead lanes
    return boxes, fs.pack_rays(org, dirs, cap)


@pytest.mark.parametrize("V", [1, 3, 16, 17, 24, 32])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("marked", [False, True], ids=["unmarked", "done"])
def test_cull_select_kernel_bit_equal(dev, packed, V, marked):
    """Phase 1 and two phases after it; with ``marked``, a random third of
    the rays get the exhausted key, and so do rays 64-95: two whole 16-ray
    blocks (RAYS_PER_BLOCK in csrc/cull_select.cu), which return before
    staging a box."""
    rng = np.random.default_rng(V)
    boxes, rays = _boxes_and_rays(rng, dev)
    R = rays.shape[0]
    excl = fs.first_excl(R, dev)
    for _ in range(3):
        fs.reset_launches()
        got = fs.cull_select(rays, boxes, excl, V, 300, TMIN, packed)
        assert fs.LAUNCHES == {"cull_select": 1}
        ref = fs.cull_select_plain(rays, boxes, excl, V, 300, TMIN, packed)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0])
        for x, y in zip(got[1:], ref[1:]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        done = None
        if marked:
            done = _t(rng.uniform(size=R) < 1 / 3, dev)
            done[64:96] = True
        excl = fs.next_excl(got[0], got[1], done, TMIN, packed)


def test_cull_select_refuses_other_v(dev):
    """The kernel takes V up to 32 (``cull_select`` chains larger ones)."""
    boxes, rays = _boxes_and_rays(np.random.default_rng(0), dev, R=64)
    with pytest.raises(ValueError, match="V in 1..32"):
        fs.cull_select_kernel(rays, boxes, fs.first_excl(64, dev), 33, 300, TMIN)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_cull_select_chained_v64_bit_equal(dev, packed):
    """V = 64 (the sub-tile route's at CRT_SUBC=2): two K3 selections of 32,
    the second from the first's last key with its exhausted rays marked,
    equal one plain selection at V 64 bit for bit, over three phases."""
    rng = np.random.default_rng(64)
    c = rng.normal(0, 4.0, (300, 3))
    half = rng.uniform(1.0, 4.0, (300, 3))
    boxes = fs.pack_boxes(_t((c - half).astype(np.float32), dev),
                          _t((c + half).astype(np.float32), dev))
    org, dirs, _ = _rays(rng, dev, 5000)
    cap = _t(rng.uniform(1.0, 40.0, 5000).astype(np.float32), dev)
    cap[:100] = TMIN
    rays = fs.pack_rays(org, dirs, cap)
    excl = fs.first_excl(5000, dev)
    for _ in range(3):
        fs.reset_launches()
        got = fs.cull_select(rays, boxes, excl, 64, 300, TMIN, packed)
        assert fs.LAUNCHES == {"cull_select": 2}
        ref = fs.cull_select_plain(rays, boxes, excl, 64, 300, TMIN, packed)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0])
        for x, y in zip(got[1:], ref[1:]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        excl = fs.next_excl(got[0], got[1])
    first = fs.cull_select_plain(rays, boxes, fs.first_excl(5000, dev), 64, 300, TMIN,
                                 packed)
    assert int((torch.isfinite(first[1]).sum(1) > 32).sum()) > 100


def _random_scene(kind, dev, n=2000):
    rng = np.random.default_rng({"quad": 1, "tri": 2, "sphere": 3}[kind])
    b = SceneBuilder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.7, 0.7, 0.7))]
    for i, c in enumerate(rng.uniform(-10, 10, (n, 3))):
        if kind == "sphere":
            b.moving_sphere(c, c + rng.normal(0, 0.1, 3), rng.uniform(0.1, 0.6),
                            mats[i % 2])
        elif kind == "tri":
            v = c + rng.normal(0, 0.6, (3, 3))
            b.triangle(v[0], v[1], v[2], mats[i % 2])
        else:
            b.quad(c, rng.normal(0, 0.6, 3), rng.normal(0, 0.6, 3), mats[i % 2])
    return b.build(dev)


@pytest.mark.parametrize("kind", ["quad", "tri", "sphere"])
def test_sweep_kernel_matches_plain(dev, kind):
    scene = _random_scene(kind, dev)
    sphere = kind == "sphere"
    chunks = scene.sphere_chunks if sphere else (
        scene.tri_chunks if kind == "tri" else scene.quad_chunks)
    tabs = scene.sphere_perray if sphere else (
        scene.tri_perray if kind == "tri" else scene.quad_perray)
    K = tabs.table.shape[0]
    org, dirs, time = _rays(np.random.default_rng(9), dev, 8000)
    cap = torch.full((8000,), 60.0, device=dev)
    ids, nears, _ = fs.cull_select(fs.pack_rays(org, dirs, cap), tabs.boxes,
                                   fs.first_excl(8000, dev), 16, K, TMIN)
    rays = fsw.pack_rays(org, dirs, time if sphere else None)
    z = torch.zeros_like(cap)
    best = (fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
            if sphere else
            fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int()))
    fsw.reset_launches()
    got = fsw.sweep(rays, ids, nears, best, tabs.table, TMIN, kind == "tri", sphere)
    assert fsw.LAUNCHES == {"visit_sweep": 1, "visit_sweep_sub": 0, "visit_sweep_q16": 0}
    ref = fsw.sweep_plain(rays, ids, nears, best, tabs.table, TMIN, kind == "tri",
                          sphere)
    torch.cuda.synchronize()
    hit = ref[:, 0] < cap
    assert int(hit.sum()) > 100 and int(chunks.active.sum()) == 2000
    assert torch.equal(got[:, 0] < cap, hit)
    assert torch.equal(got[:, 6:8], ref[:, 6:8])
    torch.testing.assert_close(got[hit, 0], ref[hit, 0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[hit, 1:6], ref[hit, 1:6], rtol=0, atol=1e-3)
    assert torch.equal(cases.bits(got), cases.bits(ref))


@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("kind", cases.KINDS)
def test_sweep_kernel_adversarial_lists(dev, kind, case):
    """K4 against ``sweep_plain``, all 8 columns bit for bit, on the lists
    of tests/torch_sweep_cases.py: ties within a row and across slots,
    nears between the running and the input best, every slot exhausted
    (the kernel launches and returns best unchanged), duplicate and
    out-of-range ids, R = 1, K = 1."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, case, dev)
    fsw.reset_launches()
    got = fsw.sweep(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    assert fsw.LAUNCHES == {"visit_sweep": 1, "visit_sweep_sub": 0, "visit_sweep_q16": 0}
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    cases.check_case(case, got, ref, best, nears)


@pytest.mark.parametrize("R", [0, 1, 127, 129, 255, 257, 1000])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_sweep_kernel_ragged_ray_counts(dev, kind, R):
    """R = 0 and R off every block size (256 rays, 128-visit tiles)."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, "clip", dev,
                                                              R=max(R, 1), V=16)
    rays, ids, nears, best = rays[:R], ids[:R], nears[:R], best[:R]
    got = fsw.sweep_kernel(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert got.shape == (R, 8)
    assert torch.equal(cases.bits(got), cases.bits(ref))


def test_sweep_kernel_empty_lists(dev):
    """V = 0 slots: no visit, best unchanged."""
    rays, ids, nears, best, table, tri, sph = cases.make_case("tri", "ties", dev)
    got = fsw.sweep_kernel(rays, ids[:, :0].contiguous(), nears[:, :0].contiguous(),
                           best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert torch.equal(cases.bits(got), cases.bits(best))


@pytest.mark.parametrize("kind", cases.KINDS)
def test_sweep_kernel_many_chunks(dev, kind):
    """K = 9,000 chunks, above the 8,192 a block counts in shared memory:
    the counts go to global memory directly."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, "clip", dev,
                                                              R=2000, V=16, K=9000)
    got = fsw.sweep_kernel(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert torch.equal(cases.bits(got), cases.bits(ref))
    assert bool((ref[:, 0] < best[:, 0]).any())


@pytest.mark.parametrize("kind", cases.KINDS)
def test_sweep_kernel_one_visit_in_10000_rays(dev, kind):
    """Every slot of 10,000 rays exhausted but one: one tile, one winner."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, "ties", dev,
                                                              R=10_000, V=16)
    nears = torch.full_like(nears, float("nan"))
    nears[7_777, 3] = 0.0
    got = fsw.sweep_kernel(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert torch.equal(cases.bits(got), cases.bits(ref))
    changed = (cases.bits(got) != cases.bits(best)).any(1)
    assert torch.nonzero(changed)[:, 0].tolist() in ([], [7_777])


def _mode_lists(kind, dev, CS=None, K3_V=24):
    """The random scene's rays, K3's phase-1 lists at ``K3_V`` slots over
    the chunk boxes or, with ``CS``, the sub-tile boxes, and the tables."""
    scene = _random_scene(kind, dev)
    sphere = kind == "sphere"
    tabs = scene.sphere_perray if sphere else (
        scene.tri_perray if kind == "tri" else scene.quad_perray)
    sel = tabs if CS is None else tabs.subtile(CS)
    org, dirs, time = _rays(np.random.default_rng(11), dev, 8000)
    cap = torch.full((8000,), 60.0, device=dev)
    cap[:500] = TMIN
    ids, nears, _ = fs.cull_select(fs.pack_rays(org, dirs, cap), sel.boxes,
                                   fs.first_excl(8000, dev), K3_V, sel.table.shape[0], TMIN)
    rays = fsw.pack_rays(org, dirs, time if sphere else None)
    z = torch.zeros_like(cap)
    best = (fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
            if sphere else
            fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int()))
    return rays, ids, nears, best, tabs, sel, cap


@pytest.mark.parametrize("CS", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["quad", "tri", "sphere"])
def test_subtile_sweep_kernel_k7_matches_plain(dev, kind, CS):
    """K7 over sub-tile rows of every width dividing 128 (one kernel
    instance a row kind, the width passed at run time) against
    ``sweep_plain`` at that width, all 8 columns bit for bit; a width that
    does not divide 128 raises."""
    rays, ids, nears, best, _, sub, cap = _mode_lists(kind, dev, CS)
    fsw.reset_launches()
    got = fsw.sweep_sub(rays, ids, nears, best, sub.table, TMIN, kind == "tri",
                        kind == "sphere")
    assert fsw.LAUNCHES == {"visit_sweep": 0, "visit_sweep_sub": 1, "visit_sweep_q16": 0}
    ref = fsw.sweep_plain(rays, ids, nears, best, sub.table, TMIN, kind == "tri",
                          kind == "sphere")
    torch.cuda.synchronize()
    assert int((ref[:, 0] < cap).sum()) > 100
    assert torch.equal(cases.bits(got), cases.bits(ref))
    if CS == 64:
        wide = sub.table[:, :, :48].contiguous()
        with pytest.raises(ValueError, match="K7 takes"):
            fsw.sweep_sub(rays, ids, nears, best, wide, TMIN, kind == "tri",
                          kind == "sphere")


def _subtile_case(kind, case, dev, CS, **kw):
    """An adversarial case of tests/torch_sweep_cases.py as sub-tile lists
    at width CS: slot s names sub-tile s mod G of its chunk (out-of-range
    chunk ids stay out of range, for the clip)."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, case, dev, **kw)
    G = 128 // CS
    sub_ids = ids * G + torch.arange(ids.shape[1], device=dev, dtype=torch.int32) % G
    return rays, sub_ids.contiguous(), nears, best, perray.subtile_rows(table, CS), tri, sph


@pytest.mark.parametrize("CS", [4, 32])
@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("kind", cases.KINDS)
def test_subtile_sweep_kernel_k7_adversarial_lists(dev, kind, case, CS):
    """K7 against ``sweep_plain`` at width CS, all 8 columns bit for bit,
    on the adversarial lists as sub-tile lists: ties within a sub-tile,
    across sub-tiles and slots, nears between the running and the input
    best, every slot exhausted, duplicate and clipped ids, R = 1, K = 1."""
    rays, ids, nears, best, table, tri, sph = _subtile_case(kind, case, dev, CS)
    fsw.reset_launches()
    got = fsw.sweep_sub(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    assert fsw.LAUNCHES == {"visit_sweep": 0, "visit_sweep_sub": 1, "visit_sweep_q16": 0}
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert torch.equal(cases.bits(got), cases.bits(ref))
    hits = int((ref[:, 0] < best[:, 0]).sum())
    if case == "exhausted":
        assert hits == 0
    elif case != "one_ray":                 # one ray's 8 sub-tiles may all miss
        assert hits > 0


@pytest.mark.parametrize("R", [0, 1, 129, 257])
def test_subtile_sweep_kernel_k7_ragged_and_empty(dev, R):
    """R = 0 and R off the block sizes at CS 8, and V = 0 slots (no visit:
    best unchanged)."""
    rays, ids, nears, best, table, tri, sph = _subtile_case("sphere", "clip", dev, 8,
                                                            R=max(R, 1), V=16)
    rays, ids, nears, best = rays[:R], ids[:R], nears[:R], best[:R]
    got = fsw.sweep_sub_kernel(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    empty = fsw.sweep_sub_kernel(rays, ids[:, :0].contiguous(), nears[:, :0].contiguous(),
                                 best, table, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert got.shape == (R, 8)
    assert torch.equal(cases.bits(got), cases.bits(ref))
    assert torch.equal(cases.bits(empty), cases.bits(best))


@pytest.mark.parametrize("CS", [16, 4])
def test_subtile_sweep_kernel_k7_many_subtiles(dev, CS):
    """K7 over ~9,000 sub-tiles (9,000 at width 16, 9,024 at width 4: whole
    chunks), ids from -4 past the last (clipped), on the adversarial
    table's ties: its count keys the chunks (1,125 and 282), in shared
    memory as the colonnade's 2,015 are at every width."""
    K = -(-9000 * CS // 128)
    rays, ids, nears, best, table, tri, sph = cases.make_case("tri", "clip", dev, R=2000,
                                                              V=24, K=K)
    sub = perray.subtile_rows(table, CS)
    KG = sub.shape[0]
    ids = torch.randint(-4, KG + 4, ids.shape, device=dev, dtype=torch.int32)
    got = fsw.sweep_sub_kernel(rays, ids, nears, best, sub, cases.TMIN, tri, sph)
    ref = fsw.sweep_plain(rays, ids, nears, best, sub, cases.TMIN, tri, sph)
    torch.cuda.synchronize()
    assert KG >= 9000 and torch.equal(cases.bits(got), cases.bits(ref))
    assert bool((ref[:, 0] < best[:, 0]).any())


def _q16_grazing_lists(kind, dev):
    """The grazing set (tests/torch_sweep_cases.py) as K8 lists over 8
    chunks of which the rays name only the first 6 (chunks 6 and 7 get no
    visit), shuffled, 5 rays dropped (chunks 0 and 1 end on a partial tile
    of 32 visits): slot 0 the aimed-at chunk, slot 1 the next, slot 2 the aimed-at
    one again, slot 3 id -1 (clipped to 0); every near 0; the input best t
    inf for half the rays and 2 (the aimed-at vertex lies at t = 1) for the
    others."""
    q, rays, chunk = cases.q16_grazing(kind, dev, K=8)
    keep = torch.nonzero(chunk < 6)[5:, 0]
    keep = keep[torch.randperm(keep.numel(), generator=torch.Generator().manual_seed(3))
                .to(dev)]
    rays, chunk = rays[keep].contiguous(), chunk[keep]
    R = rays.shape[0]
    ids = torch.stack([chunk, (chunk + 1) % 6, chunk, torch.full_like(chunk, -1)], 1)
    nears = torch.zeros((R, 4), device=dev)
    t_in = torch.where(torch.arange(R, device=dev) % 2 == 0, float("inf"), 2.0)
    z = torch.zeros_like(t_in)
    best = fsw.pack_best_planar(t_in, torch.zeros((R, 3), device=dev), z, z, z.int(),
                                z.int())
    return rays, ids.to(torch.int32).contiguous(), nears, best, q


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_q16_sweep_kernel_k8_matches_plain(dev, kind):
    """K8 over the quantized rows against ``sweep_q16_plain``, all 8
    columns bit for bit: on the random scene's K3 lists, and on the grazing
    set (rays aimed at every vertex, along the axes and grazing, at +-1,200
    units; partial tiles; chunks with no visit), where its group boxes are
    tightest."""
    rays, ids, nears, best, tabs, _, cap = _mode_lists(kind, dev, K3_V=16)
    q = tabs.q16()
    fsw.reset_launches()
    got = fsw.sweep_q16(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                        kind == "tri")
    assert fsw.LAUNCHES == {"visit_sweep": 0, "visit_sweep_sub": 0, "visit_sweep_q16": 1}
    ref = fsw.sweep_q16_plain(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                              kind == "tri")
    torch.cuda.synchronize()
    assert int((ref[:, 0] < cap).sum()) > 100
    assert torch.equal(cases.bits(got), cases.bits(ref))
    rays, ids, nears, best, q = _q16_grazing_lists(kind, dev)
    got = fsw.sweep_q16_kernel(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                               kind == "tri")
    ref = fsw.sweep_q16_plain(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                              kind == "tri")
    torch.cuda.synchronize()
    assert int((ref[:, 0] < best[:, 0]).sum()) > rays.shape[0] // 2
    # some rays hit a quantum-wide primitive beyond its box (its |n|^2 below
    # the plane test's clamp), which only an unskipped group finds
    won = ref[:, 0] < best[:, 0]
    assert bool(cases.q16_thin(q).reshape(-1)[ref[won, 7].long()].any())
    assert torch.equal(cases.bits(got), cases.bits(ref))


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_q16_group_boxes_match_kernel_row_stage(dev, kind):
    """K8's row stage builds the group boxes that ``q16_group_boxes``
    builds, which the CPU test of the cull holds every candidate in: the
    boxes, pads and flags it leaves in the scratch (a call through the C
    entry that stops after the tile stage), bit for bit for every chunk
    with visits, on the grazing set and the random scene's lists."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tri = kind == "tri"
    rays, ids, nears, best, tabs, _, _ = _mode_lists(kind, dev, K3_V=16)
    for rays, ids, nears, best, q in (_q16_grazing_lists(kind, dev),
                                      (rays, ids, nears, best, tabs.q16())):
        K, R, V = q.words.shape[0], *ids.shape
        base = fsw.scratch_ints(R, V, K)
        scratch = torch.zeros(base + fsw.q16_scratch_ints(R, V, K), dtype=torch.int32,
                              device=dev)
        out = torch.empty((R, 8), device=dev)
        with torch.cuda.device(dev):
            err = build.load().crt_visit_sweep(
                rays.data_ptr(), ids.data_ptr(), nears.data_ptr(), best.data_ptr(),
                q.words.data_ptr(), q.lo.data_ptr(), q.scale.data_ptr(), R, V, K,
                fsw.CHUNK_C, TMIN, int(tri), 0, 1, scratch.data_ptr(), out.data_ptr(), 3,
                torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0
        torch.cuda.synchronize()
        # the scratch layout of csrc/visit_sweep.cu's C interface note
        bucket = scratch[3 * R * V + K + 1:3 * R * V + 2 * K + 2]
        visited = bucket[1:] > bucket[:-1]
        G = fsw.CHUNK_C // fsw.Q16_GROUP
        at = (base + 3) // 4 * 4 + K * 3 * fsw.CHUNK_C * 4
        box = scratch[at:at + K * G * 12].view(torch.float32).reshape(K, G, 3, 4)
        live = scratch[at + K * G * 12:at + K * G * 13].reshape(K, G) != 0
        blo, bhi, A, C, want = fsw.q16_group_boxes(q.words, q.lo, q.scale, fsw.Q16_PAD, tri)
        assert int(visited.sum()) >= 6
        assert torch.equal(live[visited], want[visited])
        m = visited[:, None] & want
        got = torch.cat([box[:, :, 0, :3], box[:, :, 1, :3], box[:, :, 2, :3],
                         box[:, :, :, 3]], -1)[m]
        assert torch.equal(got.view(torch.int32),
                           torch.cat([blo, bhi, C, A], -1)[m].view(torch.int32))
        assert bool(torch.isfinite(C[m]).any())


@pytest.mark.parametrize("mode", ["CRT_SUBTILE", "CRT_SWEEP_Q16"])
@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_perray_modes_on_card_match_oracle(dev, monkeypatch, kind, mode):
    """The opt-in routes' phase loops on the card: the sub-tile route
    (K3 + K7) exact against the chunk scan, the quantized one (K3 + K8,
    planar only; spheres keep K4) on all but a few rays."""
    monkeypatch.setenv(mode, "1")
    scene = _random_scene(kind, dev)
    org, dirs, time = _rays(np.random.default_rng(4), dev, 4000)
    cap = torch.full((4000,), 60.0, device=dev)
    fsw.reset_launches()
    if kind == "sphere":
        t, pay = perray.sphere_closest_perray(org, dirs, time, scene.sphere_chunks, TMIN,
                                              cap, tabs=scene.sphere_perray)
        t_o, pay_o = ch.sphere_closest(org, dirs, time, scene.sphere_chunks, TMIN,
                                       tmax=cap)
    else:
        t, pay = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True, cap,
                                              tabs=scene.tri_perray)
        t_o, pay_o = ch.planar_closest(org, dirs, scene.tri_chunks, TMIN, True, tmax=cap)
    want = ("visit_sweep_sub" if mode == "CRT_SUBTILE" else
            "visit_sweep" if kind == "sphere" else "visit_sweep_q16")
    assert fsw.LAUNCHES[want] > 0 and sum(fsw.LAUNCHES.values()) == fsw.LAUNCHES[want]
    hit = torch.isfinite(t_o)
    same = (torch.isfinite(t) == hit) & (pay[-1] == pay_o[-1])
    assert int(hit.sum()) > 100
    assert float(same.float().mean()) >= (0.999 if want == "visit_sweep_q16" else 1.0)


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_perray_on_card_matches_oracle(dev, kind):
    """K3 + K4 phase loop (V = 4, several phases) against the chunk scan."""
    scene = _random_scene(kind, dev)
    org, dirs, time = _rays(np.random.default_rng(4), dev, 4000)
    cap = torch.full((4000,), 60.0, device=dev)
    if kind == "sphere":
        t, pay = perray.sphere_closest_perray(org, dirs, time, scene.sphere_chunks,
                                              TMIN, cap, V=4)
        t_o, pay_o = ch.sphere_closest(org, dirs, time, scene.sphere_chunks, TMIN,
                                       tmax=cap)
        # the oracle's expanded quadratic |o|^2 - 2 o.c + |c|^2 cancels
        # (|o| <= 21 here); the JAX package holds the same pair to rtol 5e-4,
        # atol 3e-4 (tests/test_perray.py:233-239)
        rtol, atol = 5e-4, 3e-4
    else:
        t, pay = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN,
                                              True, cap, V=4)
        t_o, pay_o = ch.planar_closest(org, dirs, scene.tri_chunks, TMIN, True,
                                       tmax=cap)
        # the two plane formulas round n.c - n.o apart by a few ulp of the
        # coordinates (|x| <= 12): ~1e-6 of distance, which rtol misses at
        # t ~ 1e-3
        rtol, atol = 1e-4, 1e-5
    hit = torch.isfinite(t_o)
    assert int(hit.sum()) > 100
    assert torch.equal(torch.isfinite(t), hit)
    # compared as distances along the ray (t |d|): the directions are not
    # unit, and the oracle's rounding is a distance
    dl = dirs.norm(dim=-1)[hit]
    torch.testing.assert_close(t[hit] * dl, t_o[hit] * dl, rtol=rtol, atol=atol)
    assert torch.equal(pay[-1][hit], pay_o[-1][hit])
    assert torch.equal(pay[-2], pay_o[-2])


@pytest.mark.parametrize("kind", ["quad", "tri", "sphere", "quad-holes", "tri-holes"])
def test_pid_output_matches_plain(dev, kind):
    rng = np.random.default_rng(21)
    org, dirs, time = _rays(rng, dev, 20000)
    fi.reset_launches()
    if kind == "sphere":
        chunks = _sphere_chunks(rng, dev)
        t, pid = fi.sphere_winner(org, dirs, time, chunks, TMIN)
        t_r, pay_r = ch.sphere_closest(org, dirs, time, chunks, TMIN)
    else:
        chunks = _planar_chunks(rng, dev, holes=kind.endswith("holes"))
        tri = kind.startswith("tri")
        t, pid = fi.planar_winner(org, dirs, chunks, TMIN, tri)
        t_r, pay_r = ch.planar_closest(org, dirs, chunks, TMIN, tri)
    assert sum(fi.LAUNCHES.values()) == 1
    hit = torch.isfinite(t_r)
    assert int(hit.sum()) > 100 and torch.equal(torch.isfinite(t), hit)
    assert torch.equal(pid, pay_r[-1])


# K5's cases: (R, K, V, ROWF). "clamped": ids past both ends of the table,
# read through a pointer 4 bytes past a 16-byte boundary; "unnamed": K far
# above R*V, so most rows are unnamed (the row stage sums them all, the
# fold reads only the named ones); "ragged": R not a multiple of the fold's
# block of 128 and V not of 4; "cancelling": rows of values near 1e6 in
# pairs that cancel, whose sums only an f64 accumulation gets within the
# measure
GATHER_CASES = {"64": (5000, 64, 16, 1408), "2048": (5000, 2048, 16, 1408),
                "clamped": (5000, 2048, 16, 1408), "unnamed": (500, 131_072, 16, 1408),
                "ragged": (1001, 2048, 5, 1408), "cancelling": (4000, 512, 16, 1408)}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_sum_kernel_matches_plain(dev, case):
    R, K, V, rowf = GATHER_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(K)
    table = torch.randn((K, rowf), generator=gen, device=dev)
    ids = torch.randint(0, K, (R, V), generator=gen, device=dev, dtype=torch.int32)
    if case == "clamped":
        buf = torch.empty(R * V + 1, dtype=torch.int32, device=dev)
        ids = buf[1:].view(R, V).copy_(ids)
        ids[::3, 0] = -7
        ids[1::3, V - 1] = K + 11
        ids[2::5, 4] = 2**31 - 1
    elif case == "cancelling":
        big = 1e6 * torch.randn((K // 2, rowf), generator=gen, device=dev)
        table[0::2] = big
        table[1::2] = torch.randn((K // 2, rowf), generator=gen, device=dev) - big
        pairs = torch.randint(0, K // 2, (R, V // 2), generator=gen, device=dev,
                              dtype=torch.int32)
        ids = torch.stack([2 * pairs, 2 * pairs + 1], dim=2).reshape(R, V)
    gather_probe.reset_launches()
    got = gather_probe.gather_sum(ids, table)
    assert gather_probe.LAUNCHES == {"gather_sum": 1}
    ref = gather_probe.gather_sum_plain(ids, table)
    torch.cuda.synchronize()
    assert got.shape == (R, 1) and torch.isfinite(got).all()
    assert gather_probe.rel_err(got, ref) <= 1e-5
    if case == "cancelling":  # the same sums in f32 miss by far more
        f32 = sum(table[ids[:, s].long()].sum(dim=1, keepdim=True) for s in range(V))
        assert gather_probe.rel_err(f32, ref) > 1e-3


def test_gather_sum_kernel_refuses_an_empty_table(dev):
    """With no row to clamp an id to, K5 raises instead of reading before
    the table (its plain version raises an IndexError on the CPU)."""
    ids = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="has none"):
        gather_probe.gather_sum_kernel(ids, torch.empty((0, 16), device=dev))


def test_kernel_route_gradients_match_plain_autograd(dev):
    """K1's autograd route (kernel forward, chunk-scan backward) gives plain
    autograd's gradients (table gradients: atomic adds, rtol 1e-4)."""
    rng = np.random.default_rng(22)
    chunks = _planar_chunks(rng, dev, K=2, n=200)
    chunks = ch.PlanarChunks(**{**chunks.__dict__, **{
        f: getattr(chunks, f).clone().requires_grad_() for f in ("corner", "eu", "ev")}})
    org, dirs, _ = _rays(rng, dev, 8000)
    org.requires_grad_()
    dirs.requires_grad_()
    leaves = [org, dirs, chunks.corner, chunks.eu, chunks.ev]
    fi.reset_launches()
    t, (n, u, v, _) = fi.planar_closest_fused(org, dirs, chunks, TMIN, False)
    assert fi.LAUNCHES["planar_closest"] == 1 and t.grad_fn is not None
    t_r, (n_r, u_r, v_r, _, _) = ch.planar_closest(org, dirs, chunks, TMIN, False)
    w = torch.randn((8000, 6), device=dev)

    def loss(tt, nn, uu, vv):
        tt = torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt))
        return (torch.cat([tt[:, None], nn, uu[:, None], vv[:, None]], 1) * w).sum()

    g = torch.autograd.grad(loss(t, n, u, v), leaves)
    g_r = torch.autograd.grad(loss(t_r, n_r, u_r, v_r), leaves)
    for a, b in zip(g, g_r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def _cpu_and_card(make, dev, seed, **kw):
    out = []
    for d in ("cpu", dev):
        scene, cam = make(d)
        target = torch.zeros((cam.height, cam.width, 3), device=scene.device)
        out.append(diff.loss_and_grads(scene, cam, keys.key(seed), target, cam.spp, **kw))
    return out


def _close(got, ref):
    (loss, (gs, gc)), (loss_r, (gs_r, gc_r)) = got, ref
    assert abs(float(loss) - float(loss_r)) <= 1e-4 * abs(float(loss_r))
    for grads, grads_r, tol in ((gs, gs_r, dict(rtol=2e-3, atol=1e-5)),
                                (gc, gc_r, dict(rtol=5e-3, atol=1e-4))):
        for name, g in grads.items():
            torch.testing.assert_close(g.cpu(), grads_r[name].cpu(), **tol)


@pytest.mark.parametrize("replay_isect", [None, False], ids=["replay", "oracle"])
def test_loss_and_grads_on_card_match_cpu(dev, replay_isect):
    ref, got = _cpu_and_card(
        lambda d: catalog.cornell_box(width=24, spp=2, max_depth=3, device=d), dev, 3,
        replay_isect=replay_isect)
    _close(got, ref)


def test_dense_backward_pass_launches_no_kernel(dev):
    """The replay route's backward pass reads the winners from its tape."""
    scene, cam = catalog.cornell_box(width=16, spp=2, max_depth=3, device=dev)
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    counts = {}
    backward_pass = diff._backward_pass

    def counted(*a, **k):
        counts["fwd"] = fi.LAUNCHES["planar_closest"]
        return backward_pass(*a, **k)

    diff._backward_pass = counted
    try:
        fi.reset_launches()
        diff.loss_and_grads(scene, cam, keys.key(0), target, 2)
    finally:
        diff._backward_pass = backward_pass
    assert counts["fwd"] == 2 * cam.max_depth
    assert fi.LAUNCHES["planar_closest"] == counts["fwd"]


def test_colonnade_gradient_on_card_matches_cpu(dev):
    packet.reset_launches()
    ref, got = _cpu_and_card(
        lambda d: catalog.sponza(width=12, spp=2, max_depth=2, device=d), dev, 6)
    # its chunks take K6: both passes, every bounce
    assert packet.LAUNCHES["packet_planar"] >= 2 * 2 * 2
    _close(got, ref)


# the golden workload's recorded means (tests/test_golden.py) of the
# scenes that need picture textures, the other cameras or sphereflake's
# chunked spheres; the F1 scenes (earthmap.jpg missing) are held to the
# port's own CPU render instead
NEW_GOLDENS = {"cornell_box_with_rotated_box": 0.535078,
               "cornell_box_with_specular_box": 0.488185,
               "different_fuzz_metal": 0.322772, "skybox_and_fisheye": 0.633859,
               "sphereflake": 0.592463,
               "three_material_ball_with_defocus_blur": 0.605853,
               "white_sphere": 1.000000, "cornell_box_with_glossy_ball": None,
               "infinite_reflection": None, "skybox_and_motion_blur": None}


@pytest.mark.parametrize("name", sorted(NEW_GOLDENS))
def test_new_golden_renders_on_card(dev, name):
    """The golden workload (16 px, 4 spp, depth 3, key 42) on the card: the
    recorded mean (atol 2e-3), or the CPU port's for an F1 scene; the
    scene's kernels launched (K2 for dense spheres, K1 for quads, K6 for
    sphereflake's chunked spheres)."""
    scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=dev)
    fi.reset_launches()
    fs.reset_launches()
    fsw.reset_launches()
    packet.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    want = NEW_GOLDENS[name]
    if want is None:
        s_cpu, c_cpu = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
        want = float(integrator.render_image(s_cpu, c_cpu, keys.key(42)).mean())
    assert abs(float(img.mean()) - want) <= 2e-3
    n_sph, n_quad = scene.counts[:2]
    bounces = cam.spp * cam.max_depth
    if scene.sphere_chunks is not None:
        assert packet.LAUNCHES["packet_sphere"] == bounces
        assert fs.LAUNCHES["cull_select"] == 0
    elif n_sph:
        assert fi.LAUNCHES["sphere_closest"] == bounces
    if n_quad:
        assert fi.LAUNCHES["planar_closest"] == bounces


@pytest.mark.parametrize("name,lanes", [("cornell_box", 64), ("sponza", 64),
                                        ("sphereflake", 64), ("sphereflake", None)])
def test_wavefront_matches_scan_on_card(dev, name, lanes):
    """Each wavefront path is the scan's path: the images agree to the
    order of summation (rtol 1e-5, atol 1e-5), and the scan's pixel
    batches are bitwise the whole frame's."""
    scene, cam = catalog.SCENES[name](width=16, spp=3, max_depth=3, device=dev)
    key = keys.key(42)
    ids = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
    scan = integrator.accumulate_samples_subset(scene, cam, key, ids, 0, 3)
    packet.reset_launches()
    wf = integrator.render_wavefront(scene, cam, key, 3, lanes=lanes)
    assert wf.device.type == "cuda"
    if scene.sphere_chunks is not None or scene.tri_chunks is not None:
        assert sum(packet.LAUNCHES.values()) > 0   # 16 px: the packet route
    torch.testing.assert_close(wf, scan, rtol=1e-5, atol=1e-5)
    batched = integrator.accumulate_samples_subset(scene, cam, key, ids, 0, 3,
                                                   batch_pixels=37)
    assert torch.equal(batched, scan)


def test_sweep_kernel_on_sphereflake_matches_plain(dev):
    """K3 and K4's sphere branch on sphereflake's table (7,381 spheres, 58
    chunks) and its primary camera rays: K3 bit-equal, K4 with equal hit
    masks, pid and mat, t within rtol 1e-4, the rest within atol 1e-3."""
    from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam_mod
    from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect

    scene, cam = catalog.sphereflake(width=64, spp=1, device=dev)
    tabs = scene.sphere_perray
    K = tabs.table.shape[0]
    assert K == 58 and scene.counts[0] == 7381
    n = cam.width * cam.height
    gen = torch.Generator().manual_seed(3)
    org, dirs, time = cam_mod.generate_rays(
        cam, torch.arange(n, dtype=torch.int32, device=dev),
        torch.rand(n, cam_mod.N_CAM_SLOTS, generator=gen).to(dev))
    org = org.contiguous()
    cap = isect._packet_cap(scene, org, dirs, None, float("inf"), TMIN)
    rays = fs.pack_rays(org, dirs, cap)
    excl = fs.first_excl(n, dev)
    got = fs.cull_select_kernel(rays, tabs.boxes, excl, 16, K, TMIN)
    ref = fs.cull_select_plain(rays, tabs.boxes, excl, 16, K, TMIN)
    for x, y in zip(got, ref):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)) if (
            x.dtype == torch.float32) else torch.equal(x, y)
    srays = fsw.pack_rays(org, dirs, time)
    z = torch.zeros_like(cap)
    best = fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
    k4 = fsw.sweep_kernel(srays, got[0], got[1], best, tabs.table, TMIN, False, True)
    k4_ref = fsw.sweep_plain(srays, got[0], got[1], best, tabs.table, TMIN, False, True)
    hit = k4_ref[:, 0] < cap
    assert int(hit.sum()) > 300
    assert torch.equal(k4[:, 0] < cap, hit)
    assert torch.equal(k4[:, 6:8], k4_ref[:, 6:8])
    torch.testing.assert_close(k4[hit, 0], k4_ref[hit, 0], rtol=1e-4, atol=0)
    torch.testing.assert_close(k4[hit, 1:6], k4_ref[hit, 1:6], rtol=0, atol=1e-3)
    assert torch.equal(cases.bits(k4), cases.bits(k4_ref))


# ------------------------- next-event estimation, volumes and noise scenes
def _bit_equal(a, b):
    """Equal bit for bit, NaN where NaN."""
    if a.dtype == torch.float32:
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _shadow_rays(scene, cam, dev, seed=0):
    """Every pixel's first hit (a miss's origin too: the render traces the
    inactive lanes as well) and a direction toward a sampled light point."""
    R = cam.width * cam.height
    u = torch.rand(R, 5, generator=torch.Generator().manual_seed(seed)).to(dev)
    org, dirs, time = cam_mod.generate_rays(
        cam, torch.arange(R, dtype=torch.int32, device=dev), u)
    hit = isect.intersect_brute(scene, org, dirs, time, TMIN,
                                torch.zeros((R, scene.n_volumes), device=dev))
    sh = mat_ops.light_sample(scene, hit.p, u[:, 0], u[:, 3], u[:, 4])
    return hit.p.contiguous(), sh, time, hit.valid


def test_shadow_rays_through_k1_k2_match_plain(dev):
    """The shadow rays of cornell_box_with_sphere_light through K1 (walls
    and boxes) and K2 (the light sphere), against the plain versions."""
    scene, cam = catalog.cornell_box_with_sphere_light(width=64, spp=1, device=dev)
    org, dirs, time, live = _shadow_rays(scene, cam, dev)
    assert 0 < int(live.sum()) < org.shape[0]
    view, pack = scene.quad_view
    got = fi.planar_closest_fused(org, dirs, view, TMIN, False, pack=pack)
    ref = ch.planar_closest(org, dirs, view, TMIN, False)
    _check(got, (ref[0], ref[1][:4]), 1e-3)
    view, pack = scene.sphere_view
    got = fi.sphere_closest_fused(org, dirs, time, view, TMIN, pack=pack)
    ref = ch.sphere_closest(org, dirs, time, view, TMIN)
    _check(got, (ref[0], ref[1][:3]), 1e-3)


def test_shadow_rays_through_k3_k4_match_plain(dev):
    """perlin_texture_ball's 2,401 chunked quads: rays from the first hits
    toward its light quad, half the lanes dead (cap = tmin), through K3
    (bit-equal) and K4 at every phase of the per-ray loop (bit for bit)."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import profiling

    scene, cam = catalog.perlin_texture_ball(width=64, spp=1, device=dev)
    R = cam.width * cam.height
    gen = torch.Generator().manual_seed(1)
    org, dirs, _, cap = profiling.scene_rays(scene, cam, gen)
    tabs, K = scene.quad_perray, scene.quad_chunks.corner.shape[0]
    t, _ = perray.planar_closest_perray(org, dirs, scene.quad_chunks, TMIN, False, cap,
                                        tabs=tabs)
    p = (org + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * dirs)
    uv = torch.rand(R, 2, generator=gen).to(dev)
    target = (torch.tensor([123.0, 554.0, 147.0], device=dev)
              + uv[:, :1] * torch.tensor([300.0, 0, 0], device=dev)
              + uv[:, 1:] * torch.tensor([0, 0, 265.0], device=dev))
    o, d = p.contiguous(), (target - p).contiguous()
    live = (torch.rand(R, generator=gen) < 0.5).to(dev) & torch.isfinite(t)
    c = isect._packet_cap(scene, o, d, live, float("inf"), TMIN)
    V = min(perray.VISIT_BLOCK, K)
    rays = fs.pack_rays(o, d, c)
    excl = fs.first_excl(R, dev)
    got = fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN)
    ref = fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN)
    assert all(_bit_equal(a, b) for a, b in zip(got, ref))
    rays4, calls = profiling.sweep_phases(o, d, None, c, tabs, K, TMIN, False, False)
    assert calls
    for ids, nears, best in calls:
        got = fsw.sweep_kernel(rays4, ids, nears, best, tabs.table, TMIN, False, False)
        ref = fsw.sweep_plain(rays4, ids, nears, best, tabs.table, TMIN, False, False)
        assert _bit_equal(got, ref)


@pytest.mark.parametrize("name", ["cornell_box_with_sphere_light",
                                  "cornell_box_with_volume"])
def test_nee_render_on_card_matches_cpu(dev, name):
    """NEE and roulette on the card: the CPU port's image (mean within
    2e-3, 98% of pixels within 1e-3), K1 (and K2) launched spp x (2 depth -
    1) times (the last bounce's shadow ray is skipped on the host), and
    the wavefront equal to the scan up to the order of its sums."""
    kw = dict(width=16, spp=4, max_depth=3)
    scene, cam = catalog.SCENES[name](device=dev, **kw)
    cam = cam.replace(nee=True, rr_depth=2)
    fi.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    want = cam.spp * (2 * cam.max_depth - 1)
    assert fi.LAUNCHES["planar_closest"] == want
    assert fi.LAUNCHES["sphere_closest"] == (want if scene.counts[0] else 0)
    s_cpu, c_cpu = catalog.SCENES[name](device="cpu", **kw)
    ref = integrator.render_image(s_cpu, c_cpu.replace(nee=True, rr_depth=2),
                                  keys.key(42))
    assert abs(float(img.mean()) - float(ref.mean())) <= 2e-3
    close = (img.cpu() - ref).abs().amax(-1) <= 1e-3
    assert float(close.float().mean()) >= 0.98
    wf = integrator.render_image_wavefront(scene, cam, keys.key(42))
    torch.testing.assert_close(wf, img, rtol=1e-5, atol=1e-5)


def test_nee_volume_gradient_on_card(dev):
    """loss_and_grads with NEE through the volumes: the backward pass reads
    the path rays' and the shadow rays' winners from its tape (no K1
    launch), and the gradients equal the CPU port's."""
    counts = {}
    backward_pass = diff._backward_pass

    def counted(*a, **k):
        counts["fwd"] = fi.LAUNCHES["planar_closest"]
        return backward_pass(*a, **k)

    diff._backward_pass = counted
    try:
        fi.reset_launches()
        ref, got = _cpu_and_card(
            lambda d: (lambda s, c: (s, c.replace(nee=True)))(
                *catalog.cornell_box_with_volume(width=16, spp=2, max_depth=3, device=d)),
            dev, 3)
    finally:
        diff._backward_pass = backward_pass
    assert counts["fwd"] == 2 * (2 * 3 - 1)
    assert fi.LAUNCHES["planar_closest"] == counts["fwd"]
    _close(got, ref)


# the golden workload's recorded means of the scenes that need noise
# textures, sphere lights or volumes; the F1 scenes (an asset missing) are
# held to the port's own CPU render
ESTIMATOR_GOLDENS = {"perlin_texture_ball": 0.418168, "test_perlin_noise": 0.507109,
                     "test_value_noise": 0.496078, "test_worley_noise": 0.322421,
                     "test_voronoi_noise": 0.462877,
                     "cornell_box_with_sphere_light": 0.427467,
                     "cornell_box_with_volume": 0.487237, "simple_light_earth": None,
                     "smoke_fox": None}


@pytest.mark.parametrize("name", sorted(ESTIMATOR_GOLDENS))
def test_estimator_golden_renders_on_card(dev, name):
    scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=dev)
    fi.reset_launches()
    packet.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    want = ESTIMATOR_GOLDENS[name]
    if want is None:
        s_cpu, c_cpu = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
        want = float(integrator.render_image(s_cpu, c_cpu, keys.key(42)).mean())
    assert abs(float(img.mean()) - want) <= 2e-3
    bounces = cam.spp * cam.max_depth
    if scene.quad_chunks is not None:     # 19 chunks: the packet route
        assert packet.LAUNCHES["packet_planar"] == bounces
    elif scene.counts[1]:
        assert fi.LAUNCHES["planar_closest"] == bounces
    if scene.counts[0]:
        assert fi.LAUNCHES["sphere_closest"] == bounces


# the golden workload's recorded means of the spectral and env-light scenes,
# and the Cornell box under QMC and the threefry stream, held to the port's
# own CPU render
SPECTRAL_GOLDENS = {"dispersion_prism": 0.782510, "sunlit_spheres": 0.090164}


@pytest.mark.parametrize("name,variant", [("dispersion_prism", None),
                                          ("sunlit_spheres", None),
                                          ("sunlit_spheres", "nee"),
                                          ("cornell_box", "qmc"),
                                          ("cornell_box", "threefry")])
def test_spectral_qmc_threefry_renders_on_card(dev, monkeypatch, name, variant):
    if variant == "threefry":
        monkeypatch.setenv("CRT_RNG", "threefry")

    def build(d):
        s, c = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=d)
        return s, c.replace(nee=variant == "nee", qmc=variant == "qmc")

    scene, cam = build(dev)
    fi.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    s_cpu, c_cpu = build("cpu")
    want = float(integrator.render_image(s_cpu, c_cpu, keys.key(42)).mean())
    assert abs(float(img.mean()) - want) <= 2e-3
    if variant is None:
        assert abs(float(img.mean()) - SPECTRAL_GOLDENS[name]) <= 2e-3
    bounces = cam.spp * cam.max_depth
    if scene.counts[1]:
        assert fi.LAUNCHES["planar_closest"] == bounces
    if scene.counts[0]:
        assert fi.LAUNCHES["sphere_closest"] == (
            cam.spp * (2 * cam.max_depth - 1) if variant == "nee" else bounces)


def test_qmc_threefry_envlight_on_card_equal_cpu(dev):
    """The int64 word arithmetic and the env-light tables on the card:
    QMC and threefry uniforms bit-equal to the CPU's, sample and pdf on the
    same tables equal, the card's own tables within rtol 1e-5."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import envlight, qmc

    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1 << 20, 5000).astype(np.int32)
    sidx = rng.integers(0, 256, 5000).astype(np.int32)
    words = qmc.seed_words(keys.key(3))
    groups, dims, ng = qmc.bounce_layout(10)
    args = (torch.as_tensor(sidx), qmc.N_CAM_GROUPS + torch.as_tensor(sidx % 8) * ng,
            groups, dims)
    cpu = qmc.uniforms(words, torch.as_tensor(ids), *args)
    card = qmc.uniforms(words, _t(ids, dev), *[a.to(dev) if torch.is_tensor(a) else a
                                               for a in args])
    assert torch.equal(card.cpu(), cpu)
    k_cpu = keys.fold_in_lanes(keys.key(9), torch.as_tensor(ids))
    k_card = keys.fold_in_lanes(keys.key(9), _t(ids, dev))
    assert torch.equal(k_card.cpu(), k_cpu)
    assert torch.equal(keys.uniform(k_card, 9).cpu(), keys.uniform(k_cpu, 9))
    s_card, _ = catalog.sunlit_spheres(width=16, spp=1, max_depth=2, device=dev)
    s_cpu, _ = catalog.sunlit_spheres(width=16, spp=1, max_depth=2, device="cpu")
    for a, b in zip((s_card.env_texel_p, s_card.env_row_cdf, s_card.env_col_cdf),
                    (s_cpu.env_texel_p, s_cpu.env_row_cdf, s_cpu.env_col_cdf)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-9)
    s_same = s_card.replace(env_texel_p=s_cpu.env_texel_p.to(dev),
                            env_row_cdf=s_cpu.env_row_cdf.to(dev),
                            env_col_cdf=s_cpu.env_col_cdf.to(dev))
    u1, u2 = rng.uniform(0, 1, (2, 5000)).astype(np.float32)
    d_card = envlight.sample(s_same, _t(u1, dev), _t(u2, dev))
    d_cpu = envlight.sample(s_cpu, torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_allclose(d_card.cpu().numpy(), d_cpu.numpy(), atol=1e-5)
    np.testing.assert_allclose(envlight.pdf(s_same, d_card).cpu().numpy(),
                               envlight.pdf(s_cpu, d_cpu).numpy(), rtol=1e-4)


def _fox_scene(dev, rings):
    """An attributed, textured ellipsoid of 24 segments (576 triangles at
    13 rings: chunked; 480 at 11: dense) on the card and on the CPU."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import procgen

    pos, nrm, uv, idx = procgen.ellipsoid_mesh(24, rings)
    c = idx.reshape(-1, 3)

    def build(device):
        b = SceneBuilder()
        pic = b.picture(np.random.default_rng(0).uniform(0, 255, (8, 8, 3)))
        b.triangles(pos[c] + np.array([0.0, 40.0, 0.0]), b.lambertian(pic),
                    normals=nrm[c], uvs=uv[c])
        b.set_background(b.solid((0.6, 0.7, 0.9)))
        return b.build(device)

    cam = cam_mod.perspective(64, 1.0, (120, 120, 120), (0, 40, 0), 1, 45.0, 4, 3,
                              device=dev)
    return build(dev), build("cpu"), cam


def test_pid_with_attributes_matches_plain(dev):
    """K1 with its pid on a dense attributed mesh, and K6 on a chunked one
    (5 chunks: the packet route): the interpolated normal and (u, v) of each
    first hit within atol 1e-3 of the plain versions' on the same scene,
    hit masks equal."""
    for rings, names in ((11, ("planar_closest",)), (13, ("packet_planar",))):
        scene, scene_cpu, cam = _fox_scene(dev, rings)
        assert (scene.tri_chunks is not None) == (rings == 13)
        ids = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
        u = torch.full((ids.shape[0], cam_mod.N_CAM_SLOTS), 0.5, device=dev)
        org, dirs, time = cam_mod.generate_rays(cam, ids, u)
        fi.reset_launches()
        packet.reset_launches()
        u_vol = torch.zeros((ids.shape[0], 1), device=dev)
        got = isect.intersect_brute(scene, org, dirs, time, TMIN, u_vol)
        launched = {**fi.LAUNCHES, **packet.LAUNCHES}
        assert all(launched[n] > 0 for n in names), launched
        ref = isect.intersect_brute(scene_cpu, org.cpu(), dirs.cpu(), time.cpu(), TMIN,
                                    u_vol.cpu())
        assert torch.equal(got.valid.cpu(), ref.valid) and 0.1 < ref.valid.float().mean() < 0.9
        for f in ("normal", "u", "v"):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(ref, f).numpy(), rtol=0, atol=1e-3,
                                       err_msg=f)


def test_adaptive_tol_zero_is_the_uniform_render_on_card(dev):
    from cpu_ray_tracing_implementation_tpu_torch.models import adaptive

    scene, cam = catalog.cornell_box(width=64, spp=16, max_depth=4, device=dev)
    fi.reset_launches()
    img = adaptive.render_image_adaptive(scene, cam, keys.key(0), rel_tol=0.0,
                                         min_spp=8, max_spp=16, chunk_spp=8)
    assert fi.LAUNCHES["planar_closest"] == 16 * 4
    assert torch.equal(img, integrator.render_image(scene, cam, keys.key(0)))


def test_aovs_and_denoise_on_card_stay_finite(dev):
    from cpu_ray_tracing_implementation_tpu_torch.models import aov
    from cpu_ray_tracing_implementation_tpu_torch.utils import denoise

    scene, cam = catalog.cornell_box(width=96, spp=4, max_depth=4, device=dev)
    fi.reset_launches()
    bufs = aov.render_aovs(scene, cam, keys.key(1))
    assert fi.LAUNCHES["planar_closest"] == 4
    img = integrator.render_image(scene, cam, keys.key(1))
    out = denoise.denoise(img, bufs)
    assert out.device.type == "cuda" and torch.isfinite(out).all()
    cpu = aov.render_aovs(*catalog.cornell_box(width=96, spp=4, max_depth=4, device="cpu"),
                          keys.key(1))
    np.testing.assert_array_equal(bufs["coverage"].cpu().numpy(), cpu["coverage"].numpy())


@pytest.mark.parametrize("tile", [2048, 256, 100])
def test_packet_sphere_kernel_matches_plain(dev, tile):
    rng = np.random.default_rng(21)
    chunks = _sphere_chunks(rng, dev, K=12, n=1400)
    org, dirs, time = _rays(rng, dev, 5000)
    cap = torch.full((5000,), 40.0, device=dev)
    cap[:300] = TMIN                                  # dead lanes
    packet.reset_launches()
    t, pay, visits = packet.sphere_packet_hit(org, dirs, time, chunks, TMIN, cap, tile)
    assert packet.LAUNCHES["packet_sphere"] == 1
    t_r, pay_r, visited = packet.sphere_packet_plain(org, dirs, time, chunks, TMIN, cap,
                                                     tile)
    hit = torch.isfinite(t_r)
    assert int(hit.sum()) > 100 and not bool(hit[:300].any())
    assert torch.equal(torch.isfinite(t), hit)
    for x, x_r in zip(pay[2:], pay_r[2:]):            # mat, pid
        assert torch.equal(x, x_r)
    torch.testing.assert_close(t[hit], t_r[hit], rtol=1e-4, atol=1e-4)
    for x, x_r in zip(pay[:2], pay_r[:2]):
        torch.testing.assert_close(x[hit], x_r[hit], rtol=0, atol=1e-3)
    assert visits.tolist() == [len(v) for v in visited]


@pytest.mark.parametrize("tri", [False, True])
def test_packet_planar_kernel_matches_plain(dev, tri):
    rng = np.random.default_rng(22)
    chunks = _planar_chunks(rng, dev, K=12, n=1400, holes=True)
    org, dirs, _ = _rays(rng, dev, 5000)
    t, pay, visits = packet.planar_packet_hit(org, dirs, chunks, TMIN, tri, 40.0, 512)
    t_r, pay_r, visited = packet.planar_packet_plain(org, dirs, chunks, TMIN, tri, 40.0,
                                                     512)
    hit = torch.isfinite(t_r)
    assert int(hit.sum()) > 100 and torch.equal(torch.isfinite(t), hit)
    same = hit & (pay[4] == pay_r[4])
    near = hit & ~same & ((t - t_r).abs() <= 1e-4 * t_r.abs())
    assert torch.equal(same | near, hit)
    assert torch.equal(pay[3][same], pay_r[3][same])
    torch.testing.assert_close(t[hit], t_r[hit], rtol=1e-4, atol=1e-4)
    for x, x_r in zip(pay[:3], pay_r[:3]):
        torch.testing.assert_close(x[same], x_r[same], rtol=0, atol=1e-3)
    v_r = torch.tensor([len(v) for v in visited], device=dev, dtype=torch.int32)
    assert int((visits != v_r).sum()) <= 1


@pytest.mark.parametrize("tile", [1, 33, packet.AUTO_TILE, 200, 300, 2048])
@pytest.mark.parametrize("n_rays", [1, 31, 257, 513])
def test_packet_sphere_kernel_bit_equal_at_ragged_counts(dev, n_rays, tile):
    """Every instance K6 picks (one ray a thread in four sets up to 64 rays,
    two rays in two sets up to 256, two rays up to 512, four rays above, in
    groups past 1,024) on ray counts that leave a tile, a warp and a block
    part empty: bit for bit the plain version, visits equal."""
    rng = np.random.default_rng(n_rays * 7 + tile)
    chunks = _sphere_chunks(rng, dev, K=9, n=1000, holes=True)
    org, dirs, time = _rays(rng, dev, n_rays)
    cap = torch.full((n_rays,), 40.0, device=dev)
    cap[::5] = TMIN                                   # dead lanes
    t, pay, visits = packet.sphere_packet_hit(org, dirs, time, chunks, TMIN, cap, tile)
    t_r, pay_r, visited = packet.sphere_packet_plain(org, dirs, time, chunks, TMIN, cap,
                                                     tile)
    if n_rays > 100:
        assert int(torch.isfinite(t_r).sum()) > 10
    assert torch.equal(t, t_r)
    for x, x_r in zip(pay, pay_r):                    # center, rad, mat, pid
        assert torch.equal(x, x_r)
    assert visits.tolist() == [len(v) for v in visited]


@pytest.mark.parametrize("tile", [32, 64, 200])
def test_packet_sphere_tie_across_chunks_keeps_the_first_visited(dev, tile):
    """The same sphere in chunk 0 (lane 0) and chunk 1 (lane 1, beside a
    sphere that pulls chunk 1's box toward the rays, so chunk 1 is visited
    first): every ray keeps chunk 1's copy, as the plain version does,
    though the two copies lie in lanes that different threads test."""
    C = 128
    c0 = np.zeros((2, C, 3), np.float32)
    rad = np.full((2, C), 0.1, np.float32)
    act = np.zeros((2, C), bool)
    c0[0, 0], rad[0, 0], act[0, 0] = (0, 0, 10), 1.0, True
    c0[1, 0], rad[1, 0], act[1, 0] = (5, 0, 3), 0.5, True
    c0[1, 1], rad[1, 1], act[1, 1] = (0, 0, 10), 1.0, True
    lo = np.where(act[..., None], c0 - rad[..., None], np.inf).min(1)
    hi = np.where(act[..., None], c0 + rad[..., None], -np.inf).max(1)
    chunks = ch.SphereChunks(c0=_t(c0, dev), c1=_t(c0, dev), rad=_t(rad, dev),
                             mat=_t(np.zeros((2, C), np.int32), dev), active=_t(act, dev),
                             lo=_t(lo.astype(np.float32), dev),
                             hi=_t(hi.astype(np.float32), dev))
    rng = np.random.default_rng(25)
    n = 300
    dirs = np.c_[rng.uniform(-0.05, 0.05, (n, 2)), np.ones(n)].astype(np.float32)
    org, dirs, time = _t(np.zeros((n, 3), np.float32), dev), _t(dirs, dev), \
        torch.zeros(n, device=dev)
    cap = torch.full((n,), 40.0, device=dev)
    t, pay, visits = packet.sphere_packet_hit(org, dirs, time, chunks, TMIN, cap, tile)
    t_r, pay_r, visited = packet.sphere_packet_plain(org, dirs, time, chunks, TMIN, cap,
                                                     tile)
    assert bool(torch.isfinite(t).all())
    assert torch.equal(pay[3], torch.full_like(pay[3], C + 1))
    assert torch.equal(pay[3], pay_r[3]) and torch.equal(t, t_r)
    assert visits.tolist() == [len(v) for v in visited]


@pytest.mark.parametrize("tile", [31, 77, 301, 1001])
@pytest.mark.parametrize("tri", [False, True])
def test_packet_planar_kernel_holes_odd_tiles(dev, tri, tile):
    """A holed table at odd tiles: one ray a thread in four sets (31), two
    rays a thread in two sets (77), two rays a thread (301), four (1001)."""
    rng = np.random.default_rng(24 + tile)
    chunks = _planar_chunks(rng, dev, K=10, n=1000, holes=True)
    org, dirs, _ = _rays(rng, dev, 3000)
    t, pay, visits = packet.planar_packet_hit(org, dirs, chunks, TMIN, tri, 40.0, tile)
    t_r, pay_r, visited = packet.planar_packet_plain(org, dirs, chunks, TMIN, tri, 40.0,
                                                     tile)
    hit = torch.isfinite(t_r)
    assert int(hit.sum()) > 100 and torch.equal(torch.isfinite(t), hit)
    same = hit & (pay[4] == pay_r[4])
    near = hit & ~same & ((t - t_r).abs() <= 1e-4 * t_r.abs())
    assert torch.equal(same | near, hit)
    assert torch.equal(pay[3][same], pay_r[3][same])
    torch.testing.assert_close(t[hit], t_r[hit], rtol=1e-4, atol=1e-4)
    for x, x_r in zip(pay[:3], pay_r[:3]):
        torch.testing.assert_close(x[same], x_r[same], rtol=0, atol=1e-3)
    v_r = torch.tensor([len(v) for v in visited], device=dev, dtype=torch.int32)
    assert int((visits != v_r).sum()) <= 1


def test_packet_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(23)
    chunks = _sphere_chunks(rng, dev, K=2)
    org, dirs, time = _rays(rng, dev, 64)
    pack = fi.pack_sphere_constants(chunks)
    rays = fi.pack_rays(org, dirs, time)
    cap = torch.full((64,), 40.0, device=dev)
    with pytest.raises(ValueError, match="chunks"):
        big = torch.zeros((packet.MAX_CHUNKS + 1, 3), device=dev)
        packet.packet_sphere_kernel(rays, cap, pack[:1].expand(packet.MAX_CHUNKS + 1, -1, -1)
                                    .contiguous(), big, big, TMIN, 64)
    with pytest.raises(ValueError, match="CUDA"):
        packet.packet_sphere_kernel(rays.cpu(), cap, pack, chunks.lo, chunks.hi, TMIN, 64)


def test_sphereflake_render_takes_the_packet_route(dev):
    scene, cam = catalog.sphereflake(width=64, spp=2, max_depth=3, device=dev)
    packet.reset_launches()
    fs.reset_launches()
    img = integrator.render_image(scene, cam, keys.key(42))
    assert packet.LAUNCHES["packet_sphere"] > 0
    assert fs.LAUNCHES["cull_select"] == 0
    ref = integrator.render_image(*catalog.sphereflake(width=64, spp=2, max_depth=3,
                                                       device="cpu"), keys.key(42))
    assert abs(float(img.mean()) - float(ref.mean())) <= 2e-3


# K9's scenes: the Cornell box at the scan cell's bounce shapes (600x600,
# depth 4), every material family (all_materials_fixture: lambertian, metal,
# dielectric, gloss, diffuse light; the volume box: isotropic), a sphere
# light, and a dispersive scene (ior_shift)
SCATTER_SCENES = {
    "cornell_box_scan": lambda d: catalog.cornell_box(width=600, spp=1, max_depth=4, device=d),
    "all_materials": lambda d: catalog.all_materials_fixture(width=128, spp=1, max_depth=4,
                                                             device=d),
    "volume": lambda d: catalog.cornell_box_with_volume(width=128, spp=1, max_depth=4,
                                                        device=d),
    "sphere_light": lambda d: catalog.cornell_box_with_sphere_light(width=128, spp=1,
                                                                    max_depth=4, device=d),
    "dispersion_prism": lambda d: catalog.dispersion_prism(width=128, spp=1, max_depth=4,
                                                           device=d),
}


def _scatter_check(scene, calls):
    r = kernel_ab.scatter_check(scene, calls)
    print(f"K9: {r['lanes']} lanes, {r['bit_equal']} bit for bit, max abs err "
          f"{r['max_abs_err']:.3g}; beyond the tolerance (call, lane): {r['outliers']}")
    assert r["ok"], r["outliers"]


@pytest.mark.parametrize("cosine", ["sphere", "onb"])
@pytest.mark.parametrize("name", sorted(SCATTER_SCENES))
def test_scatter_kernel_matches_plain(dev, monkeypatch, name, cosine):
    monkeypatch.setenv("CRT_COSINE", cosine)
    scene, cam = SCATTER_SCENES[name](dev)
    calls = kernel_ab.scatter_calls(scene, cam, keys.key(11))
    assert len(calls) == cam.max_depth
    if name == "dispersion_prism":
        assert calls[0][3] is not None
    _scatter_check(scene, calls)


def test_scatter_kernel_on_invalid_lanes(dev):
    """A third of the lanes marked invalid: they do not continue, and their
    outputs are the plain version's all the same."""
    scene, cam = catalog.all_materials_fixture(width=96, spp=1, max_depth=3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    calls = []
    for hit, *rest in kernel_ab.scatter_calls(scene, cam, keys.key(2)):
        drop = torch.rand(hit.valid.shape, generator=gen, device=dev) < 1 / 3
        calls.append((dataclasses.replace(hit, valid=hit.valid & ~drop), *rest))
    _scatter_check(scene, calls)
    hit, ray_dir, u, ior_shift, pre = calls[0]
    continues = fsc.scatter(scene, hit, ray_dir, u, ior_shift, *pre)[2]
    assert not bool(continues[~hit.valid].any())


def test_scatter_kernel_launches_once_a_bounce_without_grad(dev):
    """Under no_grad a render launches K9 once a bounce; with a leaf that
    needs a gradient it runs the eager route and launches none; a gradient
    step launches it in its forward pass alone."""
    scene, cam = catalog.cornell_box(width=32, spp=3, max_depth=4, device=dev)
    fsc.reset_launches()
    with torch.no_grad():
        integrator.render_image(scene, cam, keys.key(0))
    assert fsc.LAUNCHES["scatter"] == cam.spp * cam.max_depth
    fsc.reset_launches()
    color0 = scene.textures.color0.clone().requires_grad_()
    leafy = scene.replace(textures=dataclasses.replace(scene.textures, color0=color0))
    with torch.enable_grad():
        img = integrator.render_image(leafy, cam, keys.key(0))
    assert img.requires_grad and fsc.LAUNCHES["scatter"] == 0
    fsc.reset_launches()
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    diff.loss_and_grads(scene, cam, keys.key(0), target, cam.spp)
    assert fsc.LAUNCHES["scatter"] == cam.spp * cam.max_depth


def test_scatter_kernel_strides_and_refusals(dev):
    """The [R,3] rows and the uniforms are read at their strides (a
    transposed layout gives the same bits); what the kernel does not take
    raises."""
    scene, cam = catalog.cornell_box(width=16, spp=1, max_depth=2, device=dev)
    hit, ray_dir, u, ior_shift, (mt, atten) = kernel_ab.scatter_calls(scene, cam,
                                                                       keys.key(0))[1]
    flip = lambda x: x.T.contiguous().T
    ref = fsc.scatter(scene, hit, ray_dir, u, ior_shift, mt, atten)
    got = fsc.scatter(scene, dataclasses.replace(hit, p=flip(hit.p), normal=flip(hit.normal)),
                      flip(ray_dir), flip(u), ior_shift, mt, flip(atten))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="contiguous"):
        fsc.scatter(scene, hit, ray_dir, u, ior_shift, torch.stack([mt, mt], 1)[:, 0], atten)
    with pytest.raises(TypeError, match="int32"):
        fsc.scatter(scene, hit, ray_dir, u, ior_shift, mt.long(), atten)
    with pytest.raises(ValueError, match="u has shape"):
        fsc.scatter(scene, hit, ray_dir, u[:, :8], ior_shift, mt, atten)
    with pytest.raises(RuntimeError, match="gradient"):
        with torch.enable_grad():
            fsc.scatter(scene, hit, ray_dir, u, ior_shift, mt, atten.clone().requires_grad_())
    # more lights than a block's 48 KB of shared memory holds: the launch is refused
    many = scene.replace(lights=scene.lights.repeat(600))
    with pytest.raises(RuntimeError, match="crt_scatter launch failed"):
        fsc.scatter(many, hit, ray_dir, u, ior_shift, mt, atten)
