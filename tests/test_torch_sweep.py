"""Plain K4 (``ops/fused_sweep.sweep_plain``) against the JAX Pallas
kernel ``pallas_sweep.sweep``, which runs in interpret mode on the CPU as
tests/test_pallas_sweep.py:55-97 runs it.

The same rays, visit lists (the XLA selection rounds of ``perray``) and
running best go through both, for planar quads, planar triangles and
spheres, over two consecutive phases. pid and mat are equal; every one
of the 8 best columns agrees within rtol = atol = 2e-5, except u and v of
grazing planar hits (|d.n| < 0.05 with unit d), which are held to 1e-4.
Why: XLA's CPU code contracts multiply-adds into FMAs inside its fused
loops, PyTorch rounds every operation (measured: d.n 3 ulp apart on one
ray). At a grazing hit t = (n.c - n.o)/(d.n) cancels, so those few ulp
become 189 ulp of t (1.3e-5 relative, still inside 2e-5) and 4.7e-5 of
the edge coefficients, which carry t times |d.(ev x w)|. The sweep tables
are equal exactly.

The kernel's decomposition (``sweep_fold_plain``: each visited slot's
minimum against the input best, then the in-order fold) is held to the JAX
kernel the same way, and to ``sweep_plain`` bit for bit on adversarial
visit lists.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_sweep_cases as cases

from cpu_ray_tracing_implementation_tpu.models import scene as jscene
from cpu_ray_tracing_implementation_tpu.ops import pallas_sweep as jpsw
from cpu_ray_tracing_implementation_tpu.ops import perray as jperray
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import perray

TMIN = 1e-3
R = jpsw.RB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread for this module: on several, its CPU kernels
    round a few of the plain sweep's values otherwise from run to run. The
    suite's workers run on PyTorch's default thread count (8 on an 8-core
    host); this module's count is restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(kind):
    rng = np.random.default_rng({"quad": 11, "tri": 12, "sphere": 13}[kind])
    b = jscene.SceneBuilder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.5, 0.5, 0.5))]
    for i, c in enumerate(rng.normal(0, 3.0, (600, 3))):
        if kind == "sphere":
            b.moving_sphere(c, c + rng.normal(0, 0.1, 3),
                            abs(rng.normal(0.2, 0.05)) + 0.05, mats[i % 2])
        elif kind == "tri":
            v = c + rng.normal(0, 0.3, (3, 3))
            b.triangle(v[0], v[1], v[2], mats[i % 2])
        else:
            b.quad(c, rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3), mats[i % 2])
    s = b.build()
    return {"quad": s.quad_chunks, "tri": s.tri_chunks,
            "sphere": s.sphere_chunks}[kind]


def _to_torch(jchunks, cls):
    return cls(*[torch.as_tensor(np.array(getattr(jchunks, f.name)))
                 for f in dataclasses.fields(cls)])


def _against_jax(kind, sweep_fn):
    jchunks = _scene(kind)
    sphere = kind == "sphere"
    K, C = jchunks.mat.shape
    rng = np.random.default_rng(21)
    org = rng.normal(0, 3.0, (R, 3)).astype(np.float32)
    d = rng.normal(0, 1, (R, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    time = rng.uniform(0, 1, R).astype(np.float32)
    cap = np.full(R, 50.0, np.float32)
    cap[:16] = rng.uniform(0.5, 3.0, 16)
    jo, jd, jt, jc = (jnp.asarray(x) for x in (org, dirs, time, cap))

    if sphere:
        jtable = jperray._sphere_table(jchunks).reshape(K, 7, C)
        tabs = perray.sphere_tables(_to_torch(jchunks, ch.SphereChunks))
        jrays = jpsw.pack_rays(jo, jd, jt)
        rays = fsw.pack_rays(*(torch.as_tensor(x) for x in (org, dirs, time)))
        pk = jpsw.pack_best_sphere((jc, jnp.zeros((R, 3)), jnp.ones((R,)),
                                    jnp.zeros((R,), jnp.int32),
                                    jnp.zeros((R,), jnp.int32)))
    else:
        jtable = jperray._planar_table(jchunks).reshape(K, 9, C)
        tabs = perray.planar_tables(_to_torch(jchunks, ch.PlanarChunks))
        jrays = jpsw.pack_rays(jo, jd)
        rays = fsw.pack_rays(torch.as_tensor(org), torch.as_tensor(dirs))
        pk = jpsw.pack_best_planar((jc, jnp.zeros((R, 3)), jnp.zeros((R,)),
                                    jnp.zeros((R,)), jnp.zeros((R,), jnp.int32),
                                    jnp.zeros((R,), jnp.int32)))
    np.testing.assert_array_equal(tabs.table.numpy(), np.asarray(jtable))
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
    best = torch.as_tensor(np.array(pk))

    V = 4
    nr = jperray._near_matrix(jo, jd, jchunks.lo, jchunks.hi, TMIN, jc)
    hits = 0
    for _ in range(2):                    # phase 1, then phase 2 from its best
        ids, nears, nr = jperray._select_block(nr, V)
        ids = jnp.clip(ids, 0, K - 1)
        ref = jpsw.sweep(jrays, ids, nears, pk, jtable, V, C, TMIN,
                         kind == "tri", sphere)
        got = sweep_fn(rays, torch.as_tensor(np.array(ids)),
                       torch.as_tensor(np.array(nears)), best, tabs.table,
                       TMIN, kind == "tri", sphere)
        ref_np, got_np = np.asarray(ref), got.numpy()
        np.testing.assert_array_equal(got_np[:, 6:8], ref_np[:, 6:8])
        grazing = np.zeros(R, bool)
        if not sphere:
            hit = ref_np[:, 0] < cap
            grazing = hit & (np.abs(np.sum(dirs * ref_np[:, 1:4], axis=1)) < 0.05)
        assert grazing.sum() <= R // 50
        np.testing.assert_allclose(got_np[~grazing], ref_np[~grazing],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_np[grazing][:, [0, 1, 2, 3]],
                                   ref_np[grazing][:, [0, 1, 2, 3]],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_np[grazing][:, 4:6],
                                   ref_np[grazing][:, 4:6], rtol=0, atol=1e-4)
        hits = int((ref_np[:, 0] < cap).sum())
        pk, best = ref, got
    assert hits > 20


@pytest.mark.parametrize("kind", ["quad", "tri", "sphere"])
def test_plain_matches_jax_kernel(kind):
    _against_jax(kind, fsw.sweep)


@pytest.mark.parametrize("kind", ["quad", "tri", "sphere"])
def test_fold_plain_matches_jax_kernel(kind):
    """The kernel's decomposition (``sweep_fold_plain``) against the JAX
    kernel as above; the JAX sweep's compile of the same shapes is reused."""
    _against_jax(kind, fsw.sweep_fold_plain)


@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("kind", cases.KINDS)
def test_fold_plain_matches_plain_bit_for_bit(kind, case):
    """Per-slot minima against the input best, then the in-order fold, give
    ``sweep_plain``'s 8 columns bit for bit on the adversarial lists of
    tests/torch_sweep_cases.py (ties within a row and across slots, nears
    between the running and the input best, exhausted slots, duplicate and
    out-of-range ids, R = 1, K = 1)."""
    rays, ids, nears, best, table, tri, sph = cases.make_case(kind, case, "cpu")
    ref = fsw.sweep_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    got = fsw.sweep_fold_plain(rays, ids, nears, best, table, cases.TMIN, tri, sph)
    cases.check_case(case, got, ref, best, nears)


def test_scratch_layout():
    """The kernel's int32 scratch: (t, lane) per slot (2RV), the visit list
    (RV), counts and a ticket (K + 1), two offset arrays (K + 1 each)."""
    assert fsw.scratch_ints(40_000, 16, 2_015) == 3 * 640_000 + 3 * 2_015 + 3
    assert fsw.scratch_ints(0, 16, 1) == 6


def test_best_packing_round_trips():
    rng = np.random.default_rng(3)
    t, u, v = (torch.as_tensor(rng.uniform(0, 9, 5).astype(np.float32))
               for _ in range(3))
    n = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    m = torch.arange(5, dtype=torch.int32)
    p = torch.arange(5, dtype=torch.int32) * 1000 + 262143 - 5000
    for a, b in zip(fsw.unpack_best_planar(fsw.pack_best_planar(t, n, u, v, m, p)),
                    (t, n, u, v, m, p)):
        assert torch.equal(a, b)
    for a, b in zip(fsw.unpack_best_sphere(fsw.pack_best_sphere(t, n, u, m, p)),
                    (t, n, u, m, p)):
        assert torch.equal(a, b)


def test_cpu_tensors_launch_nothing_and_kernel_refuses_them():
    table = torch.zeros((2, 9, 128))
    rays = torch.zeros((4, 8))
    ids = torch.zeros((4, 2), dtype=torch.int32)
    nears = torch.full((4, 2), float("inf"))
    best = torch.zeros((4, 8))
    best[:, 0] = 10.0
    fsw.reset_launches()
    out = fsw.sweep(rays, ids, nears, best, table, TMIN, False, False)
    assert torch.equal(out, best) and fsw.LAUNCHES == {
        "visit_sweep": 0, "visit_sweep_sub": 0, "visit_sweep_q16": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fsw.sweep_kernel(rays, ids, nears, best, table, TMIN, False, False)


@pytest.mark.parametrize("kind", ["tri", "quad"])
def test_q16_group_boxes_hold_every_candidate(kind):
    """K8's cull is conservative: every candidate t of the plain slot test
    (``_planar_slot``, unbounded above) lies in its group's padded [entry,
    exit] as the kernel computes it (``q16_group_boxes``,
    ``q16_group_slab``), on tests/torch_sweep_cases.py's grazing set: rays
    aimed at every vertex (the boxes' extreme ones among them) from random
    directions, along the axes and grazing, on small and large chunks at
    +-1,200 units with slivers and dead lanes (``procgen.grazing_table``,
    ``vertex_rays``), and a quantum-wide primitive near the origin, hit by
    rays aimed where the clamp of |n|^2 to 1e-20 makes it reach. The groups
    never skipped (infinite pad) are exactly those holding a primitive whose
    1/sin of its edges' angle exceeds ``Q16_MAX_SKEW`` or whose |n|^2 lies
    below 1e-20. Without the pad some candidates fall outside: the pad is
    needed."""
    q, rays, chunk = cases.q16_grazing(kind, "cpu")
    tri = kind == "tri"
    R = rays.shape[0]
    row = fsw.dequant_q16(q.words[chunk], q.lo[chunk], q.scale[chunk])
    ts, _ = fsw._planar_slot(rays[:, 0:3], rays[:, 3:6], row, TMIN,
                             torch.full((R,), float("inf")), tri)
    cand = torch.isfinite(ts)
    assert int(cand.sum()) > R // 2
    group = torch.arange(fsw.CHUNK_C) // fsw.Q16_GROUP
    outside = {}
    for pad in (fsw.Q16_PAD, 0.0):
        blo, bhi, A, C, live = fsw.q16_group_boxes(q.words, q.lo, q.scale, pad, tri)
        entry, exit_ = fsw.q16_group_slab(rays, blo[chunk], bhi[chunk], A[chunk],
                                          C[chunk])
        inside = (entry[:, group] <= ts) & (ts <= exit_[:, group])
        assert bool(live[chunk][:, group][cand].all())
        outside[pad] = int((cand & ~inside).sum())
        if pad:   # never skipped: the groups holding a live S above the limit
            x = fsw.dequant_q16(q.words, q.lo, q.scale)
            eu, ev = x[:, 3:6], x[:, 6:9]
            # the kernel's normal, products and differences rounded on their
            # own: zero means never hit, and left out
            n32 = torch.stack(fsw._cross3(*eu.unbind(1), *ev.unbind(1)), 1)
            eu, ev = eu.double(), ev.double()
            skew = (eu.norm(dim=1) * ev.norm(dim=1)
                    / torch.linalg.cross(eu, ev, dim=1).norm(dim=1))
            thin = cases.q16_thin(q)                    # w = n / |n|^2 clamped
            ill = ((n32 != 0).any(1) & (skew > fsw.Q16_MAX_SKEW)) | thin
            never = torch.isinf(C).all(-1)
            assert torch.equal(never, ill.reshape(-1, 4, fsw.Q16_GROUP).any(-1))
            assert bool(never.any()) and bool(torch.isfinite(C).any())
            # the thin primitives are hit, far outside their boxes' unpadded
            # faces, by the rays aimed at the region the clamp adds
            assert bool((cand & thin[chunk]).any())
    assert outside[fsw.Q16_PAD] == 0
    assert outside[0.0] > 0


def test_q16_group_boxes_leave_dead_lanes_out():
    """A group of dead lanes only (eu = ev = 0: zero normal, never hit) is
    not live; a live group's box is the integer hull of its live lanes'
    points, the fourth corner included for quads."""
    q, _, _ = cases.q16_grazing("quad", "cpu", K=1)
    words = q.words.clone()
    words[:, :, 64:96] = words[:, :, 50:51]          # group 2: dead lanes only
    for tri in (True, False):
        blo, bhi, _, _, live = fsw.q16_group_boxes(words, q.lo, q.scale, fsw.Q16_PAD, tri)
        assert live[0].tolist() == [True, True, False, True]
        x = fsw.dequant_q16(words, q.lo, q.scale)[0]
        c, eu, ev = x[0:3, 96:], x[3:6, 96:], x[6:9, 96:]
        pts = torch.stack([c, c + eu, c + ev] + ([] if tri else [c + eu + ev]))
        assert bool((pts.amin((0, 2)) >= blo[0, 3] - 1e-3).all())
        assert bool((pts.amax((0, 2)) <= bhi[0, 3] + 1e-3).all())
