"""The per-ray accelerator's opt-in routes (``CRT_SUBTILE``,
``CRT_SWEEP_Q16``) and the JAX package's other switches, against the JAX
package and the chunk-scan oracle on the CPU.

Scenes are tests/test_perray.py's and tests/test_q16_sweep.py's: 700 random
triangles of seed 8 (6 chunks) and 700 random spheres of seed 7, the
port's tables converted from the JAX build. Both packages read the
switches per call, set here with ``monkeypatch.setenv``. Tolerances:

- tables (sub-tile boxes and rows, quantized words) bitwise JAX's;
- sub-tile route: hit masks and pids equal to the oracle's and to JAX's
  sub-tile route, t within rtol 1e-4 (spheres rtol 5e-4, atol 3e-4, as
  tests/test_perray.py:238), at CS 64, 32, 8 and (triangles) 2; at CS 2
  and 8 the route's hits equal the chunk route's, and at CS 1, 4 and 8
  the sub-tile sweep equals its stage decomposition bit for bit;
- quantized rows: against JAX's q16, hit masks equal on >= 99.9% of rays,
  pids on >= 99.9% of hits, t within rtol 1e-4 where pids agree; against
  the oracle, JAX's own contract (tests/test_q16_sweep.py:35-56);
- the 16 px colonnade under each route (``CRT_ACCEL=ray``) against JAX
  under the same switches: mean within 2e-3, the share of pixels within
  1e-3 printed and at least 0.9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models import scene as jscene
from cpu_ray_tracing_implementation_tpu.ops import perray as jperray
from cpu_ray_tracing_implementation_tpu_torch import cli
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import perray
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

TMIN = 1e-3
SWITCHES = ("CRT_SUBTILE", "CRT_SUBC", "CRT_RAYV_SUB", "CRT_SWEEP_Q16", "CRT_RAYV")


@pytest.fixture(scope="module")
def tri_chunks():
    rng = np.random.default_rng(8)
    b = jscene.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    jc = b.build().tri_chunks
    return jc, _to_torch(jc, ch.PlanarChunks)


@pytest.fixture(scope="module")
def sphere_chunks():
    rng = np.random.default_rng(7)
    b = jscene.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        b.sphere(c, rng.uniform(0.05, 0.3), m)
    jc = b.build().sphere_chunks
    return jc, _to_torch(jc, ch.SphereChunks)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread here (this file's tensors are small, and the
    suite runs several workers at once), restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch):
    """Set the switches for both packages, the others unset."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def set_(**kw):
        for name, value in kw.items():
            monkeypatch.setenv(name, str(value))
    return set_


def _to_torch(jchunks, cls):
    return cls(*[torch.as_tensor(np.array(getattr(jchunks, f.name)))
                 for f in dataclasses.fields(cls)])


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    return org, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _closest(kind, chunks, jchunks, org, dirs, tmax=float("inf")):
    """(port, JAX, oracle) closest hits of one ray batch: (t, pid) numpy;
    ``tmax`` a scalar or a per-ray numpy cap."""
    to, td = torch.as_tensor(org), torch.as_tensor(dirs)
    jo, jd = jnp.asarray(org), jnp.asarray(dirs)
    if isinstance(tmax, np.ndarray):
        tmax, jtmax = torch.as_tensor(tmax), jnp.asarray(tmax)
    else:
        jtmax = tmax
    if kind == "sphere":
        tt = torch.zeros(org.shape[0])
        t_p, pay_p = perray.sphere_closest_perray(to, td, tt, chunks, TMIN, tmax)
        t_j, pay_j = jperray.sphere_closest_perray(jo, jd, jnp.zeros(org.shape[0]),
                                                   jchunks, TMIN, jtmax)
        t_o, pay_o = ch.sphere_closest(to, td, tt, chunks, TMIN, tmax=tmax)
    else:
        t_p, pay_p = perray.planar_closest_perray(to, td, chunks, TMIN, True, tmax)
        t_j, pay_j = jperray.planar_closest_perray(jo, jd, jchunks, TMIN, True, jtmax)
        t_o, pay_o = ch.planar_closest(to, td, chunks, TMIN, True, tmax=tmax)
    return [(np.asarray(t), np.asarray(pay[-1])) for t, pay in
            ((t_p, pay_p), (t_j, pay_j), (t_o, pay_o))]


@pytest.mark.parametrize("kind,CS", [("tri", 32), ("tri", 64), ("sphere", 32),
                                     ("sphere", 64), ("tri", "q16")])
def test_mode_tables_are_jax_bit_for_bit(tri_chunks, sphere_chunks, kind, CS):
    jc, tc = tri_chunks if kind == "tri" else sphere_chunks
    if CS == "q16":
        words, lo, scale = jperray._planar_table_q16(jc)
        q = perray.planar_tables(tc).q16()
        assert q.words.dtype == torch.int32 and q.words.shape == (6, 5, 128)
        np.testing.assert_array_equal(_bits(words).reshape(6, 5, 128),
                                      q.words.numpy().view(np.uint32))
        np.testing.assert_array_equal(_bits(lo), _bits(q.lo))
        np.testing.assert_array_equal(_bits(scale), _bits(q.scale))
        return
    K, C = jc.mat.shape
    bounds = (jperray._subtile_bounds_sphere if kind == "sphere"
              else jperray._subtile_bounds_planar)(jc, CS)
    table = (jperray._sphere_table(jc) if kind == "sphere" else jperray._planar_table(jc))
    F = 7 if kind == "sphere" else 9
    rows = jperray._table_sub(table, K, F, C, CS)
    tabs = (perray.sphere_tables if kind == "sphere" else perray.planar_tables)(tc)
    sub = tabs.subtile(CS)
    assert tabs.subtile(CS) is sub                  # built once, then cached
    KG = K * (C // CS)
    assert sub.table.shape == (KG, F, CS)
    np.testing.assert_array_equal(_bits(rows).reshape(KG, F, CS), _bits(sub.table))
    lo, hi = perray.subtile_bounds(tc, CS)
    np.testing.assert_array_equal(_bits(bounds[0]), _bits(lo))
    np.testing.assert_array_equal(_bits(bounds[1]), _bits(hi))
    assert torch.equal(sub.boxes, fs.pack_boxes(lo, hi))


@pytest.mark.parametrize("kind,CS", [("tri", 32), ("tri", 64), ("sphere", 32),
                                     ("sphere", 64), ("tri", 8), ("sphere", 8),
                                     ("tri", 2)])
def test_subtile_route_matches_oracle_and_jax(tri_chunks, sphere_chunks, env,
                                              monkeypatch, kind, CS):
    """``CRT_RAYV_SUB=8``: 8 slots a phase at CS 32 and 64 (many phases),
    16 at CS 8, 64 at CS 2 (one phase of two chained selections of 32);
    every other ray capped at t = 4.0."""
    jc, tc = tri_chunks if kind == "tri" else sphere_chunks
    env(CRT_SUBTILE=1, CRT_SUBC=CS, CRT_RAYV_SUB=8)
    org, dirs = _rays(2 if kind == "tri" else 21, 800 if kind == "tri" else 512)
    tmax = np.where(np.arange(org.shape[0]) % 2 == 1, 4.0, np.inf).astype(np.float32)
    sizes = []
    plain = fs.cull_select_plain
    monkeypatch.setattr(fs, "cull_select_plain",
                        lambda *a, **k: sizes.append(a[3]) or plain(*a, **k))
    perray.reset_phases()
    (t_p, p_p), (t_j, p_j), (t_o, p_o) = _closest(kind, tc, jc, org, dirs, tmax)
    if CS == 2:                                   # each phase chains two selections
        assert sizes == [32, 32] * perray.PHASES["phases"]
    else:                                         # the exactness loop re-selects
        assert perray.PHASES["phases"] >= 2 and max(sizes) <= 16
    hit = np.isfinite(t_p)
    assert hit.sum() > 50 and hit[1::2].sum() > 20
    rtol, atol = (5e-4, 3e-4) if kind == "sphere" else (1e-4, 0.0)
    for t_ref, p_ref in ((t_o, p_o), (t_j, p_j)):
        np.testing.assert_array_equal(np.isfinite(t_ref), hit)
        np.testing.assert_array_equal(p_p[hit], p_ref[hit])
        np.testing.assert_allclose(t_p[hit], t_ref[hit], rtol=rtol, atol=atol)
    assert (t_p[hit] <= tmax[hit]).all()


def test_q16_route_matches_jax_and_the_oracle(tri_chunks, env):
    jc, tc = tri_chunks
    env(CRT_SWEEP_Q16=1, CRT_SUBTILE=1)            # q16 wins for planar tables
    org, dirs = _rays(0, 800)
    fsw.reset_launches()
    (t_p, p_p), (t_j, p_j), (t_o, p_o) = _closest("tri", tc, jc, org, dirs)
    hit_p, hit_j, hit_o = np.isfinite(t_p), np.isfinite(t_j), np.isfinite(t_o)
    assert (hit_p == hit_j).mean() >= 0.999
    both = hit_p & hit_j
    assert both.sum() > 100
    agree = p_p[both] == p_j[both]
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(t_p[both][agree], t_j[both][agree], rtol=1e-4)
    # JAX's own contract against the oracle (tests/test_q16_sweep.py:35-56)
    assert (hit_o == hit_p).mean() >= 0.995
    both = hit_o & hit_p
    rel = np.abs(t_p[both] - t_o[both]) / t_o[both]
    assert rel.max() < 0.05 and np.median(rel) < 2e-3
    assert (p_p[both] == p_o[both]).mean() >= 0.99


@pytest.mark.parametrize("CS", [1, 4, 8])
def test_subtile_sweep_is_its_decomposition_at_narrow_widths(tri_chunks, sphere_chunks,
                                                             CS):
    """At CS 1, 4 and 8, on the route's own lists (K3 on the sub-tile boxes
    at ``subtile_v`` slots: 128, 32 and 24, the first chained), the
    sub-tile sweep equals K7's decomposition (``sweep_fold_plain``) at the
    same width, all 8 columns bit for bit, for triangles and spheres."""
    for kind, (_, tc) in (("tri", tri_chunks), ("sphere", sphere_chunks)):
        sphere = kind == "sphere"
        tabs = (perray.sphere_tables if sphere else perray.planar_tables)(tc)
        sub = tabs.subtile(CS)
        KG = sub.table.shape[0]
        org, dirs = (torch.as_tensor(x) for x in _rays(9, 300))
        time = torch.as_tensor(np.random.default_rng(9).uniform(0, 1, 300),
                               dtype=torch.float32)
        cap = torch.full((300,), 30.0)
        V = perray.subtile_v(KG, CS)
        ids, nears, _ = fs.cull_select(fs.pack_rays(org, dirs, cap), sub.boxes,
                                       fs.first_excl(300, "cpu"), V, KG, TMIN)
        z = torch.zeros(300)
        best = (fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
                if sphere else
                fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int()))
        rays = fsw.pack_rays(org, dirs, time if sphere else None)
        got = fsw.sweep_sub(rays, ids, nears, best, sub.table, TMIN, True, sphere)
        ref = fsw.sweep_fold_plain(rays, ids, nears, best, sub.table, TMIN, True, sphere)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert int((got[:, 0] < cap).sum()) > 30


def test_q16_plain_is_the_plain_sweep_on_dequantized_rows(tri_chunks):
    """K8's plain version equals K4's on the dequantized table bit for bit,
    and the sub-tile sweep's decomposition (``sweep_fold_plain``, K7's
    stages) equals ``sweep_plain`` at a width of 32."""
    _, tc = tri_chunks
    tabs = perray.planar_tables(tc)
    q = tabs.q16()
    org, dirs = (torch.as_tensor(x) for x in _rays(3, 400))
    cap = torch.full((400,), 30.0)
    rays = fsw.pack_rays(org, dirs)
    z = torch.zeros(400)
    best = fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int())
    ids, nears, _ = fs.cull_select(fs.pack_rays(org, dirs, cap), tabs.boxes,
                                   fs.first_excl(400, "cpu"), 4, 6, TMIN)
    deq = fsw.dequant_q16(q.words, q.lo, q.scale)
    got = fsw.sweep_q16(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN, True)
    ref = fsw.sweep_plain(rays, ids, nears, best, deq, TMIN, True, False)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert int((got[:, 0] < cap).sum()) > 50
    sub = tabs.subtile(32)
    ids, nears, _ = fs.cull_select(fs.pack_rays(org, dirs, cap), sub.boxes,
                                   fs.first_excl(400, "cpu"), 24, 24, TMIN)
    got = fsw.sweep_fold_plain(rays, ids, nears, best, sub.table, TMIN, True, False)
    ref = fsw.sweep_sub(rays, ids, nears, best, sub.table, TMIN, True, False)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_kernel_wrappers_refuse_cpu_tensors_and_gradients(tri_chunks):
    _, tc = tri_chunks
    tabs = perray.planar_tables(tc)
    q, sub = tabs.q16(), tabs.subtile(32)
    org, dirs = (torch.as_tensor(x) for x in _rays(4, 8))
    rays = fsw.pack_rays(org, dirs)
    ids = torch.zeros((8, 4), dtype=torch.int32)
    nears = torch.zeros((8, 4))
    best = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fsw.sweep_sub_kernel(rays, ids, nears, best, sub.table, TMIN, True, False)
    with pytest.raises(ValueError, match="CUDA"):
        fsw.sweep_q16_kernel(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN, True)
    with pytest.raises(RuntimeError, match="no backward"):
        fsw.sweep_sub_kernel(rays.requires_grad_(), ids, nears, best, sub.table, TMIN,
                             True, False)
    with pytest.raises(ValueError, match="K7 takes"):
        fsw.sweep_sub_kernel(rays.detach(), ids, nears, best, sub.table[:, :, :3],
                             TMIN, True, False)
    assert fsw.LAUNCHES == {"visit_sweep": 0, "visit_sweep_sub": 0, "visit_sweep_q16": 0}


def test_switch_edges(tri_chunks, env):
    """``CRT_SUBC`` not dividing the chunk width takes the chunk route (no
    sub-tile table is built); the narrow widths 2 and 8 render, with the
    chunk route's hits; K3's kernel entry refuses a V above 32 (the wrapper
    chains those); ``CRT_RAYV`` sets the chunk route's V."""
    _, tc = tri_chunks
    org, dirs = (torch.as_tensor(x) for x in _rays(5, 300))
    tabs = perray.planar_tables(tc)
    perray.reset_phases()
    t0, pay0 = perray.planar_closest_perray(org, dirs, tc, TMIN, True, tabs=tabs)
    phases0 = perray.PHASES["phases"]
    env(CRT_SUBTILE=1, CRT_SUBC=48)
    assert perray.route(128, True) == "chunk"
    perray.reset_phases()
    t1, pay1 = perray.planar_closest_perray(org, dirs, tc, TMIN, True, tabs=tabs)
    assert perray.PHASES["phases"] == phases0 and tabs.modes == {}
    assert torch.equal(t0, t1) and torch.equal(pay0[-1], pay1[-1])
    for cs in (2, 8):
        env(CRT_SUBC=cs)
        assert perray.route(128, True) == "subtile"
        t_cs, pay_cs = perray.planar_closest_perray(org, dirs, tc, TMIN, True, tabs=tabs)
        assert cs in tabs.modes
        assert torch.equal(t_cs, t0) and torch.equal(pay_cs[-1], pay0[-1])
    with pytest.raises(ValueError, match="V in 1..32"):
        fs.check_v(33)
    env(CRT_SUBTILE=0, CRT_RAYV=2)
    perray.reset_phases()
    t2, pay2 = perray.planar_closest_perray(org, dirs, tc, TMIN, True, tabs=tabs)
    assert perray.PHASES["phases"] > phases0
    assert torch.equal(torch.isfinite(t2), torch.isfinite(t0))
    assert torch.equal(pay2[-1], pay0[-1])


@pytest.mark.parametrize("mode", ["subtile", "q16"])
def test_gradient_under_each_route_is_the_default_routes(tri_chunks, env, mode):
    """The backward replays the winner on the exact f32 chunks whichever
    route ran forward: with the rays whose pid differs weighted out, the
    gradients equal the chunk route's."""
    _, tc = tri_chunks
    org, dirs = _rays(6, 600)
    w = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 1.5, (600, 6)),
                        dtype=torch.float32)

    def run(weights=None):
        leaves = [torch.as_tensor(org).requires_grad_(), torch.as_tensor(dirs).requires_grad_(),
                  tc.corner.clone().requires_grad_(), tc.eu.clone().requires_grad_(),
                  tc.ev.clone().requires_grad_()]
        chunks = dataclasses.replace(tc, corner=leaves[2], eu=leaves[3], ev=leaves[4])
        t, (n, u, v, _, pid) = perray.planar_closest_perray(leaves[0], leaves[1], chunks,
                                                            TMIN, True)
        hit = torch.isfinite(t)
        out = torch.stack([torch.where(hit, t, 0.0), n[:, 0], n[:, 1], n[:, 2], u, v], 1)
        ww = w if weights is None else w * weights[:, None]
        (out * ww).sum().backward()
        return pid, hit, [x.grad for x in leaves]

    pid0, hit0, _ = run()
    env(**({"CRT_SUBTILE": 1} if mode == "subtile" else {"CRT_SWEEP_Q16": 1}))
    pid1, hit1, _ = run()
    same = (pid1 == pid0) & (hit1 == hit0)
    assert float(same.float().mean()) >= 0.999 and int(hit0.sum()) > 50
    _, _, g1 = run(same.float())
    env(CRT_SUBTILE=0, CRT_SWEEP_Q16=0)
    _, _, g0 = run(same.float())
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["subtile", "q16"])
def test_colonnade_render_under_each_route_matches_jax(env, monkeypatch, mode):
    """The 16 px colonnade (71 chunks) on the per-ray route under the
    switch, in both packages, at the golden workload (4 spp, depth 3, key
    42)."""
    monkeypatch.setenv("CRT_ACCEL", "ray")
    env(**({"CRT_SUBTILE": 1} if mode == "subtile" else {"CRT_SWEEP_Q16": 1}))
    jax.clear_caches()          # the switches are read when JAX traces
    js, jc = jcat.sponza(width=16, spp=4, max_depth=3)
    jkey = jax.random.key(42)
    ref = np.asarray(jint.render_image(js, jc, jkey))
    jax.clear_caches()
    fsw.reset_launches()
    img = integrator.render_image(convert.scene_from_numpy(js, device="cpu"),
                                  convert.camera_from_numpy(jc, device="cpu"),
                                  convert.key_from_numpy(jax.random.key_data(jkey))).numpy()
    assert np.isfinite(img).all() and img.shape == ref.shape
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    share = float((np.abs(img - ref) <= 1e-3).mean())
    print(f"colonnade 16 px under {mode}: mean {img.mean():.6f} (JAX {ref.mean():.6f}), "
          f"share of pixels within 1e-3 {share:.4f}")
    assert share >= 0.9


def test_fit_scene_honours_crt_replay(env, monkeypatch):
    """``CRT_REPLAY=0`` sends ``fit_scene`` (and ``loss_and_grads``' default)
    to the chunk-scan VJP route, as it does in the JAX package; both routes
    give the same loss and, within the replay test's tolerance, the same
    fitted scene."""
    scene, cam = catalog.cornell_box(width=8, spp=2, max_depth=2, device="cpu")
    target = torch.zeros((cam.height, cam.width, 3))
    seen = []
    real = diff._value_and_grad

    def spy(*args):
        seen.append(args[5])
        return real(*args)

    monkeypatch.setattr(diff, "_value_and_grad", spy)
    fit = {}
    for value in ("1", "0"):
        monkeypatch.setenv("CRT_REPLAY", value)
        assert diff._use_replay(scene) is (value == "1")
        fit[value] = diff.fit_scene(scene, cam, target, steps=1, lr=0.3, spp=2)
    assert seen == [True, False]
    np.testing.assert_allclose(fit["0"][1], fit["1"][1], rtol=1e-5)
    for name, p in diff.scene_params(fit["0"][0]).items():
        torch.testing.assert_close(p, diff.scene_params(fit["1"][0])[name], rtol=2e-3,
                                   atol=1e-5)


def test_cli_help_states_each_switch():
    text = cli.build_parser().format_help()
    for name in ("CRT_RAYV", "CRT_SUBTILE", "CRT_SUBC", "CRT_RAYV_SUB", "CRT_SWEEP_Q16",
                 "CRT_REPLAY", "CRT_PACKET", "CRT_TILE", "CRT_UNROLL", "CRT_DENSE_PALLAS",
                 "CRT_NO_PALLAS", "CRT_PALLAS_SWEEP"):
        assert name in text, name
