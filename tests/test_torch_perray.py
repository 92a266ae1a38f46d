"""The port's per-ray closest hit (K3 + K4 phase loop, plain versions on
the CPU) against the JAX package's Pallas phase loop and the chunk-scan
oracle.

JAX runs ``perray.planar_closest_perray`` / ``sphere_closest_perray``
with ``_use_pallas_select`` and ``_use_pallas_sweep`` set to True, so both
of its Pallas kernels run in interpret mode (as
tests/test_pallas_select.py:103-121 does), at V = 3 and 4 to force many
phases. The oracle is the port's ``ops/chunked.py`` scan. Equal hit masks
and pids, t within rtol 1e-4. Rays include per-ray caps, dead lanes
(cap = tmin) and misses, whose material is the sentinel 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import scene as jscene
from cpu_ray_tracing_implementation_tpu.ops import perray as jperray
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import perray

TMIN = 1e-3
R = 300
INF = float("inf")


def _chunks(kind, n=1300, builder=jscene.SceneBuilder):
    """Chunked (BVH-ordered) random table of n primitives, built by the JAX
    package's builder or, with ``builder=sc.SceneBuilder``, by the port's
    (the same tables: tests/test_torch_scene.py)."""
    rng = np.random.default_rng({"tri": 8, "quad": 9, "sphere": 12}[kind])
    b = builder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.5, 0.5, 0.5)),
            b.dielectric(1.5)]
    for i, c in enumerate(rng.normal(0, 3.0, (n, 3))):
        m = mats[1 + i % 2]          # material 0 never appears: miss sentinel
        if kind == "sphere":
            b.moving_sphere(c, c + rng.normal(0, 0.1, 3),
                            abs(rng.normal(0.2, 0.05)) + 0.05, m)
        elif kind == "tri":
            v = c + rng.normal(0, 0.3, (3, 3))
            b.triangle(v[0], v[1], v[2], m)
        else:
            b.quad(c, rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3), m)
    s = b.build() if builder is jscene.SceneBuilder else b.build("cpu")
    return {"tri": s.tri_chunks, "quad": s.quad_chunks,
            "sphere": s.sphere_chunks}[kind]


def _to_torch(jchunks, cls):
    return cls(*[torch.as_tensor(np.array(getattr(jchunks, f.name)))
                 for f in dataclasses.fields(cls)])


def _rays(seed, n=R):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    cap = np.full(n, 40.0, np.float32)
    cap[:40] = rng.uniform(0.3, 3.0, 40)        # per-ray tmax
    cap[40:60] = TMIN                           # dead lanes
    return org, dirs, time, cap


@pytest.mark.parametrize("V", [3, 4])
@pytest.mark.parametrize("kind", ["tri", "quad", "sphere"])
def test_perray_matches_jax_pallas_loop_and_oracle(kind, V, monkeypatch):
    monkeypatch.setattr(jperray, "_use_pallas_select", lambda tmin: True)
    monkeypatch.setattr(jperray, "_use_pallas_sweep", lambda: True)
    monkeypatch.setenv("CRT_RAYV", str(V))
    jchunks = _chunks(kind)
    org, dirs, time, cap = _rays(V)
    jo, jd, jt, jc = (jnp.asarray(x) for x in (org, dirs, time, cap))
    to, td, tt, tc = (torch.as_tensor(x) for x in (org, dirs, time, cap))
    perray.reset_phases()
    if kind == "sphere":
        chunks = _to_torch(jchunks, ch.SphereChunks)
        t_j, pay_j = jperray.sphere_closest_perray(jo, jd, jt, jchunks, TMIN, jc)
        t_p, pay_p = perray.sphere_closest_perray(to, td, tt, chunks, TMIN, tc,
                                                  V=V)
        t_o, pay_o = ch.sphere_closest(to, td, tt, chunks, TMIN, tmax=tc)
    else:
        tri = kind == "tri"
        chunks = _to_torch(jchunks, ch.PlanarChunks)
        t_j, pay_j = jperray.planar_closest_perray(jo, jd, jchunks, TMIN, tri, jc)
        t_p, pay_p = perray.planar_closest_perray(to, td, chunks, TMIN, tri, tc,
                                                  V=V)
        t_o, pay_o = ch.planar_closest(to, td, chunks, TMIN, tri, tmax=tc)
    # the oracle's sphere test expands |o - c|^2 = |o|^2 - 2 o.c + |c|^2,
    # which cancels (kernel K2's form); the sweep subtracts first. Their t
    # differ by up to ~1e-4 absolute at these coordinates, as
    # tests/test_pallas_sweep.py:114-117 notes for the JAX pair.
    oracle_atol = 2e-4 if kind == "sphere" else 0.0
    assert perray.PHASES["calls"] == 1 and perray.PHASES["phases"] >= 3
    t_p, t_j, t_o = t_p.numpy(), np.asarray(t_j), t_o.numpy()
    hit = np.isfinite(t_p)
    assert hit.sum() > 20 and not hit[40:60].any()
    for t_ref, pay_ref, atol in ((t_j, pay_j, 0.0), (t_o, pay_o, oracle_atol)):
        np.testing.assert_array_equal(np.isfinite(t_ref), hit)
        np.testing.assert_allclose(t_p[hit], t_ref[hit], rtol=1e-4, atol=atol)
        np.testing.assert_array_equal(pay_p[-1].numpy()[hit],
                                      np.asarray(pay_ref[-1])[hit])       # pid
        np.testing.assert_array_equal(pay_p[-2].numpy(),
                                      np.asarray(pay_ref[-2]))            # mat
    assert (pay_p[-2].numpy()[~hit] == 0).all()


def test_gradients_are_refused():
    """The kernels' own wrappers refuse an input that needs a gradient (their
    outputs carry no graph); the per-ray drop-in takes such an input through
    its winner-replay backward instead (tests/test_torch_perray_grad.py)."""
    jchunks = _chunks("tri")
    org, dirs, _, cap = _rays(1)
    org_t = torch.as_tensor(org).requires_grad_(True)
    chunks = _to_torch(jchunks, ch.PlanarChunks)
    rays = fs.pack_rays(org_t, torch.as_tensor(dirs), torch.as_tensor(cap))
    with pytest.raises(RuntimeError, match="no backward"):
        fs.cull_select_kernel(rays, perray.planar_tables(chunks).boxes,
                              fs.first_excl(org.shape[0], "cpu"), 4,
                              chunks.corner.shape[0], TMIN)
    t, _ = perray.planar_closest_perray(org_t, torch.as_tensor(dirs), chunks, TMIN,
                                        True, torch.as_tensor(cap))
    assert t.grad_fn is not None


def test_chunked_tables_take_the_per_ray_route(monkeypatch):
    """A 71-chunk table, which ``auto`` sends to the tile-packet route in
    both packages, takes the port's per-ray route under ``CRT_ACCEL=ray``,
    capped as JAX caps it (``_packet_cap``: the ray's exit from the scene
    AABB, tmin for dead lanes), and gives the packet route's hits."""
    from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
    from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect

    assert jisect._auto_mode(71) == "packet"
    scene, _ = catalog.sponza(width=16, spp=1, device="cpu")
    js, _ = jcat.sponza(width=16, spp=1)
    assert scene.tri_chunks.corner.shape[0] == 71
    org, dirs, time, _ = _rays(7)
    org = org * 300.0                       # inside the hall
    alive = np.arange(R) % 7 != 0
    cap = isect._packet_cap(scene, torch.as_tensor(org), torch.as_tensor(dirs),
                            torch.as_tensor(alive), INF, TMIN)
    jcap = jisect._packet_cap(js, jnp.asarray(org), jnp.asarray(dirs),
                              jnp.asarray(alive), INF, TMIN)
    np.testing.assert_allclose(cap.numpy(), np.asarray(jcap), rtol=1e-6)
    perray.reset_phases()
    args = (scene, torch.as_tensor(org), torch.as_tensor(dirs), torch.as_tensor(time),
            TMIN, torch.zeros((R, 0)))
    monkeypatch.delenv("CRT_ACCEL", raising=False)
    packet_hit = isect.intersect_brute(*args, active=torch.as_tensor(alive))
    assert perray.PHASES["calls"] == 0
    monkeypatch.setenv("CRT_ACCEL", "ray")
    hit = isect.intersect_brute(*args, active=torch.as_tensor(alive))
    assert perray.PHASES["calls"] == 1
    assert torch.equal(hit.valid, packet_hit.valid) and torch.equal(hit.mat, packet_hit.mat)
    torch.testing.assert_close(hit.t, packet_hit.t, rtol=1e-4, atol=0)
    assert int(hit.valid.sum()) > 20
    # a dead lane (cap = tmin) hits no triangle; the dense light quad, like
    # JAX's dense tables, does not read the cap
    dead = torch.as_tensor(~alive) & hit.valid
    light_mat = int(scene.quads.mat[0])
    assert (hit.mat[dead] == light_mat).all() and light_mat != 0


def _unmarked_loop(rays, srays, tabs, K, V, best, triangle, sphere):
    """The phase loop as it ran before done rays were marked, on the plain
    K3 and K4: (phases, best, rays still live after each phase)."""
    excl = fs.first_excl(rays.shape[0], "cpu")
    phases, live = 0, []
    while True:
        ids, nears, rest = fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN)
        best = fsw.sweep_plain(srays, ids, nears, best, tabs.table, TMIN, triangle,
                               sphere)
        phases += 1
        excl = fs.next_excl(ids, nears)
        live.append(int((rest < best[:, 0]).sum()))
        if not live[-1]:
            return phases, best, live


@pytest.mark.parametrize("kind", ["quad", "sphere"])
def test_marking_done_rays_keeps_the_phases_and_hits(kind):
    """The phase loop marks done rays exhausted; its phase count, the rays
    it reports live per phase and its best hits equal the unmarked loop's,
    which is computed here from the plain K3 and K4. 120 rays against 700
    primitives in 6 chunks (the port's own build), 2 visit slots a phase:
    3 phases."""
    n_rays = 120
    chunks = _chunks(kind, 700, sc.SceneBuilder)
    org, dirs, time, cap = (torch.as_tensor(x) for x in _rays(5, n_rays))
    sphere = kind == "sphere"
    if sphere:
        tabs = perray.sphere_tables(chunks)
        K = chunks.rad.shape[0]
    else:
        tabs = perray.planar_tables(chunks)
        K = chunks.corner.shape[0]
    V = 2
    z = torch.zeros(n_rays)
    best0 = (fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
             if sphere else
             fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int()))
    srays = fsw.pack_rays(org, dirs, time if sphere else None)
    want, best_u, live_u = _unmarked_loop(fs.pack_rays(org, dirs, cap), srays, tabs, K,
                                          V, best0, False, sphere)
    perray.reset_phases()
    best = perray._phase_loop(
        org, dirs, cap, tabs, K, TMIN, V,
        lambda ids, nears, b: fsw.sweep(srays, ids, nears, b, tabs.table, TMIN, False,
                                        sphere), best0)
    assert want >= 3
    assert perray.PHASES["calls"] == 1 and perray.PHASES["phases"] == want
    assert perray.PHASES["live"] == [n_rays] + live_u[:-1]
    # the same winners (pid, mat) and hit masks; the float columns within
    # the rtol 1e-4 of the suite's t checks (two CPU runs of the plain
    # sweep once gave one ray's t 13 ulp apart)
    np.testing.assert_array_equal(best[:, 6:8].numpy(), best_u[:, 6:8].numpy())
    np.testing.assert_array_equal((best[:, 0] < cap).numpy(), (best_u[:, 0] < cap).numpy())
    np.testing.assert_allclose(best[:, :6].numpy(), best_u[:, :6].numpy(), rtol=1e-4,
                               atol=1e-6)
