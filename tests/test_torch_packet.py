"""The port's tile-packet closest hit (plain per-tile loop on the CPU)
against the JAX package's ``ops/packet.py`` and the chunk-scan oracle.

Same random BVH-ordered tables and rays as tests/test_torch_perray.py,
with per-ray caps, dead lanes (cap = tmin) and misses. Against JAX's
``planar_closest_packet`` / ``sphere_closest_packet`` (its ``map``
schedule) at tiles of 2,048 (one tile), 64 (five, the last padded) and
32 (``packet.AUTO_TILE``; ten, the last padded):
equal hit masks, materials and pids, t within rtol 1e-4 (spheres also
atol 2e-4, the two packages' rounding of the expanded quadratic), every other
payload field within atol 1e-3 (normal and center 1e-4). The VJP of the
winner replay against JAX's custom VJP at the JAX package's gradient
tolerances (tests/test_replay.py:106-112). Sphereflake at 16 px takes the
packet route under ``auto`` in both packages.
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
from cpu_ray_tracing_implementation_tpu.ops import packet as jpacket
from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import packet
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

TMIN = 1e-3
R = 300
INF = float("inf")
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
_TABLES = {}


def _chunks(kind, n=1300):
    """A chunked random table of n primitives built by the JAX package (the
    port's builder gives the same tables: tests/test_torch_scene.py)."""
    if kind not in _TABLES:
        rng = np.random.default_rng({"tri": 8, "quad": 9, "sphere": 12}[kind])
        b = jscene.SceneBuilder()
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
        s = b.build()
        _TABLES[kind] = {"tri": s.tri_chunks, "quad": s.quad_chunks,
                         "sphere": s.sphere_chunks}[kind]
    return _TABLES[kind]


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


def _port(kind, org, dirs, time, cap, **kw):
    jchunks = _chunks(kind)
    to, td, tt = (torch.as_tensor(x) for x in (org, dirs, time))
    tc = torch.as_tensor(cap) if np.ndim(cap) else cap
    if kind == "sphere":
        return packet.sphere_closest_packet(to, td, tt, _to_torch(jchunks, ch.SphereChunks),
                                            TMIN, tc, **kw)
    return packet.planar_closest_packet(to, td, _to_torch(jchunks, ch.PlanarChunks), TMIN,
                                        kind == "tri", tc, **kw)


def _hold(t_p, pay_p, t_r, pay_r, kind, fields_atol, t_atol=0.0):
    """Equal masks, mats and pids; t rtol 1e-4 (and ``t_atol``); the other
    fields atol."""
    t_p, t_r = t_p.numpy(), np.asarray(t_r)
    hit = np.isfinite(t_p)
    np.testing.assert_array_equal(np.isfinite(t_r), hit)
    np.testing.assert_allclose(t_p[hit], t_r[hit], rtol=1e-4, atol=t_atol)
    mat_i = 2 if kind == "sphere" else 3
    np.testing.assert_array_equal(pay_p[mat_i].numpy(), np.asarray(pay_r[mat_i]))
    np.testing.assert_array_equal(pay_p[-1].numpy()[hit], np.asarray(pay_r[-1])[hit])
    for i, atol in fields_atol.items():
        np.testing.assert_allclose(pay_p[i].numpy()[hit], np.asarray(pay_r[i])[hit],
                                   rtol=0, atol=atol)
    return hit


def _fields(kind, against_jax):
    if kind == "sphere":
        return {0: 1e-4 if against_jax else 1e-3, 1: 1e-3}
    return {0: 1e-4 if against_jax else 1e-3, 1: 1e-3, 2: 1e-3}


@pytest.mark.parametrize("tile", [2048, 64, 32])
@pytest.mark.parametrize("kind", ["tri", "quad", "sphere"])
def test_plain_packet_matches_jax(kind, tile):
    org, dirs, time, cap = _rays(tile)
    jo, jd, jt, jc = (jnp.asarray(x) for x in (org, dirs, time, cap))
    jchunks = _chunks(kind)
    if kind == "sphere":
        t_j, pay_j = jpacket.sphere_closest_packet(jo, jd, jt, jchunks, TMIN, tmax=jc,
                                                   tile=tile)
    else:
        t_j, pay_j = jpacket.planar_closest_packet(jo, jd, jchunks, TMIN, kind == "tri",
                                                   tmax=jc, tile=tile)
    t_p, pay_p = _port(kind, org, dirs, time, cap, tile=tile)
    # the port expands |o - c|^2 = |o|^2 - 2 o.c + |c|^2 (kernel K2's form,
    # which cancels) in its own rounding, JAX in its contractions': their
    # sphere t differ by up to ~1e-4 absolute at these coordinates, as the
    # sweep's and the oracle's do (tests/test_torch_perray.py)
    hit = _hold(t_p, pay_p, t_j, pay_j, kind, _fields(kind, True),
                t_atol=2e-4 if kind == "sphere" else 0.0)
    assert hit.sum() > 20 and not hit[40:60].any()


@pytest.mark.parametrize("kind", ["tri", "quad", "sphere"])
def test_plain_packet_matches_chunk_scan(kind):
    org, dirs, time, cap = _rays(5)
    t_p, pay_p = _port(kind, org, dirs, time, cap, tile=128)
    to, td, tt, tc = (torch.as_tensor(x) for x in (org, dirs, time, cap))
    jchunks = _chunks(kind)
    if kind == "sphere":
        t_o, pay_o = ch.sphere_closest(to, td, tt, _to_torch(jchunks, ch.SphereChunks),
                                       TMIN, tmax=tc)
    else:
        t_o, pay_o = ch.planar_closest(to, td, _to_torch(jchunks, ch.PlanarChunks), TMIN,
                                       kind == "tri", tmax=tc)
    _hold(t_p, pay_p, t_o, pay_o, kind, _fields(kind, False))


def test_cap_respected_and_all_miss():
    org, dirs, time, cap = _rays(7)
    t, pay = _port("tri", org, dirs, time, cap, tile=64)
    t = t.numpy()
    hit = np.isfinite(t)
    assert hit.any() and (t[hit] < cap[hit]).all() and not hit[40:60].any()
    # a scalar cap below every hit: nothing is kept
    t_s, _ = _port("tri", org, dirs, time, float(np.nanmin(np.where(hit, t, INF))) * 0.5,
                   tile=64)
    assert not torch.isfinite(t_s).any()
    # every ray leaves the table's box: all miss, payload the sentinels
    far_org = np.tile(np.float32([0.0, 0.0, 500.0]), (R, 1))
    up = np.tile(np.float32([0.0, 0.0, 1.0]), (R, 1))
    for kind in ("quad", "sphere"):
        t_m, pay_m = _port(kind, far_org, up, time, np.full(R, 40.0, np.float32), tile=64)
        assert not torch.isfinite(t_m).any()
        assert int(pay_m[-1].abs().sum()) == 0 and int(pay_m[-2].abs().sum()) == 0
    chunks = _to_torch(_chunks("quad"), ch.PlanarChunks)
    _, _, visited = packet.planar_packet_hit(torch.as_tensor(far_org), torch.as_tensor(up),
                                             chunks, TMIN, False, 40.0, tile=64)
    # the full tiles visit nothing; the last tile's padding lanes (zero rays,
    # cap 0, as JAX pads them) pass the cull of the chunks that hold the
    # origin, which their tile then visits
    assert len(visited) == 5 and visited[:4] == [[]] * 4
    for k in visited[4]:
        assert bool((chunks.lo[k] <= 0).all() and (chunks.hi[k] >= 0).all())


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_vjp_matches_jax_winner_replay(kind):
    org, dirs, time, cap = _rays(11)
    w = np.random.default_rng(3).normal(0, 1, (R, 8)).astype(np.float32)
    jchunks = _chunks(kind)
    names = ("c0", "c1", "rad") if kind == "sphere" else ("corner", "eu", "ev")

    def loss(t, pay, lib):
        wl = jnp.asarray(w) if lib is jnp else torch.as_tensor(w)
        t0 = lib.where(lib.isfinite(t), t, lib.zeros_like(t))
        out = (t0 * wl[:, 0]).sum() + (pay[0] * wl[:, 1:4]).sum()
        out = out + (pay[1] * wl[:, 4]).sum()
        return out + (pay[2] * wl[:, 5]).sum() if kind != "sphere" else out

    def jloss(o, d, *geo):
        c = jchunks.replace(**dict(zip(names, geo)))
        if kind == "sphere":
            t, pay = jpacket.sphere_closest_accel(o, d, jnp.asarray(time), c, TMIN,
                                                  jnp.asarray(cap))
        else:
            t, pay = jpacket.planar_closest_accel(o, d, c, TMIN, True, jnp.asarray(cap))
        return loss(t, pay, jnp)

    geo = [getattr(jchunks, n) for n in names]
    ref = jax.grad(jloss, argnums=tuple(range(5)))(jnp.asarray(org), jnp.asarray(dirs),
                                                  *geo)
    xs = [torch.as_tensor(org).requires_grad_(), torch.as_tensor(dirs).requires_grad_()]
    xs += [torch.as_tensor(np.array(g)).requires_grad_() for g in geo]
    cls = ch.SphereChunks if kind == "sphere" else ch.PlanarChunks
    chunks = dataclasses.replace(_to_torch(jchunks, cls), **dict(zip(names, xs[2:])))
    if kind == "sphere":
        t, pay = packet.sphere_closest_packet(xs[0], xs[1], torch.as_tensor(time), chunks,
                                              TMIN, torch.as_tensor(cap))
    else:
        t, pay = packet.planar_closest_packet(xs[0], xs[1], chunks, TMIN, True,
                                              torch.as_tensor(cap))
    got = torch.autograd.grad(loss(t, pay, torch), xs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


def test_sphereflake_auto_takes_packet_and_matches_jax(monkeypatch):
    monkeypatch.delenv("CRT_ACCEL", raising=False)
    calls = []
    real = packet.sphere_closest_packet
    monkeypatch.setattr(packet, "sphere_closest_packet",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    js, jc = jcat.sphereflake(width=16, spp=4, max_depth=1)
    jkey = jax.random.key(42)
    ref = np.asarray(jint.render_image(js, jc, jkey))
    scene = convert.scene_from_numpy(js, device="cpu")
    assert isect.accel_mode() == "auto" and isect._auto_mode(
        int(scene.sphere_chunks.mat.shape[0])) == "packet"
    img = integrator.render_image(scene, convert.camera_from_numpy(jc, device="cpu"),
                                  convert.key_from_numpy(jax.random.key_data(jkey))).numpy()
    assert calls and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    close = np.abs(img - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()
