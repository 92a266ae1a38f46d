"""Procedural stand-in geometry for assets missing from the reference
snapshot.

Port of ``cpu_ray_tracing_implementation_tpu/utils/procgen.py:16-98``
(numpy only). ``Sponza.bin`` is absent from the reference snapshot, so the
reference's 262k-triangle BVH scale test (``catalog.sponza``) renders a
colonnade hall of comparable triangle count instead. The same seed gives
the same triangles as the JAX package.
"""

from __future__ import annotations

import numpy as np


def _box_tris(lo, hi):
    """12 triangles of an axis-aligned box."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ])
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),
             (0, 1, 5), (0, 5, 4), (2, 3, 7), (2, 7, 6),
             (1, 2, 6), (1, 6, 5), (3, 0, 4), (3, 4, 7)]
    return v[np.array(faces)]


def _cylinder_tris(center, radius, y0, y1, segments):
    """Open cylinder of 2*segments triangles (a column shaft)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    nxt = np.roll(ang, -1)
    cx, cz = center
    a0 = np.stack([cx + radius * np.cos(ang), np.full_like(ang, y0),
                   cz + radius * np.sin(ang)], -1)
    a1 = np.stack([cx + radius * np.cos(nxt), np.full_like(ang, y0),
                   cz + radius * np.sin(nxt)], -1)
    b0 = a0.copy()
    b0[:, 1] = y1
    b1 = a1.copy()
    b1[:, 1] = y1
    t1 = np.stack([a0, a1, b1], axis=1)
    t2 = np.stack([a0, b1, b0], axis=1)
    return np.concatenate([t1, t2], axis=0)


def _sphere_tris(center, radius, lat, lon):
    """UV sphere (a capital ornament), 2*lat*lon triangles."""
    th = np.linspace(0, np.pi, lat + 1)
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    tris = []
    for i in range(lat):
        for j in range(lon):
            jn = (j + 1) % lon

            def pt(t, p):
                return center + radius * np.array(
                    [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)])

            p00, p01 = pt(th[i], ph[j]), pt(th[i], ph[jn])
            p10, p11 = pt(th[i + 1], ph[j]), pt(th[i + 1], ph[jn])
            tris.append([p00, p10, p11])
            tris.append([p00, p11, p01])
    return np.asarray(tris)


def colonnade_hall(target_tris: int = 260_000, seed: int = 14) -> np.ndarray:
    """[T,3,3] float32 triangle soup: floor + walls + two rows of columns
    with sphere capitals, subdivided until ~target_tris. Footprint roughly
    matches Sponza's atrium scale (x in [-1200,1200], y up, z in
    [-600,600])."""
    rng = np.random.default_rng(seed)
    parts = [
        _box_tris((-1200, -10, -600), (1200, 0, 600)),      # floor
        _box_tris((-1200, 0, -620), (1200, 800, -600)),     # back wall
        _box_tris((-1200, 0, 600), (1200, 800, 620)),       # front wall
        _box_tris((-1220, 0, -620), (-1200, 800, 620)),     # end walls
        _box_tris((1200, 0, -620), (1220, 800, 620)),
    ]
    # column grid; per-column budget split ~40% shaft / ~60% capital.
    # shaft = 2*seg tris (linear); capital = 2*lat*(2*lat) = 4*lat^2 tris
    # (quadratic): solve each for its share of the budget.
    n_cols = 24
    xs = np.linspace(-1050, 1050, n_cols // 2)
    base_budget = target_tris - sum(len(p) for p in parts)
    per_col = max(64, base_budget // n_cols)
    seg = max(8, int(0.4 * per_col / 2))
    lat = max(4, int(np.sqrt(0.6 * per_col / 4.0)))
    for x in xs:
        for z in (-320.0, 320.0):
            jitter = rng.uniform(-8, 8, 2)
            c = (x + jitter[0], z + jitter[1])
            parts.append(_cylinder_tris(c, 40.0, 0.0, 500.0, seg))
            parts.append(_box_tris((c[0] - 55, 500, c[1] - 55),
                                   (c[0] + 55, 540, c[1] + 55)))
            parts.append(_sphere_tris(np.array([c[0], 580.0, c[1]]), 45.0,
                                      lat, 2 * lat))
    return np.concatenate(parts, axis=0).astype(np.float32)
