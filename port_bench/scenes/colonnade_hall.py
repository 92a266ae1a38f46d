"""A procedural colonnade hall of triangles: a frozen numpy copy of the
port's ``utils/procgen.colonnade_hall``.

It is no configuration of the benchmark: it is not Sponza, and no public
source describes it. The CPU tests render it through the per-ray route
(``tests/fixtures/colonnade_hall.json``), so that the reference's
triangles and the per-ray kernels' bounds stay tested until a cell on a
committed mesh uses them. Written with whole-array numpy operations, it
takes a fraction of a second: the same seed gives the port generator's
float32 triangles, bit for bit (``tests/test_pb_scenes.py`` holds it to a
recorded checksum)"""

from __future__ import annotations

import numpy as np

_BOX_FACES = np.array([(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),
                       (0, 1, 5), (0, 5, 4), (2, 3, 7), (2, 7, 6),
                       (1, 2, 6), (1, 6, 5), (3, 0, 4), (3, 4, 7)])


def _box(lo, hi) -> np.ndarray:
    """12 triangles of an axis-aligned box, float64 [12,3,3]."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
    return v[_BOX_FACES]


def _cylinder(center, radius, y0, y1, segments) -> np.ndarray:
    """An open cylinder of 2 * segments triangles (a column shaft)."""
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
    return np.concatenate([np.stack([a0, a1, b1], axis=1),
                           np.stack([a0, b1, b0], axis=1)], axis=0)


def _sphere(center, radius, lat, lon) -> np.ndarray:
    """A UV sphere of 2 * lat * lon triangles (a capital ornament), in the
    generator's order: band by band, two triangles per cell."""
    th = np.linspace(0, np.pi, lat + 1)
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    jn = (np.arange(lon) + 1) % lon

    def pt(t, p):
        # each point as the generator forms it: the three products, then
        # the radius times them, then the center plus that
        unit = np.stack([np.sin(t) * np.cos(p), np.cos(t) + 0.0 * p,
                         np.sin(t) * np.sin(p)], -1)
        return center + radius * unit

    ti, tn = th[:-1, None], th[1:, None]
    pj, pn = ph[None, :], ph[jn][None, :]
    p00, p01 = pt(ti, pj), pt(ti, pn)
    p10, p11 = pt(tn, pj), pt(tn, pn)
    cells = np.stack([np.stack([p00, p10, p11], -2),
                      np.stack([p00, p11, p01], -2)], axis=2)  # [lat, lon, 2, 3, 3]
    return cells.reshape(-1, 3, 3)


def colonnade_hall(target_tris: int = 260_000, seed: int = 14) -> np.ndarray:
    """[T,3,3] float32 triangle soup: floor, walls and two rows of columns
    with sphere capitals, subdivided to about ``target_tris`` (257,916 at
    the default). x in [-1220, 1220], y up from -10 to 800, z in [-620,
    620]."""
    rng = np.random.default_rng(seed)
    parts = [
        _box((-1200, -10, -600), (1200, 0, 600)),      # floor
        _box((-1200, 0, -620), (1200, 800, -600)),     # back wall
        _box((-1200, 0, 600), (1200, 800, 620)),       # front wall
        _box((-1220, 0, -620), (-1200, 800, 620)),     # end walls
        _box((1200, 0, -620), (1220, 800, 620)),
    ]
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
            parts.append(_cylinder(c, 40.0, 0.0, 500.0, seg))
            parts.append(_box((c[0] - 55, 500, c[1] - 55), (c[0] + 55, 540, c[1] + 55)))
            parts.append(_sphere(np.array([c[0], 580.0, c[1]]), 45.0, lat, 2 * lat))
    return np.concatenate(parts, axis=0).astype(np.float32)
