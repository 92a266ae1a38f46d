"""Procedural stand-in geometry for assets missing from the reference
snapshot.

Port of ``cpu_ray_tracing_implementation_tpu/utils/procgen.py:16-98``
(numpy only). ``Sponza.bin`` is absent from the reference snapshot, so the
reference's 262k-triangle BVH scale test (``catalog.sponza``) renders a
colonnade hall of comparable triangle count instead. The same seed gives
the same triangles as the JAX package.

The port adds a writer of stand-in glTF assets (``write_gltf``, with an
indexed ellipsoid, ``ellipsoid_mesh``, and a PNG checker, ``checker_png``),
so that the glTF scenes can be driven where the reference's Fox and
Sponza files are absent: point ``$CRT_ASSETS`` at a directory holding
``Fox/glTF/Fox.gltf`` or ``Sponza/glTF/Sponza.gltf`` written by it.
"""

from __future__ import annotations

import base64
import json
import os
import struct

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


def ellipsoid_mesh(segments: int = 24, rings: int = 13, radii=(30.0, 45.0, 20.0)):
    """An indexed UV ellipsoid about the origin, a stand-in for a glTF
    mesh such as the Fox: (positions [V,3] float32, normals [V,3] float32,
    uvs [V,2] float32, indices [3T] uint32). ``rings`` latitude bands, the
    two at the poles fans of ``segments`` triangles each and the other
    ``rings - 2`` of ``2 * segments``: at 24 x 13, the Fox's 576 triangles;
    at 24 x 11, 480. The seam column is duplicated so that u runs 0..1, and
    each pole has a vertex per segment."""
    a = np.asarray(radii, np.float64)
    th = np.linspace(0.0, np.pi, rings + 1)                 # latitude lines
    ph = np.linspace(0.0, 2.0 * np.pi, segments + 1)        # seam duplicated
    t, p = np.meshgrid(th, ph, indexing="ij")               # [rings+1, segments+1]
    unit = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    pos = unit * a
    nrm = unit / a                                           # the surface gradient
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([p / (2.0 * np.pi), t / np.pi], -1)
    vid = np.arange((rings + 1) * (segments + 1)).reshape(rings + 1, segments + 1)
    i, j = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    v00, v01 = vid[i, j], vid[i, j + 1]
    v10, v11 = vid[i + 1, j], vid[i + 1, j + 1]
    # counter-clockwise seen from outside; the triangle whose two corners
    # share a pole is left out of each pole's band
    upper = np.stack([v00, v11, v10], -1)[:-1]
    lower = np.stack([v00, v01, v11], -1)[1:]
    idx = np.concatenate([upper.reshape(-1, 3), lower.reshape(-1, 3)])
    return (pos.reshape(-1, 3).astype(np.float32), nrm.reshape(-1, 3).astype(np.float32),
            uv.reshape(-1, 2).astype(np.float32), idx.reshape(-1).astype(np.uint32))


def checker_png(size: int = 16, cells: int = 4) -> bytes:
    """PNG bytes of a colourful [size, size] checker (PIL), a texture for
    stand-in glTF materials."""
    import io

    from PIL import Image

    y, x = np.mgrid[0:size, 0:size] * cells // size
    img = np.stack([(x * 255) // max(cells - 1, 1), ((x + y) % 2) * 200 + 40,
                    (y * 255) // max(cells - 1, 1)], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def write_gltf(path: str, positions, indices=None, normals=None, uvs=None,
               png: bytes | None = None, base_color=None, nodes=None,
               index_type=np.uint32, stride: bool = False, image_in: str = "data",
               buffer_in: str = "file") -> str:
    """Write one mesh as glTF 2.0 (``.gltf`` with its buffer in a ``.bin``
    beside it or a data URI, or ``.glb`` with a BIN chunk), for stand-in
    assets and tests.

    ``indices``: a flat index list stored as ``index_type`` (uint8, uint16
    or uint32), or None for a non-indexed primitive. ``normals`` [V,3] /
    ``uvs`` [V,2]: NORMAL / TEXCOORD_0; with ``stride`` POSITION and NORMAL
    are interleaved in one bufferView with a byteStride. ``png`` (bytes):
    the material's baseColorTexture, in a data URI (``image_in="data"``) or
    a bufferView (``"bufferView"``); ``base_color``: its baseColorFactor.
    ``nodes``: the node list (default one node holding the mesh); a node
    with ``"mesh": 0`` places the mesh. ``buffer_in``: "file", "data", or
    "glb" (then ``path`` should end in .glb)."""
    pos = np.ascontiguousarray(positions, np.float32)
    views, accessors, chunks = [], [], []
    offset = 0

    def add_view(data: bytes, byte_stride: int = 0) -> int:
        nonlocal offset
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if byte_stride:
            view["byteStride"] = byte_stride
        views.append(view)
        pad = (-len(data)) % 4
        chunks.append(data + b"\0" * pad)
        offset += len(data) + pad
        return len(views) - 1

    def add_accessor(view: int, ctype: int, count: int, typ: str, byte_offset=0) -> int:
        accessors.append({"bufferView": view, "byteOffset": byte_offset,
                          "componentType": ctype, "count": int(count), "type": typ})
        return len(accessors) - 1

    attrs = {}
    if stride and normals is not None:
        inter = np.concatenate([pos, np.asarray(normals, np.float32)], axis=1)
        v = add_view(np.ascontiguousarray(inter).tobytes(), byte_stride=24)
        attrs["POSITION"] = add_accessor(v, 5126, len(pos), "VEC3")
        attrs["NORMAL"] = add_accessor(v, 5126, len(pos), "VEC3", byte_offset=12)
    else:
        attrs["POSITION"] = add_accessor(add_view(pos.tobytes()), 5126, len(pos), "VEC3")
        if normals is not None:
            attrs["NORMAL"] = add_accessor(
                add_view(np.asarray(normals, np.float32).tobytes()), 5126, len(pos), "VEC3")
    accessors[attrs["POSITION"]].update(min=pos.min(0).tolist(), max=pos.max(0).tolist())
    if uvs is not None:
        attrs["TEXCOORD_0"] = add_accessor(
            add_view(np.asarray(uvs, np.float32).tobytes()), 5126, len(pos), "VEC2")
    prim = {"attributes": attrs, "mode": 4}
    if indices is not None:
        idx = np.asarray(indices).astype(index_type)
        ctype = {np.dtype(np.uint8): 5121, np.dtype(np.uint16): 5123,
                 np.dtype(np.uint32): 5125}[idx.dtype]
        prim["indices"] = add_accessor(add_view(idx.tobytes()), ctype, len(idx), "SCALAR")
    doc = {"asset": {"version": "2.0", "generator": "procgen.write_gltf"},
           "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": nodes if nodes is not None else [{"mesh": 0}],
           "meshes": [{"primitives": [prim]}]}
    if png is not None or base_color is not None:
        pbr = {}
        if base_color is not None:
            pbr["baseColorFactor"] = [float(c) for c in base_color]
        if png is not None:
            if image_in == "bufferView":
                image = {"bufferView": add_view(png), "mimeType": "image/png"}
            else:
                image = {"uri": "data:image/png;base64," + base64.b64encode(png).decode()}
            doc.update(images=[image], textures=[{"source": 0}])
            pbr["baseColorTexture"] = {"index": 0}
        doc["materials"] = [{"name": "standin", "pbrMetallicRoughness": pbr}]
        prim["material"] = 0
    blob = b"".join(chunks)
    doc.update(accessors=accessors, bufferViews=views)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if buffer_in == "glb":
        doc["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(doc).encode()
        js += b" " * ((-len(js)) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(blob), 0x004E4942) + blob)
        with open(path, "wb") as f:
            f.write(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
        return path
    if buffer_in == "data":
        uri = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
    else:
        uri = os.path.splitext(os.path.basename(path))[0] + ".bin"
        with open(os.path.join(os.path.dirname(os.path.abspath(path)), uri), "wb") as f:
            f.write(blob)
    doc["buffers"] = [{"uri": uri, "byteLength": len(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def grazing_table(quads: bool, K: int = 6, C: int = 128, seed: int = 31):
    """K chunks of C random triangles (or quads) at +-1,200 units with chunk
    extents from 0.05 (a u16 quantum of 7.6e-7, below the float spacing
    there) to 800 units, and one of 0.01 within 1 unit of the origin, to
    stress a quantized table's group boxes. Lane 32g shares its corner and
    eu with lane 32g - 1 (an edge shared across groups of 32), lanes 5, 6
    and 7 are slivers (ev = 2 eu plus ~1e-4, ~1e-2 and ~3e-4 of |eu|
    across: 1 / sin of their angle ~1e4, ~1e2 and ~3e3, needles like the
    colonnade's column sides) and lanes 50-52 are dead (eu = ev = 0). In
    the chunk at the origin lanes 72 and 73 are a quantum wide (eu and ev one
    quantum along two axes), so |n|^2 falls below the 1e-20 that the plane
    test clamps it to, and the primitive is hit far beyond its box
    (``vertex_rays`` aims there). -> float32 (corner, eu, ev [K, C, 3],
    active [K, C] bool, lo, hi [K, 3]: the live points' box)."""
    rng = np.random.default_rng(seed)
    corner, eu, ev = (np.zeros((K, C, 3)) for _ in range(3))
    for k in range(K):
        ext = (0.05, 0.5, 30.0, 800.0, 2.0, 0.01)[k % 6]
        centre = rng.uniform(-1200, 1200, 3) / (1200 if k % 6 == 5 else 1)
        c = centre + rng.uniform(-ext / 2, ext / 2, (C, 3))
        a, b = rng.normal(0, ext / 6, (C, 3)), rng.normal(0, ext / 6, (C, 3))
        for g in range(32, C, 32):
            c[g], a[g] = c[g - 1], a[g - 1]
        b[5] = 2 * a[5] + rng.normal(0, 1e-4 * ext / 6, 3)
        b[6] = 2 * a[6] + rng.normal(0, 1e-2 * ext / 6, 3)
        b[7] = 2 * a[7] + rng.normal(0, 3e-4 * ext / 6, 3)
        if k % 6 == 5:  # a quantum wide: set below, once the box is known
            c[72:74], a[72:74], b[72:74] = centre, 0.0, 0.0
        corner[k], eu[k], ev[k] = c, a, b
    active = np.ones((K, C), bool)
    active[:, 50:53] = False
    eu[~active] = ev[~active] = 0.0
    pts = np.stack([corner, corner + eu, corner + ev] + ([corner + eu + ev] if quads else []))
    lo = np.where(active[..., None], pts.min(0), np.inf).min(1)
    hi = np.where(active[..., None], pts.max(0), -np.inf).max(1)
    for k in range(5, K, 6):  # inside the box, which they leave as it is
        quantum = (hi[k] - lo[k]) / 65535
        eu[k, 72], ev[k, 72] = quantum * (1, 0, 0), quantum * (0, 1, 0)
        eu[k, 73], ev[k, 73] = quantum * (0, 0, 1), quantum * (0, 1, 0)
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(corner), f32(eu), f32(ev), active, f32(lo), f32(hi)


def vertex_rays(words, lo, scale, quads: bool, seed: int = 7):
    """Rays aimed at every vertex of every primitive of a quantized table
    (words [K, 5, C] int32 of u16 pairs, lo and scale [K, 3] float32; the
    vertices dequantized as lo + q0 * scale and (q1 - q0) * scale, each
    operation rounded in float32), so at each group's extreme vertices and
    at the ends of shared edges: from random directions 1-600 units away,
    along an axis (two zero direction components) and grazing (along eu,
    nearly in the primitive's plane); the direction ends at the vertex
    (t = 1 there). Then, for each live primitive whose |n|^2 (n = eu x ev,
    each product and difference rounded in float32) lies below 1e-20, rays
    at three points of the region the plane test's clamp of |n|^2 to 1e-20
    makes it hit: c + f (a eu + b ev), f = 1e-20 / |n|^2, (a, b) = (0.25,
    0.25), (0.6, 0.1) and (0.1, 0.6), each from two random directions 1-50
    units away and along an axis. -> float32 (org [R, 3], dirs [R, 3]),
    chunk [R] int64."""
    rng = np.random.default_rng(seed)
    w = words.astype(np.int64) & 0xFFFFFFFF
    q = np.stack([w >> 16, w & 0xFFFF], axis=-2).reshape(w.shape[0], 10, -1)[:, :9]
    q = q.astype(np.float32).transpose(0, 2, 1)                        # [K, C, 9]
    s = scale[:, None, :]
    c = lo[:, None, :] + q[..., 0:3] * s
    eu, ev = (q[..., 3:6] - q[..., 0:3]) * s, (q[..., 6:9] - q[..., 0:3]) * s
    verts = np.stack([c, c + eu, c + ev] + ([c + eu + ev] if quads else []), 2)
    K, C, nv, _ = verts.shape
    P = verts.reshape(-1, 3)
    n = P.shape[0]
    u = rng.normal(size=(n, 3))
    o_rand = P + rng.uniform(1, 600, (n, 1)) * u / np.linalg.norm(u, axis=1, keepdims=True)
    axis = np.zeros((n, 3))
    axis[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    o_axis = P - axis * rng.uniform(1, 600, (n, 1))
    e = np.repeat(eu.reshape(K * C, 1, 3), nv, axis=1).reshape(n, 3).astype(np.float64)
    e += 1e-3 * np.linalg.norm(e, axis=1, keepdims=True) * rng.normal(size=(n, 3))
    o_graze = P - e * rng.uniform(1, 50, (n, 1))
    orgs, dirs = [o_rand, o_axis, o_graze], [P - o_rand, axis, P - o_graze]
    chunks = [np.tile(np.repeat(np.arange(K), C * nv), 3)]
    nx = eu[..., 1] * ev[..., 2] - eu[..., 2] * ev[..., 1]
    ny = eu[..., 2] * ev[..., 0] - eu[..., 0] * ev[..., 2]
    nz = eu[..., 0] * ev[..., 1] - eu[..., 1] * ev[..., 0]
    nn = nx * nx + ny * ny + nz * nz
    kt, lt = np.nonzero((nn < 1e-20) & ((nx != 0) | (ny != 0) | (nz != 0)))
    if kt.size:
        f = (1e-20 / nn[kt, lt].astype(np.float64))[:, None, None]
        ab = np.array([[0.25, 0.25], [0.6, 0.1], [0.1, 0.6]])[None, :, :, None]
        T = (c[kt, lt][:, None] + f * (ab[:, :, 0] * eu[kt, lt][:, None]
                                       + ab[:, :, 1] * ev[kt, lt][:, None])).reshape(-1, 3)
        m = T.shape[0]
        u = rng.normal(size=(2 * m, 3))
        o = np.tile(T, (2, 1)) + rng.uniform(1, 50, (2 * m, 1)) * u / np.linalg.norm(
            u, axis=1, keepdims=True)
        ax = np.zeros((m, 3))
        ax[np.arange(m), rng.integers(0, 3, m)] = rng.choice([-1.0, 1.0], m)
        orgs += [o, T - ax * rng.uniform(1, 50, (m, 1))]
        dirs += [np.tile(T, (2, 1)) - o, ax]
        chunks.append(np.tile(np.repeat(kt, 3), 3))
    org = np.concatenate(orgs).astype(np.float32)
    return org, np.concatenate(dirs).astype(np.float32), np.concatenate(chunks)
