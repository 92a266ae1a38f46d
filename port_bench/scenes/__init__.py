"""Scenes as data: a configuration file expanded into primitive lists.

A configuration (``configs/<name>.json``) gives the scene as data: its
materials, quads, boxes, triangle meshes (a mesh is a generator of this
package, found by its name, and its arguments), which quads are lights, the background and
the camera. ``describe`` expands it into one ``Description`` of numpy
arrays: the ``planar`` family's description (``families/planar.py``). The
harness hands that same description to the port's ``SceneBuilder`` and to
the plain reference (``reference/planar.py``), so both render the same
numbers.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

KINDS = ("lambertian", "diffuse_light")


@dataclasses.dataclass(frozen=True)
class Description:
    materials: list          # [(kind, (r, g, b))], in the configuration's order
    quad_corner: np.ndarray  # [Q,3] float64
    quad_u: np.ndarray       # [Q,3]
    quad_v: np.ndarray       # [Q,3]
    quad_mat: np.ndarray     # [Q] int
    tri_verts: np.ndarray    # [T,3,3] float32
    tri_mat: np.ndarray      # [T] int
    lights: list             # quad indices sampled as lights
    background: tuple | None  # (r, g, b), or None for black
    camera: dict             # pos, lookat, fovy_deg, focal_length, aspect


def box_quads(a, b, translate=(0.0, 0.0, 0.0)):
    """Six (corner, u, v) faces of the axis-aligned box between ``a`` and
    ``b``, moved by ``translate``: the reference's ``box`` (src/quad.h:91-112)
    in its face order."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0, 0])
    dy = np.array([0, mx[1] - mn[1], 0])
    dz = np.array([0, 0, mx[2] - mn[2]])
    faces = [((mn[0], mn[1], mx[2]), dy, dx), ((mx[0], mn[1], mx[2]), dy, -dz),
             ((mx[0], mn[1], mn[2]), dy, -dx), ((mn[0], mn[1], mn[2]), dy, dz),
             ((mn[0], mx[1], mx[2]), -dz, dx), ((mn[0], mn[1], mn[2]), dz, dx)]
    off = np.asarray(translate, np.float64)
    return [(np.asarray(c, np.float64) + off, u, v) for c, u, v in faces]


def generator(name: str):
    """The mesh generator a configuration names: the function ``name`` of
    the module ``port_bench.scenes.<name>``, which returns [T,3,3]
    vertices."""
    return getattr(importlib.import_module(f"port_bench.scenes.{name}"), name)


def describe(config: dict, overrides: dict | None = None) -> Description:
    """The scene of ``config`` (a parsed configuration file). ``overrides``
    replace top-level keys of a mesh's arguments by name (``{"target_tris":
    3000}``), for small test scenes only."""
    names = [m["name"] for m in config["materials"]]
    for m in config["materials"]:
        if m["kind"] not in KINDS:
            raise ValueError(f"material {m['name']}: kind {m['kind']!r} not in {KINDS}")
    mat_id = {n: i for i, n in enumerate(names)}
    quads, lights = [], []
    for q in config.get("quads", []):
        if q.get("light"):
            lights.append(len(quads))
        quads.append((np.asarray(q["corner"], np.float64), np.asarray(q["u"], np.float64),
                      np.asarray(q["v"], np.float64), mat_id[q["material"]]))
    for bx in config.get("boxes", []):
        for c, u, v in box_quads(bx["a"], bx["b"], bx.get("translate", (0, 0, 0))):
            quads.append((c, u, v, mat_id[bx["material"]]))
    verts, tmat = [np.zeros((0, 3, 3), np.float32)], [np.zeros((0,), np.int64)]
    for mesh in config.get("meshes", []):
        args = dict(mesh.get("args", {}))
        args.update({k: v for k, v in (overrides or {}).items() if k in args})
        v = generator(mesh["generator"])(**args)
        verts.append(v.astype(np.float32))
        tmat.append(np.full(len(v), mat_id[mesh["material"]], np.int64))
    stack = (lambda i: np.stack([q[i] for q in quads]) if quads
             else np.zeros((0, 3), np.float64))
    bg = config.get("background")
    return Description(
        materials=[(m["kind"], tuple(float(c) for c in m["color"]))
                   for m in config["materials"]],
        quad_corner=stack(0), quad_u=stack(1), quad_v=stack(2),
        quad_mat=np.array([q[3] for q in quads], np.int64),
        tri_verts=np.concatenate(verts), tri_mat=np.concatenate(tmat),
        lights=lights, background=None if bg is None else tuple(float(c) for c in bg),
        camera=dict(config["camera"]))
