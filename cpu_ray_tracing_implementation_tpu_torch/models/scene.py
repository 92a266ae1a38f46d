"""Structure-of-arrays scene tables + host-side builder.

Port of ``cpu_ray_tracing_implementation_tpu/models/scene.py``: every
primitive, material and texture lives in a flat table padded to at least
one row and addressed by integer id. Tables are frozen dataclasses of
tensors on one device (``SceneBuilder.build(device=...)``).

Ported so far: the dense tables, and for tables above
``chunked.DENSE_MAX`` rows the chunked tables (primitives in BVH order,
cut into chunks of ``chunked.CHUNK`` with AABBs, ``utils/accel.py``) that
the accelerators read (``ops/packet.py``, ``ops/perray.py``), and the
threaded BVH of the same primitives for the traversal oracle
(``ops/bvh.py``, the ``*_tree`` fields); solid, checker,
picture and the four noise textures (with their ``NoiseTables``), the
lambertian, metal, dielectric, gloss, isotropic and diffuse-light
materials (the dielectric with a Cauchy dispersion coefficient, which
turns on the hero-wavelength render, ``Scene.has_dispersion``), quad and
sphere lights, constant-density volumes in box, sphere and triangle-mesh
boundaries, a textured background, optionally importance-sampled as one
more light (its tables built at ``build``, ``ops/envlight.py``), and the
``world_offset`` recentering, and per-vertex triangle attributes
(``TriAttrs``: smooth normals and UVs, from ``triangles(normals=,
uvs=)`` or a glTF asset, ``gltf_asset``), their rows in the intersector's
pid space.

Tables are replaceable (``dataclasses.replace``, ``Scene.replace``), so the
gradient path (``models/diff.py``) builds a scene from parameter tensors.
The views and packs the kernels read are cached per scene and built from
detached tables: the kernels only decide, and gradients flow through the
winner replay or the chunk-scan VJP.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import bvh as bvh_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as chunked_mod
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import noise as noise_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import perray
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.utils import accel

# material type codes (src/material.h concrete classes)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_GLOSS = 3
MAT_ISOTROPIC = 4
MAT_DIFFUSE_LIGHT = 5

# texture type codes (src/texture.h concrete classes)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PICTURE = 2
TEX_PERLIN = 3
TEX_VALUE = 4
TEX_WORLEY = 5
TEX_VORONOI = 6

# volume boundary kinds
VOL_BOX = 0
VOL_SPHERE = 1
VOL_MESH = 2


@dataclass(frozen=True)
class Spheres:
    c0: torch.Tensor      # [S,3] center at time 0
    c1: torch.Tensor      # [S,3] center at time 1 (== c0 for static)
    rad: torch.Tensor     # [S]
    mat: torch.Tensor     # [S] int32
    active: torch.Tensor  # [S] bool (False on padding rows)


@dataclass(frozen=True)
class Quads:
    corner: torch.Tensor  # [Q,3]
    eu: torch.Tensor      # [Q,3] edge u
    ev: torch.Tensor      # [Q,3] edge v
    mat: torch.Tensor     # [Q] int32
    active: torch.Tensor  # [Q] bool


@dataclass(frozen=True)
class Triangles:
    v0: torch.Tensor      # [T,3]
    v1: torch.Tensor      # [T,3]
    v2: torch.Tensor      # [T,3]
    mat: torch.Tensor     # [T] int32
    active: torch.Tensor  # [T] bool


@dataclass(frozen=True)
class TriAttrs:
    """Per-vertex triangle attributes for smooth shading and texturing
    (``scene.py:87-100`` of the JAX package; the reference loads glTF
    NORMAL/TEXCOORD_0 and discards them, src/main.cc:353-393). Rows are in
    the triangle intersector's pid space: chunk order (``tri_chunk_order``,
    padded to K*C) when the table is chunked, the raw table order
    otherwise."""
    n0: torch.Tensor      # [T,3] unit vertex normals
    n1: torch.Tensor      # [T,3]
    n2: torch.Tensor      # [T,3]
    uv0: torch.Tensor     # [T,2]
    uv1: torch.Tensor     # [T,2]
    uv2: torch.Tensor     # [T,2]
    smooth: torch.Tensor  # [T] bool: interpolate normals (else flat)


@dataclass(frozen=True)
class Volumes:
    kind: torch.Tensor    # [V] int32: VOL_BOX | VOL_SPHERE | VOL_MESH
    center: torch.Tensor  # [V,3]
    half: torch.Tensor    # [V,3] half extents (sphere: radius in [:,0])
    rot: torch.Tensor     # [V,3,3] object->world rotation
    neg_inv_density: torch.Tensor  # [V] -1/density (src/volumne.h:36)
    mat: torch.Tensor     # [V] int32 (an isotropic material)
    active: torch.Tensor  # [V] bool
    # the boundary triangles of every VOL_MESH row, concatenated; None when
    # the scene has no mesh volume (``scene.py:103-120`` of the JAX package)
    mesh_v0: torch.Tensor | None = None      # [MT,3]
    mesh_e1: torch.Tensor | None = None      # [MT,3] v1 - v0
    mesh_e2: torch.Tensor | None = None      # [MT,3] v2 - v0
    mesh_vid: torch.Tensor | None = None     # [MT] int32 owning volume row
    mesh_active: torch.Tensor | None = None  # [MT] bool


@dataclass(frozen=True)
class Materials:
    mtype: torch.Tensor      # [M] int32
    tex: torch.Tensor        # [M] int32 texture id (albedo or emission)
    fuzz: torch.Tensor       # [M] metal fuzz
    ior: torch.Tensor        # [M] dielectric refraction index
    smoothness: torch.Tensor  # [M] gloss smoothness
    spec_prob: torch.Tensor  # [M] gloss specular probability
    dispersion: torch.Tensor  # [M] Cauchy B (0 = non-dispersive)


@dataclass(frozen=True)
class Textures:
    ttype: torch.Tensor     # [X] int32
    color0: torch.Tensor    # [X,3] solid color / checker even
    color1: torch.Tensor    # [X,3] checker odd
    scale: torch.Tensor     # [X] checker cell width
    image_id: torch.Tensor  # [X] int32
    tfilter: torch.Tensor   # [X] int32 image filter


@dataclass(frozen=True)
class NoiseTables:
    perlin_grad: torch.Tensor  # [256,3]
    perlin_perm: torch.Tensor  # [256] int32
    value_grid: torch.Tensor   # [res,res,res]


@dataclass(frozen=True)
class Scene:
    spheres: Spheres
    quads: Quads
    tris: Triangles
    volumes: Volumes
    materials: Materials
    textures: Textures
    noise: NoiseTables
    lights: torch.Tensor     # [L] int32 quad indices sampled as lights
    # [Ls] int32 sphere indices sampled as lights (solid-angle cone
    # sampling, ``ops/sampling.cone_dir``); None = no sphere lights
    sphere_lights: torch.Tensor | None = None
    images: tuple = ()       # [h,w,3] float32 picture texels in byte scale
    background: int = -1     # texture id or -1
    # the environment light's importance tables (``ops/envlight.py``, built
    # under set_background(..., importance_sample=True)): [H,W] texel
    # probability, [H] row CDF, [H,W] column CDFs; None = the background is
    # found by BSDF sampling only (src/camera.h:205-210)
    env_texel_p: torch.Tensor | None = None
    env_row_cdf: torch.Tensor | None = None
    env_col_cdf: torch.Tensor | None = None
    # static feature sets: branches for kinds the scene never uses are skipped
    tex_types_used: tuple = ()
    mat_types_used: tuple = ()
    # some picture texture filters bilinearly
    has_bilinear: bool = False
    # some material has a nonzero Cauchy dispersion coefficient: every path
    # carries a hero wavelength (off: the RGB render, bit for bit)
    has_dispersion: bool = False
    # real (unpadded) row counts: (spheres, quads, tris, volumes)
    counts: tuple = (-1, -1, -1, -1)
    # static scene AABB in the traced (recentered) frame
    world_lo: tuple | None = None
    world_hi: tuple | None = None
    # world = stored + world_offset (None = identity); see _maybe_recenter
    world_offset: torch.Tensor | None = None
    # tables above chunked.DENSE_MAX rows, in BVH order and cut into chunks
    # (None for small tables, which take the 1-chunk views below)
    sphere_chunks: chunked_mod.SphereChunks | None = None
    quad_chunks: chunked_mod.PlanarChunks | None = None
    tri_chunks: chunked_mod.PlanarChunks | None = None
    # threaded BVH trees of the same tables (``ops/bvh.py``, CRT_ACCEL=bvh);
    # None for dense tables and under the builder's Morton fallback
    sphere_tree: bvh_mod.BVHTree | None = None
    quad_tree: bvh_mod.BVHTree | None = None
    tri_tree: bvh_mod.BVHTree | None = None
    # build-time BVH permutation (dense row -> chunk-major position)
    sphere_chunk_order: torch.Tensor | None = None  # [S] int32
    quad_chunk_order: torch.Tensor | None = None    # [Q] int32
    tri_chunk_order: torch.Tensor | None = None     # [T] int32
    # per-vertex triangle attributes (None: flat normals, no UV)
    tri_attrs: TriAttrs | None = None

    @property
    def n_volumes(self) -> int:
        return int(self.volumes.kind.shape[0])

    @property
    def n_sphere_lights(self) -> int:
        return 0 if self.sphere_lights is None else int(self.sphere_lights.shape[0])

    @property
    def has_env_light(self) -> bool:
        return self.env_texel_p is not None

    @property
    def has_lights(self) -> bool:
        return (int(self.lights.shape[0]) > 0 or self.n_sphere_lights > 0
                or self.has_env_light)

    @property
    def device(self) -> torch.device:
        return self.quads.corner.device

    def replace(self, **changes) -> "Scene":
        """A copy with fields replaced (its cached views are rebuilt)."""
        return dataclasses.replace(self, **changes)

    # The 1-chunk views of the dense tables and their kernel constant packs,
    # and the per-ray accelerator's sweep tables and box packs of the
    # chunked ones, built once per scene rather than once per bounce, from
    # detached tables. A chunked table never gets a 1-chunk view.
    @functools.cached_property
    def quad_view(self):
        _dense_only("quad", self.quad_chunks)
        view = fi.dense_quad_view(_detached(self.quads))
        return view, fi.pack_prim_constants(view)

    @functools.cached_property
    def tri_view(self):
        _dense_only("triangle", self.tri_chunks)
        view = fi.dense_tri_view(_detached(self.tris))
        return view, fi.pack_prim_constants(view)

    @functools.cached_property
    def sphere_view(self):
        _dense_only("sphere", self.sphere_chunks)
        view = fi.dense_sphere_view(_detached(self.spheres))
        return view, fi.pack_sphere_constants(view)

    def fused_view(self, kind: str):
        """(view, pack) of the dense ``kind`` table ("quad", "tri",
        "sphere") for the fused closest hit. Under autograd, when the table
        needs a gradient, the view is rebuilt from the live table on each
        call, so the chunk-scan VJP reaches it and no graph outlives one
        backward; the pack, which only the kernel reads, stays cached."""
        view, pack = getattr(self, f"{kind}_view")
        table = {"quad": self.quads, "tri": self.tris, "sphere": self.spheres}[kind]
        if tbl.needs_grad(*_tensor_fields(table)):
            view = _VIEWS[kind](table)
        return view, pack

    # the kernel constant packs of the chunked tables (K6, ``ops/packet.py``)
    @functools.cached_property
    def quad_pack(self) -> torch.Tensor:
        return fi.pack_prim_constants(_detached(self.quad_chunks))

    @functools.cached_property
    def tri_pack(self) -> torch.Tensor:
        return fi.pack_prim_constants(_detached(self.tri_chunks))

    @functools.cached_property
    def sphere_pack(self) -> torch.Tensor:
        return fi.pack_sphere_constants(_detached(self.sphere_chunks))

    @functools.cached_property
    def quad_perray(self) -> perray.PerRayTables:
        return perray.planar_tables(_detached(self.quad_chunks))

    @functools.cached_property
    def tri_perray(self) -> perray.PerRayTables:
        return perray.planar_tables(_detached(self.tri_chunks))

    @functools.cached_property
    def sphere_perray(self) -> perray.PerRayTables:
        return perray.sphere_tables(_detached(self.sphere_chunks))


def _tensor_fields(table) -> list:
    return [getattr(table, f.name) for f in dataclasses.fields(table)]


def _detached(table):
    """``table`` with every tensor field detached from the graph."""
    return dataclasses.replace(table, **{
        f.name: getattr(table, f.name).detach() for f in dataclasses.fields(table)})


_VIEWS = {"quad": fi.dense_quad_view, "tri": fi.dense_tri_view,
          "sphere": fi.dense_sphere_view}


def _dense_only(kind: str, chunks) -> None:
    if chunks is not None:
        raise ValueError(f"the {kind} table is chunked (above "
                         f"{chunked_mod.DENSE_MAX} rows): it has no 1-chunk "
                         "view, the accelerators read it")


def _rot_matrix(axis: str, degrees: float) -> np.ndarray:
    """Object->world rotation matching reference rotate_{x,y,z}
    (src/hittable.h:93-293)."""
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    m = np.eye(3)
    i, j = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[axis]
    m[i, i] = c
    m[i, j] = s
    m[j, i] = -s
    m[j, j] = c
    return m


def _apply_instance(points, rotate, translate, is_vector: bool = False) -> np.ndarray:
    """Fold a rotate-then-translate instance transform into point/vector
    data; ``rotate`` is None, (axis, degrees) or a list of them, applied
    innermost first."""
    out = np.asarray(points, np.float64)
    if rotate is not None:
        rots = [rotate] if isinstance(rotate, tuple) else list(rotate)
        for axis, deg in rots:
            out = out @ _rot_matrix(axis, deg).T
    if translate is not None and not is_vector:
        out = out + np.asarray(translate, np.float64)
    return out


class SceneBuilder:
    """Accumulates python-side lists; ``build()`` emits padded tables."""

    # beyond this centroid distance from the origin, geometry is recentered
    # at build time (f32 catastrophic-cancellation guard)
    RECENTER_THRESHOLD = 2000.0

    def __init__(self, seed: int = 0, value_noise_resolution: int = 10):
        """``seed`` makes the noise tables (``ops/noise.py``);
        ``value_noise_resolution``: the value-noise grid's side, raised by
        ``value``."""
        self._sph = []    # (c0, c1, rad, mat)
        self._quads = []  # (corner, eu, ev, mat)
        self._tris = []   # (v0, v1, v2, mat)
        self._tri_attrs = []  # per triangle: None or (normals [3,3] | None, uvs [3,2] | None)
        self._vols = []   # (kind, center, half, rot, density, mat)
        self._vol_mesh = []  # (volume row, [T,3,3] boundary vertices)
        self._mats = []   # dict rows
        self._texs = []   # dict rows
        self._imgs = []   # [h,w,3] float32 picture images
        self._lights = []
        self._sphere_lights = []
        self._background = -1
        self._env_importance = False
        self._env_res = (64, 128)
        self._seed = seed
        self._value_res = value_noise_resolution

    # ---------------- textures ----------------
    def _tex_row(self, **kw) -> int:
        row = dict(ttype=TEX_SOLID, color0=(0, 0, 0), color1=(0, 0, 0),
                   scale=1.0, image_id=0, tfilter=0)
        row.update(kw)
        self._texs.append(row)
        return len(self._texs) - 1

    def solid(self, color) -> int:
        return self._tex_row(ttype=TEX_SOLID, color0=tuple(color))

    def checker(self, odd, even, scale: float) -> int:
        """3-D position-based checker (src/texture.h:39-63)."""
        return self._tex_row(ttype=TEX_CHECKER, color0=tuple(even),
                             color1=tuple(odd), scale=scale)

    def picture(self, image: np.ndarray, filter: str = "nearest") -> int:
        """Image texture, v flipped, scaled by 1/256 (src/texture.h:65-78).
        ``image``: [h,w,3] floats in byte scale. ``filter``: "nearest" (the
        reference's) or "bilinear"."""
        img = np.ascontiguousarray(np.asarray(image, np.float32))
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"picture needs an [h,w,3] image, got {img.shape}")
        self._imgs.append(img)
        return self._tex_row(ttype=TEX_PICTURE, image_id=len(self._imgs) - 1,
                             tfilter={"nearest": 0, "bilinear": 1}[filter])

    def perlin(self, scale: float) -> int:
        """Marble of perlin turbulence (src/texture.h:80-91)."""
        return self._tex_row(ttype=TEX_PERLIN, scale=scale)

    def value(self, resolution: int) -> int:
        self._value_res = max(self._value_res, int(resolution))
        return self._tex_row(ttype=TEX_VALUE)

    def worley(self) -> int:
        return self._tex_row(ttype=TEX_WORLEY)

    def voronoi(self) -> int:
        return self._tex_row(ttype=TEX_VORONOI)

    def _as_tex(self, tex_or_color) -> int:
        if isinstance(tex_or_color, (int, np.integer)):
            return int(tex_or_color)
        return self.solid(tex_or_color)

    # ---------------- materials ----------------
    def _mat_row(self, **kw) -> int:
        row = dict(mtype=MAT_LAMBERTIAN, tex=0, fuzz=0.0, ior=1.0,
                   smoothness=0.0, spec_prob=0.0, dispersion=0.0)
        row.update(kw)
        self._mats.append(row)
        return len(self._mats) - 1

    def lambertian(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_LAMBERTIAN, tex=self._as_tex(tex_or_color))

    def metal(self, tex_or_color, fuzz: float = 0.0) -> int:
        return self._mat_row(mtype=MAT_METAL, tex=self._as_tex(tex_or_color),
                             fuzz=float(np.clip(fuzz, 0.0, 1.0)))

    def dielectric(self, ior: float, tex_or_color=(1.0, 1.0, 1.0),
                   dispersion: float = 0.0) -> int:
        """``dispersion``: Cauchy B in um^2 (BK7 glass ~0.0042, dense flint
        ~0.013); nonzero turns on the hero-wavelength render for the whole
        scene (``Scene.has_dispersion``)."""
        return self._mat_row(mtype=MAT_DIELECTRIC, tex=self._as_tex(tex_or_color),
                             ior=float(ior), dispersion=float(dispersion))

    def gloss(self, tex_or_color, smoothness: float, spec_prob: float) -> int:
        """Probabilistic specular/diffuse lobe pick with a smoothness lerp of
        the specular direction (src/material.h:158-173)."""
        return self._mat_row(mtype=MAT_GLOSS, tex=self._as_tex(tex_or_color),
                             smoothness=float(np.clip(smoothness, 0.0, 1.0)),
                             spec_prob=float(spec_prob))

    def isotropic(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_ISOTROPIC, tex=self._as_tex(tex_or_color))

    def diffuse_light(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_DIFFUSE_LIGHT, tex=self._as_tex(tex_or_color))

    # ---------------- primitives ----------------
    def sphere(self, center, radius: float, mat: int) -> int:
        c = np.asarray(center, np.float64)
        self._sph.append((c, c, max(0.0, float(radius)), int(mat)))
        return len(self._sph) - 1

    def moving_sphere(self, center0, center1, radius: float, mat: int) -> int:
        self._sph.append((np.asarray(center0, np.float64),
                          np.asarray(center1, np.float64),
                          max(0.0, float(radius)), int(mat)))
        return len(self._sph) - 1

    def quad(self, corner, u, v, mat: int, rotate=None, translate=None) -> int:
        c = _apply_instance(np.asarray(corner, np.float64), rotate, translate)
        eu = _apply_instance(np.asarray(u, np.float64), rotate, None, is_vector=True)
        ev = _apply_instance(np.asarray(v, np.float64), rotate, None, is_vector=True)
        self._quads.append((c, eu, ev, int(mat)))
        return len(self._quads) - 1

    def box(self, a, b, mat: int, rotate=None, translate=None) -> list:
        """Axis-aligned box as six quads (src/quad.h:91-112), with an
        optional folded rotate/translate instance transform."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0])
        dy = np.array([0, mx[1] - mn[1], 0])
        dz = np.array([0, 0, mx[2] - mn[2]])
        faces = [
            ((mn[0], mn[1], mx[2]), dy, dx),    # front
            ((mx[0], mn[1], mx[2]), dy, -dz),   # right
            ((mx[0], mn[1], mn[2]), dy, -dx),   # back
            ((mn[0], mn[1], mn[2]), dy, dz),    # left
            ((mn[0], mx[1], mx[2]), -dz, dx),   # top
            ((mn[0], mn[1], mn[2]), dz, dx),    # bottom
        ]
        return [self.quad(c, u, v, mat, rotate=rotate, translate=translate)
                for c, u, v in faces]

    def triangles(self, verts, mat: int, rotate=None, translate=None,
                  normals=None, uvs=None):
        """Bulk add [T,3,3] triangle vertices (a mesh, main.cc:345-498).
        ``normals`` [T,3,3] / ``uvs`` [T,3,2]: optional per-vertex
        attributes, interpolated at the hit's barycentric (a, b); the
        normals turn with ``rotate`` as vectors."""
        verts = _apply_instance(np.asarray(verts, np.float64).reshape(-1, 3),
                                rotate, translate).reshape(-1, 3, 3)
        if normals is not None:
            normals = _apply_instance(np.asarray(normals, np.float64).reshape(-1, 3),
                                      rotate, None, is_vector=True).reshape(-1, 3, 3)
        if uvs is not None:
            uvs = np.asarray(uvs, np.float64).reshape(-1, 3, 2)
        for i, t in enumerate(verts):
            self._tris.append((t[0], t[1], t[2], int(mat)))
            n_i = None if normals is None else normals[i]
            uv_i = None if uvs is None else uvs[i]
            self._tri_attrs.append(None if n_i is None and uv_i is None
                                   else (n_i, uv_i))

    def gltf_asset(self, asset, default_mat: int | None = None,
                   filter: str = "nearest") -> int:
        """Add every primitive of a ``utils.gltf.GltfAsset``, each bound to
        its own glTF material as a lambertian: its baseColorTexture (sampled
        through the primitive's UVs) or its solid baseColorFactor
        (``scene.py:450-500`` of the JAX package). A non-unit factor
        premultiplies the texture on the host (glTF's baseColor = factor x
        texture); glTF's UV origin is top-left, so v is flipped for the
        picture texture's bottom-left convention (src/texture.h:68-74).
        ``default_mat``: the material of primitives without one (default:
        white lambertian). Returns the number of triangles added."""
        mat_cache: dict = {}

        def mat_for(mi: int) -> int:
            if mi not in mat_cache:
                if mi < 0 or mi >= len(asset.materials):
                    mat_cache[mi] = (default_mat if default_mat is not None
                                     else self.lambertian((1.0, 1.0, 1.0)))
                else:
                    m = asset.materials[mi]
                    f = np.asarray(m.base_color_factor[:3], np.float32)
                    if m.base_color_image is None:
                        mat_cache[mi] = self.lambertian(tuple(f))
                    else:
                        img = m.base_color_image
                        if not np.allclose(f, 1.0):
                            img = img * f[None, None, :]
                        mat_cache[mi] = self.lambertian(self.picture(img, filter=filter))
            return mat_cache[mi]

        n = 0
        for p in asset.primitives:
            if not len(p.indices):
                continue
            corners = p.indices.reshape(-1, 3)
            normals = None if p.normals is None else p.normals[corners]
            uvs = None
            if p.uvs is not None:
                uvs = p.uvs[corners].copy()
                uvs[..., 1] = 1.0 - uvs[..., 1]
            self.triangles(p.triangles, mat_for(p.material), normals=normals, uvs=uvs)
            n += len(corners)
        return n

    def triangle(self, p0, p1, p2, mat: int, rotate=None, translate=None) -> int:
        pts = _apply_instance(np.stack([np.asarray(p, np.float64)
                                        for p in (p0, p1, p2)]),
                              rotate, translate)
        self._tris.append((pts[0], pts[1], pts[2], int(mat)))
        self._tri_attrs.append(None)
        return len(self._tris) - 1

    def volume_box(self, a, b, density: float, tex_or_color, rotate=None,
                   translate=None) -> int:
        """Constant-density medium in a (possibly rotated) box boundary
        (src/volumne.h, the smoke boxes of main.cc:227-283)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        center = (a + b) / 2.0
        half = np.abs(b - a) / 2.0
        rot = np.eye(3)
        if rotate is not None:
            rots = [rotate] if isinstance(rotate, tuple) else list(rotate)
            for axis, deg in rots:
                rot = _rot_matrix(axis, deg) @ rot
        center = rot @ center
        if translate is not None:
            center = center + np.asarray(translate, np.float64)
        mat = self.isotropic(tex_or_color)
        self._vols.append((VOL_BOX, center, half, rot, float(density), mat))
        return len(self._vols) - 1

    def volume_sphere(self, center, radius: float, density: float, tex_or_color) -> int:
        mat = self.isotropic(tex_or_color)
        self._vols.append((VOL_SPHERE, np.asarray(center, np.float64),
                           np.array([radius, radius, radius]), np.eye(3),
                           float(density), mat))
        return len(self._vols) - 1

    def volume_mesh(self, verts, density: float, tex_or_color, rotate=None,
                    translate=None) -> int:
        """Constant-density medium bounded by a closed triangle mesh ([T,3,3]
        vertices): the medium spans [first hit, last hit] of the boundary
        along the whole line (interval::universe, src/volumne.h:21-22),
        exact for convex meshes, as the reference's own probe."""
        verts = _apply_instance(np.asarray(verts, np.float64).reshape(-1, 3),
                                rotate, translate).reshape(-1, 3, 3)
        mat = self.isotropic(tex_or_color)
        centroid = verts.reshape(-1, 3).mean(axis=0)
        self._vols.append((VOL_MESH, centroid, np.ones(3), np.eye(3),
                           float(density), mat))
        vid = len(self._vols) - 1
        self._vol_mesh.append((vid, verts))
        return vid

    def light(self, quad_id: int):
        """Register a quad as an MIS-sampled light (src/camera.h:135)."""
        self._lights.append(int(quad_id))

    def sphere_light(self, sphere_id: int):
        """Register a sphere as an MIS-sampled light (solid-angle cone
        sampling, ``ops/sampling.cone_dir``; the reference's hook,
        src/sphere.h:76-81, has placeholder math and no scene uses it)."""
        self._sphere_lights.append(int(sphere_id))

    def set_background(self, tex_id: int, importance_sample: bool = False,
                       env_res: tuple = (64, 128)):
        """The background texture, found by BSDF sampling
        (src/camera.h:205-210); ``importance_sample=True`` also registers it
        as an MIS light, its luminance tabulated on an ``env_res`` (H, W)
        equirect grid at build time (``ops/envlight.py``)."""
        self._background = int(tex_id)
        self._env_importance = bool(importance_sample)
        self._env_res = tuple(env_res)

    def _maybe_recenter(self) -> np.ndarray | None:
        """Fold a size-weighted scene centroid out of all geometry when it
        is far from the origin. Returns the offset (world = stored +
        offset) or None. Weights are 1/feature-size: f32 cancellation in
        the expanded quadratics scales with |center|^2 / size^2."""
        pts, wts = [], []

        def add(center, size):
            pts.append(np.asarray(center, np.float64))
            wts.append(1.0 / max(float(size), 1e-6))

        for r in self._sph:
            add(r[0], r[2])
        for r in self._quads:
            add(np.asarray(r[0], np.float64)
                + 0.5 * (np.asarray(r[1], np.float64) + np.asarray(r[2], np.float64)),
                max(np.linalg.norm(r[1]), np.linalg.norm(r[2])))
        for r in self._tris:
            v0 = np.asarray(r[0], np.float64)
            add((v0 + np.asarray(r[1], np.float64) + np.asarray(r[2], np.float64)) / 3.0,
                max(np.linalg.norm(np.asarray(r[1], np.float64) - v0),
                    np.linalg.norm(np.asarray(r[2], np.float64) - v0)))
        for r in self._vols:
            add(r[1], np.linalg.norm(r[2]))
        if not pts:
            return None
        w = np.asarray(wts)[:, None]
        centroid = (np.stack(pts) * w).sum(axis=0) / w.sum()
        if np.linalg.norm(centroid) <= self.RECENTER_THRESHOLD:
            return None
        off = centroid.astype(np.float32).astype(np.float64)
        self._sph = [(r[0] - off, r[1] - off, r[2], r[3]) for r in self._sph]
        self._quads = [(r[0] - off, r[1], r[2], r[3]) for r in self._quads]
        self._tris = [(r[0] - off, r[1] - off, r[2] - off, r[3])
                      for r in self._tris]
        self._vols = [(r[0], r[1] - off, r[2], r[3], r[4], r[5])
                      for r in self._vols]
        return off

    # ---------------- build ----------------
    def build(self, device=tbl.DEFAULT_DEVICE) -> Scene:
        """Padded tables on ``device`` (the card unless the caller asks for
        the CPU). A table above ``chunked.DENSE_MAX`` rows also gets its
        chunked form (``scene.py:660-735`` of the JAX package)."""
        device = tbl.as_device(device)
        f32 = np.float32
        world_offset = self._maybe_recenter()

        def stack3(rows, idx):
            if rows:
                return np.stack([np.asarray(r[idx], f32) for r in rows])
            return np.zeros((0, 3), f32)

        def col(rows, idx, dtype=f32):
            return (np.array([r[idx] for r in rows], dtype) if rows
                    else np.zeros((0,), dtype))

        def pad(arr, n, fill=0):
            if arr.shape[0] >= n:
                return arr
            pad_shape = (n - arr.shape[0],) + arr.shape[1:]
            return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])

        def table(rows, specs):
            n = max(1, len(rows))
            out = []
            for idx, dtype in specs:
                a = stack3(rows, idx) if dtype == "vec3" else col(rows, idx, dtype)
                out.append(pad(a, n))
            out.append(np.arange(n) < len(rows))
            return out

        vec4 = [(0, "vec3"), (1, "vec3"), (2, "vec3"), (3, np.int32)]
        sph = table(self._sph, [(0, "vec3"), (1, "vec3"), (2, f32), (3, np.int32)])
        qds = table(self._quads, vec4)
        tri = table(self._tris, vec4)

        chunks = self._chunk_tables()
        nodes = {fam: chunks.pop(f"{fam}_nodes") for fam in ("sphere", "quad", "tri")}
        tri_attrs = self._tri_attr_table(chunks["tri_chunk_order"])

        vol_rows = self._vols
        n_v = max(1, len(vol_rows))
        vols = [
            pad(col(vol_rows, 0, np.int32), n_v),
            pad(stack3(vol_rows, 1), n_v),
            pad(stack3(vol_rows, 2), n_v, 1),
            pad(np.stack([np.asarray(r[3], f32) for r in vol_rows])
                if vol_rows else np.zeros((0, 3, 3), f32), n_v),
            pad(np.array([-1.0 / r[4] for r in vol_rows], f32), n_v, -1),
            pad(col(vol_rows, 5, np.int32), n_v),
            np.arange(n_v) < len(vol_rows),
        ]
        if self._vol_mesh:
            mv = np.concatenate([m[1] for m in self._vol_mesh]).astype(f32)
            vols += [mv[:, 0], mv[:, 1] - mv[:, 0], mv[:, 2] - mv[:, 0],
                     np.concatenate([np.full(len(m[1]), m[0], np.int32)
                                     for m in self._vol_mesh]),
                     np.ones(len(mv), bool)]
        grad, perm = noise_ops.make_perlin_tables(self._seed)
        noise = [grad, perm, noise_ops.make_value_grid(self._value_res, self._seed + 1)]

        if not self._mats:
            self._mat_row()
        mats = [np.array([m[k] for m in self._mats], dt) for k, dt in (
            ("mtype", np.int32), ("tex", np.int32), ("fuzz", f32), ("ior", f32),
            ("smoothness", f32), ("spec_prob", f32), ("dispersion", f32))]
        if not self._texs:
            self._tex_row()
        texs = [np.array([t[k] for t in self._texs], dt) for k, dt in (
            ("ttype", np.int32), ("color0", f32), ("color1", f32),
            ("scale", f32), ("image_id", np.int32), ("tfilter", np.int32))]

        # static scene AABB (traced frame): union over all primitive bounds
        blo = np.full(3, np.inf)
        bhi = np.full(3, -np.inf)

        def acc(lo_pts, hi_pts):
            nonlocal blo, bhi
            blo = np.minimum(blo, np.min(lo_pts, axis=0))
            bhi = np.maximum(bhi, np.max(hi_pts, axis=0))

        if self._sph:
            c0 = np.stack([np.asarray(r[0], np.float64) for r in self._sph])
            c1 = np.stack([np.asarray(r[1], np.float64) for r in self._sph])
            rr = np.array([r[2] for r in self._sph])[:, None]
            acc(np.minimum(c0, c1) - rr, np.maximum(c0, c1) + rr)
        if self._quads:
            qc, qu, qv = (np.stack([np.asarray(r[i], np.float64)
                                    for r in self._quads]) for i in range(3))
            p = np.stack([qc, qc + qu, qc + qv, qc + qu + qv])
            acc(p.min(axis=0), p.max(axis=0))
        if self._tris:
            tv = np.stack([[np.asarray(r[i], np.float64) for i in range(3)]
                           for r in self._tris])
            acc(tv.min(axis=1), tv.max(axis=1))
        if self._vols:
            vc = np.stack([np.asarray(r[1], np.float64) for r in self._vols])
            vr = np.array([np.linalg.norm(r[2]) for r in self._vols])[:, None]
            acc(vc - vr, vc + vr)
        have_bounds = bool(np.isfinite(blo).all() and np.isfinite(bhi).all())

        scene = scene_from_tables(
            dict(spheres=sph, quads=qds, tris=tri, volumes=vols,
                 materials=mats, textures=texs, noise=noise,
                 lights=np.array(self._lights, np.int32),
                 sphere_lights=(np.array(self._sphere_lights, np.int32)
                                if self._sphere_lights else None),
                 images=self._imgs or [np.zeros((1, 1, 3), f32)],
                 world_offset=(None if world_offset is None
                               else world_offset.astype(f32)),
                 tri_attrs=tri_attrs, **chunks),
            device=device,
            background=self._background,
            tex_types_used=tuple(sorted({t["ttype"] for t in self._texs})),
            mat_types_used=tuple(sorted({m["mtype"] for m in self._mats})),
            has_bilinear=any(t["tfilter"] == 1 for t in self._texs),
            has_dispersion=any(m["dispersion"] != 0.0 for m in self._mats),
            counts=(len(self._sph), len(self._quads), len(self._tris),
                    len(self._vols)),
            world_lo=tuple(float(x) for x in blo) if have_bounds else None,
            world_hi=tuple(float(x) for x in bhi) if have_bounds else None)
        # the traversal trees over the chunk tables' kernel constant packs,
        # built on the scene's device, so a leaf's constants are bitwise the
        # kernels' (K1, K2, K6)
        scene = scene.replace(**{
            f"{fam}_tree": bvh_mod.build_tree(
                n, bvh_mod.flatten_chunk_pack(getattr(scene, f"{fam}_pack")), MAX_LEAF)
            for fam, n in nodes.items() if n is not None})
        if self._env_importance and self._background >= 0:
            # the tables rasterize the built scene's background texture
            # (imported here: envlight reads ops/textures, which reads this)
            from cpu_ray_tracing_implementation_tpu_torch.ops import envlight

            p_texel, row_cdf, col_cdf = envlight.build_tables(scene, self._env_res)
            scene = scene.replace(env_texel_p=p_texel, env_row_cdf=row_cdf,
                                  env_col_cdf=col_cdf)
        return scene


    def _tri_attr_table(self, order) -> list | None:
        """The ``TriAttrs`` columns as numpy arrays, or None when no
        triangle carries an attribute: rows in the intersector's pid space,
        ``order`` (the chunk order) padded to K*C when the table is
        chunked, the raw order padded to one row otherwise
        (``scene.py:737-770`` of the JAX package)."""
        if all(a is None for a in self._tri_attrs):
            return None
        n_raw = len(self._tris)
        nrm = np.zeros((n_raw, 3, 3), np.float32)
        uv = np.zeros((n_raw, 3, 2), np.float32)
        smooth = np.zeros((n_raw,), bool)
        for i, a in enumerate(self._tri_attrs):
            if a is None:
                continue
            n_i, uv_i = a
            if n_i is not None:
                nrm[i] = n_i
                smooth[i] = True
            if uv_i is not None:
                uv[i] = uv_i
        n_rows = max(1, n_raw)
        if order is not None:
            nrm, uv, smooth = nrm[order], uv[order], smooth[order]
            n_rows = -(-n_raw // chunked_mod.CHUNK) * chunked_mod.CHUNK

        def pad(a):
            return np.concatenate([a, np.zeros((n_rows - len(a),) + a.shape[1:], a.dtype)])

        nrm, uv, smooth = pad(nrm), pad(uv), pad(smooth)
        return [nrm[:, 0], nrm[:, 1], nrm[:, 2], uv[:, 0], uv[:, 1], uv[:, 2], smooth]

    def _chunk_tables(self) -> dict:
        """Chunked tables of the families above ``chunked.DENSE_MAX`` rows:
        ``{"<family>_chunks": column list | None, "<family>_chunk_order":
        [n] int32 | None, "<family>_nodes": the builder's node array | None}``
        with the columns in dataclass field order; no nodes under the
        builder's Morton fallback (``scene.py:671-735`` of the JAX
        package)."""
        f32 = np.float32
        C = chunked_mod.CHUNK

        def chunkify(cols, lo, hi, mats):
            """BVH order, pad to a CHUNK multiple, reshape chunk-major."""
            n = len(lo)
            order, nodes = accel.build_bvh((lo + hi) / 2.0, lo, hi,
                                           max_leaf=MAX_LEAF)
            k = (n + C - 1) // C
            pad_n = k * C - n
            out = []
            for col in cols:
                a = np.asarray(col, f32)[order]
                a = np.concatenate([a, np.zeros((pad_n,) + a.shape[1:], a.dtype)])
                out.append(a.reshape((k, C) + a.shape[1:]))
            m = np.concatenate([np.asarray(mats, np.int32)[order],
                                np.zeros(pad_n, np.int32)])
            act = np.concatenate([np.ones(n, bool), np.zeros(pad_n, bool)])
            clo, chi = accel.chunk_bounds(lo[order], hi[order], C)
            return (out + [m.reshape(k, C), act.reshape(k, C), clo, chi],
                    np.asarray(order, np.int32), nodes)

        def planar(corner, eu, ev, mats):
            pts = np.stack([corner, corner + eu, corner + ev, corner + eu + ev])
            # pad degenerate axes (src/aabb.h:81-86)
            return chunkify([corner, eu, ev], pts.min(axis=0) - 1e-4,
                            pts.max(axis=0) + 1e-4, mats)

        def stack(rows, idx):
            return np.stack([np.asarray(r[idx], f32) for r in rows])

        out = {f"{fam}_{what}": None for fam in ("sphere", "quad", "tri")
               for what in ("chunks", "chunk_order", "nodes")}
        big = chunked_mod.DENSE_MAX
        if len(self._sph) > big:
            c0, c1 = stack(self._sph, 0), stack(self._sph, 1)
            rad = np.array([r[2] for r in self._sph], f32)
            out["sphere_chunks"], out["sphere_chunk_order"], out["sphere_nodes"] = chunkify(
                [c0, c1, rad], np.minimum(c0, c1) - rad[:, None],
                np.maximum(c0, c1) + rad[:, None], [r[3] for r in self._sph])
        if len(self._quads) > big:
            out["quad_chunks"], out["quad_chunk_order"], out["quad_nodes"] = planar(
                stack(self._quads, 0), stack(self._quads, 1),
                stack(self._quads, 2), [r[3] for r in self._quads])
        if len(self._tris) > big:
            v0 = stack(self._tris, 0)
            out["tri_chunks"], out["tri_chunk_order"], out["tri_nodes"] = planar(
                v0, stack(self._tris, 1) - v0, stack(self._tris, 2) - v0,
                [r[3] for r in self._tris])
        return out


# primitives per BVH leaf of the chunk order (the JAX package's MAX_LEAF)
MAX_LEAF = 8

_TABLES = {"spheres": Spheres, "quads": Quads, "tris": Triangles,
           "volumes": Volumes, "materials": Materials, "textures": Textures,
           "noise": NoiseTables}
_CHUNKS = {"sphere_chunks": chunked_mod.SphereChunks,
           "quad_chunks": chunked_mod.PlanarChunks,
           "tri_chunks": chunked_mod.PlanarChunks}


def scene_from_tables(arrays: dict, device, **static) -> Scene:
    """Scene on ``device`` from numpy arrays: ``arrays`` maps each table
    name of ``_TABLES`` to its column list (dataclass field order; an
    optional trailing column, such as the volumes' mesh tables, may be
    None or left out), plus ``lights``, ``sphere_lights`` (or None),
    ``images`` (a list of [h,w,3] arrays) and ``world_offset`` (or None),
    optionally the environment light's ``env_texel_p``, ``env_row_cdf``
    and ``env_col_cdf`` (absent or None: no environment light), optionally
    ``tri_attrs``, the ``TriAttrs`` columns in field order (absent or None:
    no per-vertex attributes), and optionally, for each
    name of ``_CHUNKS``, its column list, its ``*_chunk_order`` array and
    its ``*_tree`` (node_pack, prim_pack, max_leaf) as
    ``SceneBuilder._chunk_tables`` gives them (absent or None: the table is
    dense, or has no tree). ``static`` holds the non-tensor Scene fields."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)  # own, writable copy

    def opt(a):
        return None if a is None else t(a)

    tables = {name: cls(*[opt(a) for a in arrays[name]])
              for name, cls in _TABLES.items()}
    for name, cls in _CHUNKS.items():
        cols = arrays.get(name)
        tables[name] = None if cols is None else cls(*[t(a) for a in cols])
        order = name.replace("_chunks", "_chunk_order")
        tables[order] = opt(arrays.get(order))
        tree = arrays.get(name.replace("_chunks", "_tree"))
        tables[name.replace("_chunks", "_tree")] = None if tree is None else bvh_mod.BVHTree(
            node_pack=t(tree[0]), prim_pack=t(tree[1]), max_leaf=int(tree[2]))
    return Scene(**tables, lights=t(arrays["lights"]),
                 sphere_lights=opt(arrays.get("sphere_lights")),
                 images=tuple(t(im) for im in arrays["images"]),
                 world_offset=opt(arrays["world_offset"]),
                 env_texel_p=opt(arrays.get("env_texel_p")),
                 env_row_cdf=opt(arrays.get("env_row_cdf")),
                 env_col_cdf=opt(arrays.get("env_col_cdf")),
                 tri_attrs=(None if arrays.get("tri_attrs") is None
                            else TriAttrs(*[t(a) for a in arrays["tri_attrs"]])),
                 **static)
