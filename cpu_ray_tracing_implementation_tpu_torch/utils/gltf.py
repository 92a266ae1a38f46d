"""Host-side glTF 2.0 asset ingestion.

A copy of ``cpu_ray_tracing_implementation_tpu/utils/gltf.py`` (it imports
no jax there either; the port imports nothing of the JAX package, so its
images decode through the port's own ``utils/image_io``). It replaces the
reference's hand-rolled C++ loader (src/gltf_loader.h:256-812): scene
assembly is host-side Python (stdlib ``json`` + NumPy buffer walks)
producing flat triangle arrays that feed the SceneBuilder tables; nothing
here runs on the device.

Deliberate fixes over the reference (SURVEY.md appendix item 6):
 - every mesh contributes primitives (the reference's ``loadMesh`` keeps only
   the last mesh, src/gltf_loader.h:300-303);
 - node TRS / matrix transforms are composed down the scene graph and applied
   to vertices (parsed but ignored in the reference, src/gltf_loader.h:432-505);
 - all buffers load, including base64 data URIs and GLB BIN chunks (the
   reference reads only ``buffers[0]`` from disk, src/gltf_loader.h:563-582);
 - u8/u16/u32 index widths (the reference handles only u16, src/main.cc:370);
 - accessor reads honor bufferView byteStride (the reference copies
   stride-sized chunks assuming tight packing, src/gltf_loader.h:666-673).

Missing files degrade to an empty triangle list with a warning, mirroring the
reference's magenta-texture-style graceful degradation (src/image.h:75).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

# componentType -> numpy dtype (glTF 2.0 spec table; src/gltf_loader.h:16-36)
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_LANES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}

MODE_TRIANGLES = 4  # primitive.mode (src/gltf_loader.h:318-344)


@dataclass
class Primitive:
    """One drawable primitive in world space."""

    positions: np.ndarray           # [V,3] float32, node transform applied
    indices: np.ndarray             # [I] int32 (triangle list)
    normals: np.ndarray | None = None   # [V,3]
    uvs: np.ndarray | None = None       # [V,2]
    tangents: np.ndarray | None = None  # [V,4] xyz world-space + w handedness
    material: int = -1

    @property
    def triangles(self) -> np.ndarray:
        """[T,3,3] vertex triples."""
        idx = self.indices.reshape(-1, 3)
        return self.positions[idx]


@dataclass
class Material:
    """glTF PBR material reduced to what the renderer binds: base color.

    The reference parses pbrMetallicRoughness (factor + baseColorTexture)
    and then never uses it — no main.cc scene reads loader materials
    (src/gltf_loader.h:706-758). Here the parsed base color binds per
    primitive via SceneBuilder.gltf_asset."""

    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    base_color_image: np.ndarray | None = None  # [h,w,3] f32 byte-scale
    name: str = ""


@dataclass
class GltfAsset:
    primitives: list = field(default_factory=list)
    materials: list = field(default_factory=list)

    def all_triangles(self) -> np.ndarray:
        """Concatenated [T,3,3] world-space triangles of every primitive."""
        tris = [p.triangles for p in self.primitives if len(p.indices)]
        if not tris:
            return np.zeros((0, 3, 3), np.float32)
        return np.concatenate(tris, axis=0)


def _node_matrix(node: dict) -> np.ndarray:
    """4x4 local transform: explicit matrix, else T*R*S from TRS fields."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    s = node.get("scale")
    if s is not None:
        m = m @ np.diag([s[0], s[1], s[2], 1.0])
    q = node.get("rotation")  # [x,y,z,w]
    if q is not None:
        x, y, z, w = q
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    t = node.get("translation")
    if t is not None:
        tm = np.eye(4)
        tm[:3, 3] = t
        m = tm @ m
    return m


class GltfLoader:
    """Parse a .gltf/.glb file into world-space primitives."""

    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(path)
        self.primitives: list[Primitive] = []
        self._buffers: list[bytes | None] = []
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":
                self.gltf, self._glb_bin = self._parse_glb(f.read())
            else:
                self.gltf = json.loads(f.read().decode("utf-8"))
                self._glb_bin = None
        self._load_buffers()
        self.materials = self._load_materials()
        self._walk_scene()

    # ------------------------------------------------------------ containers
    @staticmethod
    def _parse_glb(blob: bytes):
        magic, version, _length = struct.unpack_from("<4sII", blob, 0)
        assert magic == b"glTF" and version == 2, (magic, version)
        off = 12
        gltf_json, bin_chunk = None, None
        while off < len(blob):
            clen, ctype = struct.unpack_from("<II", blob, off)
            data = blob[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                gltf_json = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = data
            off += 8 + clen
        return gltf_json, bin_chunk

    def _load_buffers(self):
        for buf in self.gltf.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                self._buffers.append(self._glb_bin)
            elif uri.startswith("data:"):
                self._buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                p = os.path.join(self.dir, uri)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        self._buffers.append(f.read())
                else:
                    print(f"[gltf] missing buffer {p!r}; primitives using it are dropped")
                    self._buffers.append(None)

    # ------------------------------------------------------------ materials
    def _load_materials(self) -> list:
        """Parse materials[] down to base color (factor + texture image) —
        the data the reference's loader reads and drops
        (src/gltf_loader.h:706-758; its metallicRoughnessTexture even
        overwrites base_color_texture_index, :749-751)."""
        mats = []
        for m in self.gltf.get("materials", []):
            pbr = m.get("pbrMetallicRoughness", {})
            factor = tuple(pbr.get("baseColorFactor", (1.0, 1.0, 1.0, 1.0)))
            img = None
            if "baseColorTexture" in pbr:
                try:
                    tex = self.gltf["textures"][pbr["baseColorTexture"]["index"]]
                    if "source" in tex:
                        img = self._load_image(tex["source"])
                except Exception as e:  # degrade, not die (image.h:75 spirit)
                    print(f"[gltf] baseColorTexture load failed: {e}")
            mats.append(Material(base_color_factor=factor,
                                 base_color_image=img,
                                 name=m.get("name", "")))
        return mats

    def _load_image(self, idx: int) -> np.ndarray | None:
        """images[idx] -> [h,w,3] float32 byte-scale (file uri, data uri, or
        GLB bufferView)."""
        image = self.gltf["images"][idx]
        uri = image.get("uri")
        if uri and not uri.startswith("data:"):
            from cpu_ray_tracing_implementation_tpu_torch.utils import image_io

            return image_io.load_image(os.path.join(self.dir, uri))
        if uri:
            raw = base64.b64decode(uri.split(",", 1)[1])
        elif "bufferView" in image:
            bv = self.gltf["bufferViews"][image["bufferView"]]
            buf = self._buffers[bv["buffer"]]
            if buf is None:
                return None
            off = bv.get("byteOffset", 0)
            raw = buf[off:off + bv["byteLength"]]
        else:
            return None
        import io

        from PIL import Image

        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"), np.float32)

    # ------------------------------------------------------------ accessors
    def _read_accessor(self, idx: int) -> np.ndarray | None:
        """Decode accessor ``idx`` to [count, lanes] (stride-aware)."""
        acc = self.gltf["accessors"][idx]
        if "bufferView" not in acc:  # sparse-only accessors default to zeros
            lanes = _TYPE_LANES[acc["type"]]
            return np.zeros((acc["count"], lanes), _COMPONENT_DTYPES[acc["componentType"]])
        bv = self.gltf["bufferViews"][acc["bufferView"]]
        raw = self._buffers[bv["buffer"]]
        if raw is None:
            return None
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        lanes = _TYPE_LANES[acc["type"]]
        count = acc["count"]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or dtype.itemsize * lanes
        if stride == dtype.itemsize * lanes:
            out = np.frombuffer(raw, dtype, count * lanes, start).reshape(count, lanes)
        else:  # interleaved attributes: each element's bytes at its stride
            width = dtype.itemsize * lanes
            blk = np.frombuffer(raw, np.uint8, (count - 1) * stride + width, start)
            rows = np.lib.stride_tricks.as_strided(blk, (count, width), (stride, 1))
            out = rows.copy().view(dtype).reshape(count, lanes)
        return np.array(out)  # owned copy

    # ------------------------------------------------------------ scene walk
    def _walk_scene(self):
        scenes = self.gltf.get("scenes", [])
        nodes = self.gltf.get("nodes", [])
        scene_idx = self.gltf.get("scene", 0 if scenes else -1)
        if scene_idx < 0 or not scenes:
            roots = list(range(len(nodes)))  # no scene: treat all nodes as roots
        else:
            roots = scenes[scene_idx].get("nodes", [])

        def visit(node_idx: int, parent: np.ndarray):
            node = nodes[node_idx]
            world = parent @ _node_matrix(node)
            if "mesh" in node:
                self._emit_mesh(node["mesh"], world)
            for child in node.get("children", []):
                visit(child, world)

        for r in roots:
            visit(r, np.eye(4))
        if not roots and not self.primitives:
            for m in range(len(self.gltf.get("meshes", []))):
                self._emit_mesh(m, np.eye(4))

    def _emit_mesh(self, mesh_idx: int, world: np.ndarray):
        mesh = self.gltf["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", MODE_TRIANGLES) != MODE_TRIANGLES:
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = self._read_accessor(attrs["POSITION"])
            if pos is None:
                continue
            pos = pos.astype(np.float64)
            pos_w = (pos @ world[:3, :3].T) + world[:3, 3]

            if "indices" in prim:
                idx = self._read_accessor(prim["indices"])
                if idx is None:
                    continue
                idx = idx.reshape(-1).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32)
            idx = idx[: (len(idx) // 3) * 3]

            normals = uvs = None
            if "NORMAL" in attrs:
                n = self._read_accessor(attrs["NORMAL"])
                if n is not None:
                    # normals transform by the inverse-transpose linear part
                    lin = np.linalg.inv(world[:3, :3]).T
                    nw = n.astype(np.float64) @ lin.T
                    normals = (nw / (np.linalg.norm(nw, axis=-1, keepdims=True) + 1e-20)).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                t = self._read_accessor(attrs["TEXCOORD_0"])
                if t is not None:
                    uvs = t.astype(np.float32)
            tangents = None
            if "TANGENT" in attrs:
                # [V,4]: xyz tangent + w bitangent handedness. The reference
                # parses TANGENT and then drops it (src/gltf_loader.h:174,
                # 349,770); kept here for normal-mapping consumers. Tangents
                # are surface directions: transform by the LINEAR part (not
                # the normals' inverse-transpose), renormalize, keep w.
                tg = self._read_accessor(attrs["TANGENT"])
                if tg is not None and tg.ndim == 2 and tg.shape[1] == 4:
                    txyz = tg[:, :3].astype(np.float64) @ world[:3, :3].T
                    txyz /= np.linalg.norm(txyz, axis=-1, keepdims=True) + 1e-20
                    # mirroring transform (negative determinant) flips
                    # surface orientation: a consumer reconstructing the
                    # bitangent as w*(n x t) needs w's sign flipped too,
                    # or normal maps invert on mirrored instances
                    wsign = 1.0 if np.linalg.det(world[:3, :3]) >= 0 else -1.0
                    tangents = np.concatenate(
                        [txyz, wsign * tg[:, 3:4].astype(np.float64)],
                        axis=1).astype(np.float32)

            self.primitives.append(Primitive(
                positions=pos_w.astype(np.float32),
                indices=idx,
                normals=normals,
                uvs=uvs,
                tangents=tangents,
                material=prim.get("material", -1),
            ))


def load_asset(path: str) -> GltfAsset:
    """Load ``path`` -> GltfAsset; missing file degrades to empty."""
    if not os.path.exists(path):
        print(f"[gltf] {path!r} not found; returning empty asset")
        return GltfAsset()
    try:
        ld = GltfLoader(path)
        return GltfAsset(primitives=ld.primitives, materials=ld.materials)
    except Exception as e:  # noqa: BLE001
        print(f"[gltf] failed to parse {path!r}: {e}; returning empty asset")
        return GltfAsset()


def load_mesh(path: str):
    """(triangles [T,3,3], normals [T,3,3] | None, uvs [T,3,2] | None) —
    per-vertex attributes expanded per triangle corner.

    Attributes are returned only when EVERY primitive carries them (mixed
    meshes degrade to flat shading for all, keeping the tables uniform).
    The reference parses NORMAL/TEXCOORD_0 and then discards them
    (src/main.cc:353-393, SURVEY.md appendix item 8); here they feed
    barycentric-interpolated shading (models/scene.TriAttrs).
    """
    asset = load_asset(path)
    prims = [p for p in asset.primitives if len(p.indices)]
    if not prims:
        z = np.zeros((0, 3, 3), np.float32)
        return z, None, None
    tris = np.concatenate([p.triangles for p in prims], axis=0)
    normals = uvs = None
    if all(p.normals is not None for p in prims):
        normals = np.concatenate(
            [p.normals[p.indices.reshape(-1, 3)] for p in prims], axis=0)
    if all(p.uvs is not None for p in prims):
        uvs = np.concatenate(
            [p.uvs[p.indices.reshape(-1, 3)] for p in prims], axis=0)
        # glTF UV origin is top-left (v down); the picture texture samples
        # with the reference's bottom-left v-flip (src/texture.h:68-74) —
        # convert so glTF meshes read their texels correctly
        uvs = uvs.copy()
        uvs[..., 1] = 1.0 - uvs[..., 1]
    return tris, normals, uvs


def load_triangles(path: str) -> np.ndarray:
    """[T,3,3] world-space triangles of every mesh in the file (the shape the
    catalog scenes feed to SceneBuilder.triangles, src/main.cc:345-498)."""
    return load_asset(path).all_triangles()
