"""The port's glTF loader (``utils/gltf.py``) against the JAX package's.

Each case writes a small glTF file with the port's stand-in writer
(``procgen.write_gltf``) and loads it with both loaders: every primitive's
positions, indices, normals, UVs, tangents and material index, every
material's factor, image and name, and ``load_mesh`` / ``load_triangles``
must be equal bitwise. The files cover data-URI, ``.bin`` and GLB
buffers, node TRS (quaternion), matrix and hierarchy transforms, u8, u16
and u32 indices, interleaved attributes (byteStride), several meshes, and
PNG baseColorTextures in a data URI and a GLB bufferView with a factor.
"""

import json

import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.utils import gltf as jgltf
from cpu_ray_tracing_implementation_tpu_torch.utils import gltf, procgen

# a quarter turn about y, as glTF's [x, y, z, w] quaternion
QUARTER_Y = [0.0, 0.70710678, 0.0, 0.70710678]


def _mesh(segments=6, rings=4):
    return procgen.ellipsoid_mesh(segments, rings, radii=(1.0, 2.0, 0.5))


def _equal(path):
    a, b = gltf.load_asset(path), jgltf.load_asset(path)
    assert len(a.primitives) == len(b.primitives)
    for pa, pb in zip(a.primitives, b.primitives):
        for f in ("positions", "indices", "normals", "uvs", "tangents"):
            x, y = getattr(pa, f), getattr(pb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert pa.material == pb.material
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert ma.base_color_factor == mb.base_color_factor and ma.name == mb.name
        assert (ma.base_color_image is None) == (mb.base_color_image is None)
        if ma.base_color_image is not None:
            np.testing.assert_array_equal(ma.base_color_image, mb.base_color_image)
    for got, ref in zip(gltf.load_mesh(path), jgltf.load_mesh(path)):
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(gltf.load_triangles(path), jgltf.load_triangles(path))
    return a


CASES = {
    # data-URI buffer, u16 indices, translation + quaternion + scale
    "data_uri_trs_u16": dict(buffer_in="data", index_type=np.uint16, nodes=[
        {"mesh": 0, "translation": [1.0, 2.0, 3.0], "rotation": QUARTER_Y,
         "scale": [2.0, 1.0, 0.5]}]),
    # GLB, u32 indices, the texture in a bufferView of the BIN chunk
    "glb_u32_texture_bufferview": dict(buffer_in="glb", index_type=np.uint32,
                                       png=True, image_in="bufferView"),
    # .gltf + .bin, u8 indices, interleaved POSITION/NORMAL (byteStride 24)
    "bin_u8_byte_stride": dict(buffer_in="file", index_type=np.uint8, stride=True),
    # a two-level hierarchy with a matrix node under a TRS node
    "hierarchy_matrix": dict(buffer_in="data", nodes=[
        {"children": [1], "translation": [0.0, 5.0, 0.0], "rotation": QUARTER_Y},
        {"mesh": 0, "matrix": [2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 3, 0, 1, 1, 1, 1]}]),
    # a data-URI texture premultiplied by a non-unit factor
    "texture_and_factor": dict(buffer_in="data", png=True, base_color=(0.5, 0.8, 1.0, 1.0)),
    # a factor alone
    "factor_only": dict(buffer_in="file", base_color=(0.2, 0.4, 0.6, 1.0)),
    # no index accessor: three vertices a triangle
    "non_indexed": dict(buffer_in="file", indices=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(tmp_path, case):
    kw = dict(CASES[case])
    pos, nrm, uv, idx = _mesh()
    if kw.pop("indices", True) is False:
        pos, nrm, uv = (x[idx] for x in (pos, nrm, uv))
        idx = None
    if kw.pop("png", False):
        kw["png"] = procgen.checker_png(8, 2)
    path = str(tmp_path / ("m.glb" if kw.get("buffer_in") == "glb" else "m.gltf"))
    procgen.write_gltf(path, pos, idx, nrm, uv, **kw)
    asset = _equal(path)
    (prim,) = asset.primitives
    assert prim.triangles.shape == (len(_mesh()[3]) // 3, 3, 3)
    assert prim.normals is not None and prim.uvs is not None
    if case == "texture_and_factor":
        assert asset.materials[0].base_color_image.shape == (8, 8, 3)


def test_every_mesh_and_instance_survives(tmp_path):
    """Two meshes, one of them placed by two nodes: three primitives, each
    in its own world transform (the reference keeps only the last mesh)."""
    pos, nrm, uv, idx = _mesh()
    path = tmp_path / "two.gltf"
    procgen.write_gltf(str(path), pos, idx, nrm, uv, buffer_in="data")
    doc = json.loads(path.read_text())
    second = json.loads(json.dumps(doc["meshes"][0]))
    second["primitives"][0].pop("indices")
    second["primitives"][0]["attributes"] = {"POSITION": 0}
    doc["meshes"].append(second)
    doc["nodes"] = [{"mesh": 0}, {"mesh": 1, "translation": [4.0, 0.0, 0.0]},
                    {"mesh": 0, "scale": [1.0, -1.0, 1.0]}]
    doc["scenes"] = [{"nodes": [0, 1, 2]}]
    path.write_text(json.dumps(doc))
    asset = _equal(str(path))
    assert len(asset.primitives) == 3
    # mixed attributes: load_mesh drops normals and UVs for all
    _, normals, uvs = gltf.load_mesh(str(path))
    assert normals is None and uvs is None


@pytest.mark.parametrize("what", ["missing", "unparseable", "undecodable_png"])
def test_bad_input_degrades_as_jax(tmp_path, what):
    path = tmp_path / "bad.gltf"
    if what == "unparseable":
        path.write_text("{ not json")
    elif what == "undecodable_png":
        pos, nrm, uv, idx = _mesh()
        procgen.write_gltf(str(path), pos, idx, nrm, uv, png=b"not a png",
                           buffer_in="data")
    asset = _equal(str(path))
    if what == "undecodable_png":
        assert asset.materials[0].base_color_image is None
        assert len(asset.primitives) == 1
    else:
        assert not asset.primitives
        assert gltf.load_triangles(str(path)).shape == (0, 3, 3)


def test_strided_read_is_vectorised_and_exact(tmp_path):
    """A large interleaved accessor reads in one numpy pass, bit for bit the
    JAX loader's per-element gather."""
    pos, nrm, uv, idx = procgen.ellipsoid_mesh(96, 64)
    path = str(tmp_path / "big.gltf")
    procgen.write_gltf(path, pos, idx, nrm, uv, stride=True)
    asset = _equal(path)
    np.testing.assert_array_equal(asset.primitives[0].positions, pos)
