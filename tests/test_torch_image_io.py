"""The port's image IO and asset lookup against the JAX package's, its
picture texture against JAX's ``eval_texture``, and the catalog's handling
of an asset file its glTF loader refuses.

``utils/image_io.reference_asset`` searches ``$CRT_ASSETS``, the reference
snapshot's mount, then ``assets`` under the working directory, as
``cpu_ray_tracing_implementation_tpu/utils/image_io.py:78-85`` does; where
it finds ``Sponza/glTF/Sponza.gltf`` both packages load the glTF, and a
file the loader cannot parse comes back empty, so ``catalog.sponza``
builds the colonnade as the JAX package does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import textures as jtex
from cpu_ray_tracing_implementation_tpu.utils import image_io as jio
from cpu_ray_tracing_implementation_tpu_torch.models import catalog
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import textures
from cpu_ray_tracing_implementation_tpu_torch.utils import convert, image_io

GLTF = "Sponza/glTF/Sponza.gltf"


def _write_asset(root):
    path = root / GLTF
    path.parent.mkdir(parents=True)
    path.write_text("")
    return path


@pytest.mark.parametrize("where", ["crt_assets", "working_directory", "nowhere"])
def test_reference_asset_matches_jax(tmp_path, monkeypatch, where):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CRT_ASSETS", raising=False)
    if where == "crt_assets":
        _write_asset(tmp_path / "elsewhere")
        monkeypatch.setenv("CRT_ASSETS", str(tmp_path / "elsewhere"))
    elif where == "working_directory":
        _write_asset(tmp_path / "assets")
    got = image_io.reference_asset(GLTF)
    assert got == jio.reference_asset(GLTF)
    if where != "nowhere":   # else wherever the snapshot's mount holds it
        assert got == {"crt_assets": str(tmp_path / "elsewhere" / GLTF),
                       "working_directory": "assets/" + GLTF}[where]


def test_sponza_refuses_a_present_gltf(tmp_path, monkeypatch, capsys):
    """With an empty Sponza.gltf under $CRT_ASSETS, the port's loader
    refuses the file (it does not parse) and returns no triangles, as the
    JAX package's does, so the scene falls back to the colonnade: the same
    tables as with no file at all."""
    path = _write_asset(tmp_path)
    monkeypatch.setenv("CRT_ASSETS", str(tmp_path))
    scene, _ = catalog.sponza(width=16, spp=1, max_depth=1, device="cpu")
    assert f"[gltf] failed to parse {str(path)!r}" in capsys.readouterr().out
    monkeypatch.setenv("CRT_ASSETS", str(tmp_path / "nothing_here"))
    monkeypatch.chdir(tmp_path)
    ref, _ = catalog.sponza(width=16, spp=1, max_depth=1, device="cpu")
    assert scene.counts == ref.counts and scene.counts[2] > 2000
    assert torch.equal(scene.tri_chunks.corner, ref.tri_chunks.corner)


def test_load_image_of_a_png_matches_jax(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(4).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(path)
    got = image_io.load_image(path)
    assert got.dtype == np.float32 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, jio.load_image(path))
    np.testing.assert_array_equal(got, rgb.astype(np.float32))


@pytest.mark.parametrize("what", ["missing", "undecodable"])
def test_bad_file_gives_the_magenta_fallback(tmp_path, what):
    path = tmp_path / "earthmap.jpg"
    if what == "undecodable":
        path.write_bytes(b"not a jpeg")
    got = image_io.load_image(str(path))
    np.testing.assert_array_equal(got, jio.load_image(str(path)))
    np.testing.assert_array_equal(got, image_io.MAGENTA.reshape(1, 1, 3))


def test_procedural_sky_is_bit_equal():
    got = image_io.procedural_sky()
    assert got.shape == (256, 512, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.procedural_sky())
    np.testing.assert_array_equal(image_io.procedural_sky(8, 16, seed=3),
                                  jio.procedural_sky(8, 16, seed=3))


def test_exr_input_raises_naming_m13(tmp_path):
    """EXR input is ported (it raised naming M13 before): a missing .exr
    gives the magenta fallback and a present one its clamped byte-scale
    texels, both equal to the JAX package's."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import exr

    path = str(tmp_path / "bathroom.exr")
    np.testing.assert_array_equal(image_io.load_image(path), jio.load_image(path))
    np.testing.assert_array_equal(image_io.load_image(path), image_io.MAGENTA.reshape(1, 1, 3))
    exr.write_exr(path, np.random.default_rng(3).uniform(0, 2, (4, 5, 3)))
    got = image_io.load_image(path)
    assert got.shape == (4, 5, 3) and got.max() == 255.0
    np.testing.assert_array_equal(got, jio.load_image(path))


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_picture_texture_matches_jax(filt):
    """The picture kind of eval_texture at 256 random (u, v), in a scene
    with a solid, a checker and two pictures of different sizes."""
    rng = np.random.default_rng(8)
    imgs = [rng.uniform(0, 255, (9, 13, 3)).astype(np.float32),
            rng.uniform(0, 255, (4, 6, 3)).astype(np.float32)]

    def build(b):
        ids = [b.solid((0.2, 0.3, 0.4)), b.checker((1, 1, 1), (0, 0, 0), 1.0),
               b.picture(imgs[0], filter=filt), b.picture(imgs[1])]
        b.sphere((0, 0, 0), 1.0, b.lambertian(ids[2]))
        return b

    js = build(JSceneBuilder()).build()
    ps = build(sc.SceneBuilder()).build("cpu")
    assert ps.has_bilinear == (filt == "bilinear") == js.has_bilinear
    assert len(ps.images) == 2
    tex = rng.integers(0, 4, 256).astype(np.int32)
    u, v = rng.uniform(0, 1, (2, 256)).astype(np.float32)
    p = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    ref = np.asarray(jtex.eval_texture(js, jnp.asarray(tex), jnp.asarray(u),
                                       jnp.asarray(v), jnp.asarray(p)))
    got = textures.eval_texture(ps, torch.as_tensor(tex), torch.as_tensor(u),
                                torch.as_tensor(v), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the carried-across JAX scene evaluates the same
    got2 = textures.eval_texture(convert.scene_from_numpy(js, device="cpu"),
                                 torch.as_tensor(tex), torch.as_tensor(u),
                                 torch.as_tensor(v), torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got2, got)
