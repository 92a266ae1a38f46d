"""The port's EXR codec, EXR input and film output against the JAX package's.

Files written by one package's ``write_exr`` are read by the other's
``read_exr`` in FLOAT and HALF, bit for bit; ``image_io.load_image`` reads
an ``.exr`` as JAX's does (clamped to [0, 1], byte scale); ``film.tonemap``
matches JAX's in all three modes within atol 1e-6, and ``film.to_bytes``
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import film as jfilm
from cpu_ray_tracing_implementation_tpu.utils import exr as jexr
from cpu_ray_tracing_implementation_tpu.utils import image_io as jio
from cpu_ray_tracing_implementation_tpu_torch.models import film
from cpu_ray_tracing_implementation_tpu_torch.utils import exr, image_io


def _hdr(h=5, w=7, seed=0):
    """Linear radiance with negatives, zeros and highlights above 1."""
    return np.random.default_rng(seed).uniform(-0.5, 4.0, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exr_round_trip_across_packages(tmp_path, half, writer):
    img = _hdr()
    path = str(tmp_path / "x.exr")
    (exr if writer == "port" else jexr).write_exr(path, img, half=half)
    reader = jexr if writer == "port" else exr
    got = reader.read_exr(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(exr.read_exr(path), jexr.read_exr(path))


def test_exr_files_are_byte_equal(tmp_path):
    img = _hdr(3, 4, seed=1)
    exr.write_exr(str(tmp_path / "a.exr"), img)
    jexr.write_exr(str(tmp_path / "b.exr"), img)
    assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()


@pytest.mark.parametrize("what", ["present", "missing", "compressed"])
def test_load_image_of_an_exr_matches_jax(tmp_path, what):
    path = tmp_path / "sky.exr"
    if what == "present":
        jexr.write_exr(str(path), _hdr(6, 9, seed=2))
    elif what == "compressed":   # a compression byte the codec refuses
        jexr.write_exr(str(path), _hdr(2, 2))
        raw = bytearray(path.read_bytes())
        at = raw.index(b"compression\0compression\0") + len("compression\0compression\0") + 4
        raw[at] = 3
        path.write_bytes(bytes(raw))
    got = image_io.load_image(str(path))
    np.testing.assert_array_equal(got, jio.load_image(str(path)))
    if what == "present":
        assert got.shape == (6, 9, 3) and got.min() >= 0.0 and got.max() <= 255.0
    else:
        np.testing.assert_array_equal(got, image_io.MAGENTA.reshape(1, 1, 3))


@pytest.mark.parametrize("mode", [None, "none", "reinhard", "aces"])
def test_tonemap_and_bytes_match_jax(mode):
    img = _hdr(8, 8, seed=3)
    got = film.tonemap(torch.as_tensor(img), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfilm.tonemap(jnp.asarray(img), mode)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(film.to_bytes(torch.as_tensor(img), mode),
                                  jfilm.to_bytes(jnp.asarray(img), mode))


def test_tonemap_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="filmic"):
        film.tonemap(torch.zeros(1, 1, 3), "filmic")


def test_write_png_and_exr_match_jax(tmp_path):
    from PIL import Image

    img = _hdr(4, 6, seed=4)
    img[0, 0] = np.nan
    film.write_png(str(tmp_path / "a.png"), torch.as_tensor(img), "aces")
    jfilm.write_png(str(tmp_path / "b.png"), jnp.asarray(img), "aces")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    for half in (False, True):
        film.write_exr(str(tmp_path / "a.exr"), torch.as_tensor(img), half=half)
        jfilm.write_exr(str(tmp_path / "b.exr"), img, half=half)
        assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
    back = exr.read_exr(str(tmp_path / "a.exr"))
    assert back[0, 0].tolist() == [0.0, 0.0, 0.0]   # NaN written as 0, no clamp
    assert back.max() > 1.0
