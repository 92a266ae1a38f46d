"""Image and asset IO of the port.

Port of ``cpu_ray_tracing_implementation_tpu/utils/image_io.py`` (a copy:
it imports nothing of the JAX package). The reference decodes JPEG/PNG
with stb_image into 8-bit bytes (src/image.h:33-67,107-117), which its
picture texture scales by 1/256 (src/texture.h:72). ``load_image`` keeps
that pipeline on the host: a float32 [h,w,3] array in byte scale (0..255),
which ``ops/textures.py`` scales on the device. EXR input goes through the
port's own codec (``utils/exr.py``), HDR values clamped to [0, 1] before
the byte scale, as the reference's ``src/image.h:107-117`` converts them.

Asset note: ``bathroom.exr`` is absent from the reference snapshot, so the
skybox scenes use ``procedural_sky`` instead, as the JAX package does.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# the reference's fallback texel for a file it cannot load (src/image.h:75)
MAGENTA = np.array([255.0, 0.0, 255.0], np.float32)

# where the reference package looks for the reference's asset tree, in
# order: $CRT_ASSETS, the read-only snapshot's mount, then ``assets`` under
# the working directory (image_io.py:78-85 of the JAX package)
ASSET_ROOTS = ("/root/reference/assets", "assets")


def load_image(path: str) -> np.ndarray:
    """Decode to float32 [h,w,3] in byte scale. A missing or undecodable
    file gives a 1x1 magenta image, as the reference degrades
    (src/image.h:75); so does a host without PIL, where the JAX package
    falls back the same way. An ``.exr`` is read by ``exr.read_exr``;
    a compressed or tiled one, which that codec refuses, by imageio where
    the host has a backend for it."""
    try:
        if path.lower().endswith(".exr"):
            from cpu_ray_tracing_implementation_tpu_torch.utils import exr

            try:
                arr = exr.read_exr(path)
            except ValueError:
                import imageio.v3 as iio

                arr = np.asarray(iio.imread(path), np.float32)
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, axis=-1)
            # float HDR -> clamped bytes, as src/image.h:107-117 does
            return np.clip(arr[..., :3], 0.0, 1.0) * 255.0
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), np.float32)
    except (ImportError, OSError, ValueError, KeyError, IndexError, struct.error) as e:
        # a truncated or foreign EXR fails inside the codec's unpacking
        print(f"[image_io] failed to load {path!r}: {e}; using magenta fallback")
        return np.broadcast_to(MAGENTA, (1, 1, 3)).copy()


def procedural_sky(height: int = 256, width: int = 512, seed: int = 7) -> np.ndarray:
    """Equirect stand-in for the missing bathroom.exr, bit-equal to the JAX
    package's: a vertical gradient, a bright window blob and soft noise.
    Byte scale."""
    rng = np.random.default_rng(seed)
    v = np.linspace(0.0, 1.0, height)[:, None]
    u = np.linspace(0.0, 1.0, width)[None, :]
    base = np.stack(
        [
            0.85 - 0.45 * v + 0.0 * u,
            0.80 - 0.35 * v + 0.0 * u,
            0.95 - 0.25 * v + 0.0 * u,
        ],
        axis=-1,
    )
    # a warm bright "window"
    du = (u - 0.3) * 2.0
    dv = (v - 0.45) * 4.0
    blob = np.exp(-(du * du + dv * dv) * 18.0)[..., None]
    base = base + blob * np.array([1.6, 1.4, 1.0])
    base = base + rng.normal(0.0, 0.01, base.shape)
    return (np.clip(base, 0.0, 1.0) * 255.0).astype(np.float32)


def reference_asset(name: str) -> str:
    """Path to a reference asset where one of the roots holds it, else
    ``name`` itself (which the callers then find missing)."""
    for root in (os.environ.get("CRT_ASSETS", ""), *ASSET_ROOTS):
        if root:
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return name
