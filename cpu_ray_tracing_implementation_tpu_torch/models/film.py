"""Film: tone mapping, gamma and image output.

Port of ``cpu_ray_tracing_implementation_tpu/models/film.py``
(src/color.h:16-36: gamma 1/2.2, then "R G B" PPM rows), clamped to [0, 1).
Every writer takes a tensor on any device (or an array) and moves it to the
host once.
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA = 1.0 / 2.2


def linear_to_gamma(img: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp(img, min=0.0), GAMMA)


def tonemap(img, mode: str | None = None) -> torch.Tensor:
    """HDR -> displayable range, applied before gamma. None/"none": the
    reference's hard clamp at the byte stage; "reinhard": x/(1+x); "aces":
    the Narkowicz 2015 rational fit of the ACES filmic curve."""
    x = torch.clamp(torch.as_tensor(img, dtype=torch.float32), min=0.0)
    if mode in (None, "none"):
        return x
    if mode == "reinhard":
        return x / (1.0 + x)
    if mode == "aces":
        return torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14),
                           0.0, 1.0)
    raise ValueError(f"unknown tonemap mode {mode!r}")


def to_bytes(img, tonemap_mode: str | None = None) -> np.ndarray:
    """linear [H,W,3] -> uint8: optional tone map, gamma 1/2.2, clamp."""
    g = linear_to_gamma(tonemap(img, tonemap_mode)).detach().cpu().numpy()
    g = np.nan_to_num(g, nan=0.0, posinf=1.0, neginf=0.0)
    return (255.999 * np.clip(g, 0.0, 0.999)).astype(np.uint8)


def write_ppm(path: str, img) -> None:
    """P3 PPM, the reference's output container (src/camera.h:149-151)."""
    data = to_bytes(img)
    h, w, _ = data.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in data.reshape(-1, 3)))
        f.write("\n")


def write_png(path: str, img, tonemap_mode: str | None = None) -> None:
    from PIL import Image

    Image.fromarray(to_bytes(img, tonemap_mode)).save(path)


def write_exr(path: str, img, half: bool = False) -> None:
    """Linear radiance as an uncompressed scanline EXR (``utils/exr.py``):
    no gamma, no clamp, NaN written as 0."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import exr

    a = torch.as_tensor(img).detach().to(torch.float32).cpu().numpy()
    exr.write_exr(path, np.nan_to_num(a, nan=0.0), half=half)
