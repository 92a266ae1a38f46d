"""Film: gamma and image output.

Port of ``cpu_ray_tracing_implementation_tpu/models/film.py``
(src/color.h:16-36: gamma 1/2.2, then "R G B" PPM rows), clamped to [0, 1).
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA = 1.0 / 2.2


def linear_to_gamma(img: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp(img, min=0.0), GAMMA)


def to_bytes(img) -> np.ndarray:
    """linear [H,W,3] -> uint8: gamma 1/2.2, clamp."""
    g = linear_to_gamma(torch.as_tensor(img)).detach().cpu().numpy()
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


def write_png(path: str, img) -> None:
    from PIL import Image

    Image.fromarray(to_bytes(img)).save(path)
