"""Table-row lookup, the device that tables are built on, and the checks a
kernel wrapper makes on the tensors it hands to a kernel.

Port of ``cpu_ray_tracing_implementation_tpu/ops/tables.py``. The JAX
package contracts a one-hot mask against small tables because a per-ray
row gather serialises on the TPU. A GPU gathers rows natively, so
``take_rows`` is plain indexing here.
"""

from __future__ import annotations

import torch

# the port's entry points build on the card unless the caller asks for the CPU
DEFAULT_DEVICE = "cuda"


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D index batch."""
    return table[idx]


def as_device(device) -> torch.device:
    """``device`` as a torch.device. A CUDA device on a host without one
    raises here, rather than later inside torch, and never falls back to
    the CPU: pass ``device="cpu"`` to build there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but this host has no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


def check_cuda(name: str, x: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a kernel's plain C interface takes."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
