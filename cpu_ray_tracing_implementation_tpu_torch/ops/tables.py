"""Table-row lookup, the device that tables are built on, and the checks a
kernel wrapper makes on the tensors it hands to a kernel.

Port of ``cpu_ray_tracing_implementation_tpu/ops/tables.py``. The JAX
package contracts a one-hot mask against small tables because a per-ray
row gather serialises on the TPU. A GPU gathers rows natively, so
``take_rows`` is a row gather here: ``index_select``, whose backward is an
``index_add_`` (atomic adds on the card, in no fixed order). Indexing
(``table[idx]``) would give the same values, but its backward sorts the
indices and sums each run of equal ones serially; with a few hundred
thousand lanes gathering from a table of a few rows, that took nearly all
of a gradient step's device time on an H100.
"""

from __future__ import annotations

import torch

# the port's entry points build on the card unless the caller asks for the CPU
DEFAULT_DEVICE = "cuda"


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D (int32 or int64) index batch."""
    return torch.index_select(table, 0, idx)


def as_device(device) -> torch.device:
    """``device`` as a torch.device. A CUDA device on a host without one
    raises here, rather than later inside torch, and never falls back to
    the CPU: pass ``device="cpu"`` to build there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but this host has no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


def needs_grad(*xs) -> bool:
    """True when autograd is on and any tensor among ``xs`` requires a
    gradient: a result computed from them must then carry a graph."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


def check_no_grad(kernel: str, *xs) -> None:
    """A kernel launched through ctypes writes outputs that carry no graph.
    Raise when any input needs a gradient, rather than return a result that
    silently drops it: such a caller goes through the kernel's
    ``torch.autograd.Function``, or decides under ``torch.no_grad()``."""
    if needs_grad(*xs):
        raise RuntimeError(f"{kernel} has no backward: an input requires a "
                           "gradient; call it under torch.no_grad() or "
                           "through its differentiable wrapper")


def vjp(outputs, inputs, grad_outputs) -> tuple:
    """Gradients of ``inputs`` given the cotangents of ``outputs``, for a
    ``torch.autograd.Function``'s backward that recomputes its forward:
    outputs that came out with no graph (a table no ray reached) contribute
    nothing; an input that nothing reached gets None."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    if not pairs:
        return (None,) * len(inputs)
    outs, gs = zip(*pairs)
    return torch.autograd.grad(outs, inputs, gs, allow_unused=True)


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
