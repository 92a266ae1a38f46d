"""Table-row lookup.

Port of ``cpu_ray_tracing_implementation_tpu/ops/tables.py``. The JAX
package contracts a one-hot mask against small tables because a per-ray
row gather serialises on the TPU. A GPU gathers rows natively, so
``take_rows`` is plain indexing here.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D index batch."""
    return table[idx]
