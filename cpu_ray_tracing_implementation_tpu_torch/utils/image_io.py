"""Image and asset IO of the port.

Port of ``cpu_ray_tracing_implementation_tpu/utils/image_io.py`` (a copy:
it imports nothing of the JAX package). So far only ``reference_asset``,
which the catalog's asset lookups go through; ``load_image``,
``procedural_sky`` and the rest are ROADMAP M13.
"""

from __future__ import annotations

import os

# where the reference package looks for the reference's asset tree, in
# order: $CRT_ASSETS, the read-only snapshot's mount, then ``assets`` under
# the working directory (image_io.py:78-85 of the JAX package)
ASSET_ROOTS = ("/root/reference/assets", "assets")


def reference_asset(name: str) -> str:
    """Path to a reference asset where one of the roots holds it, else
    ``name`` itself (which the callers then find missing)."""
    for root in (os.environ.get("CRT_ASSETS", ""), *ASSET_ROOTS):
        if root:
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return name
