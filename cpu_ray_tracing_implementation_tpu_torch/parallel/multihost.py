"""Multi-process setup and the render over every process of the job.

Port of ``cpu_ray_tracing_implementation_tpu/parallel/multihost.py``. The
reference is one process (SURVEY.md §2.4). Here ``initialize`` joins this
process to a ``torch.distributed`` job, ``global_mesh`` is the 1-D mesh
over all of its ranks, the scene is built on every rank, pixels shard over
the job, and the image is gathered onto every process
(``parallel/mesh.py``). Nothing on a machine tells a process of its job:
the coordinator's address, the process count and this process's index are
passed in, or read from torchrun's environment (``MASTER_ADDR``,
``WORLD_SIZE``, ``RANK``) when no address is given.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "nccl") -> None:
    """Join the job: ``dist.init_process_group`` at
    ``tcp://coordinator_address`` (``host:port``) with ``num_processes``
    ranks as rank ``process_id``; with no address, torchrun's environment
    (``env://``). ``backend``: NCCL with a card per process, gloo on the
    CPU or for processes that share a card."""
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh(device=None) -> pm.Mesh:
    """1-D mesh over every rank of the job (this process alone when no job
    was joined). ``device``: this rank's device (default its card)."""
    return pm.make_mesh(device=device)


def render_image_global(scene, camera, key: np.ndarray, spp: int | None = None) -> np.ndarray:
    """Render with pixels sharded over the whole job; the full [H,W,3]
    image as host numpy on every process."""
    mesh = global_mesh(device=scene.device)
    img = pm.render_image_sharded(scene, camera, key, mesh, spp=spp)
    return img.cpu().numpy()
