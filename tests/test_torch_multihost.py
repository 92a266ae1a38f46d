"""Two processes joined through the port's ``parallel/multihost.py``.

Two CPU processes (no JAX) join one gloo job over ``tcp://`` on a free
localhost port through ``multihost.initialize``, and each renders the same
Cornell box through ``render_image_global``: both return the same full
image, bitwise the single-process render (pixel-id keyed RNG).
"""

import os
import socket
import subprocess
import sys

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys

_WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)

from cpu_ray_tracing_implementation_tpu_torch.models import catalog
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel import multihost

multihost.initialize(coordinator_address=coord, num_processes=2, process_id=pid,
                     backend="gloo")
assert dist.get_world_size() == 2 and multihost.global_mesh(device="cpu").size == 2
scene, cam = catalog.cornell_box(width=15, spp=2, max_depth=2, device="cpu")
img = multihost.render_image_global(scene, cam, keys.key(0), spp=2)
assert "jax" not in sys.modules
np.save(out, img)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_render_identical(tmp_path):
    coord = f"localhost:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [tmp_path / f"rank{pid}.npy" for pid in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(pid), str(out)],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    a, b = (np.load(o) for o in outs)
    np.testing.assert_array_equal(a, b)
    scene, cam = catalog.cornell_box(width=15, spp=2, max_depth=2, device="cpu")
    ref = integrator.render_image(scene, cam, keys.key(0), spp=2).numpy()
    np.testing.assert_array_equal(a, ref)
