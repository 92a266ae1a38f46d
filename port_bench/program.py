"""The system under test: the port's public entry points. A request runs
``ENTRIES[entry](scene, camera, key, target, **entry_options)``, with the
scene and camera a configuration family built (``families/``); a traffic
mix's ``entry_options`` are the entry's keyword parameters.

The harness reaches the port (``cpu_ray_tracing_implementation_tpu_torch``)
through this module, ``families/*.py`` and ``tracing.py``; the reference
never does.
"""

from __future__ import annotations

import inspect

import numpy as np

from cpu_ray_tracing_implementation_tpu_torch.models import diff, integrator


def key_words(key) -> np.ndarray:
    """A key as the port takes it: [2] uint32."""
    return np.array([int(key[0]), int(key[1])], np.uint32)


# entry name -> what one request runs; a traffic mix names its entry
def render_scan(scene, camera, key, target=None):
    return integrator.render_image(scene, camera, key_words(key))


def render_wavefront(scene, camera, key, target=None):
    return integrator.render_image_wavefront(scene, camera, key_words(key))


def grad_step(scene, camera, key, target, geometry=False):
    """(loss, gradients): the scene's leaves under their names, the
    camera's under ``camera.<name>``."""
    loss, (gs, gc) = diff.loss_and_grads(scene, camera, key_words(key), target,
                                         camera.spp, geometry=geometry)
    return loss, {**gs, **{f"camera.{k}": v for k, v in gc.items()}}


ENTRIES = {"scan": render_scan, "wavefront": render_wavefront, "grad": grad_step}


def entry_options(kind: str) -> tuple:
    """The keyword parameters of entry ``kind`` beyond (scene, camera, key,
    target): the options a traffic mix may give under ``entry_options``."""
    params = list(inspect.signature(ENTRIES[kind]).parameters)
    return tuple(params[4:])
