"""Configuration families: how a configuration's scene is built on each side.

A configuration file names its family under ``"family"`` (``planar`` where
it names none). A family is two files, found by that name under each root
of ``PATH`` in turn:

- ``families/<family>.py``, the program side: ``describe(config,
  overrides)`` (the configuration expanded into one description both sides
  are handed), ``build_scene(desc, device)`` (the port's scene, and the
  leaves the check needs to map the reference's gradients onto the port's),
  ``build_camera(desc, width, spp, max_depth, device, **options)`` and
  ``CAMERA_OPTIONS``, the names of the options it takes;
- ``reference/<family>.py``, the plain side: ``render``,
  ``loss_and_grads``, ``expected_leaves``, ``leaf_shapes``, and
  ``CAMERA_OPTIONS`` and ``ENTRY_OPTIONS``, the options it implements. It
  imports neither the port, nor JAX, nor its family's program side.

Only the program side reaches the port.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

DEFAULT = "planar"
# roots searched in order for families/<name>.py and reference/<name>.py
PATH = [Path(__file__).resolve().parent.parent]


def name_of(config: dict) -> str:
    return config.get("family", DEFAULT)


def _load(folder: str, name: str):
    for root in PATH:
        path = Path(root) / folder / f"{name}.py"
        if path.is_file():
            break
    else:
        raise KeyError(f"no family {name!r}: no {folder}/{name}.py under "
                       f"{', '.join(str(r) for r in PATH)}")
    modname = f"port_bench.{folder}.{name}"
    mod = sys.modules.get(modname)
    if mod is not None and Path(getattr(mod, "__file__", "")).resolve() == path.resolve():
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def program(name: str):
    """The program side of family ``name``."""
    return _load("families", name)


def reference(name: str):
    """The plain side of family ``name``."""
    return _load("reference", name)
