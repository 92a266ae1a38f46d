"""The ``planar`` family, the plain side: ``tracer.py``'s path tracer and
the map of its gradients onto the port's leaves.

It implements no camera or entry option: the pinhole camera, the hash
stream, no next-event estimation, no roulette, and gradients in the
materials' colors, the background and the camera, not in the geometry.
"""

from __future__ import annotations

import torch

from port_bench.reference.tracer import loss_and_grads, render  # noqa: F401

# options of a traffic mix's "camera" and "entry_options" this side traces
CAMERA_OPTIONS = ()
ENTRY_OPTIONS = ()


def expected_leaves(program_grads: dict, ref_grads: dict, leaves: dict) -> dict:
    """The reference's gradients in the layout of the program's leaves:
    each material's color gradient on its texture row of ``tex_color0``,
    the background's on its row, each camera leaf's as ``camera.<name>``,
    every other leaf zero. ``leaves``: what the program side's
    ``build_scene`` returned beside the scene."""
    out = {k: torch.zeros_like(v, dtype=torch.float32, device="cpu")
           for k, v in program_grads.items()}
    tex = out["tex_color0"]
    for i, row in enumerate(leaves["tex_rows"]):
        tex[row] += ref_grads["color"][i].cpu()
    bg_row = leaves["bg_row"]
    if bg_row is not None and ref_grads["background"] is not None:
        tex[bg_row] += ref_grads["background"].cpu()
    for k, g in ref_grads["camera"].items():
        out[f"camera.{k}"] = g.detach().float().cpu().reshape(out[f"camera.{k}"].shape)
    return out


def leaf_shapes(ref_grads: dict, leaves: dict) -> dict:
    """Zero leaves in the program's layout, for the control, which has no
    program gradients: ``tex_color0`` up to the last row a material or the
    background uses, and the camera's leaves."""
    bg_row = leaves["bg_row"]
    n_tex = max(leaves["tex_rows"] + [bg_row if bg_row is not None else -1]) + 1
    shape = {"tex_color0": torch.zeros((n_tex, 3))}
    shape.update({f"camera.{k}": torch.zeros(g.shape) for k, g in ref_grads["camera"].items()})
    return shape
