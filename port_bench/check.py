"""The comparison that decides ``correct``: the program's answer against
the plain reference's, number by number, each beside its limit.

- A render (``scan``, ``wavefront``): ``image_mae_rel``, the mean absolute
  difference over the checked pixels divided by the mean absolute value of
  the reference's. Both sides trace the same paths, so it reads rounding
  and the rare path that a rounding sends to another primitive.
- A gradient step (``grad``): ``loss_rel``, the gap of the losses over the
  reference's; ``grad_rel``, over every leaf the step differentiates (the
  scene's and the camera's), the largest norm of the difference of a
  leaf's gradient over the reference's norm of that leaf or a thousandth of
  the largest leaf's, whichever is larger (a leaf the reference finds zero
  is held to that floor).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import tracer

RENDER_KINDS = ("scan", "wavefront")


def check_pixels(n_pix: int, wanted: int, seed: int) -> np.ndarray | None:
    """Sorted pixel ids of the check's sample, drawn from ``seed``; None:
    every pixel."""
    if not wanted or wanted >= n_pix:
        return None
    return np.sort(np.random.default_rng(seed).choice(n_pix, wanted, replace=False))


def render_numbers(img: torch.Tensor, ref: torch.Tensor) -> dict:
    img = img.reshape(-1, 3).float().to(ref.device)
    gap = (img - ref).abs().mean()
    return {"image_mae_rel": float(gap / ref.abs().mean().clamp(min=1e-30))}


def expected_leaves(program_grads: dict, ref_grads: dict, tex_rows, bg_row) -> dict:
    """The reference's gradients in the layout of the program's leaves:
    each material's color gradient on its texture row of ``tex_color0``,
    the background's on its row, each camera leaf's as ``camera.<name>``,
    every other leaf zero."""
    out = {k: torch.zeros_like(v, dtype=torch.float32, device="cpu")
           for k, v in program_grads.items()}
    tex = out["tex_color0"]
    for i, row in enumerate(tex_rows):
        tex[row] += ref_grads["color"][i].cpu()
    if bg_row is not None and ref_grads["background"] is not None:
        tex[bg_row] += ref_grads["background"].cpu()
    for k, g in ref_grads["camera"].items():
        out[f"camera.{k}"] = g.detach().float().cpu().reshape(out[f"camera.{k}"].shape)
    return out


def grad_numbers(loss: float, grads: dict, ref_loss: float, expected: dict) -> dict:
    norms = {k: float(v.norm()) for k, v in expected.items()}
    floor = 1e-3 * max(norms.values())
    rel = 0.0
    for k, want in expected.items():
        got = grads[k].detach().float().cpu()
        rel = max(rel, float((got - want).norm()) / max(norms[k], floor, 1e-30))
    return {"loss_rel": abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30),
            "grad_rel": rel}


def reference_numbers(kind, desc, traffic, key, answer, pixels, target, tex_rows, bg_row,
                      dtype=torch.float32, device="cpu") -> dict:
    """The check's numbers for the program's ``answer`` to the request keyed
    ``key``: an image [H,W,3], or (loss, grads) of a step."""
    W, spp, D = traffic["width"], traffic["spp"], traffic["max_depth"]
    if kind in RENDER_KINDS:
        ref = tracer.render(desc, W, spp, D, key, pixel_ids=pixels, dtype=dtype,
                            device=device)
        img = answer.reshape(-1, 3)
        if pixels is not None:
            img = img[torch.as_tensor(pixels, device=img.device)]
        return render_numbers(img, ref)
    loss, grads = answer
    ref_loss, ref_grads = tracer.loss_and_grads(desc, W, spp, D, key, target,
                                                dtype=dtype, device=device)
    return grad_numbers(float(loss), grads, ref_loss,
                        expected_leaves(grads, ref_grads, tex_rows, bg_row))


def control_numbers(kind, desc, traffic, key, pixels, target, tex_rows, bg_row,
                    dtype=torch.bfloat16, device="cpu") -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place and compared as the program's answer is."""
    W, spp, D = traffic["width"], traffic["spp"], traffic["max_depth"]
    if kind in RENDER_KINDS:
        low = tracer.render(desc, W, spp, D, key, pixel_ids=pixels, dtype=dtype,
                            device=device)
        ref = tracer.render(desc, W, spp, D, key, pixel_ids=pixels, device=device)
        return render_numbers(low, ref)
    low_loss, low_grads = tracer.loss_and_grads(desc, W, spp, D, key, target, dtype=dtype,
                                                device=device)
    ref_loss, ref_grads = tracer.loss_and_grads(desc, W, spp, D, key, target,
                                                device=device)
    n_tex = max(tex_rows + [bg_row if bg_row is not None else -1]) + 1
    shape = {"tex_color0": torch.zeros((n_tex, 3))}
    shape.update({f"camera.{k}": torch.zeros(g.shape) for k, g in ref_grads["camera"].items()})
    got = expected_leaves(shape, low_grads, tex_rows, bg_row)
    want = expected_leaves(shape, ref_grads, tex_rows, bg_row)
    return grad_numbers(low_loss, got, ref_loss, want)
