"""The comparison that decides ``correct``: the program's answer against
the plain reference's, number by number, each beside its limit. The
reference is the plain side of the configuration's family
(``reference/<family>.py``), called with the traffic's options.

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

from port_bench import families

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


def grad_numbers(loss: float, grads: dict, ref_loss: float, expected: dict) -> dict:
    norms = {k: float(v.norm()) for k, v in expected.items()}
    floor = 1e-3 * max(norms.values())
    rel = 0.0
    for k, want in expected.items():
        got = grads[k].detach().float().cpu()
        rel = max(rel, float((got - want).norm()) / max(norms[k], floor, 1e-30))
    return {"loss_rel": abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30),
            "grad_rel": rel}


def reference_numbers(kind, family, desc, traffic, key, answer, pixels, target, leaves,
                      dtype=torch.float32, device="cpu") -> dict:
    """The check's numbers for the program's ``answer`` to the request keyed
    ``key``: an image [H,W,3], or (loss, grads) of a step. ``family``
    names the reference (``reference/<family>.py``); ``leaves``: what the
    family's ``build_scene`` returned beside the scene."""
    ref = families.reference(family)
    W, spp, D = traffic["width"], traffic["spp"], traffic["max_depth"]
    cam = traffic.get("camera", {})
    if kind in RENDER_KINDS:
        want = ref.render(desc, W, spp, D, key, pixel_ids=pixels, dtype=dtype, device=device,
                          **cam)
        img = answer.reshape(-1, 3)
        if pixels is not None:
            img = img[torch.as_tensor(pixels, device=img.device)]
        return render_numbers(img, want)
    loss, grads = answer
    ref_loss, ref_grads = ref.loss_and_grads(desc, W, spp, D, key, target, dtype=dtype,
                                             device=device, **cam,
                                             **traffic.get("entry_options", {}))
    return grad_numbers(float(loss), grads, ref_loss,
                        ref.expected_leaves(grads, ref_grads, leaves))


def control_numbers(kind, family, desc, traffic, key, pixels, target, leaves,
                    dtype=torch.bfloat16, device="cpu") -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place and compared as the program's answer is."""
    ref = families.reference(family)
    W, spp, D = traffic["width"], traffic["spp"], traffic["max_depth"]
    cam = traffic.get("camera", {})
    if kind in RENDER_KINDS:
        low = ref.render(desc, W, spp, D, key, pixel_ids=pixels, dtype=dtype, device=device,
                         **cam)
        want = ref.render(desc, W, spp, D, key, pixel_ids=pixels, device=device, **cam)
        return render_numbers(low, want)
    ent = traffic.get("entry_options", {})
    low_loss, low_grads = ref.loss_and_grads(desc, W, spp, D, key, target, dtype=dtype,
                                             device=device, **cam, **ent)
    ref_loss, ref_grads = ref.loss_and_grads(desc, W, spp, D, key, target, device=device,
                                             **cam, **ent)
    shape = ref.leaf_shapes(ref_grads, leaves)
    got = ref.expected_leaves(shape, low_grads, leaves)
    want = ref.expected_leaves(shape, ref_grads, leaves)
    return grad_numbers(low_loss, got, ref_loss, want)
