"""One bounce's scatter decision in one launch: the wrapper of CUDA kernel K9.

``materials.scatter``'s forward (the lobes, the light sample, the light
pdf and the mixture weight of the one-sample 50/50 estimator) is ~200
eager tensor ops a bounce; kernel K9 (``csrc/scatter.cu``) computes the
same (new_dir, weight, continues) a thread a ray, with each light's
constants derived once per block and no [R, L] intermediate in device
memory. It has no backward: ``materials.scatter`` launches it where
``takes`` holds and the tensors are on the card, runs its plain version
``materials.scatter_plain`` on the CPU, and its eager differentiable
version otherwise. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

LAUNCHES = {"scatter": 0}


def reset_launches() -> None:
    LAUNCHES["scatter"] = 0


def _inputs(scene, hit, ray_dir, u, ior_shift, atten) -> tuple:
    """Every tensor the function reads that a gradient could flow from."""
    m, q, s = scene.materials, scene.quads, scene.spheres
    return (hit.p, hit.normal, ray_dir, u, atten, ior_shift, m.fuzz, m.ior,
            m.dispersion, m.smoothness, m.spec_prob, q.corner, q.eu, q.ev, s.c0,
            s.rad)


def takes(scene, hit, ray_dir, u, ior_shift, atten) -> bool:
    """Whether the forward alone will do: autograd records nothing from
    the inputs, and the scene has no environment light (whose pick K9
    does not take)."""
    return (not scene.has_env_light
            and not tbl.needs_grad(*_inputs(scene, hit, ray_dir, u, ior_shift, atten)))


def _check(name: str, x: torch.Tensor, dtype, shape, strided: bool = False) -> None:
    """Raise unless ``x`` is a CUDA tensor of ``dtype`` and ``shape``,
    contiguous or, where ``strided``, of any non-negative strides."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not (min(x.stride()) >= 0 if strided else x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous")


def scatter(scene, hit, ray_dir, u, ior_shift, mt, atten):
    """Kernel K9: (new_dir [R,3], weight [R,3], continues [R] bool) of R
    hits on the card, launched on the current stream. ``u``: [R, 9], the
    uniform slots of ``materials``' layout that the scatter reads;
    ``mt``, ``atten``: ``materials.mat_rows(scene, hit)``; ``ior_shift``:
    [R] or None. ``scene`` and ``hit`` need only the fields read here
    (tables and per-lane rows). Raises on an input that needs a gradient,
    on what the kernel does not take, and on a failed launch (among them
    lights whose constants overflow a block's 48 KB of shared memory)."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad("crt_scatter", *_inputs(scene, hit, ray_dir, u, ior_shift, atten))
    R = hit.p.shape[0]
    f32, i32 = torch.float32, torch.int32
    m, q, s = scene.materials, scene.quads, scene.spheres
    sl = scene.sphere_lights
    rows = (hit.p, hit.normal, ray_dir, atten)  # passed with their strides, as is u
    for name, x in zip(("p", "normal", "ray_dir", "atten"), rows):
        _check(name, x, f32, (R, 3), strided=True)
    for name, x in (("front", hit.front), ("valid", hit.valid)):
        _check(name, x, torch.bool, (R,))
    _check("mat", hit.mat, i32, (R,))
    _check("mt", mt, i32, (R,))
    _check("u", u, f32, (R, 9), strided=True)
    if ior_shift is not None:
        _check("ior_shift", ior_shift, f32, (R,))
    for name in ("fuzz", "ior", "dispersion", "smoothness", "spec_prob"):
        _check(name, getattr(m, name), f32, (m.fuzz.shape[0],))
    L, Ls = int(scene.lights.shape[0]), scene.n_sphere_lights
    _check("lights", scene.lights, i32, (L,))
    for name in ("corner", "eu", "ev"):
        _check(name, getattr(q, name), f32, (q.corner.shape[0], 3))
    if sl is not None:
        _check("sphere_lights", sl, i32, (Ls,))
    _check("c0", s.c0, f32, (s.rad.shape[0], 3))
    _check("rad", s.rad, f32, (s.rad.shape[0],))
    if len({x.device for x in (hit.p, u, m.fuzz, q.corner, s.rad)}) > 1:
        raise ValueError("the hits, uniforms and scene tables lie on different devices")

    dev = hit.p.device
    new_dir = torch.empty((R, 3), dtype=f32, device=dev)
    weight = torch.empty((R, 3), dtype=f32, device=dev)
    continues = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        p, normal, d, alb = ((x.data_ptr(), *x.stride()) for x in rows)
        err = lib.crt_scatter(
            *p, *normal, hit.front.data_ptr(), hit.valid.data_ptr(), hit.mat.data_ptr(),
            *d, u.data_ptr(), *u.stride(), mt.data_ptr(), *alb,
            None if ior_shift is None else ior_shift.data_ptr(), m.fuzz.data_ptr(),
            m.ior.data_ptr(), m.dispersion.data_ptr(), m.smoothness.data_ptr(),
            m.spec_prob.data_ptr(), scene.lights.data_ptr(), L, q.corner.data_ptr(),
            q.eu.data_ptr(), q.ev.data_ptr(), None if sl is None else sl.data_ptr(), Ls,
            s.c0.data_ptr(), s.rad.data_ptr(), int(smp.cosine_impl() == "onb"), R,
            new_dir.data_ptr(), weight.data_ptr(), continues.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crt_scatter launch failed: {build.error_string(err)}")
    LAUNCHES["scatter"] += 1
    return new_dir, weight, continues

