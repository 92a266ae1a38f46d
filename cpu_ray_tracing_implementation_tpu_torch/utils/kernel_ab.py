"""Kernels K1, K2 and K4 of other checkouts of the port beside this one's,
held to one another and timed in turns on one GPU.

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.kernel_ab ROOT [ROOT ...]

ROOT is the root of another checkout (the parent commit, for example,
unpacked with ``git archive`` into the gitignored ``_scratch/``) whose
``fused_intersect`` has ``planar_closest_kernel`` and
``sphere_closest_kernel``, whose ``fused_sweep`` has ``sweep_kernel`` and
whose ``profiling`` has ``cuda_ms``. This package makes the inputs and
saves them under ``build/``:

- ``CASES``, K1 on cornell_box's 1-chunk view, K2 on three_material_ball's
  and random_motion_ball's: 512*512 primary rays of the scene's camera and
  rays leaving their hits in random directions (``profiling.camera_rays``
  and ``secondary``);
- K4 on the lists and input best of the per-ray phase
  loop (``profiling.sweep_phases``): the colonnade's (200x200) primary
  rays at phases 1, 2 (the rays phase 1 left done marked exhausted) and 3,
  its secondary rays (leaving the primary hits in random directions, a
  tenth dead) at phase 1, sphereflake's 160,000 primary rays, and 40,000
  random rays against a random table of 6,000 moving spheres in 47 chunks.

Then one process per turn, in the order this checkout, the others, the
others reversed, this one, imports the package of its own checkout (which
builds its own kernels), launches its kernels on those inputs (K1 and K2
with and without pid) and times each case with CUDA events (K1 and K2 at
their primary rays). Every turn's outputs (all 8 rows or columns, and the
pid) must equal the first turn's bit for bit: the ones that differ are
printed. Prints the card's name and power limit, then one line per turn
and case.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TMIN = 1e-3
# (label, catalog scene, kernel)
CASES = (("K1 cornell_box", "cornell_box", "planar_closest"),
         ("K2 three_material_ball", "three_material_ball", "sphere_closest"),
         ("K2 random_motion_ball", "random_motion_ball", "sphere_closest"))


def sweep_inputs(dev) -> dict:
    """{label: (rays, ids, nears, best, table, triangle, sphere)}: K4's
    cases, labels starting with "K4"."""
    from cpu_ray_tracing_implementation_tpu_torch.models import catalog
    from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
    from cpu_ray_tracing_implementation_tpu_torch.ops import perray
    from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
        scene_rays, secondary, sweep_phases)

    gen = torch.Generator().manual_seed(1)
    out = {}
    scene, cam = catalog.sponza(device=dev)
    tabs, K = scene.tri_perray, scene.tri_chunks.corner.shape[0]
    org, dirs, time, cap = scene_rays(scene, cam, gen)
    rays, calls = sweep_phases(org, dirs, time, cap, tabs, K, TMIN, True, False)
    for p, call in enumerate(calls[:3]):
        out[f"K4 colonnade primary, phase {p + 1}"] = (rays, *call, tabs.table, True, False)
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True, cap,
                                        tabs=tabs)
    o2, d2 = secondary(org, dirs, t, gen)
    alive = (torch.rand(org.shape[0], generator=gen) > 0.1).to(dev)
    cap2 = isect._packet_cap(scene, o2, d2, alive, float("inf"), TMIN)
    rays, calls = sweep_phases(o2, d2, time, cap2, tabs, K, TMIN, True, False)
    out["K4 colonnade secondary, phase 1"] = (rays, *calls[0], tabs.table, True, False)

    scene, cam = catalog.sphereflake(device=dev)
    tabs, K = scene.sphere_perray, scene.sphere_chunks.rad.shape[0]
    rays, calls = sweep_phases(*scene_rays(scene, cam, gen), tabs, K, TMIN, False, True)
    out["K4 sphereflake primary, phase 1"] = (rays, *calls[0], tabs.table, False, True)

    rng = np.random.default_rng(2)
    b = SceneBuilder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.7, 0.7, 0.7))]
    for i, c in enumerate(rng.uniform(-30, 30, (6000, 3))):
        b.moving_sphere(c, c + rng.normal(0, 0.2, 3), rng.uniform(0.2, 1.2), mats[i % 2])
    scene = b.build(dev)
    tabs, K = scene.sphere_perray, scene.sphere_chunks.rad.shape[0]
    n = 40_000
    o = (torch.rand(n, 3, generator=gen) * 70 - 35).to(dev)
    d = torch.randn(n, 3, generator=gen).to(dev)
    tm = torch.rand(n, generator=gen).to(dev)
    cap = isect._packet_cap(scene, o, d, None, float("inf"), TMIN)
    rays, calls = sweep_phases(o, d, tm, cap, tabs, K, TMIN, False, True)
    out["K4 random 6000 spheres, phase 1"] = (rays, *calls[0], tabs.table, False, True)
    return out


def make_inputs(path: Path) -> None:
    """Save {label: (primary rays [8,R], secondary rays [8,R], pack)} and
    the sweep cases' inputs."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
        camera_rays, secondary)

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda", 0)
    inputs = {}
    for label, name, kernel in CASES:
        scene, org, dirs, time = camera_rays(name, gen, dev)
        if kernel == "planar_closest":
            view, pack = scene.quad_view
            t = ch.planar_closest(org, dirs, view, TMIN, False)[0]
        else:
            view, pack = scene.sphere_view
            t = ch.sphere_closest(org, dirs, time, view, TMIN)[0]
        o2, d2 = secondary(org, dirs, t, gen)
        inputs[label] = (fi.pack_rays(org, dirs, time), fi.pack_rays(o2, d2, time), pack)
    inputs.update(sweep_inputs(dev))
    torch.save(inputs, path)


def turn(root: str, inputs: Path, outputs: Path) -> None:
    """One turn, in a process of its own: the kernels of the checkout at
    ``root`` on the saved inputs. Saves their outputs; prints the times."""
    sys.path[0] = root
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
    from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import cuda_ms

    saved = torch.load(inputs)
    outs = {}
    for label, name, kernel in CASES:
        launch = getattr(fi, f"{kernel}_kernel")
        primary, second, pack = saved[label]
        for which, rays in (("primary", primary), ("secondary", second)):
            outs[f"{label} {which}"] = (launch(rays, pack, TMIN)[0],
                                        *launch(rays, pack, TMIN, with_pid=True))
        ms = cuda_ms(lambda: launch(primary, pack, TMIN))
        ms_pid = cuda_ms(lambda: launch(primary, pack, TMIN, with_pid=True))
        print(f"{label} primary, {primary.shape[1]} rays, {root}: {ms:.4f} ms, "
              f"with pid {ms_pid:.4f} ms", flush=True)
    for label in (k for k in saved if k.startswith("K4")):
        args = saved[label]
        outs[label] = (fsw.sweep_kernel(*args[:5], TMIN, *args[5:]),)
        ms = cuda_ms(lambda: fsw.sweep_kernel(*args[:5], TMIN, *args[5:]))
        visits = int((args[2] < args[3][:, :1]).sum())
        print(f"{label}, {args[1].shape[0]} rays, {visits} visited slots, {root}: "
              f"{ms:.4f} ms", flush=True)
    torch.save(outs, outputs)


def differences(got: dict, ref: dict) -> list[str]:
    """The (case, output) whose bits differ from the reference's."""
    names = ("out", "out with pid", "pid")
    return [f"{case} {n}" for case, outs in got.items()
            for n, x, y in zip(names, outs, ref[case])
            if not torch.equal(x.view(torch.int32), y.view(torch.int32))]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--turn"]:
        turn(argv[1], Path(argv[2]), Path(argv[3]))
        return 0
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    own = str(Path(__file__).resolve().parents[2])
    work = Path(own) / "cpu_ray_tracing_implementation_tpu_torch" / "build"
    work.mkdir(exist_ok=True)
    inputs = work / "kernel_ab_inputs.pt"
    make_inputs(inputs)
    others = [str(Path(r).resolve()) for r in argv]
    ref = None
    differ = 0
    for i, root in enumerate([own, *others, *others[::-1], own]):
        outputs = work / f"kernel_ab_outputs_{i}.pt"
        subprocess.run([sys.executable, __file__, "--turn", root, str(inputs),
                        str(outputs)], check=True, cwd=root)
        got = torch.load(outputs)
        outputs.unlink()
        if ref is None:
            ref = got
        for d in differences(got, ref):
            differ += 1
            print(f"{root}: {d} differs from the first turn's", flush=True)
    inputs.unlink()
    print(f"kernel_ab: {differ} outputs differ from the first turn's")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
