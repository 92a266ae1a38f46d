"""Kernels K1 and K2 of other checkouts of the port beside this one's, held
to one another and timed in turns on one GPU.

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.kernel_ab ROOT [ROOT ...]

ROOT is the root of another checkout (the parent commit, for example,
unpacked with ``git archive`` into the gitignored ``_scratch/``) whose
``fused_intersect`` has ``planar_closest_kernel``, ``sphere_closest_kernel``
and ``profiling.cuda_ms``. This package makes the inputs (``CASES``: K1 on
cornell_box's 1-chunk view, K2 on three_material_ball's and
random_motion_ball's; 512*512 primary rays of the scene's camera and rays
leaving their hits in random directions, ``profiling.camera_rays`` and
``secondary``) and saves them under ``build/``. Then one process per turn,
in the order this checkout, the others, the others reversed, this one,
imports the package of its own checkout (which builds its own kernels),
launches its kernels on those inputs with and without pid, and times each
case's primary rays with CUDA events. Every turn's outputs (all 8 rows and
the pid) must equal the first turn's bit for bit: the rows that differ are
printed. Prints the card's name and power limit, then one line per turn
and case.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

TMIN = 1e-3
# (label, catalog scene, kernel)
CASES = (("K1 cornell_box", "cornell_box", "planar_closest"),
         ("K2 three_material_ball", "three_material_ball", "sphere_closest"),
         ("K2 random_motion_ball", "random_motion_ball", "sphere_closest"))


def make_inputs(path: Path) -> None:
    """Save {label: (primary rays [8,R], secondary rays [8,R], pack)}."""
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
    torch.save(inputs, path)


def turn(root: str, inputs: Path, outputs: Path) -> None:
    """One turn, in a process of its own: the kernels of the checkout at
    ``root`` on the saved inputs. Saves their outputs; prints the times."""
    sys.path[0] = root
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
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
    torch.save(outs, outputs)


def differences(got: dict, ref: dict) -> list[str]:
    """The (case, rays, output) whose bits differ from the reference's."""
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
    for i, root in enumerate([own, *others, *others[::-1], own]):
        outputs = work / f"kernel_ab_outputs_{i}.pt"
        subprocess.run([sys.executable, __file__, "--turn", root, str(inputs),
                        str(outputs)], check=True, cwd=root)
        got = torch.load(outputs)
        outputs.unlink()
        if ref is None:
            ref = got
        for d in differences(got, ref):
            print(f"{root}: {d} differs from the first turn's", flush=True)
    inputs.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
