"""Command line: render any scene of the catalog on the card.

The port's counterpart of the repo's ``render.py`` (the reference's stdin
menu, src/main.cc:633-686, as argparse flags, with ``--interactive`` for
the original prompt flow): the same flags, ``CONFIG_KEYS``, integrator
routing (``use_wavefront``) and flag contract (``validate_flags``).

    python -m cpu_ray_tracing_implementation_tpu_torch.cli cornell_box -o cornell.png
    python -m cpu_ray_tracing_implementation_tpu_torch.cli sphereflake --width 400 --spp 50
    python -m cpu_ray_tracing_implementation_tpu_torch.cli --list
    torchrun --nproc-per-node 2 -m cpu_ray_tracing_implementation_tpu_torch.cli sponza --sharded

It renders on the card (``main(argv, device="cpu")`` renders on the CPU).
``--sharded`` shards the pixels over every rank of the job: one rank
unless the command runs under torchrun, whose environment it joins (NCCL
when each rank has a card of its own, gloo when ranks share one); rank 0
writes the image. ``--profile DIR`` writes a ``torch.profiler`` trace that
names the port's layers (``utils/trace.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cpu_ray_tracing_implementation_tpu_torch.models import adaptive, aov, catalog, film
from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops.tables import DEFAULT_DEVICE, as_device
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.parallel import multihost
from cpu_ray_tracing_implementation_tpu_torch.utils import checkpoint as ckpt
from cpu_ray_tracing_implementation_tpu_torch.utils import denoise, profiling


# The JAX package's environment switches, and what the port does with each
# (the CLI's help prints them).
SWITCHES = """\
environment switches (read per call):
  CRT_ACCEL       chunked tables' accelerator: auto | ray | packet | bvh | pallas | chunked
  CRT_RAYV        per-ray visit slots a phase (default 16; above 32, K3's largest,
                  selections of 32 chained)
  CRT_SUBTILE     1: per-ray sub-tile selection, CRT_SUBC lanes a sub-tile (default 32;
                  any width dividing 128, else the chunk route), CRT_RAYV_SUB slots
                  (default 24); K3 on the sub-tile boxes and K7
  CRT_SWEEP_Q16   1: per-ray planar sweep over u16-quantized rows, K8 (wins over
                  CRT_SUBTILE; spheres keep their route)
  CRT_REPLAY      0: the gradient's chunk-scan VJP instead of the winner replay (both
                  through K1/K2 on the card)
  CRT_TILE        packet tile (default packet.AUTO_TILE, 32 on the card)
  CRT_SORT        coherence sort on the packet route: auto | on | off
  CRT_RNG, CRT_COSINE, CRT_WF_LANES, CRT_SCAN_TILE, CRT_ASSETS   as the JAX package
  CRT_PACKET      not read: 'lockstep' is a TPU schedule of K6's function
  CRT_UNROLL      not read: XLA loop unrolling, no meaning in eager PyTorch
  CRT_DENSE_PALLAS, CRT_NO_PALLAS, CRT_PALLAS_SWEEP   not read: they choose between
                  Pallas and XLA forms of one function; the port always runs its kernel
                  on the card (its plain version on CPU tensors)
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cpu_ray_tracing_implementation_tpu_torch.cli",
                                description=__doc__, epilog=SWITCHES,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", help="scene name (see --list) or 1-based index")
    p.add_argument("-o", "--output", default=None, help="output path (.png, .ppm or .exr)")
    p.add_argument("--width", type=int, default=None, help="image width override")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel override")
    p.add_argument("--max-depth", type=int, default=None, help="bounce depth override")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--stratify", action="store_true",
                   help="stratified pixel jitter: sample s of spp jitters within cell s "
                        "of an exact grid over the pixel (off = the reference's uniform "
                        "jitter)")
    p.add_argument("--adaptive", type=float, default=None, metavar="REL_TOL",
                   help="adaptive sampling: per-pixel 95%% CI termination at this "
                        "relative tolerance (e.g. 0.05); --spp becomes the per-pixel max")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous denoise (utils/denoise.py) guided by "
                        "first-hit AOVs before writing the image")
    p.add_argument("--aovs", default=None, metavar="PREFIX",
                   help="also write first-hit AOV buffers (normal/albedo/depth/coverage) "
                        "as PREFIX_<name>.png")
    p.add_argument("--tonemap", choices=("none", "reinhard", "aces"), default=None,
                   help="HDR tone map before gamma for png/ppm output (default none = "
                        "the reference's hard clamp)")
    p.add_argument("--tile-pixels", type=int, default=None, metavar="N",
                   help="render in fixed N-pixel tiles (bounds device memory for very "
                        "large frames; identical output); with --sharded, each rank's "
                        "scan batch or wavefront pool cap")
    p.add_argument("--qmc", action="store_true",
                   help="Owen-scrambled Sobol sampling (lower variance at equal spp)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: a shadow-ray light sample and a BSDF "
                        "continuation per diffuse bounce, power-heuristic MIS")
    p.add_argument("--rr-depth", type=int, default=None, metavar="N",
                   help="Russian-roulette path termination from bounce N (unbiased)")
    p.add_argument("--wavefront", choices=("auto", "on", "off"), nargs="?", const="on",
                   default="auto",
                   help="path-regeneration wavefront integrator (forward only; each "
                        "path's radiance the scan's, the image allclose). 'auto' takes "
                        "it for chunked scenes and the scan for dense tables, as "
                        "render.py does")
    p.add_argument("--clamp", type=float, default=None, metavar="C",
                   help="firefly clamp: per-sample radiance min'd against C per channel")
    p.add_argument("--format", choices=("png", "ppm", "exr"), default=None,
                   help="output container (default: from the output extension, else "
                        "png); exr writes linear HDR radiance")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over every rank of the job (torchrun)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="spp-chunked render with resume from PATH")
    p.add_argument("--chunk-spp", type=int, default=16,
                   help="samples per checkpoint chunk (with --checkpoint)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="load render settings from a JSON config file (CLI flags "
                        "override)")
    p.add_argument("--save-config", default=None, metavar="JSON",
                   help="write the resolved settings to a JSON config file")
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for filename + scene number like the reference")
    return p


CONFIG_KEYS = ("scene", "output", "width", "spp", "max_depth", "seed",
               "format", "sharded", "checkpoint", "chunk_spp", "stratify",
               "denoise", "aovs", "adaptive", "clamp", "qmc", "tonemap",
               "tile_pixels", "rr_depth", "nee", "wavefront")


def use_wavefront(mode, scene) -> bool:
    """The forward integrator: 'on' the wavefront, 'off' the scan, 'auto'
    the wavefront for chunked tables and the scan for dense ones
    (``render.py:105-119``); a bool from an older JSON config as is."""
    if mode == "on" or mode is True:
        return True
    if mode == "off" or mode is False:
        return False
    return (scene.tri_chunks is not None or scene.sphere_chunks is not None
            or scene.quad_chunks is not None)


def validate_flags(args) -> str | None:
    """The flag-combination contract of ``render.py:128-154``: combinations
    compose or error, never silently drop a flag. Returns an error message,
    or None when the combination composes. --checkpoint composes with
    --wavefront, --sharded and --tile-pixels and rejects --adaptive;
    --adaptive composes with --sharded only; --wavefront and --sharded
    compose with each other and with --tile-pixels."""
    wf_on = args.wavefront in ("on", True)
    if args.checkpoint and args.adaptive is not None:
        return "--checkpoint does not compose with --adaptive"
    if args.adaptive is not None:
        for flag, name in ((wf_on, "--wavefront on"),
                           (args.tile_pixels, "--tile-pixels")):
            if flag:
                return f"--adaptive does not compose with {name}"
    return None


def _apply_config(args, argv):
    """JSON defaults from --config, flags typed on the command line win:
    re-parse with every default suppressed, so the namespace holds exactly
    the typed flags, and a config value fills any key left unset."""
    with open(args.config) as f:
        cfg = json.load(f)
    probe = build_parser()
    for action in probe._actions:
        action.default = argparse.SUPPRESS
    provided = vars(probe.parse_args(argv))
    for k, v in cfg.items():
        if k in CONFIG_KEYS and k not in provided:
            setattr(args, k, v)


def _job_mesh(device) -> pm.Mesh:
    """The mesh over the job: under torchrun (``WORLD_SIZE`` > 1) join its
    process group first, NCCL when every local rank has a card of its own,
    else gloo (NCCL refuses two ranks on one card; gloo also on the CPU)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        own_card = (device is None and torch.cuda.is_available()
                    and torch.cuda.device_count() >= local)
        multihost.initialize(backend="nccl" if own_card else "gloo")
    return pm.make_mesh(device=device)


def _render(args, scene, cam, key, mesh, wavefront):
    """The image [H,W,3] on the scene's device, by the route the flags ask."""
    if args.checkpoint:
        # validate_flags rejected what a checkpoint does not compose with
        return ckpt.render_with_checkpoint(scene, cam, seed=args.seed,
                                           chunk_spp=args.chunk_spp,
                                           ckpt_path=args.checkpoint,
                                           use_wavefront=wavefront, mesh=mesh,
                                           batch_pixels=args.tile_pixels)
    if args.adaptive is not None:
        img, spp_map = adaptive.render_image_adaptive(scene, cam, key,
                                                      rel_tol=args.adaptive,
                                                      return_spp_map=True, mesh=mesh)
        print(f"Adaptive spp: mean {spp_map.mean():.1f}, min {spp_map.min()}, "
              f"max {spp_map.max()} (budget {cam.spp})")
        return img
    if mesh is not None and wavefront:
        return pm.render_image_wavefront_sharded(scene, cam, key, mesh,
                                                 lanes_cap=args.tile_pixels)
    if mesh is not None:
        return pm.render_image_sharded(scene, cam, key, mesh, batch_pixels=args.tile_pixels)
    if wavefront:
        return integrator.render_image_wavefront(scene, cam, key,
                                                 tile_pixels=args.tile_pixels)
    if args.tile_pixels:
        return integrator.render_image_tiled(scene, cam, key, tile_pixels=args.tile_pixels)
    return integrator.render_image(scene, cam, key)


def _write_aovs(prefix: str, bufs: dict) -> None:
    for name, b in bufs.items():
        v = b.detach().cpu().numpy()
        if name == "normal":
            v = 0.5 * (v + 1.0)  # [-1,1] -> display range
        elif name == "depth":
            v = v / max(float(v.max()), 1e-6)
        if v.shape[-1] == 1:
            v = np.repeat(v, 3, axis=-1)
        film.write_png(f"{prefix}_{name}.png", v)
    print(f"Wrote AOVs to {prefix}_*.png")


def main(argv=None, device=None) -> int:
    """Run the command line ``argv`` (default ``sys.argv[1:]``); ``device``:
    where to render (default the card; ``"cpu"`` for the CPU)."""
    args = build_parser().parse_args(argv)
    if args.config:
        _apply_config(args, argv)
    if args.save_config:
        with open(args.save_config, "w") as f:
            json.dump({k: getattr(args, k) for k in CONFIG_KEYS
                       if getattr(args, k) is not None}, f, indent=1)
        print(f"Wrote config to {args.save_config}")

    names = list(catalog.SCENES)
    if args.list:
        for i, n in enumerate(names, 1):
            print(f"{i:2d}  {n}")
        return 0
    if args.interactive:
        out = input("Enter Output Filename: ").strip()
        for i, n in enumerate(names, 1):
            print(f"{i:2d}. {n}")
        which = int(input("Enter the scene number: "))
        args.scene = names[which - 1]
        args.output = out
    elif args.scene is None:
        build_parser().error("scene name required (or --list / --interactive)")

    scene_name = args.scene
    if scene_name.isdigit():
        scene_name = names[int(scene_name) - 1]
    if scene_name not in catalog.SCENES:
        print(f"unknown scene {scene_name!r}; see --list", file=sys.stderr)
        return 2
    err = validate_flags(args)
    if err:
        build_parser().error(err)

    out = args.output or f"{scene_name}.png"
    low = out.lower()
    fmt = args.format or ("ppm" if low.endswith(".ppm")
                          else "exr" if low.endswith(".exr") else "png")

    mesh = _job_mesh(device) if args.sharded else None
    dev = mesh.device if mesh is not None else as_device(device or DEFAULT_DEVICE)
    if mesh is not None and mesh.size == 1:
        print("--sharded: the job has one rank; rendering on one device")
        mesh = None
    scene, cam = catalog.SCENES[scene_name](width=args.width, spp=args.spp,
                                            max_depth=args.max_depth, device=dev)
    fields = {"stratify": args.stratify or None, "clamp": args.clamp,
              "qmc": args.qmc or None, "nee": args.nee or None, "rr_depth": args.rr_depth}
    cam = cam.replace(**{k: v for k, v in fields.items() if v is not None})
    ranks = f", {mesh.size} ranks" if mesh is not None else ""
    print(f"Rendering {scene_name}: {cam.width}x{cam.height}, {cam.spp} spp, "
          f"depth {cam.max_depth} on {dev}{ranks}")

    key = keys.key(args.seed)
    stats = profiling.RenderStats(device=dev)
    with profiling.device_trace(args.profile):
        with stats.phase("render", rays=cam.width * cam.height * cam.spp):
            img = _render(args, scene, cam, key, mesh, use_wavefront(args.wavefront, scene))
        if args.denoise or args.aovs:
            with stats.phase("aovs and denoise"):
                bufs = aov.render_aovs(scene, cam, key, spp=min(cam.spp, 16))
                if args.denoise:
                    img = denoise.denoise(img, bufs)
    p = stats.phases["render"]
    print(f"Done in {p.seconds:.2f}s ({p.mrays_per_s:.2f}M camera rays/s)")
    print(stats.summary())
    if mesh is not None and mesh.rank != 0:
        return 0   # rank 0 writes
    if args.aovs:
        _write_aovs(args.aovs, bufs)
    if fmt == "ppm":
        film.write_ppm(out, film.tonemap(img, args.tonemap))
    elif fmt == "exr":
        film.write_exr(out, img)  # EXR keeps raw linear radiance
    else:
        film.write_png(out, img, tonemap_mode=args.tonemap)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
