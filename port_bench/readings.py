"""The readings a check's limits are set from, on the card, in one process:

    python3 -m port_bench.readings <cell> [--seeds N] [--controls M] [--first S]

For each of N seeds (S, S+1, ...) the program answers the cell's first
request at the cell's own sizes and the check's numbers are printed (the
lower readings); then, for the first M seeds, the control: the reference
computed in bfloat16 put in the program's place (the upper readings). One
JSON line per reading, with the seconds the program and the reference
took.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import check, harness, program
from port_bench.reference import rng


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.readings")
    p.add_argument("cell")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first", type=int, default=1_000_003)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.cell)
    tr = cell.traffic
    t = time.perf_counter()
    family, desc, scene, leaves, camera = harness.build(cell.config, tr, dev)
    H, W = camera.height, camera.width
    print(json.dumps({"cell": cell.name, "build_s": time.perf_counter() - t}), flush=True)
    seeds = [args.first + i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        key = rng.fold_in(harness.base_key(seed), 0)
        target = harness.make_target(seed, H, W, tr, dev) if cell.kind == "grad" else None
        t = time.perf_counter()
        answer = program.ENTRIES[cell.kind](scene, camera, key, target,
                                            **tr.get("entry_options", {}))
        torch.cuda.synchronize()
        t_prog = time.perf_counter() - t
        if cell.kind in check.RENDER_KINDS:
            answer = answer.detach().float().cpu()
        else:
            answer = (float(answer[0]), {k: v.detach().float().cpu() for k, v in answer[1].items()})
        pixels = check.check_pixels(W * H, tr.get("check_pixels", 0), seed)
        t = time.perf_counter()
        nums = check.reference_numbers(cell.kind, family, desc, tr, key, answer, pixels,
                                       target, leaves, device=dev)
        t_ref = time.perf_counter() - t
        print(json.dumps({"cell": cell.name, "seed": seed, "side": "program", **nums,
                          "program_s": t_prog, "reference_s": t_ref}), flush=True)
        if i < args.controls:
            t = time.perf_counter()
            low = check.control_numbers(cell.kind, family, desc, tr, key, pixels, target,
                                        leaves, device=dev)
            print(json.dumps({"cell": cell.name, "seed": seed, "side": "control", **low,
                              "control_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
