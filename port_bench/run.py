"""Run one cell of the port's benchmark once and print its result.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the check compared with its limit); the last
lines of standard error repeat the check's numbers. Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits with 1.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cpu_ray_tracing_implementation_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN``, compared whole (the port's package name begins with the
    JAX package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import harness

    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload)
    if chips is None:
        print(f"port_bench: no workload {args.workload!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload, manifest)
    out, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             device=torch.device("cuda", 0), t0=T0)
    found = forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    out["device"]["power_limit"] = harness.power_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
