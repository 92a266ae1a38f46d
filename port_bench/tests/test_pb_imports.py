"""A run's process loads no JAX and nothing of the JAX package, and a
reference loads nothing of the port either."""

import subprocess
import sys

import pytest

from port_bench import harness

CODE = """
import sys
import port_bench.run, port_bench.harness, port_bench.program, port_bench.tracing
import port_bench.readings, port_bench.families
from port_bench import harness
for w in harness.json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]:
    for m in harness.load_cell(w["name"]).per_layer:
        harness.load_reader(m["name"])
for p in (harness.BENCH / "families").glob("*.py"):
    if p.stem != "__init__":
        port_bench.families.program(p.stem), port_bench.families.reference(p.stem)
port_bench.tracing.roofline_files()
print(port_bench.run.forbidden_modules())
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "cpu_ray_tracing_implementation_tpu"}))
"""


def test_no_jax_in_a_run_process():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]


def test_forbidden_names_are_compared_whole():
    from port_bench import run

    assert run.forbidden_modules(["cpu_ray_tracing_implementation_tpu_torch.ops",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "cpu_ray_tracing_implementation_tpu.ops"]) == [
        "cpu_ray_tracing_implementation_tpu", "jax"]


ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "cpu_ray_tracing_implementation_tpu",
                "cpu_ray_tracing_implementation_tpu_torch"}))
print(sorted(m for m in sys.modules if m.startswith("port_bench.families")))
"""


@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.BENCH / "reference").glob("*.py")))
def test_a_reference_alone_loads_no_port_and_no_jax(name):
    """Each plain side imported alone, in a process of its own, loads
    neither the port, nor JAX, nor a family's program side."""
    module = "port_bench.reference" + ("" if name == "__init__" else f".{name}")
    out = subprocess.run([sys.executable, "-c", ALONE, module], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]
