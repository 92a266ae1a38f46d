"""A run's process loads no JAX and nothing of the JAX package."""

import subprocess
import sys

from port_bench import harness

CODE = """
import sys
import port_bench.run, port_bench.harness, port_bench.program, port_bench.tracing
import port_bench.readings
from port_bench import harness
for w in harness.json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]:
    for m in harness.load_cell(w["name"]).per_layer:
        harness.load_reader(m["name"])
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
