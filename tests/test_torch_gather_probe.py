"""K5, the gather-bandwidth probe (utils/gather_probe.py), against the JAX
tool it ports (tools/dma_gather_probe.py).

The tool reads its shapes from ``sys.argv`` when it is imported, so it is
loaded by file path with a patched argv at a tiny shape. Its Pallas kernel
(``pallas_gather_sum``) has no interpret flag and runs only on a TPU; its
XLA reference ``xla_gather_sum`` computes the same function and is what the
port's plain version is held to here (f32 sums in another order: rel err
max |a - b| / (|b| + 1) <= 1e-5, the tool's own measure). The CUDA kernel
runs on the card only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.utils import gather_probe

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "dma_gather_probe.py"
R, K, V, ROWF, RB = 64, 32, 4, 256, 16


@pytest.fixture(scope="module")
def tool():
    argv = sys.argv
    sys.argv = ["dma_gather_probe.py", *map(str, (R, K, V, ROWF, RB))]
    try:
        spec = importlib.util.spec_from_file_location("dma_gather_probe", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    assert (mod.R, mod.K, mod.V, mod.ROWF) == (R, K, V, ROWF)
    return mod


def _inputs(seed=0, k=K):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(k, ROWF)).astype(np.float32)
    ids = rng.integers(0, k, (R, V)).astype(np.int32)
    return ids, table


def test_plain_matches_the_tool(tool):
    ids, table = _inputs()
    ref = np.asarray(tool.xla_gather_sum(jnp.asarray(ids), jnp.asarray(table)))
    got = gather_probe.gather_sum(torch.as_tensor(ids), torch.as_tensor(table))
    assert got.shape == (R, 1) and got.dtype == torch.float32
    assert gather_probe.rel_err(got, torch.as_tensor(ref)) <= 1e-5
    # and the library call the probe times beside it
    lib = gather_probe.gather_sum_library(torch.as_tensor(ids), torch.as_tensor(table))
    assert gather_probe.rel_err(lib, got) <= 1e-5


def test_ids_past_the_table_clamp_as_xla_does(tool):
    ids, table = _inputs(1)
    ids[::7, 0] = K + 5
    ref = np.asarray(tool.xla_gather_sum(jnp.asarray(ids), jnp.asarray(table)))
    got = gather_probe.gather_sum_plain(torch.as_tensor(ids), torch.as_tensor(table))
    assert gather_probe.rel_err(got, torch.as_tensor(ref)) <= 1e-5


def test_bound_at_the_tool_defaults():
    """The bound the kernel is held to at the tool's defaults: 0.92e9 f32
    adds (27.5 us at 33.5e12/s) against 14.3 MB read once (4.3 us)."""
    R0, K0, V0, F0 = gather_probe.DEFAULTS
    ms, by = gather_probe.bound(R0, K0, V0, F0, 3.35e12, 33.5e12)
    assert by == "operations"
    assert ms == pytest.approx(R0 * V0 * F0 / 33.5e12 * 1e3)
    assert 0.027 < ms < 0.028


def test_kernel_wrapper_takes_cuda_tensors_only():
    ids, table = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        gather_probe.gather_sum_kernel(torch.as_tensor(ids), torch.as_tensor(table))
    gather_probe.reset_launches()
    gather_probe.gather_sum(torch.as_tensor(ids), torch.as_tensor(table))
    assert gather_probe.LAUNCHES == {"gather_sum": 0}


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    assert gather_probe.main([]) == 2
    assert gather_probe.main(["128", "16"]) == 2
