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
    """The bound K5 is held to at the tool's defaults, where the ids name
    all 2,048 rows: 14.3 MB moved once (the rows, the ids, the output),
    4.3 us at 3.35 TB/s, against 3.5e6 adds (0.1 us at 33.5e12/s)."""
    R0, K0, V0, F0 = gather_probe.DEFAULTS
    ms, by = gather_probe.bound(R0, V0, F0, K0, 3.35e12, 33.5e12)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (R0 * V0 + K0 * F0 + R0) / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.0043


def test_bound_counts_the_named_rows():
    """At a tiny shape whose ids name 5 of 32 rows (one only through an id
    past the table's end), the bound is the hand count of what the function
    needs: those rows, the ids and the output moved once; and their adds."""
    ids = torch.tensor([[0, 3, 3, 40], [3, 0, 7, 9], [9, -2, 7, 31]], dtype=torch.int32)
    n = gather_probe.named_rows(ids, 32)
    assert n == 5  # rows 0, 3, 7, 9, 31
    ms, by = gather_probe.bound(3, 4, ROWF, n, 3.35e12, 33.5e12)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (3 * 4 + 5 * ROWF + 3) / 3.35e12 * 1e3)
    # where only operations are counted, N*ROWF + R*V adds
    ms, by = gather_probe.bound(3, 4, ROWF, n, float("inf"), 33.5e12)
    assert by == "operations"
    assert ms == pytest.approx((5 * ROWF + 3 * 4) / 33.5e12 * 1e3)


def test_bound_never_exceeds_the_old_count():
    """The old count (every (ray, slot)'s row added, R*V*ROWF FP32 adds,
    against all K rows, the ids and the output moved once) was no floor of
    the function: the recount lies at or under it at every shape, here
    random shapes and ids of every density."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        r, k, v = (int(x) for x in rng.integers(1, 3000, 3))
        f = 4 * int(rng.integers(1, 600))
        ids = torch.as_tensor(rng.integers(-5, k + 5, (r, v)).astype(np.int32))
        n = gather_probe.named_rows(ids, k)
        assert 1 <= n <= min(k, r * v)
        new = gather_probe.bound(r, v, f, n, 3.35e12, 33.5e12)[0]
        old = 1e3 * max(4 * (r * v + k * f + r) / 3.35e12, r * v * f / 33.5e12)
        assert new <= old


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
