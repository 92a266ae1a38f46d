"""The card's per-ray row-gather bandwidth: kernel K5 and its probe.

Port of ``tools/dma_gather_probe.py``, which measured on the TPU whether
per-ray row DMAs could feed the per-ray sweep (K4). Here K5
(``csrc/gather_sum.cu``) gathers, for each of R rays, the V rows its ids
name from a [K, ROWF] f32 table and sums them; the probe holds it against
``gather_sum_plain`` and times it beside one library call that computes the
same function (``embedding_bag`` in sum mode, then a row sum).

Run on a machine with an NVIDIA GPU::

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.gather_probe [R] [K] [V] [ROWF]

(defaults 40,960 rays, 2,048 rows, 16 slots, 1,408 floats per row: the JAX
tool's). The gathered GB/s reads the L2 while the table fits the card's
50 MB L2, and device memory when it does not (K 16,384 at ROWF 1,408 is
92 MB).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

DEFAULTS = (40_960, 2_048, 16, 1_408)   # R, K, V, ROWF

LAUNCHES = {"gather_sum": 0}


def reset_launches() -> None:
    LAUNCHES["gather_sum"] = 0


def gather_sum_plain(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[R, 1] f32: per ray, the sum of the rows ``table[ids[r, s]]`` over
    its V slots, ids clamped to [0, K-1] as XLA's gather clamps. One slot
    at a time, as the JAX tool's ``xla_gather_sum`` scans them, summed in
    f64 as the kernel sums (csrc/gather_sum.cu, "Rounding")."""
    ids = ids.clamp(0, table.shape[0] - 1).long()
    acc = torch.zeros((ids.shape[0], 1), dtype=torch.float64, device=ids.device)
    for s in range(ids.shape[1]):
        acc = acc + table[ids[:, s]].sum(dim=1, keepdim=True, dtype=torch.float64)
    return acc.to(torch.float32)


def gather_sum_kernel(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel K5 on CUDA tensors: ids [R, V] int32, table [K, ROWF] f32
    (ROWF a multiple of 4) -> [R, 1] f32."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad("crt_gather_sum", table)
    R, V = ids.shape
    K, rowf = table.shape
    tbl.check_cuda("ids", ids, torch.int32, (R, V))
    tbl.check_cuda("table", table, torch.float32, (K, rowf))
    if rowf % 4 or table.data_ptr() % 16:
        raise ValueError(f"K5 reads rows as float4: ROWF must be a multiple of "
                         f"4 and the table 16-byte aligned, got ROWF {rowf}")
    if ids.device != table.device:
        raise ValueError("ids and table lie on different devices")
    out = torch.empty((R, 1), dtype=torch.float32, device=ids.device)
    lib = build.load()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.crt_gather_sum(ids.data_ptr(), R, V, table.data_ptr(), K, rowf,
                                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crt_gather_sum launch failed: {build.error_string(err)}")
    LAUNCHES["gather_sum"] += 1
    return out


def gather_sum(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[R, 1] gathered row sums: kernel K5 on CUDA tensors, the plain
    version on CPU tensors."""
    if ids.device.type == "cpu":
        return gather_sum_plain(ids, table)
    return gather_sum_kernel(ids, table)


def gather_sum_library(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The same function as one library call: ``embedding_bag`` in sum mode
    (a [R, ROWF] bag sum) and a row sum. A yardstick only; the port never
    calls it."""
    bags = torch.nn.functional.embedding_bag(
        ids.clamp(0, table.shape[0] - 1).long(), table, mode="sum")
    return bags.sum(dim=1, keepdim=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The JAX tool's error measure: max |a - b| / (|b| + 1)."""
    return float(((got - ref).abs() / (ref.abs() + 1.0)).max())


def bound(R: int, K: int, V: int, rowf: int, hbm_bytes_per_s: float,
          fp32_instr_per_s: float):
    """(bound ms, "bytes" or "operations"): ids and table read once and the
    output written once, against one FP32 add per gathered float."""
    t_bytes = 4 * (R * V + K * rowf + R) / hbm_bytes_per_s
    t_ops = R * V * rowf / fp32_instr_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measure(R: int, K: int, V: int, rowf: int, device, seed: int = 0) -> dict:
    """K5 against its plain version and the library call at one shape, on
    the card: their times (ms, CUDA events), the gathered GB/s of each,
    the kernel's error and bound. The launches made here are the probe's
    own (one counted per kernel call)."""
    from cpu_ray_tracing_implementation_tpu_torch.utils import profiling

    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((K, rowf), generator=gen, device=device)
    ids = torch.randint(0, K, (R, V), generator=gen, device=device,
                        dtype=torch.int32)
    got = gather_sum_kernel(ids, table)
    ref = gather_sum_plain(ids, table)
    lib = gather_sum_library(ids, table)
    torch.cuda.synchronize()
    gb = R * V * rowf * 4 / 1e9
    res = {"R": R, "K": K, "V": V, "ROWF": rowf,
           "table_mb": K * rowf * 4 / 1e6, "gathered_gb": gb,
           "rel_err": rel_err(got, ref), "library_rel_err": rel_err(lib, ref),
           "max_abs_err": float((got - ref).abs().max()),
           "ms": profiling.cuda_ms(lambda: gather_sum_kernel(ids, table)),
           "plain_ms": profiling.cuda_ms(lambda: gather_sum_plain(ids, table)),
           "library_ms": profiling.cuda_ms(lambda: gather_sum_library(ids, table))}
    for k in ("ms", "plain_ms", "library_ms"):
        res[k.replace("ms", "gbps")] = gb / (res[k] / 1e3)
    res["bound_ms"], res["bound_by"] = bound(R, K, V, rowf, profiling.HBM_BYTES_PER_S,
                                             profiling.FP32_INSTR_PER_S)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    R, K, V, rowf = (int(a) for a in (list(argv) + list(DEFAULTS)[len(argv):])[:4])
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    r = measure(R, K, V, rowf, torch.device("cuda", 0))
    print(f"gather: {R} rays x {V} slots x {rowf * 4} B/row = {r['gathered_gb']:.2f} GB "
          f"from a {r['table_mb']:.1f} MB table")
    print(f"K5 kernel    : {r['ms']:8.4f} ms {r['gbps']:8.1f} GB/s, rel err "
          f"{r['rel_err']:.2e}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"plain        : {r['plain_ms']:8.4f} ms {r['plain_gbps']:8.1f} GB/s")
    print(f"embedding_bag: {r['library_ms']:8.4f} ms {r['library_gbps']:8.1f} GB/s")
    return 0 if r["rel_err"] <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
