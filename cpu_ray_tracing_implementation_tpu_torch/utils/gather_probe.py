"""Kernel K5, the gather-sum probe, and the card's row-gather rate.

Port of ``tools/dma_gather_probe.py``, which measured on the TPU whether
per-ray row DMAs could feed the per-ray sweep (K4). K5
(``csrc/gather_sum.cu``) computes the tool's function: for each of R rays,
the sum of the V rows its ids name in a [K, ROWF] f32 table. It no longer
gathers a row per (ray, slot): like the card's sweeps (K4, K7, K8), which
bucket visits by row, it reads and reduces each row of the table once and
then folds the row sums in slot order. So no kernel of the port gathers a row
per (ray, slot) any more, and the probe's per-slot row-gather rate is that
of a library call: it holds K5 against ``gather_sum_plain`` and times it
beside ``embedding_bag`` in sum mode (then a row sum), which computes the
same function by gathering a row per (ray, slot); that call's GB/s is the
card's per-slot row-gather rate. ``PERF.md`` keeps the rates of the first
kernel, which gathered a row per slot itself.

Run on a machine with an NVIDIA GPU::

    python -m cpu_ray_tracing_implementation_tpu_torch.utils.gather_probe [R] [K] [V] [ROWF]

(defaults 40,960 rays, 2,048 rows, 16 slots, 1,408 floats per row: the JAX
tool's). It prints K5's time and its share of ``bound``, and
embedding_bag's time and gathered GB/s, which reads the L2 while the table
fits the card's 50 MB L2 and device memory when it does not (K 16,384 at
ROWF 1,408 is 92 MB).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl

DEFAULTS = (40_960, 2_048, 16, 1_408)   # R, K, V, ROWF
# the tables K5 is timed on (chip_smoke.py, utils/kernel_ab.py): the
# default's 11.5 MB, inside the card's 50 MB L2, and 738 MB, whose rows come
# from device memory
TABLE_ROWS = (2_048, 131_072)

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
    (ROWF a multiple of 4, K at least 1) -> [R, 1] f32. One call is two
    kernels (csrc/gather_sum.cu), counted as one launch; their scratch, the
    [K] f64 row sums, is allocated here."""
    from cpu_ray_tracing_implementation_tpu_torch.kernels import build

    tbl.check_no_grad("crt_gather_sum", table)
    R, V = ids.shape
    K, rowf = table.shape
    tbl.check_cuda("ids", ids, torch.int32, (R, V))
    tbl.check_cuda("table", table, torch.float32, (K, rowf))
    if rowf % 4 or table.data_ptr() % 16:
        raise ValueError(f"K5 reads rows as float4: ROWF must be a multiple of "
                         f"4 and the table 16-byte aligned, got ROWF {rowf}")
    if K < 1:
        raise ValueError("K5 clamps ids to the table's rows: the table has none")
    if ids.device != table.device:
        raise ValueError("ids and table lie on different devices")
    out = torch.empty((R, 1), dtype=torch.float32, device=ids.device)
    rowsum = torch.empty(K, dtype=torch.float64, device=ids.device)
    lib = build.load()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.crt_gather_sum(ids.data_ptr(), R, V, table.data_ptr(), K, rowf,
                                 rowsum.data_ptr(), out.data_ptr(), stream)
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


def named_rows(ids: torch.Tensor, K: int) -> int:
    """N: the count of distinct table rows the ids name, ids clamped to
    [0, K-1]."""
    return int(ids.clamp(0, K - 1).unique().numel())


def bound(R: int, V: int, rowf: int, named: int, hbm_bytes_per_s: float,
          fp32_instr_per_s: float):
    """(bound ms, "bytes" or "operations") of the function on ``named`` (N)
    distinct rows: the named rows, the ids and the output each moved once,
    4*(R*V + N*ROWF + R) bytes, against N*ROWF adds to sum the rows and
    R*V to fold their sums."""
    t_bytes = 4 * (R * V + named * rowf + R) / hbm_bytes_per_s
    t_ops = (named * rowf + R * V) / fp32_instr_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bit_unequal(got: torch.Tensor, ref: torch.Tensor) -> int:
    """How many f32 outputs differ from the reference's in their bits."""
    return int((got.view(torch.int32) != ref.view(torch.int32)).sum())


def measure(R: int, K: int, V: int, rowf: int, device, seed: int = 0) -> dict:
    """K5 against its plain version and the library call at one shape, on
    the card: their times (ms, CUDA events), K5's error, bit-unequal
    outputs, bound and share of it, and the library call's gathered GB/s
    (a row per ray and slot).
    The launches made here are the probe's own (one counted per K5 call)."""
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
    res = {"R": R, "K": K, "V": V, "ROWF": rowf, "named_rows": named_rows(ids, K),
           "table_mb": K * rowf * 4 / 1e6, "gathered_gb": gb,
           "rel_err": rel_err(got, ref), "library_rel_err": rel_err(lib, ref),
           "max_abs_err": float((got - ref).abs().max()),
           "bit_unequal": bit_unequal(got, ref),
           "ms": profiling.cuda_ms(lambda: gather_sum_kernel(ids, table)),
           "plain_ms": profiling.cuda_ms(lambda: gather_sum_plain(ids, table)),
           "library_ms": profiling.cuda_ms(lambda: gather_sum_library(ids, table))}
    res["library_gbps"] = gb / (res["library_ms"] / 1e3)
    res["bound_ms"], res["bound_by"] = bound(R, V, rowf, res["named_rows"],
                                             profiling.HBM_BYTES_PER_S,
                                             profiling.FP32_INSTR_PER_S)
    res["share"] = res["bound_ms"] / res["ms"]
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
    print(f"{R} rays x {V} slots x {rowf * 4} B/row from a {r['table_mb']:.1f} MB "
          f"table, {r['named_rows']} of its {K} rows named")
    print(f"K5 kernel    : {r['ms']:8.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), share {r['share']:.3f}; rel err {r['rel_err']:.2e}, "
          f"{r['bit_unequal']} of {R} outputs bit-unequal to the plain version's")
    print(f"plain        : {r['plain_ms']:8.4f} ms")
    print(f"embedding_bag: {r['library_ms']:8.4f} ms, {r['library_gbps']:8.1f} GB/s "
          f"gathered ({r['gathered_gb']:.2f} GB, a row per ray and slot)")
    return 0 if r["rel_err"] <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
