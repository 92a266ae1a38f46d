"""K4, the per-ray route's visit-list sweep (``sweep_kernel``, four stage
kernels): planar calls only; a sphere call is not counted, though its
kernels' device time is."""

from port_bench import roofline

MODULE = "cpu_ray_tracing_implementation_tpu_torch.ops.fused_sweep"
ATTR = "sweep_kernel"
KERNELS = ("visit_sweep_count", "visit_sweep_scatter", "visit_sweep_tile",
           "visit_sweep_fold")


def record(args, out):
    if args["sphere"]:
        return None
    return args["rays"], args["ids"], args["nears"], args["table"], float(args["tmin"]), out


def bound_s(rec) -> float:
    rays, ids, nears, table, tmin, out = rec
    return roofline.k4_bound(rays, ids, nears, out[:, 0], table, tmin)
