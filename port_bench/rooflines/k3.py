"""K3, the per-ray route's box selection (``cull_select_kernel``): a slab
test and key per (live ray, box)."""

from port_bench import roofline

MODULE = "cpu_ray_tracing_implementation_tpu_torch.ops.fused_select"
ATTR = "cull_select_kernel"
KERNELS = ("cull_select_kernel",)


def record(args, out):
    return args["excl"], args["boxes"].numel(), args["V"], args["K_real"]


def bound_s(rec) -> float:
    return roofline.k3_bound(*rec)
