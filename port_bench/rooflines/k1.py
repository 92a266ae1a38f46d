"""K1, the dense closest hit (``planar_closest_kernel``): the ray rows,
the [8, R] hit rows and the constant pack moved once; 36 instructions per
(ray, live primitive)."""

from port_bench import roofline

MODULE = "cpu_ray_tracing_implementation_tpu_torch.ops.fused_intersect"
ATTR = "planar_closest_kernel"
KERNELS = ("planar_closest_kernel",)
# the pack's row of 1.0 / 0.0 lane flags (``fused_intersect.ROW_ACTIVE``)
ROW_ACTIVE = 12


def record(args, out):
    return args["rays"].shape[1], args["pack"]


def bound_s(rec) -> float:
    R, pack = rec
    return roofline.k1_bound(R, pack.numel(), int(pack[:, ROW_ACTIVE].sum()))
