"""The port's host-side BVH ordering against the JAX package's.

Both compile ``native/bvh_builder.cc`` (the port into its own build
directory), so on the same centroids and bounds they give the same
primitive order, and so the same chunk bounds. The numpy Morton fallback
is compared too. Equality is exact.
"""

import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.utils import accel as jaccel
from cpu_ray_tracing_implementation_tpu_torch.utils import accel


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, (n, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return (c - half + c + half) / 2.0, c - half, c + half


@pytest.mark.parametrize("n", [1, 7, 700, 5000])
def test_native_order_and_chunk_bounds_match_jax(n):
    centroid, lo, hi = _boxes(n, n)
    order, nodes = accel.build_bvh(centroid, lo, hi, max_leaf=8)
    j_order, j_nodes = jaccel.build_bvh(centroid, lo, hi, max_leaf=8)
    assert nodes is not None and j_nodes is not None  # both native
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(nodes, j_nodes)
    assert sorted(order.tolist()) == list(range(n))
    clo, chi = accel.chunk_bounds(lo[order], hi[order], 128)
    j_clo, j_chi = jaccel.chunk_bounds(lo[order], hi[order], 128)
    np.testing.assert_array_equal(clo, j_clo)
    np.testing.assert_array_equal(chi, j_chi)
    assert clo.shape == (max(1, -(-n // 128)), 3) and clo.dtype == np.float32


def test_morton_fallback_matches_jax():
    centroid, _, _ = _boxes(3000, 9)
    np.testing.assert_array_equal(accel._morton_order(centroid),
                                  jaccel._morton_order(centroid))


def test_chunk_bounds_pad_with_empty_boxes():
    lo = np.zeros((0, 3), np.float32)
    clo, chi = accel.chunk_bounds(lo, lo, 128)
    assert clo.shape == (1, 3) and np.isinf(clo).all() and (chi < clo).all()


def test_library_lands_in_the_build_directory():
    """The native builder is compiled into the port's build directory,
    never next to its source."""
    accel.build_bvh(*_boxes(10, 1)[:3])
    path = accel._library_path()
    assert path.exists() and path.parent == accel.BUILD_DIR
