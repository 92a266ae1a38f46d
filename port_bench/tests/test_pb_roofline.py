"""The roofline copy's counts at recorded shapes."""

import pytest
import torch

from port_bench import roofline


def test_k1_bound_cornell_view():
    # 512*512 rays against one chunk of 128 lanes, 18 live quads: operations bound
    R, live, numel = 512 * 512, 18, 16 * 128
    ops = R * live * 36
    assert roofline.k1_bound(R, numel, live) == pytest.approx(ops / 33.5e12)
    assert roofline.k1_bound(R, numel, live) == pytest.approx(5.0712e-6, rel=1e-4)


def test_k3_bound_counts_live_rays_only():
    excl = torch.zeros((1000, 2))
    excl[:400, 0] = float("nan")                 # done rays, packed mode
    excl[400:500, 0] = float("inf")
    excl[400:500, 1] = float(1 << 24)           # done rays, exact mode
    b = roofline.k3_bound(excl, 8 * 2048, 16, 2015)
    assert b == pytest.approx(max(4 * (8 * 500 + 8 * 2048 + 2000 + 32000 + 1000) / 3.35e12,
                                  500 * 2015 * 30 / 33.5e12))


def test_k4_needs_on_one_triangle():
    # one chunk of 128 lanes, lane 0 the triangle z = 5 over x, y in [0, 1]
    table = torch.zeros((2, 9, 128))
    table[0, 0:3, 0] = torch.tensor([0.0, 0.0, 5.0])
    table[0, 3:6, 0] = torch.tensor([1.0, 0.0, 0.0])
    table[0, 6:9, 0] = torch.tensor([0.0, 1.0, 0.0])
    rays = torch.zeros((3, 8))
    rays[:, 0:3] = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.0], [0.2, 0.2, 10.0]])
    rays[:, 3:6] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    ids = torch.tensor([[0, 1], [1, 0], [0, 1]], dtype=torch.int32)
    nears = torch.tensor([[4.9, 6.0], [1.0, 4.9], [1e30, 1e30]])
    best_t = torch.tensor([5.0, 5.0, 1e30])
    # ray 0 visits chunk 0 (4.9 < 5); ray 1 visits chunks 1 and 0; ray 2 none
    visits, rows, more = roofline.k4_needs(rays, ids, nears, best_t, table, 1e-3)
    assert (visits, rows, more) == (3, 2, 2)
    b = roofline.k4_bound(rays, ids, nears, best_t, table, 1e-3)
    ops = visits * 128 * 16 + rows * 128 * 57 + more * 30
    nbytes = 4 * (8 * 3 + 2 * 3 * 2 + 8 * 3 + 8 * 3) + rows * 4 * 9 * 128
    assert b == pytest.approx(max(nbytes / 3.35e12, ops / 33.5e12))
