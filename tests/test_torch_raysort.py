"""The port's coherence sort (``ops/raysort.py``) against the JAX package's.

``coherence_keys`` must equal JAX's bit for bit. JAX's sort is not stable
and its keys collide, so the permutation is held by what it must give: the
keys in ascending order (equal to JAX's sorted keys), every payload row
carried with its key, and ``unsort`` restoring every array, of every
dtype, exactly. A coherence-sorted ``intersect_brute`` gives each ray the
hit an unsorted one gives it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.ops import raysort as jraysort
from cpu_ray_tracing_implementation_tpu_torch.models import catalog
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import raysort
from cpu_ray_tracing_implementation_tpu_torch.utils import profiling

LO = np.float32([-3.0, -1.0, -2.0])
HI = np.float32([4.0, 2.5, 1.0])


def _rays(seed, n=5000):
    rng = np.random.default_rng(seed)
    # origins inside and around the box (clipped keys), directions with
    # zero components (octant bit 0)
    org = rng.uniform(LO - 1.0, HI + 1.0, (n, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs[::7, 1] = 0.0
    return org, dirs


@pytest.mark.parametrize("seed", [0, 1])
def test_coherence_keys_bit_equal_to_jax(seed):
    org, dirs = _rays(seed)
    ref = np.asarray(jraysort.coherence_keys(jnp.asarray(org), jnp.asarray(dirs),
                                             jnp.asarray(LO), jnp.asarray(HI)))
    got = raysort.coherence_keys(torch.as_tensor(org), torch.as_tensor(dirs),
                                 torch.as_tensor(LO), torch.as_tensor(HI))
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) < len(ref)      # keys collide


def test_sort_round_trip_and_sorted_keys():
    org, dirs = _rays(2)
    keys = raysort.coherence_keys(torch.as_tensor(org), torch.as_tensor(dirs),
                                  torch.as_tensor(LO), torch.as_tensor(HI))
    rng = np.random.default_rng(4)
    arrays = [torch.as_tensor(org), torch.as_tensor(rng.uniform(size=5000).astype(np.float32)),
              torch.as_tensor(rng.integers(0, 99, 5000).astype(np.int32)),
              torch.as_tensor(rng.uniform(size=5000) < 0.3),
              torch.as_tensor(rng.uniform(size=(5000, 2)))]
    sorted_arrays, lane_ids = raysort.sort_rays(keys, [keys] + arrays)
    s_keys = sorted_arrays[0]
    jkeys = jnp.asarray(keys.numpy())
    j_sorted, j_ids = jraysort.sort_rays(jkeys, [jkeys])
    np.testing.assert_array_equal(s_keys.numpy(), np.asarray(j_sorted[0]))
    assert bool((s_keys[1:] >= s_keys[:-1]).all()) and lane_ids.dtype == torch.int32
    assert sorted(lane_ids.tolist()) == list(range(5000))
    for a, s in zip(arrays, sorted_arrays[1:]):
        assert s.dtype == a.dtype and torch.equal(s, a[lane_ids.long()])
    back = raysort.unsort(lane_ids, sorted_arrays)
    for a, b in zip([keys] + arrays, back):
        assert b.dtype == a.dtype and torch.equal(a, b)
    # JAX's own round trip through its lane ids gives the same keys back
    np.testing.assert_array_equal(np.asarray(jraysort.unsort(j_ids, j_sorted)[0]),
                                  keys.numpy())


def test_sorted_intersect_equals_unsorted(monkeypatch):
    """Sphereflake (58 chunks, the packet route), primary rays of a 24 px
    frame plus their first bounce in tiles of 64: CRT_SORT=on against off."""
    scene, cam = catalog.sphereflake(width=24, spp=1, max_depth=2, device="cpu")
    monkeypatch.setenv("CRT_TILE", "64")
    gen = torch.Generator().manual_seed(5)
    org, dirs, time, _ = profiling.scene_rays(scene, cam, gen)
    u_vol = torch.zeros((org.shape[0], 0))
    monkeypatch.setenv("CRT_SORT", "off")
    o2, d2 = profiling.secondary(org, dirs, isect.intersect_brute(
        scene, org, dirs, time, 1e-3, u_vol).t, gen)
    hits = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("CRT_SORT", mode)
        assert isect._sort_wanted(scene, org.shape[0]) == (mode == "on")
        hits[mode] = [isect.intersect_brute(scene, o, d, time, 1e-3, u_vol)
                      for o, d in ((org, dirs), (o2, d2))]
    for a, b in zip(hits["off"], hits["on"]):
        assert torch.equal(a.valid, b.valid) and torch.equal(a.t, b.t)
        assert torch.equal(a.mat, b.mat) and int(a.valid.sum()) > 50
        for f in ("p", "normal", "u", "v"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=1e-6)
