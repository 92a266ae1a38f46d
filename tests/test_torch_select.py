"""Plain K3 (``ops/fused_select.cull_select_plain``) against the JAX
Pallas kernel ``pallas_select.cull_select``, which runs in interpret mode
on the CPU as tests/test_pallas_select.py runs it.

Same rays, boxes and exclusion keys go through both, in packed and exact
mode, for phase 1 and the two phases after it (each fed the previous
phase's exclusion key), at a K that is not a multiple of 128 and at small
V. ids, nears and rest must be bit-equal (NaN where NaN): the plain
version repeats the kernel's operations one for one in float32. Above 32
slots, the chained selection of ``cull_select`` is held to one plain call
bit for bit. One thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import scene as jscene
from cpu_ray_tracing_implementation_tpu.ops import pallas_select as jps
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs

TMIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread for this module (its tensors are small; the
    suite's workers otherwise run on the default count), restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tri_boxes():
    """The chunk AABBs of 700 random triangles (6 chunks)."""
    rng = np.random.default_rng(8)
    b = jscene.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    ch = b.build().tri_chunks
    return np.array(ch.lo), np.array(ch.hi)


def _subtile_boxes():
    """The 32-lane sub-tile boxes of the same triangles (24 boxes,
    ``perray._subtile_bounds_planar``): the sub-tile route's K3 input."""
    from cpu_ray_tracing_implementation_tpu.ops import perray as jperray

    rng = np.random.default_rng(8)
    b = jscene.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    lo, hi = jperray._subtile_bounds_planar(b.build().tri_chunks, 32)
    return np.array(lo), np.array(hi)


def _random_boxes(K, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4.0, (K, 3))
    half = rng.uniform(0.05, 1.0, (K, 3))
    return (c - half).astype(np.float32), (c + half).astype(np.float32)


def _rays(R, seed, cap=50.0):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3.0, (R, 3)).astype(np.float32)
    d = rng.normal(0, 1, (R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:5, 0] = 0.0                       # axis-parallel rays: the 1e-20 guard
    caps = np.full(R, cap, np.float32)
    caps[5:10] = TMIN                    # dead lanes: cap = tmin
    caps[10:20] = rng.uniform(0.5, 4.0, caps[10:20].shape)
    return org, d, caps


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _check_equal(got, ref, R):
    ids, nears, rest = (np.asarray(x) for x in got)
    ids_r, nears_r, rest_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(ids, ids_r[:R])
    np.testing.assert_array_equal(np.isnan(nears), np.isnan(nears_r[:R]))
    np.testing.assert_array_equal(_bits(nears)[~np.isnan(nears)],
                                  _bits(nears_r[:R])[~np.isnan(nears)])
    rest_r = rest_r[:R, 0]
    np.testing.assert_array_equal(np.isnan(rest), np.isnan(rest_r))
    np.testing.assert_array_equal(_bits(rest)[~np.isnan(rest)],
                                  _bits(rest_r)[~np.isnan(rest)])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("boxes,V", [("tri", 2), ("tri", 6), ("random200", 3),
                                     ("random200", 16), ("subtile", 24)])
def test_plain_matches_jax_kernel_over_three_phases(boxes, V, packed):
    lo, hi = {"tri": _tri_boxes, "subtile": _subtile_boxes,
              "random200": lambda: _random_boxes(200, 1)}[boxes]()
    K = lo.shape[0]
    R = 96
    org, d, caps = _rays(R, 2)

    jboxes = jps.pack_boxes(jnp.asarray(lo), jnp.asarray(hi))
    jrays, Rp = jps.pad_rays(jps.pack_rays(jnp.asarray(org), jnp.asarray(d),
                                           jnp.asarray(caps)), jboxes.shape[1])
    boxes_t = fs.pack_boxes(torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(boxes_t.numpy(), np.asarray(jboxes))
    rays_t = fs.pack_rays(torch.as_tensor(org), torch.as_tensor(d),
                          torch.as_tensor(caps))
    np.testing.assert_array_equal(rays_t.numpy(), np.asarray(jrays)[:R])

    jexcl = jnp.concatenate([jnp.full((Rp, 1), -1e30, jnp.float32),
                             jnp.full((Rp, 1), -1.0, jnp.float32)], axis=1)
    excl = fs.first_excl(R, "cpu")
    np.testing.assert_array_equal(excl.numpy(), np.asarray(jexcl)[:R])
    finite = 0
    for _ in range(3):
        ref = jps.cull_select(jrays, jboxes, jexcl, V, K, TMIN, packed=packed)
        got = fs.cull_select(rays_t, boxes_t, excl, V, K, TMIN, packed=packed)
        _check_equal(got, ref, R)
        finite += int(np.isfinite(np.asarray(got[1])).sum())
        jexcl = jnp.stack([ref[1][:, V - 1],
                           ref[0][:, V - 1].astype(jnp.float32)], axis=1)
        excl = fs.next_excl(got[0], got[1])
        np.testing.assert_array_equal(excl.numpy(), np.asarray(jexcl)[:R])
    assert finite > R  # the phases selected real chunks


def test_wide_table_packs_more_id_bits():
    """Kp = 2,048 (the colonnade's) keeps IDB = 11; above it IDB grows."""
    assert fs.id_bits(128) == 11 and fs.id_bits(2048) == 11
    assert fs.id_bits(2176) == 12 == jps._id_bits(2176)
    lo, hi = _random_boxes(2100, 4)
    org, d, caps = _rays(32, 5)
    jboxes = jps.pack_boxes(jnp.asarray(lo), jnp.asarray(hi))
    jrays, Rp = jps.pad_rays(jps.pack_rays(jnp.asarray(org), jnp.asarray(d),
                                           jnp.asarray(caps)), jboxes.shape[1])
    jexcl = jnp.concatenate([jnp.full((Rp, 1), -1e30, jnp.float32),
                             jnp.full((Rp, 1), -1.0, jnp.float32)], axis=1)
    ref = jps.cull_select(jrays, jboxes, jexcl, 4, 2100, TMIN)
    got = fs.cull_select(fs.pack_rays(*(torch.as_tensor(x) for x in (org, d, caps))),
                         fs.pack_boxes(torch.as_tensor(lo), torch.as_tensor(hi)),
                         fs.first_excl(32, "cpu"), 4, 2100, TMIN)
    _check_equal(got, ref, 32)


def test_cpu_tensors_launch_nothing_and_kernel_refuses_them():
    lo, hi = _random_boxes(10, 2)
    org, d, caps = _rays(16, 3)
    rays = fs.pack_rays(*(torch.as_tensor(x) for x in (org, d, caps)))
    boxes = fs.pack_boxes(torch.as_tensor(lo), torch.as_tensor(hi))
    fs.reset_launches()
    fs.cull_select(rays, boxes, fs.first_excl(16, "cpu"), 4, 10, TMIN)
    assert fs.LAUNCHES == {"cull_select": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fs.cull_select_kernel(rays, boxes, fs.first_excl(16, "cpu"), 4, 10, TMIN)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_done_rows_get_the_exhausted_key(packed):
    """``next_excl`` with ``done`` writes the exhausted key (NaN threshold
    packed; +inf with a last id past every chunk exact), and the plain K3
    then returns exhausted slots for exactly those rows and what it returns
    without marking for the others."""
    lo, hi = _random_boxes(200, 1)
    R, V = 96, 2
    org, d, caps = _rays(R, 2)
    rays = fs.pack_rays(*(torch.as_tensor(x) for x in (org, d, caps)))
    boxes = fs.pack_boxes(torch.as_tensor(lo), torch.as_tensor(hi))
    ids, nears, _ = fs.cull_select(rays, boxes, fs.first_excl(R, "cpu"), V, 200, TMIN,
                                   packed=packed)
    done = torch.as_tensor(np.random.default_rng(3).uniform(size=R) < 0.4)
    excl = fs.next_excl(ids, nears, done, TMIN, packed)
    plain = fs.next_excl(ids, nears)
    assert torch.equal(excl[~done], plain[~done])
    if packed:
        assert bool(torch.isnan(excl[done, 0]).all())
    else:
        assert bool((excl[done, 0] == float("inf")).all())
        assert bool((excl[done, 1] >= boxes.shape[1] - 1).all())
    got = fs.cull_select(rays, boxes, excl, V, 200, TMIN, packed=packed)
    ref = fs.cull_select(rays, boxes, plain, V, 200, TMIN, packed=packed)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x[~done].numpy(), y[~done].numpy())
    ids2, nears2, rest2 = (x[done].numpy() for x in got)
    if packed:
        assert (ids2 == (1 << fs.id_bits(boxes.shape[1])) - 1).all()
        assert np.isnan(nears2).all() and np.isnan(rest2).all()
    else:
        assert (ids2 == 0).all()
        assert np.isposinf(nears2).all() and np.isposinf(rest2).all()
    assert np.isfinite(ref[1][done].numpy()).any()   # marking changed them


def _deep_boxes():
    """300 large overlapping boxes that rays cross up to ~140 at a time."""
    rng = np.random.default_rng(1)
    c = rng.normal(0, 1.5, (300, 3))
    half = rng.uniform(0.5, 2.0, (300, 3))
    return (c - half).astype(np.float32), (c + half).astype(np.float32)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("V", [64, 128])
def test_chained_selection_equals_one_plain_call(V, packed):
    """Above 32 slots (the sub-tile route's V at CRT_SUBC=2 and 1)
    ``cull_select`` chains selections of 32, each from the last one's key
    with its exhausted rays marked done; over four phases (the last past
    every key: packed mode's NaN) the ids, nears and rest equal one
    ``cull_select_plain`` call at V bit for bit."""
    lo, hi = _deep_boxes()
    R = 96
    org, d, caps = _rays(R, 2)
    rays = fs.pack_rays(*(torch.as_tensor(x) for x in (org, d, caps)))
    boxes = fs.pack_boxes(torch.as_tensor(lo), torch.as_tensor(hi))
    excl = fs.first_excl(R, "cpu")
    deep = 0
    for _ in range(4):
        got = fs.cull_select(rays, boxes, excl, V, 300, TMIN, packed=packed)
        ref = fs.cull_select_plain(rays, boxes, excl, V, 300, TMIN, packed=packed)
        assert torch.equal(got[0], ref[0])
        for x, y in zip(got[1:], ref[1:]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        deep += int((torch.isfinite(ref[1]).sum(1) > 32).sum())
        excl = fs.next_excl(got[0], got[1])
    assert deep >= 20                    # rays whose list runs past one selection
