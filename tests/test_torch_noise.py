"""The port's noise (ops/noise.py) and noise textures against the JAX package.

Tables: bit-equal. Functions, on seeded points drawn at least 0.02 away
from every lattice plane (a point on a cell boundary can round into either
cell): perlin, turbulence and value noise within atol 1e-5; the worley and
voronoi hash is chaotic in float32 (its argument reaches ~2e4, where an
ulp of ``sin`` moves the hash by ~3e-3, and now and then across an
integer, which moves a jittered point by a whole cell), so those are held
by the share of points within 1e-5 (>= 0.95). The JAX functions are
compiled, as a render compiles them; how XLA rounds the hash (which
operations it fuses into multiply-adds) depends on what it is compiled
with, so the worley and voronoi textures are held to the port's own noise
functions, and their scenes to JAX's renders. Textures: the perlin marble
multiplies turbulence by 70 before its ``sin`` (atol 1e-4). Scenes at the golden workload (tests/test_golden.py: 16 px,
4 spp, depth 3, key 42): the image mean within 2e-3 of JAX's and of the
recorded golden mean (simple_light_earth, ROADMAP F1, loads the missing
earthmap.jpg and is held to JAX only), and the share of pixels within 1e-3
of JAX's image at least the scene's ``SHARE`` (voronoi's color is the hash
of a hashed point, so a cell whose hash is an ulp off changes its whole
region); perlin_texture_ball (2,401 chunked quads, the per-ray route
where JAX takes its packet route) by its recorded mean. The JAX renders
take ``unroll=(1, 1)``: the same image, bit for bit, at a third of the
compile time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import noise as jnoise
from cpu_ray_tracing_implementation_tpu.ops import textures as jtex
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import noise
from cpu_ray_tracing_implementation_tpu_torch.ops import textures as tex
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

N = 4096
GOLDEN = {"perlin_texture_ball": 0.418168, "test_perlin_noise": 0.507109,
          "test_value_noise": 0.496078, "test_voronoi_noise": 0.462877,
          "test_worley_noise": 0.322421}
# the scenes held pixel by pixel to a live JAX render (perlin_texture_ball,
# whose marble the other perlin scenes carry, only to its recorded mean)
SHARE = {"test_perlin_noise": 0.98, "test_value_noise": 0.98,
         "test_worley_noise": 0.98, "test_voronoi_noise": 0.9,
         "simple_light_earth": 0.98}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread renders them as fast
    and leaves the other test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(lo, hi, n=N, seed=0):
    """Seeded points at least 0.02 from every integer lattice plane."""
    p = np.random.default_rng(seed).uniform(lo, hi, (n, 3))
    f = p - np.floor(p)
    p = np.floor(p) + 0.02 + 0.96 * f
    return p.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 12])
def test_tables_bit_equal(seed):
    for a, b in zip(noise.make_perlin_tables(seed), jnoise.make_perlin_tables(seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for res in (10, 40):
        a, b = noise.make_value_grid(res, seed + 1), jnoise.make_value_grid(res, seed + 1)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_perlin_and_value_match_jax():
    grad, perm = jnoise.make_perlin_tables(0)
    grid = jnoise.make_value_grid(40, 1)
    tg, tp, tgrid = (torch.as_tensor(x) for x in (grad, perm, grid))
    p = _points(-30, 30)
    pt = torch.as_tensor(p)
    np.testing.assert_allclose(noise.perlin_noise(pt, tg, tp).numpy(),
                               np.asarray(jnoise.perlin_noise(p, grad, perm)), atol=1e-5)
    np.testing.assert_allclose(noise.perlin_turb(pt / 4, tg, tp).numpy(),
                               np.asarray(jnoise.perlin_turb(p / 4, grad, perm)), atol=1e-5)
    # value noise inside the grid and past its clamped edges
    q = _points(-3, 43)
    np.testing.assert_allclose(noise.value_noise(torch.as_tensor(q), tgrid).numpy(),
                               np.asarray(jnoise.value_noise(q, grid)), atol=1e-5)


@pytest.mark.parametrize("which", ["worley", "voronoi"])
def test_cell_noise_matches_jax(which):
    """At the noise test scenes' scale (points in [0, 40]^3), against the
    JAX functions compiled as a render compiles them (jit: XLA contracts
    the hash's dot product into fused multiply-adds; eagerly it does not)."""
    p = _points(0, 40)
    got = getattr(noise, f"{which}_noise")(torch.as_tensor(p)).numpy()
    ref = np.asarray(jax.jit(getattr(jnoise, f"{which}_noise"))(jnp.asarray(p)))
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= 1e-5).mean() >= 0.95, (err <= 1e-5).mean()
    # the hash of a lattice cell: the JAX package's up to its sin's ulps
    cells = np.floor(p)
    h = noise._cell_hash(torch.as_tensor(cells)).numpy()
    h_ref = np.asarray(jax.jit(jnoise._cell_hash)(cells))
    assert (np.abs(h - h_ref) <= 1e-6).mean() >= 0.97


def _noise_builder(builder):
    b = builder(seed=5, value_noise_resolution=12)
    for t in (b.solid((0.2, 0.3, 0.4)), b.perlin(4.0), b.value(16), b.worley(),
              b.voronoi()):
        b.sphere((0, 0, 0), 1.0, b.lambertian(t))
    return b


def test_noise_textures_match_jax():
    """eval_texture of each noise kind on one table, the tables built by
    both builders (seed 5, value grid 16): solid, perlin and value against
    the JAX package's, worley and voronoi against the port's functions."""
    js = _noise_builder(JSceneBuilder).build()
    ps = _noise_builder(sc.SceneBuilder).build("cpu")
    from test_torch_scene import _assert_scenes_equal
    _assert_scenes_equal(ps, convert.scene_from_numpy(js, device="cpu"))
    p = _points(-8, 18)
    rng = np.random.default_rng(1)
    uu, vv = rng.uniform(0, 1, (2, N)).astype(np.float32)
    ev = jax.jit(lambda t: jtex.eval_texture(js, t, uu, vv, p))

    def both(kind):
        tid = np.full(N, kind, np.int32)
        got = tex.eval_texture(ps, torch.as_tensor(tid), torch.as_tensor(uu),
                               torch.as_tensor(vv), torch.as_tensor(p)).numpy()
        return got, np.asarray(ev(jnp.asarray(tid)))

    for kind, atol in ((0, 0.0), (1, 1e-4), (2, 1e-5)):
        np.testing.assert_allclose(*both(kind), atol=atol, rtol=0, err_msg=str(kind))
    pt = torch.as_tensor(p)
    for kind, fn in ((3, noise.worley_noise), (4, noise.voronoi_noise)):
        tid = torch.full((N,), kind, dtype=torch.int32)
        got = tex.eval_texture(ps, tid, torch.as_tensor(uu), torch.as_tensor(vv), pt)
        assert torch.equal(got, fn(pt)[:, None].expand(N, 3)), kind


def test_perlin_texture_ball_golden():
    ps, pc = catalog.perlin_texture_ball(width=16, spp=4, max_depth=3, device="cpu")
    img = integrator.render_image(ps, pc, keys.key(42))
    assert bool(torch.isfinite(img).all())
    np.testing.assert_allclose(float(img.mean()), GOLDEN["perlin_texture_ball"], atol=2e-3)


@pytest.mark.parametrize("name", sorted(SHARE))
def test_noise_scene_golden_matches_jax(name):
    js, jc = jcat.SCENES[name](width=16, spp=4, max_depth=3)
    ref = np.asarray(jint.render_image(js, jc, jax.random.key(42), unroll=(1, 1)))
    ps, pc = catalog.SCENES[name](width=16, spp=4, max_depth=3, device="cpu")
    img = integrator.render_image(ps, pc, keys.key(42)).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    if name in GOLDEN:
        np.testing.assert_allclose(img.mean(), GOLDEN[name], atol=2e-3)
    close = (np.abs(img - ref).max(axis=-1) <= 1e-3).mean()
    assert close >= SHARE[name], close
