"""The per-lane threefry stream (``CRT_RNG=threefry``) and the ``onb``
cosine (``CRT_COSINE=onb``) in the port against the JAX package.

``keys.fold_in_lanes`` and ``keys.uniform`` equal ``jax.random.fold_in``
and ``jax.random.uniform`` under ``jax_threefry_partitionable`` (JAX's
default), bit for bit, tested against ``jax.random`` itself: that flag
sets the counter layout of ``uniform(k, (n,))``. ``_per_ray_uniforms`` is
bit-equal under ``CRT_RNG=threefry``, and the wavefront's key tables hold
the keys the scan folds. The wavefront under threefry, with Russian
roulette and NEE, equals the scan (rtol/atol 1e-5); the threefry scan
itself is held to JAX's render in tests/test_torch_render.py. The ``onb``
cosine directions match JAX's at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu.ops import sampling as jsmp
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp

RNG = np.random.default_rng(53)
SEEDS = [0, 42, 2**31 + 5, 2**32 - 1]
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ids(n=600):
    ids = RNG.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    ids[:3] = [0, 1, 2**32 - 1]
    return ids


def test_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


def test_threefry_block_matches_host():
    k = keys.key(7)
    x0, x1 = _ids(), _ids()
    h0, h1 = keys.threefry2x32(k, x0, x1)
    t0, t1 = keys.threefry2x32_lanes(torch.tensor(int(k[0])), torch.tensor(int(k[1])),
                                     torch.as_tensor(x0.astype(np.int64)),
                                     torch.as_tensor(x1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), h0.astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), h1.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_uniform_match_jax(seed):
    ids = _ids()
    jk = jax.random.key(seed)
    jf = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jk, jnp.asarray(ids))
    pf = keys.fold_in_lanes(keys.key(seed), torch.as_tensor(ids.astype(np.int64)))
    assert pf.shape == (ids.size, 2) and pf.dtype == torch.int64
    np.testing.assert_array_equal(pf.numpy(), _data(jf))
    # per-lane keys folded again by per-lane data
    data = ids[::-1].copy()
    jf2 = jax.vmap(jax.random.fold_in)(jf, jnp.asarray(data))
    np.testing.assert_array_equal(
        keys.fold_in_lanes(pf, torch.as_tensor(data.astype(np.int64))).numpy(), _data(jf2))
    for n in (1, 2, 5, 9, 12):
        ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jf))
        got = keys.uniform(pf, n)
        assert got.dtype == torch.float32 and got.shape == (ids.size, n)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("nslot", [1, 5, 9, 10])
def test_per_ray_uniforms_match_jax(monkeypatch, nslot):
    monkeypatch.setenv("CRT_RNG", "threefry")
    ids = RNG.integers(0, 512 * 512, 700).astype(np.int32)
    jk = jax.random.fold_in(jax.random.key(42), 3)
    ref = np.asarray(jint._per_ray_uniforms(jk, jnp.asarray(ids), nslot))
    got = integrator._per_ray_uniforms(keys.fold_in(keys.key(42), 3),
                                       torch.as_tensor(ids), nslot)
    np.testing.assert_array_equal(got.numpy(), ref)
    monkeypatch.setenv("CRT_RNG", "fast")
    assert not np.array_equal(
        integrator._per_ray_uniforms(keys.fold_in(keys.key(42), 3),
                                     torch.as_tensor(ids), nslot).numpy(), ref)


def test_wavefront_keys_are_the_scans_folds():
    spp, depth, offset = 3, 4, 5
    jkey = jax.random.key(9)
    t = integrator.wavefront_keys(keys.key(9), spp, depth, offset, rr=True)
    for s in range(spp):
        js = jax.random.fold_in(jkey, offset + s)
        jc, jp = jax.random.split(js)
        np.testing.assert_array_equal(t["cam"][s], _data(jc))
        np.testing.assert_array_equal(t["wl"][s], _data(jax.random.fold_in(js, 0x5EC7)))
        jr = jax.random.fold_in(jp, 0x5252)
        for b in range(depth):
            np.testing.assert_array_equal(t["path"][s, b], _data(jax.random.fold_in(jp, b)))
            np.testing.assert_array_equal(t["rr"][s, b], _data(jax.random.fold_in(jr, b)))


@pytest.mark.parametrize("kw", [dict(rr_depth=1), dict(nee=True, rr_depth=2)],
                         ids=["rr", "nee_rr"])
def test_wavefront_matches_scan(monkeypatch, kw):
    monkeypatch.setenv("CRT_RNG", "threefry")
    s, c = catalog.cornell_box_with_sphere_light(width=16, spp=4, max_depth=4,
                                                 device="cpu")
    c = c.replace(stratify=True, **kw)
    key = keys.key(13)
    scan = integrator.render_image(s, c, key)
    wave = (integrator.render_wavefront(s, c, key, 4, lanes=90) / 4).reshape(scan.shape)
    torch.testing.assert_close(wave, scan, **WAVEFRONT_TOL)


def test_onb_cosine_matches_jax(monkeypatch):
    monkeypatch.setenv("CRT_COSINE", "onb")
    n = RNG.normal(size=(4096, 3)).astype(np.float32)
    n[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0.95, 0.3, 0.0]]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u1, u2 = RNG.uniform(0, 1, (2, 4096)).astype(np.float32)
    ref = np.asarray(jsmp.cosine_dir(jnp.asarray(n), jnp.asarray(u1), jnp.asarray(u2)))
    got = smp.cosine_dir(torch.as_tensor(n), torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(
        smp.cosine_local_dir(torch.as_tensor(u1), torch.as_tensor(u2)).numpy(),
        np.asarray(jsmp.cosine_local_dir(jnp.asarray(u1), jnp.asarray(u2))), atol=1e-6)
    # the default construction maps the same uniforms elsewhere
    monkeypatch.setenv("CRT_COSINE", "sphere")
    other = smp.cosine_dir(torch.as_tensor(n), torch.as_tensor(u1), torch.as_tensor(u2))
    assert float((other - got).abs().max()) > 0.1
