"""Adaptive sampling (``models/adaptive.py``) of the port.

The (pixel id, absolute sample index) RNG contract and the device's float32
running sums make the port's adaptive render bitwise its uniform renders
at the two ends of the tolerance: ``rel_tol=0`` gives the ``max_spp``
render and a huge tolerance the ``min_spp`` one. Against the JAX package's
adaptive render on the same tables and key: image means within 2e-3 and
at least 99% of the per-pixel sample map equal.
"""

import jax
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import adaptive as jadaptive
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu_torch.models import adaptive, catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def cornell():
    return catalog.cornell_box(width=16, spp=8, max_depth=3, device="cpu")


def test_tol_zero_equals_uniform_max_spp(cornell):
    scene, cam = cornell
    img, spp_map = adaptive.render_image_adaptive(
        scene, cam, keys.key(0), rel_tol=0.0, min_spp=4, max_spp=12, chunk_spp=5,
        return_spp_map=True)
    assert torch.equal(img, integrator.render_image(scene, cam, keys.key(0), spp=12))
    np.testing.assert_array_equal(spp_map, 12)


def test_huge_tol_equals_uniform_min_spp(cornell):
    scene, cam = cornell
    img, spp_map = adaptive.render_image_adaptive(
        scene, cam, keys.key(0), rel_tol=1e6, min_spp=4, max_spp=16, chunk_spp=4,
        zero_var_spp=4, return_spp_map=True)
    np.testing.assert_array_equal(spp_map, 4)
    assert torch.equal(img, integrator.render_image(scene, cam, keys.key(0), spp=4))


def test_moments_continue_one_running_sum(cornell):
    """accumulate_samples_subset over consecutive sample ranges, each
    continuing the last one's sum, is bitwise one call over their union;
    its second moments are the per-sample squares summed."""
    scene, cam = cornell
    ids = torch.tensor([0, 5, 77, 200, 255], dtype=torch.int32)
    whole = integrator.accumulate_samples_subset(scene, cam, keys.key(1), ids, 0, 6)
    first, sq1 = integrator.accumulate_samples_subset(scene, cam, keys.key(1), ids, 0, 2,
                                                      moments=True)
    run, sq2 = integrator.accumulate_samples_subset(scene, cam, keys.key(1), ids, 2, 4,
                                                    accum=first, moments=True)
    assert torch.equal(run, whole)
    samples = [integrator.render_sample(scene, cam, keys.fold_in(keys.key(1), s), ids,
                                        sample_idx=s) for s in range(6)]
    torch.testing.assert_close(sq1 + sq2, sum(x * x for x in samples), rtol=1e-6, atol=0)


def test_matches_jax_adaptive():
    js, jc = jcat.cornell_box(width=16, spp=8, max_depth=3)
    jkey = jax.random.key(0)
    kw = dict(rel_tol=0.1, min_spp=8, max_spp=64, chunk_spp=8, return_spp_map=True)
    ref, ref_map = jadaptive.render_image_adaptive(js, jc, jkey, **kw)
    img, spp_map = adaptive.render_image_adaptive(
        convert.scene_from_numpy(js, device="cpu"), convert.camera_from_numpy(jc, device="cpu"),
        convert.key_from_numpy(jax.random.key_data(jkey)), **kw)
    assert torch.isfinite(img).all()
    np.testing.assert_allclose(float(img.mean()), float(np.mean(ref)), atol=2e-3)
    assert (spp_map == np.asarray(ref_map)).mean() >= 0.99
    # the budget concentrates: some pixels stop early, some run long
    assert 8 < spp_map.mean() < 64 and (spp_map == 8).any() and (spp_map >= 32).any()


def test_a_device_mesh_is_not_ported(cornell):
    """The sharded rounds are ported: a mesh of one rank (no process group)
    renders bitwise as no mesh (two ranks: tests/test_torch_parallel.py)."""
    scene, cam = cornell
    kw = dict(rel_tol=0.05, min_spp=4, max_spp=12, chunk_spp=4, return_spp_map=True)
    img, spp_map = adaptive.render_image_adaptive(scene, cam, keys.key(0),
                                                  mesh=pm.make_mesh(device="cpu"), **kw)
    ref, ref_map = adaptive.render_image_adaptive(scene, cam, keys.key(0), **kw)
    assert torch.equal(img, ref)
    np.testing.assert_array_equal(spp_map, ref_map)
