"""Geometry gradients at scale: the colonnade through the per-ray
accelerator's winner-replay backward (ops/perray.py PlanarClosestRay).

The chunk tables are re-derived from the dense vertex tables in the graph
(``chunked.rechunk_planar``), so the replay's chunk gradients scatter-add
onto the dense rows. At 10 px the colonnade has 32 chunks: JAX takes its
tile-packet accelerator there and the port its per-ray route; both replay
the same winners (as ``tests/test_diff.py:222-254`` of the JAX package).
Tolerances: the JAX package's replay test's (loss rtol 1e-4, scene
gradients rtol 2e-3 / atol 1e-5, camera rtol 5e-3 / atol 1e-4), and its
finite-difference test's (rtol 0.1, atol 3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import diff as jdiff
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, diff
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def colonnade():
    js, jc = jcat.sponza(width=10, spp=2, max_depth=2)
    jkey = jax.random.key(6)
    target = jnp.zeros((jc.height, jc.width, 3))
    p0 = jdiff.scene_params(js)
    c0 = jdiff.camera_params(jc)

    def loss_of(p, c):
        return jdiff.image_loss(jdiff.apply_scene_params(js, p),
                                jdiff.apply_camera_params(jc, c), jkey, target, spp=2)

    loss, (gs, gc) = jax.value_and_grad(loss_of, argnums=(0, 1))(p0, c0)
    port = (convert.scene_from_numpy(js, device="cpu"),
            convert.camera_from_numpy(jc, device="cpu"),
            convert.key_from_numpy(jax.random.key_data(jkey)))
    return port, (float(loss), convert.params_to_numpy(gs), convert.params_to_numpy(gc))


def test_vertex_gradients_match_jax(colonnade):
    (scene, cam, key), (j_loss, j_gs, j_gc) = colonnade
    assert scene.tri_chunks is not None
    target = torch.zeros((cam.height, cam.width, 3))
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, key, target, 2)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    g = gs["geo_tri_v0"]
    assert bool(torch.isfinite(g).all()) and int((g.abs().amax(1) > 1e-5).sum()) > 0
    for name, gg in gs.items():
        np.testing.assert_allclose(gg.numpy(), j_gs[name], rtol=2e-3, atol=1e-5,
                                   err_msg=name)
    for name, gg in gc.items():
        np.testing.assert_allclose(gg.numpy(), j_gc[name], rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_vertex_gradient_matches_finite_differences(colonnade):
    """Central differences on the largest-gradient vertex coordinate (the
    interior term: at this eps no sampled ray crosses an edge; the chunk
    boxes follow the moved vertex, so both renders cull correctly)."""
    (scene, cam, key), _ = colonnade
    target = torch.zeros((cam.height, cam.width, 3))
    _, (gs, _) = diff.loss_and_grads(scene, cam, key, target, 2)
    g = gs["geo_tri_v0"]
    row = int(torch.argmax(g.abs().amax(1)))
    axis = int(torch.argmax(g[row].abs()))
    p0 = diff.scene_params(scene)
    eps = 3e-3

    def loss_at(delta):
        p = dict(p0)
        p["geo_tri_v0"] = p0["geo_tri_v0"].clone()
        p["geo_tri_v0"][row, axis] += delta
        return float(diff.image_loss(diff.apply_scene_params(scene, p), cam, key,
                                     target, 2))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[row, axis]), fd, rtol=0.1, atol=3e-5)


def test_rechunk_reproduces_the_build():
    """apply_scene_params re-derives the chunk tables bit for bit when the
    dense geometry is unchanged (chunk boxes included)."""
    scene, _ = catalog.sponza(width=8, spp=1, device="cpu")
    s2 = diff.apply_scene_params(scene, diff.scene_params(scene))
    for f in ("corner", "eu", "ev", "lo", "hi", "mat", "active"):
        assert torch.equal(getattr(s2.tri_chunks, f), getattr(scene.tri_chunks, f)), f
    assert torch.equal(s2.tri_perray.table, scene.tri_perray.table)
    assert torch.equal(s2.tri_perray.boxes, scene.tri_perray.boxes)


def test_gradient_run_goes_through_the_accelerator_twice(monkeypatch):
    """No tape on chunked tables: the forward pass and the backward pass
    each run the per-ray accelerator (one selection-phase loop per bounce
    and pass), as the JAX package reruns it inside its remat. The 8 px
    colonnade's 71 chunks take the packet route under ``auto``, so the
    per-ray route is asked for (``CRT_ACCEL=ray``)."""
    monkeypatch.setenv("CRT_ACCEL", "ray")
    scene, cam = catalog.sponza(width=8, spp=1, max_depth=2, device="cpu")
    calls = []
    orig = fs.cull_select

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **k)

    monkeypatch.setattr(fs, "cull_select", counted)
    diff.loss_and_grads(scene, cam, keys.key(1),
                        torch.zeros((cam.height, cam.width, 3)), 1)
    # the phase loop selects under no_grad in both passes; at least one
    # selection per bounce in each
    assert len(calls) >= 2 * cam.max_depth and not any(calls)
