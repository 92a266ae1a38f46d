"""The port's path-regeneration wavefront and the scan's pixel batching.

``integrator.render_wavefront`` draws each path's uniforms from seed-word
tables built on the host; they must equal the JAX package's words bit for
bit. Every path's radiance is then the scan's, so the wavefront image
equals the scan's up to the order of summation (atol 1e-6 here), for the
dense Cornell box and for the chunked colonnade (triangles, the per-ray
route) and sphereflake (spheres, the packet and the per-ray route), with
a pool smaller than the frame, so that lanes are refilled. Against JAX's own wavefront the contract is that of
tests/test_torch_render.py: mean within 2e-3 and at least 98% of pixels
within 1e-3. Pixel batching of the scan leaves the image bitwise
unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import camera as jcam
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.models import integrator as jint
from cpu_ray_tracing_implementation_tpu_torch.models import camera as cam
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, perray
from cpu_ray_tracing_implementation_tpu_torch.utils import convert


_SCENES = {}


def _scene(name, spp, depth=3):
    """The 16 px scene, built once per module; the camera at ``spp``."""
    if (name, depth) not in _SCENES:
        _SCENES[name, depth] = catalog.SCENES[name](width=16, spp=1, max_depth=depth,
                                                    device="cpu")
    scene, camera = _SCENES[name, depth]
    return scene, camera.replace(spp=spp)


def _scan(scene, camera, key, spp, offset=0, **kw):
    ids = torch.arange(camera.width * camera.height, dtype=torch.int32)
    return integrator.accumulate_samples_subset(scene, camera, key, ids, offset,
                                                spp, **kw)


def test_seed_tables_match_jax():
    """cam_words and path_words equal jax.random.bits of the scan's folds."""
    spp, depth, offset = 3, 4, 5
    jkey = jax.random.key(9)
    tables = integrator.wavefront_keys(
        convert.key_from_numpy(jax.random.key_data(jkey)), spp, depth, offset)
    cam_w = integrator._bits_table(tables["cam"])
    path_w = integrator._bits_table(tables["path"])
    assert cam_w.shape == (spp, 2) and path_w.shape == (spp, depth, 2)
    for s in range(spp):
        k_cam, k_path = jax.random.split(jax.random.fold_in(jkey, offset + s))
        np.testing.assert_array_equal(
            cam_w[s], np.asarray(jax.random.bits(k_cam, (2,), np.uint32)))
        for b in range(depth):
            np.testing.assert_array_equal(path_w[s, b], np.asarray(
                jax.random.bits(jax.random.fold_in(k_path, b), (2,), np.uint32)))


@pytest.mark.parametrize("name,spp,lanes", [
    ("cornell_box", 3, None), ("cornell_box", 3, 64),
    ("sponza", 2, 64), ("sphereflake", 2, 64)])
def test_wavefront_matches_scan(name, spp, lanes, monkeypatch):
    scene, camera = _scene(name, spp)
    key = keys.key(42)
    # the chunked scenes run their accelerator inside the loop: the per-ray
    # route asked for, and sphereflake's packet route under auto (58 chunks)
    routes = {"cornell_box": ("auto",), "sponza": ("ray",), "sphereflake": ("auto", "ray")}
    for accel in routes[name]:
        monkeypatch.setenv("CRT_ACCEL", accel)
        integrator.reset_wavefront()
        perray.reset_phases()
        wf = integrator.render_wavefront(scene, camera, key, spp, lanes=lanes)
        assert integrator.WAVEFRONT["renders"] == 1
        # a pool smaller than the frame refills: more iterations than bounces
        n_pix = camera.width * camera.height
        assert integrator.WAVEFRONT["iterations"] >= (
            camera.max_depth if lanes is None else n_pix * spp // lanes)
        assert (perray.PHASES["calls"] > 0) == (accel == "ray")
        torch.testing.assert_close(wf, _scan(scene, camera, key, spp), rtol=0, atol=1e-6)


def test_wavefront_matches_jax():
    js, jc = jcat.cornell_box(width=16, spp=3, max_depth=3)
    jkey = jax.random.key(42)
    ref = np.asarray(jint.render_wavefront(js, jc, jkey, 3, lanes=64))
    got = integrator.render_wavefront(
        convert.scene_from_numpy(js, device="cpu"),
        convert.camera_from_numpy(jc, device="cpu"),
        convert.key_from_numpy(jax.random.key_data(jkey)), 3, lanes=64).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(), ref.mean(), atol=2e-3)
    close = np.abs(got - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()


def test_sample_halves_sum_to_the_whole():
    scene, camera = _scene("cornell_box", 4)
    key = keys.key(5)
    whole = integrator.render_wavefront(scene, camera, key, 4, lanes=48)
    halves = (integrator.render_wavefront(scene, camera, key, 2, lanes=48)
              + integrator.render_wavefront(scene, camera, key, 2, lanes=48,
                                            sample_offset=2))
    torch.testing.assert_close(whole, halves, rtol=1e-5, atol=1e-5)
    # the second half is the scan's samples 2 and 3
    torch.testing.assert_close(
        integrator.render_wavefront(scene, camera, key, 2, sample_offset=2),
        _scan(scene, camera, key, 2, offset=2), rtol=0, atol=1e-6)


def test_pixel_subset_equals_full_frame_rows():
    scene, camera = _scene("cornell_box", 3)
    key = keys.key(7)
    full = integrator.render_wavefront(scene, camera, key, 3)
    ids = torch.tensor([200, 3, 17, 255, 0, 96, 97], dtype=torch.int32)
    sub = integrator.render_wavefront(scene, camera, key, 3, pixel_ids=ids, lanes=4)
    torch.testing.assert_close(sub, full[ids.long()], rtol=0, atol=1e-6)


def test_tiled_render_equals_untiled():
    scene, camera = _scene("cornell_box", 2)
    key = keys.key(3)
    whole = integrator.render_image_wavefront(scene, camera, key)
    tiled = integrator.render_image_wavefront(scene, camera, key, tile_pixels=100)
    assert tiled.shape == (camera.height, camera.width, 3)
    torch.testing.assert_close(tiled, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["cornell_box", "sponza"])
def test_pixel_batches_are_bitwise(name):
    scene, camera = _scene(name, 2)
    key = keys.key(11)
    whole = _scan(scene, camera, key, 2)
    assert torch.equal(integrator.accumulate_samples(scene, camera, key, 0, 2,
                                                     batch_pixels=37), whole)


def test_per_lane_stratified_jitter_equals_the_int_path():
    _, camera = _scene("cornell_box", 6)
    camera = camera.replace(stratify=True)
    u = torch.rand(50, cam.N_CAM_SLOTS, generator=torch.Generator().manual_seed(1))
    s = torch.arange(50, dtype=torch.int32) % 9 + 2
    got = cam.stratify_pixel_jitter(camera, u, s)
    for i in range(50):
        ref = cam.stratify_pixel_jitter(camera, u[i:i + 1], int(s[i]))
        assert torch.equal(got[i:i + 1], ref)


def test_per_lane_stratified_jitter_matches_jax():
    _, jc = jcat.cornell_box(width=16, spp=6)
    jc = jc.replace(stratify=True)
    pc = convert.camera_from_numpy(jc, device="cpu")
    u = np.random.default_rng(3).uniform(0, 1, (40, 5)).astype(np.float32)
    s = (np.arange(40) % 13).astype(np.int32)
    ref = np.asarray(jcam.stratify_pixel_jitter(jc, jnp.asarray(u), jnp.asarray(s)))
    got = cam.stratify_pixel_jitter(pc, torch.as_tensor(u), torch.as_tensor(s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name,routed", [("cornell_box", False), ("sponza", True),
                                         ("sphereflake", True)])
def test_automatic_sizes_and_overrides(name, routed, monkeypatch):
    scene, _ = _scene(name, 1)
    monkeypatch.delenv("CRT_SCAN_TILE", raising=False)
    monkeypatch.delenv("CRT_WF_LANES", raising=False)
    monkeypatch.delenv("CRT_ACCEL", raising=False)
    # under auto the 16 px colonnade (71 chunks) and sphereflake (58) take
    # the packet route, which keeps the whole frame, as in the JAX package;
    # ``routed`` is their routing under CRT_ACCEL=ray
    assert not integrator._perray_routed(scene)
    assert integrator.scan_batch_pixels(scene) is None
    assert integrator.wavefront_lanes(scene, 1000) is None
    if routed:
        monkeypatch.setenv("CRT_ACCEL", "ray")
    assert integrator._perray_routed(scene) == routed
    want_batch = integrator.AUTO_SCAN_TILE if routed else None
    assert integrator.scan_batch_pixels(scene) == want_batch
    want_lanes = (None if not routed or integrator.AUTO_WF_LANES is None
                  else min(integrator.AUTO_WF_LANES, 1000))
    assert integrator.wavefront_lanes(scene, 1000) == want_lanes
    monkeypatch.setenv("CRT_SCAN_TILE", "512")
    monkeypatch.setenv("CRT_WF_LANES", "5000")
    assert integrator.scan_batch_pixels(scene) == 512
    assert integrator.wavefront_lanes(scene, 1000) == 1000
    monkeypatch.setenv("CRT_SCAN_TILE", "full")
    monkeypatch.setenv("CRT_WF_LANES", "full")
    assert integrator.scan_batch_pixels(scene) is None
    assert integrator.wavefront_lanes(scene, 1000) is None
