"""The port's checkpoint / resume (``utils/checkpoint.py``).

Chunked accumulation equals a single-shot render; a render interrupted
after two chunks and resumed from its checkpoint is bitwise the
uninterrupted one, through the scan and through the wavefront (on the
CPU every chunk's sum is deterministic); a checkpoint of another
configuration, or of the scan under the wavefront, is refused;
``batch_pixels`` reaches both integrators; a mesh of one rank renders as
no mesh. The port's Cornell box at 16 px, 8 spp matches the JAX
package's ``render_with_checkpoint`` (mean within 2e-3, 98% of pixels
within 1e-3, the contract of tests/test_torch_render.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.utils import checkpoint as jckpt
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.utils import checkpoint as ckpt
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        kw = dict(width=12, spp=8, max_depth=3, device="cpu")
        if name == "sphereflake":
            kw.update(spp=6, max_depth=2, depth_levels=2)
        _SCENES[name] = catalog.SCENES[name](**kw)
    return _SCENES[name]


def _quiet(*_):
    pass


def test_chunked_accumulation_matches_single_shot():
    scene, cam = _scene("cornell_box")
    single = integrator.render_image(scene, cam, keys.key(5), spp=8)
    a = integrator.accumulate_samples(scene, cam, keys.key(5), 0, 3)
    b = integrator.accumulate_samples(scene, cam, keys.key(5), 3, 5)
    chunked = ((a + b) / 8).reshape(cam.height, cam.width, 3)
    torch.testing.assert_close(single, chunked, rtol=0, atol=1e-6)
    img = ckpt.render_with_checkpoint(scene, cam, seed=5, chunk_spp=3, log=_quiet)
    torch.testing.assert_close(img, single, rtol=0, atol=1e-6)


@pytest.mark.parametrize("wavefront", [False, True])
def test_resume_after_interrupt_is_bitwise(tmp_path, wavefront):
    scene, cam = _scene("sphereflake" if wavefront else "cornell_box")
    path = str(tmp_path / "r.ckpt")
    whole = ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2, log=_quiet,
                                        use_wavefront=wavefront)
    renders = []

    def bomb(msg):
        # the third chunk's log: two chunks are in the checkpoint
        if msg.startswith("[render]"):
            renders.append(msg)
            if len(renders) == 3:
                raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2, ckpt_path=path,
                                    log=bomb, use_wavefront=wavefront)
    assert ckpt.load(path, ("wf-" if wavefront else "") + ckpt._fingerprint(
        scene, cam, 3))[1] == 4
    logs = []
    img = ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2, ckpt_path=path,
                                      log=logs.append, use_wavefront=wavefront)
    assert any("resuming at 4/" in m for m in logs)
    assert not os.path.exists(path)       # the spent checkpoint is removed
    assert torch.equal(img, whole)


def test_mismatched_fingerprint_and_integrator_refused(tmp_path):
    scene, cam = _scene("cornell_box")
    other, other_cam = _scene("sphereflake")
    path = str(tmp_path / "r.ckpt")
    fp = ckpt._fingerprint(scene, cam, seed=0)
    assert fp != ckpt._fingerprint(other, other_cam, seed=0)
    assert fp != ckpt._fingerprint(scene, cam, seed=1)
    assert fp != ckpt._fingerprint(scene, cam.replace(pos=cam.pos + 0.5), seed=0)
    ckpt.save(path, np.zeros((144, 3), np.float32), 2,
              ckpt._fingerprint(other, other_cam, seed=0))
    assert ckpt.load(path, fp) is None
    # a scan checkpoint is refused under the wavefront
    ckpt.save(path, np.full((144, 3), -7.0, np.float32), 4, fp)
    assert ckpt.load(path, fp)[1] == 4
    logs = []
    img = ckpt.render_with_checkpoint(scene, cam, seed=0, chunk_spp=4, ckpt_path=path,
                                      log=logs.append, use_wavefront=True)
    assert not any("resuming" in m for m in logs) and float(img.min()) >= 0.0
    # an unreadable file starts afresh
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    assert ckpt.load(path, fp) is None


def test_batch_pixels_reaches_both_branches(monkeypatch):
    scene, cam = _scene("cornell_box")
    seen = []
    # the scan's chunks run through accumulate_samples_subset on the frame's
    # pixel ids (a rank's share of them over a mesh)
    real_scan, real_wf = integrator.accumulate_samples_subset, integrator.render_wavefront

    def scan(*a, **k):
        seen.append(("scan", k["batch_pixels"]))
        return real_scan(*a, **k)

    def wavefront(*a, **k):
        seen.append(("wavefront", k["lanes"]))
        return real_wf(*a, **k)

    monkeypatch.setattr(integrator, "accumulate_samples_subset", scan)
    monkeypatch.setattr(integrator, "render_wavefront", wavefront)
    a = ckpt.render_with_checkpoint(scene, cam, seed=1, spp=2, chunk_spp=2, log=_quiet,
                                    batch_pixels=40)
    b = ckpt.render_with_checkpoint(scene, cam, seed=1, spp=2, chunk_spp=2, log=_quiet,
                                    batch_pixels=40, use_wavefront=True)
    assert seen == [("scan", 40), ("wavefront", 40)]
    # the batch and the pool change no path: scan batches bitwise, the
    # wavefront to summation order
    torch.testing.assert_close(a, integrator.render_image(scene, cam, keys.key(1), spp=2),
                               rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_mesh_of_several_devices_raises():
    """The sharded chunks are ported: a mesh of one rank (no process group)
    renders bitwise as no mesh, through the scan and the wavefront (two
    ranks: tests/test_torch_parallel.py)."""
    scene, cam = _scene("cornell_box")
    mesh = pm.make_mesh(device="cpu")
    for wavefront in (False, True):
        img = ckpt.render_with_checkpoint(scene, cam, spp=4, chunk_spp=2, log=_quiet,
                                          mesh=mesh, use_wavefront=wavefront)
        ref = ckpt.render_with_checkpoint(scene, cam, spp=4, chunk_spp=2, log=_quiet,
                                          use_wavefront=wavefront)
        assert torch.equal(img, ref)


def test_cornell_matches_jax_render_with_checkpoint(tmp_path):
    js, jc = jcat.cornell_box(width=16, spp=8, max_depth=3)
    ref = np.asarray(jckpt.render_with_checkpoint(js, jc, seed=7, chunk_spp=4,
                                                  log=_quiet))
    img = ckpt.render_with_checkpoint(convert.scene_from_numpy(js, device="cpu"),
                                      convert.camera_from_numpy(jc, device="cpu"), seed=7,
                                      chunk_spp=4, ckpt_path=str(tmp_path / "c.ckpt"),
                                      log=_quiet).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=2e-3)
    close = np.abs(img - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()
    assert jax.random.key_data(jax.random.key(7)).tolist() == keys.key(7).tolist()
