"""The port's multi-device renders and gradients (``parallel/mesh.py``) and
the sharded branches of adaptive sampling and checkpoint/resume, on two
gloo ranks of the CPU.

One module fixture spawns the two ranks once (the ``spawn`` context, a
``file://`` store, one thread each, no JAX); every case runs inside them
(``tests/torch_mesh_cases.py``) and returns numpy, and both ranks must
return the same. Against the single-process port: the pixel-sharded scan
and the sharded adaptive render bitwise (pixel-id keyed RNG, the same
per-pixel sample order); the spp-sharded and 2-D renders to atol 1e-5 (the
sample sum in another order); the sharded wavefront bitwise too, since
on the CPU the flush is sequential and at these sizes a rank's pool ends
each pixel's samples in the single pool's order (ROADMAP F2: a smaller
pool can reorder them in general); the sharded gradients at the JAX package's own
sharded-against-single tolerances (loss rtol 1e-5, gradients rtol 2e-4,
atol 1e-7 on the scene and 1e-6 on the camera: a rank sums its own pixels'
terms first). Against JAX's ``parallel.mesh`` on two of the conftest's
eight virtual devices, the pixel-sharded Cornell box and the sharded
gradient step under ROADMAP's port-against-JAX contract (image means
within 2e-3 and 98% of pixels within 1e-3; gradients at
``tests/test_torch_diff.py``'s tolerances).
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.parallel import mesh as jpm
from cpu_ray_tracing_implementation_tpu_torch.models import adaptive, diff
from cpu_ray_tracing_implementation_tpu_torch.models import integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.utils import checkpoint as ckpt
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

RANKS = 2
WAIT_S = 300  # for one case's answer
CORNELL = dict(width=16, spp=4, max_depth=3)
COLONNADE = dict(width=16, spp=2, max_depth=2)
SPHEREFLAKE = dict(width=16, spp=4, max_depth=2, depth_levels=3)
GRAD_CORNELL = dict(width=8, spp=2, max_depth=3)
SCENE_TOL = dict(rtol=2e-4, atol=1e-7)
CAMERA_TOL = dict(rtol=2e-4, atol=1e-6)
# the families __graft_entry__.dryrun_multichip asserts live
LIVE = ("tex_color0", "tex_color1", "mat_fuzz", "mat_ior", "mat_smoothness",
        "mat_spec_prob", "pos", "lookat", "fovy_deg", "focal_length", "geo_sph_c1")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``run(case, env=None, **kw)``: the case on both ranks, rank 0's
    result (rank 1's must be equal)."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    pipes, procs = [], []
    for r in range(RANKS):
        ours, theirs = ctx.Pipe()
        p = ctx.Process(target=torch_mesh_cases.serve, args=(r, RANKS, store, theirs),
                        daemon=True)
        p.start()
        pipes.append(ours)
        procs.append(p)

    def run(case, env=None, **kw):
        for c in pipes:
            c.send((case, env, kw))
        outs = []
        for r, c in enumerate(pipes):
            assert c.poll(WAIT_S), f"rank {r} gave no answer to {case} {kw}"
            status, out = c.recv()
            assert status == "ok", f"rank {r}: {out}"
            outs.append(out)
        _assert_same(outs[0], outs[1])
        return outs[0]

    yield run
    for c in pipes:
        c.send(None)
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not any(p.is_alive() for p in procs)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif a is not None:
        np.testing.assert_array_equal(a, b)


def _grads(name, kw, seed, spp):
    scene, cam = torch_mesh_cases.scene(name, **kw)
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, keys.key(seed),
                                         torch.zeros((cam.height, cam.width, 3)), spp)
    return {"loss": loss.numpy(), **{f"s/{k}": v.numpy() for k, v in gs.items()},
            **{f"c/{k}": v.numpy() for k, v in gc.items()}}


def _check_grads(got, ref):
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for k in ref:
        if k != "loss":
            np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                       **(SCENE_TOL if k[0] == "s" else CAMERA_TOL))


# ------------------------------------------------------------------ renders
@pytest.mark.parametrize("width", [16, 15], ids=["16px", "15px-padded"])
def test_pixel_sharded_scan_is_bitwise(ranks, width):
    kw = dict(CORNELL, width=width)
    scene, cam = torch_mesh_cases.scene("cornell_box", **kw)
    got = ranks("render", name="cornell_box", kw=kw, how="pixel")
    np.testing.assert_array_equal(got, integrator.render_image(scene, cam, keys.key(0)).numpy())
    # batch_pixels reaches each rank's scan and changes no pixel
    got = ranks("render", name="cornell_box", kw=kw, how="pixel", batch_pixels=24)
    np.testing.assert_array_equal(got, integrator.render_image(scene, cam, keys.key(0)).numpy())


@pytest.mark.parametrize("how,shape", [("spp", None), ("2d", (2, 1)), ("2d", (1, 2))],
                         ids=["spp", "2d-2x1", "2d-1x2"])
def test_sample_sharded_renders_match(ranks, how, shape):
    scene, cam = torch_mesh_cases.scene("cornell_box", **CORNELL)
    got = ranks("render", name="cornell_box", kw=CORNELL, how=how, shape=shape, spp=6)
    ref = integrator.render_image(scene, cam, keys.key(0), spp=6).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,accel", [("sponza", "ray"), ("sphereflake", "packet")],
                         ids=["colonnade-ray", "sphereflake-packet"])
def test_chunked_scenes_shard(ranks, monkeypatch, name, accel):
    monkeypatch.setenv("CRT_ACCEL", accel)
    kw = COLONNADE if name == "sponza" else SPHEREFLAKE
    scene, cam = torch_mesh_cases.scene(name, **kw)
    got = ranks("render", {"CRT_ACCEL": accel}, name=name, kw=kw, how="wavefront")
    ref = integrator.render_image_wavefront(scene, cam, keys.key(0)).numpy()
    # every path's radiance is the single wavefront's, and the CPU's flush
    # is sequential; here each pixel's samples also end in the single
    # pool's order (ROADMAP F2: not so in general; on the card the flush is
    # atomic and chip_smoke.py holds the two to rtol 1e-5)
    np.testing.assert_array_equal(got, ref)


def test_adaptive_sharded_is_bitwise(ranks):
    kw = dict(CORNELL, spp=24)
    scene, cam = torch_mesh_cases.scene("cornell_box", **kw)
    opts = dict(rel_tol=0.05, min_spp=4, chunk_spp=4, zero_var_spp=8)
    got = ranks("render", name="cornell_box", kw=kw, how="adaptive", **opts)
    img, spp_map = adaptive.render_image_adaptive(scene, cam, keys.key(0),
                                                  return_spp_map=True, **opts)
    assert 4 < spp_map.mean() < 24   # some pixels stopped, some did not
    np.testing.assert_array_equal(got["img"], img.numpy())
    np.testing.assert_array_equal(got["spp_map"], spp_map)


@pytest.mark.parametrize("first,then", [("sharded", "single"), ("single", "sharded"),
                                        ("sharded", "sharded")])
def test_checkpoint_resumes_across_meshes(ranks, tmp_path, first, then):
    kw = dict(CORNELL, spp=8)
    scene, cam = torch_mesh_cases.scene("cornell_box", **kw)
    path = str(tmp_path / "c.ckpt.npz")
    whole = ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2,
                                        log=lambda _: None).numpy()
    args = dict(name="cornell_box", kw=kw, seed=3, chunk_spp=2, path=path)

    class Stop(Exception):
        pass

    def bomb(msg):
        if msg.startswith("[render] 6/"):  # two chunks are in the file
            raise Stop

    if first == "sharded":
        assert ranks("checkpointed", stop_after=2, **args) is None
    else:
        with pytest.raises(Stop):
            ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2, ckpt_path=path,
                                        log=bomb)
    assert ckpt.load(path, ckpt._fingerprint(scene, cam, 3))[1] == 4
    if then == "sharded":
        out = ranks("checkpointed", **args)
        assert out["resumed"]
        img = out["img"]
    else:
        logs = []
        img = ckpt.render_with_checkpoint(scene, cam, seed=3, chunk_spp=2, ckpt_path=path,
                                          log=logs.append).numpy()
        assert any("resuming at 4/" in m for m in logs)
    np.testing.assert_array_equal(img, whole)


# ---------------------------------------------------------------- gradients
@pytest.mark.parametrize("shape", [None, (2, 1), (1, 2)], ids=["1d", "2d-2x1", "2d-1x2"])
def test_sharded_grads_match_single(ranks, shape):
    got = ranks("grads", name="cornell_box", kw=GRAD_CORNELL, seed=2, spp=2, shape=shape)
    _check_grads(got, _grads("cornell_box", GRAD_CORNELL, 2, 2))


def test_sharded_grads_on_chunked_geometry(ranks, monkeypatch):
    monkeypatch.setenv("CRT_ACCEL", "ray")
    kw = dict(COLONNADE, width=12)
    ref = _grads("sponza", kw, 3, 2)
    assert np.abs(ref["s/geo_tri_v0"]).max() > 0, "triangle vertex grads vacuously zero"
    got = ranks("grads", {"CRT_ACCEL": "ray"}, name="sponza", kw=kw, seed=3, spp=2)
    _check_grads(got, ref)


def test_sharded_grads_all_materials_live(ranks):
    kw = dict(width=12, spp=4, max_depth=3)
    got = ranks("grads", name="all_materials_fixture", kw=kw, seed=0, spp=4)
    for fam in LIVE:
        key = ("c/" if fam in ("pos", "lookat", "fovy_deg", "focal_length") else "s/") + fam
        assert np.linalg.norm(got[key]) > 0, f"{fam} vacuously zero"
    assert np.isfinite(got["loss"])
    _check_grads(got, _grads("all_materials_fixture", kw, 0, 4))


# ------------------------------------------------------------- against JAX
@pytest.fixture(scope="module")
def jax_mesh():
    return jpm.make_mesh(jax.devices()[:RANKS])


def test_pixel_sharded_matches_jax(ranks, jax_mesh):
    js, jc = jcat.cornell_box(**CORNELL)
    ref = np.asarray(jpm.render_image_sharded(js, jc, jax.random.key(0), jax_mesh))
    got = ranks("render", name="cornell_box", kw=CORNELL, how="pixel")
    np.testing.assert_allclose(got.mean(), ref.mean(), atol=2e-3)
    close = np.abs(got - ref).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()


def test_sharded_grad_step_matches_jax(ranks, jax_mesh):
    js, jc = jcat.cornell_box(**GRAD_CORNELL)
    target = jnp.zeros((jc.height, jc.width, 3))
    loss, (gs, gc) = jpm.render_loss_and_grad_sharded(js, jc, jax.random.key(2), target,
                                                      jax_mesh, spp=2)
    got = ranks("grads", name="cornell_box", kw=GRAD_CORNELL, seed=2, spp=2)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
    for prefix, ref, tol in (("s/", convert.params_to_numpy(gs), dict(rtol=2e-3, atol=1e-5)),
                             ("c/", convert.params_to_numpy(gc), dict(rtol=5e-3, atol=1e-4))):
        assert {k[2:] for k in got if k.startswith(prefix)} == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[prefix + k], v, err_msg=k, **tol)
