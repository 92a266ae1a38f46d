"""The winner replay (ops/replay.py) against the JAX package's.

``winner_pack`` decides with the fused closest hit (the plain chunk scan on
the CPU, kernels K1 / K2 on the card) where the JAX package runs its dense
XLA sweeps; the ids must agree wherever the decision is not a near-tie
(the two sweeps round t apart by an ulp or so), and the rays where they do
not are counted and bounded. ``replay_hit`` is held to JAX's within
``tests/test_replay.py:67-75``'s bounds, and the replay render to the
port's own default render (``test_replay.py:78-89``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracing_implementation_tpu.models import camera as jcam
from cpu_ray_tracing_implementation_tpu.models import catalog as jcat
from cpu_ray_tracing_implementation_tpu.ops import intersect as jisect
from cpu_ray_tracing_implementation_tpu.ops import replay as jreplay
from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import keys, replay
from cpu_ray_tracing_implementation_tpu_torch.utils import convert

TMIN = 1e-3
SCENES = {
    "cornell_box": lambda: jcat.cornell_box(width=16, spp=2, max_depth=3),
    "three_material_ball": lambda: jcat.three_material_ball(width=16, spp=2,
                                                            max_depth=3),
    "all_materials_fixture": lambda: jcat.all_materials_fixture(width=16, spp=2,
                                                                max_depth=3),
}


def _camera_rays(jc, n=512, seed=0):
    rng = np.random.default_rng(seed)
    pix = jnp.asarray(np.arange(n, dtype=np.int32) % (jc.width * jc.height))
    u = jnp.asarray(rng.uniform(size=(n, jcam.N_CAM_SLOTS)).astype(np.float32))
    org, dirs, time = jcam.generate_rays(jc, pix, u)
    return np.asarray(org), np.asarray(dirs), np.asarray(time)


def _secondary(js, org, dirs, time, seed=1):
    """Rays leaving the camera rays' first hits (JAX's) in random
    directions."""
    hb = jisect.intersect_brute(js, jnp.asarray(org), jnp.asarray(dirs),
                                jnp.asarray(time), TMIN, jnp.zeros((org.shape[0], 0)))
    keep = np.asarray(hb.valid)
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=org.shape).astype(np.float32)
    return np.asarray(hb.p)[keep], d2[keep], time[keep]


def _both(name, which):
    js, jc = SCENES[name]()
    org, dirs, time = _camera_rays(jc)
    if which == "secondary":
        org, dirs, time = _secondary(js, org, dirs, time)
    return js, convert.scene_from_numpy(js, device="cpu"), org, dirs, time


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("which", ["camera", "secondary"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_winner_pack_matches_jax(name, which):
    js, scene, org, dirs, time = _both(name, which)
    jz = jnp.zeros((org.shape[0], 0))
    j_ids = np.asarray(jreplay.winner_pack(js, jnp.asarray(org), jnp.asarray(dirs),
                                           jnp.asarray(time), TMIN, jz))
    ids = replay.winner_pack(scene, _t(org), _t(dirs), _t(time), TMIN, None).numpy()
    assert (j_ids >= 0).sum() >= org.shape[0] // 4
    differ = ids != j_ids
    # a near-tie: both hit, and the replayed t of the two winners agree to
    # rtol 1e-4 (two primitives at one depth, or the surface a secondary
    # ray leaves, seen at t ~ tmin by one sweep and not the other)
    jr = jreplay.replay_hit(js, jnp.asarray(org), jnp.asarray(dirs),
                            jnp.asarray(time), jz, jnp.asarray(ids), TMIN)
    jr0 = jreplay.replay_hit(js, jnp.asarray(org), jnp.asarray(dirs),
                             jnp.asarray(time), jz, jnp.asarray(j_ids), TMIN)
    t1, t0 = np.asarray(jr.t), np.asarray(jr0.t)
    near = (np.isfinite(t1) & np.isfinite(t0)
            & (np.abs(t1 - t0) <= 1e-4 * np.abs(t0) + 2 * TMIN))
    unexplained = differ & ~near
    assert differ.sum() <= max(2, org.shape[0] // 100), (differ.sum(), org.shape[0])
    assert not unexplained.any(), np.flatnonzero(unexplained)[:8]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_replay_hit_matches_jax(name):
    """The port's replay of JAX's own decisions equals JAX's replay within
    test_replay.py's bounds (decisions exactly)."""
    js, scene, org, dirs, time = _both(name, "camera")
    jz = jnp.zeros((org.shape[0], 0))
    ids = jreplay.winner_pack(js, jnp.asarray(org), jnp.asarray(dirs),
                              jnp.asarray(time), TMIN, jz)
    jh = jreplay.replay_hit(js, jnp.asarray(org), jnp.asarray(dirs),
                            jnp.asarray(time), jz, ids, TMIN)
    h = replay.replay_hit(scene, _t(org), _t(dirs), _t(time), None,
                          torch.as_tensor(np.asarray(ids)), TMIN)
    v = np.asarray(jh.valid)
    np.testing.assert_array_equal(h.valid.numpy(), v)
    np.testing.assert_array_equal(h.mat.numpy()[v], np.asarray(jh.mat)[v])
    np.testing.assert_array_equal(h.front.numpy()[v], np.asarray(jh.front)[v])
    np.testing.assert_allclose(h.t.numpy()[v], np.asarray(jh.t)[v], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.p.numpy()[v], np.asarray(jh.p)[v], rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(h.normal.numpy()[v], np.asarray(jh.normal)[v],
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(h.u.numpy()[v], np.asarray(jh.u)[v], rtol=5e-2, atol=5e-2)


def test_replay_render_close_to_default():
    """Decisions identical, values within float noise of the re-associated
    winner arithmetic."""
    scene, cam = catalog.cornell_box(width=16, spp=4, max_depth=3, device="cpu")
    base = integrator.render_image(scene, cam, keys.key(0))
    rep = integrator.render_image(scene, cam, keys.key(0), replay_isect=True)
    torch.testing.assert_close(rep, base, rtol=2e-3, atol=2e-3)


def test_tape_plays_back_what_it_recorded(monkeypatch):
    """A render that records the winners and one that plays them back give
    the same image, and the play-back decides nothing itself."""
    scene, cam = catalog.all_materials_fixture(width=12, spp=2, max_depth=3,
                                               device="cpu")
    ids = torch.arange(cam.width * cam.height, dtype=torch.int32)
    tape = replay.Tape()
    rec = integrator.accumulate_samples_subset(scene, cam, keys.key(2), ids, 0, 2,
                                               isect_fn=tape.record)
    assert len(tape) == 2 * cam.max_depth

    def refuse(*a, **k):
        raise AssertionError("the play-back decided a winner")

    monkeypatch.setattr(replay, "winner_pack", refuse)
    play = integrator.accumulate_samples_subset(scene, cam, keys.key(2), ids, 0, 2,
                                                isect_fn=tape.play)
    assert torch.equal(rec, play)
    with pytest.raises(IndexError, match="no more winner ids"):
        tape.play(scene, *[torch.zeros((1, 3))] * 2, torch.zeros(1), TMIN, None)


def test_chunked_scenes_are_not_replayed():
    scene, _ = catalog.sponza(width=8, spp=1, max_depth=1, device="cpu")
    assert not replay.supported(scene)
    dense, _ = catalog.cornell_box(width=8, spp=1, max_depth=1, device="cpu")
    assert replay.supported(dense)
