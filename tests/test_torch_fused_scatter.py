"""The scatter's routes on the CPU: the fused route (``ops/fused_scatter.py``,
kernel K9 on the card, its plain version here) is taken only where no
gradient is asked for and the scene has no environment light. The kernel
itself is held to its plain version on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from cpu_ray_tracing_implementation_tpu_torch.models import catalog, integrator
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter as fsc
from cpu_ray_tracing_implementation_tpu_torch.ops import keys
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.utils import kernel_ab, trace

# every family (all_materials_fixture; the volume box's isotropic medium), a
# quad light (cornell_box), a sphere light and a dispersive scene
SCENES = ("cornell_box", "all_materials_fixture", "cornell_box_with_volume",
          "cornell_box_with_sphere_light", "dispersion_prism")


def _scene(name, **kw):
    size = dict(width=12, spp=1, max_depth=3, device="cpu") | kw
    return getattr(catalog, name)(**size)


def _fused_spans(fn):
    with trace.recording() as rec:
        out = fn()
    return out, sum(s.name == "crt.scatter.fused" for s in rec.spans)


@pytest.mark.parametrize("name", SCENES)
def test_no_grad_scatter_takes_the_fused_route(name):
    """Each bounce's scatter under no_grad takes the fused route (one
    ``crt.scatter.fused`` span), and with an albedo that needs a gradient
    the differentiable route (none, and outputs that carry a graph). On the
    CPU both routes run ``scatter_plain``: their outputs are the same bits,
    invalid lanes included."""
    scene, cam = _scene(name)
    calls = kernel_ab.scatter_calls(scene, cam, keys.key(7))
    assert len(calls) == cam.max_depth
    assert (calls[0][3] is not None) == scene.has_dispersion
    assert not bool(calls[-1][0].valid.all()) or name == "cornell_box"
    for hit, ray_dir, u, ior_shift, (mt, atten) in calls:
        with torch.no_grad():
            got, n_fused = _fused_spans(
                lambda: mat_ops.scatter(scene, hit, ray_dir, u, ior_shift, (mt, atten)))
        leaf = atten.clone().requires_grad_()
        with torch.enable_grad():
            ref, n_eager = _fused_spans(
                lambda: mat_ops.scatter(scene, hit, ray_dir, u, ior_shift, (mt, leaf)))
        assert (n_fused, n_eager) == (1, 0)
        assert ref[1].requires_grad and not got[1].requires_grad
        assert all(torch.equal(g, r.detach()) for g, r in zip(got, ref))


def test_render_takes_the_fused_route_once_a_bounce():
    """No input of a plain render needs a gradient: every bounce's scatter
    takes the fused route, grad mode on or off, with the same image."""
    scene, cam = _scene("cornell_box", spp=2)
    img, n = _fused_spans(lambda: integrator.render_image(scene, cam, keys.key(1)))
    with torch.no_grad():
        img2, n2 = _fused_spans(lambda: integrator.render_image(scene, cam, keys.key(1)))
    assert n == n2 == cam.spp * cam.max_depth
    assert torch.equal(img, img2)


def test_wrapper_refuses_an_input_that_needs_grad():
    scene, cam = _scene("cornell_box")
    hit, ray_dir, u, ior_shift, (mt, atten) = kernel_ab.scatter_calls(
        scene, cam, keys.key(0))[0]
    leaf = ray_dir.clone().requires_grad_()
    with torch.enable_grad():
        assert not fsc.takes(scene, hit, leaf, u, ior_shift, atten)
        with pytest.raises(RuntimeError, match="gradient"):
            fsc.scatter(scene, hit, leaf, u, ior_shift, mt, atten)
    with torch.no_grad():
        assert fsc.takes(scene, hit, leaf, u, ior_shift, atten)


def test_wrapper_launches_on_card_tensors_only():
    """The kernel has no CPU version of its own: ``materials.scatter``
    runs the plain version there, and the wrapper refuses a CPU tensor."""
    scene, cam = _scene("cornell_box")
    hit, ray_dir, u, ior_shift, (mt, atten) = kernel_ab.scatter_calls(
        scene, cam, keys.key(0))[0]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        fsc.scatter(scene, hit, ray_dir, u, ior_shift, mt, atten)


def test_environment_light_scene_never_takes_the_wrapper():
    """sunlit_spheres' sky is importance-sampled, a pick the kernel does not
    take: its scatter stays eager, under no_grad too."""
    scene, cam = _scene("sunlit_spheres")
    assert scene.has_env_light
    with torch.no_grad():
        img, n = _fused_spans(lambda: integrator.render_image(scene, cam, keys.key(0)))
        hit, ray_dir, u, ior_shift, (mt, atten) = kernel_ab.scatter_calls(
            scene, cam, keys.key(0))[0]
        assert not fsc.takes(scene, hit, ray_dir, u, ior_shift, atten)
    assert n == 0 and bool(torch.isfinite(img).all())
