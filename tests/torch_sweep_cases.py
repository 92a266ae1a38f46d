"""Adversarial visit lists for kernel K4 (``ops/fused_sweep.py``), shared by
tests/test_torch_sweep.py (the plain decomposition on the CPU) and
tests/test_torch_cuda.py (the kernel on the card). Imports no JAX.

Each case is a random table in the sweep layout [K, F, 128] whose chunk 1
copies chunk 0 and whose lanes 100-115 copy lanes 0-15 of their chunk (so
rows tie within a row and across slots), a few dead lanes (eu = ev = 0,
rad = 0), rays aimed into the table's box, input bests with random pass-
through columns, and a visit list built to stress one rule of the sweep:

- ``ties``: every ray lists chunks 0, 1, 0, 1, ... with near 0;
- ``between``: slot 0 at near 0, every later near anywhere below the input
  best, unsorted (near >= the running best but < the input best);
- ``exhausted``: every near NaN (K3's exhausted slot) or +inf;
- ``duplicates``: each ray lists one chunk three times among others;
- ``clip``: ids from -4 to K + 3 (the sweep clips them to [0, K-1]);
- ``one_ray``: R = 1; ``one_chunk``: K = 1.
"""

import numpy as np
import torch

CASES = ("ties", "between", "exhausted", "duplicates", "clip", "one_ray", "one_chunk")
KINDS = ("quad", "tri", "sphere")
C = 128
TMIN = 1e-3


def _table(rng, kind, K):
    if kind == "sphere":
        c0 = rng.uniform(-3, 3, (K, 3, C))
        c1 = c0 + rng.normal(0, 0.1, (K, 3, C))
        rad = rng.uniform(0.2, 0.6, (K, 1, C))
        rad[:, :, 50:53] = 0.0
        t = np.concatenate([c0, c1, rad], axis=1)
    else:
        corner = rng.uniform(-3, 3, (K, 3, C))
        eu, ev = rng.normal(0, 1.0, (K, 3, C)), rng.normal(0, 1.0, (K, 3, C))
        eu[:, :, 50:53] = ev[:, :, 50:53] = 0.0
        t = np.concatenate([corner, eu, ev], axis=1)
    t[:, :, 100:116] = t[:, :, 0:16]
    if K > 1:
        t[1] = t[0]
    return t.astype(np.float32)


def make_case(kind: str, case: str, device, seed: int = 0, R: int = 256, V: int = 8,
              K: int = 4):
    """(rays, ids, nears, best, table, triangle, sphere) of one case."""
    rng = np.random.default_rng(1000 * CASES.index(case) + 10 * KINDS.index(kind) + seed)
    R = 1 if case == "one_ray" else R
    K = 1 if case == "one_chunk" else K
    table = _table(rng, kind, K)
    d = rng.normal(size=(R, 3))
    org = 12.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
    dirs = rng.uniform(-2.5, 2.5, (R, 3)) - org
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((R, 8), np.float32)
    rays[:, 0:3], rays[:, 3:6], rays[:, 6] = org, dirs, rng.uniform(0, 1, R)
    best = rng.uniform(-1, 1, (R, 8)).astype(np.float32)
    best[:, 0] = rng.uniform(8.0, 30.0, R)
    best[:, 6] = rng.integers(0, 3, R)
    best[:, 7] = rng.integers(0, K * C, R)
    t_in = best[:, :1]

    ids = rng.integers(0, K, (R, V))
    nears = np.sort(rng.uniform(0, 1, (R, V)) * t_in, axis=1)
    if case == "ties":
        ids = np.tile(np.arange(V) % min(K, 2), (R, 1))
        nears[:] = 0.0
    elif case == "between":
        nears = rng.uniform(0, 1, (R, V)) * t_in
        nears[:, 0] = 0.0
    elif case == "exhausted":
        nears[:] = np.nan
        nears[rng.uniform(size=(R, V)) < 0.2] = np.inf
    elif case == "duplicates":
        ids[:, [0, 2, 5]] = ids[:, :1]
    elif case == "clip":
        ids = rng.integers(-4, K + 4, (R, V))
    t = lambda x, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                                    device=device)
    return (t(rays), t(ids, torch.int32), t(nears), t(best), t(table), kind == "tri",
            kind == "sphere")


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def check_case(case: str, got: torch.Tensor, ref: torch.Tensor, best: torch.Tensor,
               nears: torch.Tensor) -> None:
    """``got`` equal to ``ref`` (``sweep_plain``) in all 8 columns bit for
    bit, and the case really stresses what it names."""
    assert torch.equal(bits(got), bits(ref))
    hit = ref[:, 0] < best[:, 0]
    if case == "exhausted":
        assert torch.equal(bits(ref), bits(best))
        return
    assert bool(hit.any())
    lane = torch.round(ref[hit, 7]).long() % C
    assert not bool(((lane >= 100) & (lane < 116)).any())  # first lane of a tie
    if case == "ties" and best.shape[0] > 1:
        assert bool((torch.round(ref[hit, 7]) < C).all())   # chunk 0, the earlier slot
    if case == "between":
        between = (nears >= ref[:, :1]) & (nears < best[:, :1])
        assert int(between.sum()) > 0


def q16_grazing(kind: str, device, K: int = 6, seed: int = 7):
    """K8's grazing set: a quantized table of K small and large chunks at
    +-1,200 units (``procgen.grazing_table``: slivers, dead lanes, edges
    shared across groups) and rays aimed at every vertex, from random
    directions, along the axes and grazing (``procgen.vertex_rays``). ->
    (perray.Q16Tables, rays [R, 8], the chunk each ray aims at [R])."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
    from cpu_ray_tracing_implementation_tpu_torch.ops import perray
    from cpu_ray_tracing_implementation_tpu_torch.utils import procgen

    corner, eu, ev, act, lo, hi = procgen.grazing_table(kind == "quad", K)
    t = lambda x: torch.as_tensor(x, device=device)
    q = perray.planar_q16(ch.PlanarChunks(
        t(corner), t(eu), t(ev), torch.zeros(act.shape, dtype=torch.int32, device=device),
        t(act), t(lo), t(hi)))
    org, dirs, chunk = procgen.vertex_rays(q.words.cpu().numpy(), q.lo.cpu().numpy(),
                                           q.scale.cpu().numpy(), kind == "quad", seed)
    return q, fsw.pack_rays(t(org), t(dirs)), t(chunk)


def q16_thin(q) -> torch.Tensor:
    """[K, C] bool: the live primitives of quantized tables ``q`` whose
    |n|^2 (n = eu x ev, each product, difference and sum rounded in
    float32, as the kernel computes it) lies below the 1e-20 that the plane
    test clamps it to, so that they are hit beyond their box."""
    from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw

    x = fsw.dequant_q16(q.words, q.lo, q.scale)
    n = torch.stack(fsw._cross3(*x[:, 3:6].unbind(1), *x[:, 6:9].unbind(1)), 1)
    nn = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    return (n != 0).any(1) & (nn < 1e-20)
