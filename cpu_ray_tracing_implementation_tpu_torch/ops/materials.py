"""Material scatter/emission as masked-lane batch functions.

Port of ``cpu_ray_tracing_implementation_tpu/ops/materials.py`` for the
lambertian, metal, dielectric, gloss, isotropic and diffuse-light families
with quad lights, sphere lights and the importance-sampled environment
(src/material.h:36-219, src/pdf.h:48-61; ``ops/envlight.py``). Every lane
evaluates every family the scene contains and selects by type id. Under
spectral dispersion a dielectric refracts at its IOR plus its Cauchy B
times the path's ``ior_shift`` (``spectrum.cauchy_ior_shift`` of the hero
wavelength).

Two estimators: ``scatter`` is the reference's one-sample 50/50 mixture of
the material and light pdfs (its forward alone, where no gradient is
asked for, one launch of kernel K9 on the card); ``scatter_nee``
(camera.nee) splits each diffuse vertex into a pure material sample for
the path and a separate light sample for a shadow ray, combined with the
power heuristic.

Random numbers arrive as a [R, NSLOT(+V)] uniform block with the JAX
package's slot layout:
  0: dielectric reflect decision
  1,2: primary direction sample
  3: dual-pdf 50/50 pick
  4,5: light surface point
  6,7: metal fuzz sphere direction
  8: light index choice
  9..: per-volume scatter distances

Gradients (detached sampling): directions come from explicit uniforms, so
they carry no parameter dependence; the weights do. ``score_w``, the
score-function weight of the two discrete lobe picks (gloss specular or
diffuse, dielectric reflect or refract), is exactly 1.0 in the forward pass
(p / p.detach()) and carries d log p(taken branch) in the backward.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import envlight, fused_scatter
from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture
from cpu_ray_tracing_implementation_tpu_torch.utils import trace

NSLOT = 9

SLOT_DECISION = 0
SLOT_DIR1, SLOT_DIR2 = 1, 2
SLOT_MIS = 3
SLOT_LIGHT_U, SLOT_LIGHT_V = 4, 5
SLOT_FUZZ1, SLOT_FUZZ2 = 6, 7
SLOT_LIGHT_PICK = 8
SLOT_VOLUME0 = 9


def _safe_div(num, den, fallback=0.0):
    ok = torch.abs(den) > 1e-20
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.full_like(num, fallback))


def mat_rows(scene, hit):
    """(mt, color): the per-hit material type and texture color, shared by
    ``emitted`` and ``scatter`` (emission color and albedo come from the
    same texture row, src/material.h:211 vs :62)."""
    mt = tbl.take_rows(scene.materials.mtype, hit.mat)
    tex_id = tbl.take_rows(scene.materials.tex, hit.mat)
    color = eval_texture(scene, tex_id, hit.u, hit.v, hit.p)
    return mt, color


def emitted(scene, hit, pre=None) -> torch.Tensor:
    """Front-face-only emission of diffuse_light (src/material.h:211-214)."""
    if scene.mat_types_used and sc.MAT_DIFFUSE_LIGHT not in scene.mat_types_used:
        return torch.zeros_like(hit.p)
    mt, color = mat_rows(scene, hit) if pre is None else pre
    is_light = (mt == sc.MAT_DIFFUSE_LIGHT) & hit.front & hit.valid
    return torch.where(is_light[:, None], color, torch.zeros_like(color))


def _sphere_cos_max(origin, center, rad):
    """(center - origin, cos of the cone half-angle the sphere subtends
    from ``origin``); 0 when the origin is inside (the full hemisphere)."""
    dc = center - origin
    dist_sq = torch.clamp(vm.dot(dc, dc), min=1e-20)
    return dc, torch.sqrt(torch.clamp(1.0 - rad * rad / dist_sq, min=0.0))


def light_sample(scene, origin: torch.Tensor, u_pick, u1, u2) -> torch.Tensor:
    """Direction to a uniformly chosen light: a uniform point on a light
    quad (src/quad.h:75-78, src/hittable_list.h:39-50), a solid-angle
    cone sample toward a light sphere (``sampling.cone_dir``) or an
    importance-sampled environment direction (``envlight.sample``)."""
    n_quad = int(scene.lights.shape[0])
    n_sph = scene.n_sphere_lights
    n_env = 1 if scene.has_env_light else 0
    total = n_quad + n_sph + n_env
    lidx = torch.clamp((u_pick * total).to(torch.int32), max=total - 1)
    out = None
    if n_quad:
        qid = tbl.take_rows(scene.lights, torch.clamp(lidx, max=n_quad - 1))
        corner = tbl.take_rows(scene.quads.corner, qid)
        eu = tbl.take_rows(scene.quads.eu, qid)
        ev = tbl.take_rows(scene.quads.ev, qid)
        out = corner + u1[:, None] * eu + u2[:, None] * ev - origin
    if n_sph:
        sid = tbl.take_rows(scene.sphere_lights, torch.clamp(lidx - n_quad, 0, n_sph - 1))
        center = tbl.take_rows(scene.spheres.c0, sid)
        rad = tbl.take_rows(scene.spheres.rad, sid)
        dc, cos_max = _sphere_cos_max(origin, center, rad)
        sph_dir = smp.cone_dir(vm.normalize(dc), cos_max, u1, u2)
        out = sph_dir if out is None else torch.where((lidx >= n_quad)[:, None],
                                                      sph_dir, out)
    if n_env:
        env_dir = envlight.sample(scene, u1, u2)
        out = env_dir if out is None else torch.where(
            (lidx >= n_quad + n_sph)[:, None], env_dir, out)
    return out


def light_pdf(scene, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the light mixture: mean over all lights of the
    per-light pdf. Quads: dist^2 / (|cos| * area) where the ray hits the
    quad (src/quad.h:66-73), in the scalar-triple-product form of
    ``chunked._planar_chunk_ts``; spheres: the cone pdf where the ray hits
    the sphere; the environment: ``envlight.pdf``."""
    n_quad = int(scene.lights.shape[0])
    n_sph = scene.n_sphere_lights
    n_env = 1 if scene.has_env_light else 0
    total = n_quad + n_sph + n_env
    env_term = envlight.pdf(scene, direction) if n_env else 0.0
    if n_quad == 0:
        s = env_term
        if n_sph:
            s = s + _sphere_light_pdf_sum(scene, origin, direction)
        return s / total
    qid = scene.lights
    corner = scene.quads.corner[qid]                    # [L,3]
    eu = scene.quads.eu[qid]
    ev = scene.quads.ev[qid]
    n = vm.cross(eu, ev)
    area = vm.length(n)                                 # [L]
    unorm = vm.normalize(n)
    w = n / torch.clamp(vm.dot(n, n), min=1e-20)[:, None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)

    o_n = vm.outer_dot(origin, unorm)
    d_n = vm.outer_dot(direction, unorm)
    ok0 = torch.abs(d_n) > 1e-20
    t = torch.where(ok0, (vm.dot(unorm, corner)[None, :] - o_n)
                    / torch.where(ok0, d_n, torch.ones_like(d_n)),
                    torch.full_like(d_n, 1e30))
    a = (vm.outer_dot(origin, evw) + t * vm.outer_dot(direction, evw)
         - vm.dot(corner, evw)[None, :])
    b = (vm.outer_dot(origin, weu) + t * vm.outer_dot(direction, weu)
         - vm.dot(corner, weu)[None, :])
    hit_ok = (ok0 & (t >= 1e-3) & (t < 1e29)
              & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))

    t_safe = torch.where(hit_ok, t, torch.ones_like(t))
    dist_sq = t_safe * t_safe * vm.length_sq(direction)[:, None]
    cosine = torch.abs(vm.outer_dot(vm.normalize(direction), unorm))
    pdf = torch.where(hit_ok, _safe_div(dist_sq, cosine * area[None, :], 0.0),
                      torch.zeros_like(t))
    quad_sum = torch.sum(pdf, dim=-1)
    if n_sph:
        quad_sum = quad_sum + _sphere_light_pdf_sum(scene, origin, direction)
    return (quad_sum + env_term) / total


def _sphere_light_pdf_sum(scene, origin: torch.Tensor,
                          direction: torch.Tensor) -> torch.Tensor:
    """Sum over the sphere lights of the cone pdf where the ray hits the
    sphere, at its time-0 center; [R, Ls] intermediates (few lights)."""
    sid = scene.sphere_lights
    center = scene.spheres.c0[sid]                      # [Ls,3]
    rad = scene.spheres.rad[sid]                        # [Ls]
    unit_d = vm.normalize(direction)
    dc = center[None, :, :] - origin[:, None, :]        # [R,Ls,3]
    dist_sq = torch.clamp(torch.sum(dc * dc, dim=-1), min=1e-20)
    proj = torch.sum(unit_d[:, None, :] * dc, dim=-1)
    disc = proj * proj - (dist_sq - (rad * rad)[None, :])
    # a hit when the forward half-line meets the sphere (either root > eps)
    hits = (disc > 0.0) & (proj + torch.sqrt(torch.clamp(disc, min=0.0)) > 1e-3)
    cos_max = torch.sqrt(torch.clamp(1.0 - (rad * rad)[None, :] / dist_sq, min=0.0))
    return torch.sum(torch.where(hits, smp.cone_pdf(cos_max), torch.zeros_like(disc)),
                     dim=-1)


def _score_ratio(p_taken: torch.Tensor) -> torch.Tensor:
    """p / p.detach(): exactly 1.0 forward (IEEE x/x), d log p backward. A
    branch taken at p == 0 (a measure-zero uniform tie) gives no score term
    rather than NaN (``materials.py:256-263`` of the JAX package)."""
    safe = p_taken > 0.0
    den = torch.where(safe, p_taken, torch.ones_like(p_taken)).detach()
    return torch.where(safe, p_taken / den, torch.ones_like(p_taken))


def _sample_lobes(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor,
                  ior_shift=None, pre=None):
    """The kDetermined candidates (metal mirror + fuzz src/material.h:85-92,
    dielectric Schlick reflect/refract src/material.h:113-131, gloss
    probabilistic specular lerp src/material.h:158-173) and the kRandom
    material sample (cosine, or the uniform sphere of an isotropic medium,
    src/material.h:193-201), shared by ``scatter`` and ``scatter_nee``.
    ``ior_shift``: the [R] Cauchy term of each path's hero wavelength, or
    None (the RGB render, which never reads the dispersion table).
    Returns (mt, atten, det_dir, det_weight, is_det, is_iso, is_rand,
    mat_sample, score_w)."""
    mats = scene.materials
    mt, atten = mat_rows(scene, hit) if pre is None else pre
    n = hit.normal
    unit_d = vm.normalize(ray_dir)
    used = scene.mat_types_used or tuple(range(6))

    cos_sample = smp.cosine_dir(n, u[:, SLOT_DIR1], u[:, SLOT_DIR2])
    det_dir = cos_sample
    det_weight = atten
    is_det = torch.zeros(mt.shape, dtype=torch.bool, device=mt.device)
    score_w = torch.ones(mt.shape, dtype=atten.dtype, device=mt.device)

    if sc.MAT_METAL in used:
        m_fuzz = tbl.take_rows(mats.fuzz, hit.mat)
        fuzz_vec = smp.unit_sphere_dir(u[:, SLOT_FUZZ1], u[:, SLOT_FUZZ2])
        metal_dir = (vm.normalize(vm.reflect(ray_dir, n))
                     + m_fuzz[:, None] * fuzz_vec)
        is_metal = mt == sc.MAT_METAL
        det_dir = torch.where(is_metal[:, None], metal_dir, det_dir)
        is_det = is_det | is_metal

    if sc.MAT_DIELECTRIC in used:
        m_ior = tbl.take_rows(mats.ior, hit.mat)
        if ior_shift is not None:
            m_ior = m_ior + tbl.take_rows(mats.dispersion, hit.mat) * ior_shift
        ri = torch.where(hit.front, 1.0 / m_ior, m_ior)
        cos_theta = torch.clamp(vm.dot(-unit_d, n), max=1.0)
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
        cant_refract = ri * sin_theta > 1.0
        refl = smp.schlick_reflectance(cos_theta, ri)
        must_reflect = cant_refract | (refl > u[:, SLOT_DECISION])
        diel_dir = torch.where(must_reflect[:, None], vm.reflect(unit_d, n),
                               vm.refract(unit_d, n, ri))
        is_diel = mt == sc.MAT_DIELECTRIC
        det_dir = torch.where(is_diel[:, None], diel_dir, det_dir)
        is_det = is_det | is_diel
        # Fresnel-probability score term: the reflect-or-refract pick is
        # Bernoulli(R(cos, ri)); cant_refract lanes are forced (prob 1)
        one = torch.ones_like(refl)
        p_diel = torch.where(cant_refract, one,
                             torch.where(must_reflect, refl, 1.0 - refl))
        score_w = torch.where(is_diel, score_w * _score_ratio(p_diel), score_w)

    is_rand = mt == sc.MAT_LAMBERTIAN
    if sc.MAT_GLOSS in used:
        m_smooth = tbl.take_rows(mats.smoothness, hit.mat)
        m_spec = tbl.take_rows(mats.spec_prob, hit.mat)
        spec_raw = vm.reflect(ray_dir, n)  # unnormalized, as in the reference
        gloss_spec_dir = vm.normalize(vm.lerp(m_smooth[:, None], cos_sample,
                                              spec_raw))
        gloss_is_spec = u[:, SLOT_DECISION] <= m_spec
        is_gloss = mt == sc.MAT_GLOSS
        is_gloss_spec = is_gloss & gloss_is_spec
        det_dir = torch.where(is_gloss_spec[:, None], gloss_spec_dir, det_dir)
        det_weight = torch.where(is_gloss_spec[:, None], torch.ones_like(atten),
                                 det_weight)
        is_det = is_det | is_gloss_spec
        p_gloss = torch.where(gloss_is_spec, m_spec, 1.0 - m_spec)
        score_w = torch.where(is_gloss, score_w * _score_ratio(p_gloss), score_w)
        is_rand = is_rand | (is_gloss & ~gloss_is_spec)
    mat_sample = cos_sample
    is_iso = torch.zeros(mt.shape, dtype=torch.bool, device=mt.device)
    if sc.MAT_ISOTROPIC in used:
        is_iso = mt == sc.MAT_ISOTROPIC
        mat_sample = torch.where(is_iso[:, None],
                                 smp.unit_sphere_dir(u[:, SLOT_DIR1], u[:, SLOT_DIR2]),
                                 cos_sample)
        is_rand = is_rand | is_iso
    return (mt, atten, det_dir, det_weight, is_det, is_iso, is_rand, mat_sample,
            score_w)


def _mat_pdf(n, is_iso, d):
    """The material sampler's pdf: 1/(4 pi) on isotropic lanes, cos/pi else."""
    return torch.where(is_iso, smp.sphere_pdf(d), smp.cosine_pdf(n, d))


def _p_scat(n, is_iso, d):
    """p_scattered (src/material.h:69-72, :200): cos/pi, or 1/(4 pi)."""
    return torch.where(is_iso, torch.full_like(d[..., 0], smp.INV_4PI),
                       smp.cosine_pdf(n, d))


def scatter(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor, ior_shift=None,
            pre=None):
    """One scatter decision per lane -> (new_dir [R,3], weight [R,3],
    continues [R] bool). Lanes whose material does not scatter
    (diffuse_light, src/material.h:43) get continues=False. ``ior_shift``:
    see ``_sample_lobes``.

    Where autograd records nothing from the inputs and the scene has no
    environment light (``fused_scatter.takes``), the forward alone is
    computed under the span ``crt.scatter.fused``: by kernel K9 on the
    card, by its plain version ``scatter_plain`` on the CPU. Otherwise
    ``scatter_plain`` runs, whose graph carries the gradients."""
    pre = mat_rows(scene, hit) if pre is None else pre
    if fused_scatter.takes(scene, hit, ray_dir, u, ior_shift, pre[1]):
        with trace.span("crt.scatter.fused"):
            if hit.p.is_cuda:
                return fused_scatter.scatter(scene, hit, ray_dir, u[:, :NSLOT], ior_shift,
                                             *pre)
            return scatter_plain(scene, hit, ray_dir, u, ior_shift, pre)
    return scatter_plain(scene, hit, ray_dir, u, ior_shift, pre)


def scatter_plain(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor, ior_shift=None,
                  pre=None):
    """``scatter`` as eager tensor ops, differentiable: the plain version
    of kernel K9, and the route of every call where ``fused_scatter.takes``
    does not hold (a gradient asked for, an environment light)."""
    with trace.span("crt.scatter.lobes"):
        (mt, atten, det_dir, det_weight, is_det, is_iso, is_rand, mat_sample,
         score_w) = _sample_lobes(scene, hit, ray_dir, u, ior_shift, pre=pre)
    n = hit.normal

    # kRandom lanes: dual-pdf light MIS when a light is registered
    if scene.has_lights:
        with trace.span("crt.scatter.light_sample"):
            ldir = light_sample(scene, hit.p, u[:, SLOT_LIGHT_PICK],
                                u[:, SLOT_LIGHT_U], u[:, SLOT_LIGHT_V])
        pick_light = u[:, SLOT_MIS] < 0.5
        rnd_dir = torch.where(pick_light[:, None], ldir, mat_sample)
        with trace.span("crt.scatter.light_pdf"):
            pl = light_pdf(scene, hit.p, rnd_dir)
        pdf_val = 0.5 * _mat_pdf(n, is_iso, rnd_dir) + 0.5 * pl
    else:
        rnd_dir = mat_sample
        pdf_val = _mat_pdf(n, is_iso, rnd_dir)
    rnd_weight = atten * _safe_div(_p_scat(n, is_iso, rnd_dir), pdf_val, 0.0)[:, None]

    continues = hit.valid & (is_det | is_rand)
    new_dir = torch.where(is_det[:, None], det_dir, rnd_dir)
    # score_w is 1.0 forward; it carries the discrete-decision gradient
    weight = (torch.where(is_det[:, None], det_weight, rnd_weight)
              * score_w[:, None])
    return new_dir, weight, continues


def scatter_nee(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor, ior_shift=None,
                pre=None):
    """Split-sample scatter for next-event estimation (camera.nee,
    ``materials.py:369-438`` of the JAX package): each kRandom lane takes a
    pure material sample for the path and a separate light sample for
    direct lighting, combined with the power heuristic (beta = 2). The slot
    layout is unchanged: SLOT_MIS goes unused and SLOT_LIGHT_* drive the
    shadow ray.

    Returns (new_dir, weight, continues, emis_w_next, nee_dir, nee_w):
    ``emis_w_next`` [R], the MIS weight of emission the continuation meets
    at the next vertex (1 on specular lanes); ``nee_dir`` [R,3], the shadow
    ray's direction; ``nee_w`` [R,3], its factor atten * p_scat * pdf_L /
    (pdf_L^2 + pdf_B^2), zero on specular or invalid lanes. The caller
    traces ``nee_dir`` and multiplies by the radiance it finds."""
    with trace.span("crt.scatter.lobes"):
        (mt, atten, det_dir, det_weight, is_det, is_iso, is_rand, rnd_dir,
         score_w) = _sample_lobes(scene, hit, ray_dir, u, ior_shift, pre=pre)
    n = hit.normal
    pdf_b = _mat_pdf(n, is_iso, rnd_dir)
    rnd_weight = atten * _safe_div(_p_scat(n, is_iso, rnd_dir), pdf_b, 0.0)[:, None]

    emis_w_next = torch.ones(mt.shape, dtype=torch.float32, device=mt.device)
    nee_dir = rnd_dir
    nee_w = torch.zeros_like(atten)
    if scene.has_lights:
        # w_B = pdf_B^2 / (pdf_B^2 + pdf_L^2) for the continuation's emission
        with trace.span("crt.scatter.light_pdf"):
            pl_b = light_pdf(scene, hit.p, rnd_dir)
        w_b = _safe_div(pdf_b * pdf_b, pdf_b * pdf_b + pl_b * pl_b, 1.0)
        live = is_rand & hit.valid
        emis_w_next = torch.where(live, w_b, torch.ones_like(w_b))
        # the direct-lighting shadow sample; f/pdf_L * w_L collapses to
        # p_scat * pl / (pl^2 + pb^2)
        with trace.span("crt.scatter.light_sample"):
            ldir = light_sample(scene, hit.p, u[:, SLOT_LIGHT_PICK],
                                u[:, SLOT_LIGHT_U], u[:, SLOT_LIGHT_V])
        with trace.span("crt.scatter.light_pdf"):
            pl = light_pdf(scene, hit.p, ldir)
        pb_l = _mat_pdf(n, is_iso, ldir)
        factor = _safe_div(_p_scat(n, is_iso, ldir) * pl, pl * pl + pb_l * pb_l, 0.0)
        nee_dir = ldir
        nee_w = torch.where(live[:, None], atten * factor[:, None],
                            torch.zeros_like(atten))

    continues = hit.valid & (is_det | is_rand)
    new_dir = torch.where(is_det[:, None], det_dir, rnd_dir)
    # score_w is 1.0 forward; the shadow contribution is conditioned on the
    # same discrete lobe pick, so it carries the score too
    weight = (torch.where(is_det[:, None], det_weight, rnd_weight)
              * score_w[:, None])
    return new_dir, weight, continues, emis_w_next, nee_dir, nee_w * score_w[:, None]
