"""Material scatter/emission as masked-lane batch functions.

Port of ``cpu_ray_tracing_implementation_tpu/ops/materials.py`` for the
lambertian, metal, dielectric, gloss and diffuse-light families with quad
lights (src/material.h:36-219, src/pdf.h:48-61). Every lane evaluates every
family the scene contains and selects by type id.

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
Isotropic media are ROADMAP M5.
"""

from __future__ import annotations

import torch

from cpu_ray_tracing_implementation_tpu_torch.models import scene as sc
from cpu_ray_tracing_implementation_tpu_torch.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu_torch.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.ops.textures import eval_texture

NSLOT = 9

SLOT_DECISION = 0
SLOT_DIR1, SLOT_DIR2 = 1, 2
SLOT_MIS = 3
SLOT_LIGHT_U, SLOT_LIGHT_V = 4, 5
SLOT_FUZZ1, SLOT_FUZZ2 = 6, 7
SLOT_LIGHT_PICK = 8
SLOT_VOLUME0 = 9

_NOT_PORTED = {
    sc.MAT_ISOTROPIC: "isotropic materials (ROADMAP M5)",
}


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


def light_sample(scene, origin: torch.Tensor, u_pick, u1, u2) -> torch.Tensor:
    """Direction to a uniform point on a uniformly chosen light quad
    (src/quad.h:75-78, src/hittable_list.h:39-50)."""
    n_quad = int(scene.lights.shape[0])
    lidx = torch.clamp((u_pick * n_quad).to(torch.int32), max=n_quad - 1)
    qid = tbl.take_rows(scene.lights, lidx)
    corner = tbl.take_rows(scene.quads.corner, qid)
    eu = tbl.take_rows(scene.quads.eu, qid)
    ev = tbl.take_rows(scene.quads.ev, qid)
    p = corner + u1[:, None] * eu + u2[:, None] * ev
    return p - origin


def light_pdf(scene, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the light mixture: mean over the light quads of
    dist^2 / (|cos| * area) where the ray hits the quad (src/quad.h:66-73).
    Same scalar-triple-product form as ``chunked._planar_chunk_ts``."""
    n_quad = int(scene.lights.shape[0])
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
    return torch.sum(pdf, dim=-1) / n_quad


def _score_ratio(p_taken: torch.Tensor) -> torch.Tensor:
    """p / p.detach(): exactly 1.0 forward (IEEE x/x), d log p backward. A
    branch taken at p == 0 (a measure-zero uniform tie) gives no score term
    rather than NaN (``materials.py:256-263`` of the JAX package)."""
    safe = p_taken > 0.0
    den = torch.where(safe, p_taken, torch.ones_like(p_taken)).detach()
    return torch.where(safe, p_taken / den, torch.ones_like(p_taken))


def _sample_lobes(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor, pre=None):
    """The kDetermined candidates (metal mirror + fuzz src/material.h:85-92,
    dielectric Schlick reflect/refract src/material.h:113-131, gloss
    probabilistic specular lerp src/material.h:158-173) and the kRandom
    cosine sample. Returns (mt, atten, det_dir, det_weight, is_det, is_rand,
    mat_sample, score_w)."""
    mats = scene.materials
    mt, atten = mat_rows(scene, hit) if pre is None else pre
    n = hit.normal
    unit_d = vm.normalize(ray_dir)
    used = scene.mat_types_used or tuple(range(6))
    for fam in used:
        if fam in _NOT_PORTED:
            raise NotImplementedError(f"{_NOT_PORTED[fam]} are not ported yet")

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
    return mt, atten, det_dir, det_weight, is_det, is_rand, cos_sample, score_w


def scatter(scene, hit, ray_dir: torch.Tensor, u: torch.Tensor, pre=None):
    """One scatter decision per lane -> (new_dir [R,3], weight [R,3],
    continues [R] bool). Lanes whose material does not scatter
    (diffuse_light, src/material.h:43) get continues=False."""
    (mt, atten, det_dir, det_weight, is_det, is_rand, mat_sample,
     score_w) = _sample_lobes(scene, hit, ray_dir, u, pre=pre)
    n = hit.normal

    # kRandom lanes: dual-pdf light MIS when a light is registered
    if scene.has_lights:
        ldir = light_sample(scene, hit.p, u[:, SLOT_LIGHT_PICK],
                            u[:, SLOT_LIGHT_U], u[:, SLOT_LIGHT_V])
        pick_light = u[:, SLOT_MIS] < 0.5
        rnd_dir = torch.where(pick_light[:, None], ldir, mat_sample)
        pdf_val = (0.5 * smp.cosine_pdf(n, rnd_dir)
                   + 0.5 * light_pdf(scene, hit.p, rnd_dir))
    else:
        rnd_dir = mat_sample
        pdf_val = smp.cosine_pdf(n, rnd_dir)

    # p_scattered (src/material.h:69-72): cos/pi
    p_scat = smp.cosine_pdf(n, rnd_dir)
    rnd_weight = atten * _safe_div(p_scat, pdf_val, 0.0)[:, None]

    continues = hit.valid & (is_det | is_rand)
    new_dir = torch.where(is_det[:, None], det_dir, rnd_dir)
    # score_w is 1.0 forward; it carries the discrete-decision gradient
    weight = (torch.where(is_det[:, None], det_weight, rnd_weight)
              * score_w[:, None])
    return new_dir, weight, continues
