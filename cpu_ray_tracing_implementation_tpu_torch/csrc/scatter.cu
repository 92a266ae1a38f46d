// The forward of one bounce's scatter decision for Hopper (sm_90a): K9.
//
// Replaces no TPU kernel: the JAX package leaves ops/materials.py scatter to
// XLA, which fuses its elementwise graph into a few loops. The port's eager
// version (ops/materials.py scatter_plain, the plain version) launches ~200
// kernels a bounce on the Cornell box: the lobes, the light sample, the
// light pdf (each light's normal, area, plane and edge vectors rebuilt every
// bounce, then [R, L] temporaries) and the MIS weight, each a tensor op of a
// few microseconds of host time over a few of device time. K9 computes the
// same function in one launch with no intermediate in device memory.
//
// Function (materials.scatter's one-sample 50/50 mixture estimator, not
// scatter_nee; quad and sphere lights, no environment light). A thread a
// ray. It reads the ray's hit (p, normal, front, valid, mat), its direction,
// its uniform row u (slots as ops/materials.py numbers them), the material
// type and albedo mat_rows gave (mt, atten: textures stay out of the
// kernel), its material row (fuzz, ior, dispersion, smoothness, spec_prob)
// and, under dispersion, its ior_shift. It writes new_dir [R,3], weight
// [R,3] and continues [R] (u8 0/1) with scatter_plain's meanings: every
// family of _sample_lobes (lambertian, metal, dielectric with the Cauchy
// shift, gloss, isotropic, diffuse light) and both cosine samplers
// (CRT_COSINE, passed in as cosine_onb). score_w, exactly 1.0 in the
// forward, is left out.
//
// Lights. Each block derives every quad light's constants once (corner,
// edges, unit normal, area, w-based edge vectors evw and weu, the plane
// offsets) and every sphere light's center and radius into shared memory;
// the light pdf then sums over them per ray, in light order, with no
// [R, L] tensor.
//
// Rounding. The plain version's tensor ops round on the card as follows
// (measured on an H100 against numpy: each matched 2^20 random cases out of
// 2^20), and K9 rounds the same: every elementwise product, sum and
// difference on its own (__fmul_rn, __fadd_rn, __fsub_rn: never contracted
// into an FMA), in the order of the ops; torch.sum over an axis of 3 as
// (x + z) + y; torch.linalg.cross's a_i b_j - a_j b_i as one FMA,
// fma(a_i, b_j, -(a_j b_i)); a division by a Python scalar as a product
// with its float reciprocal; IEEE division and sqrtf, and the libdevice
// powf, cosf and sinf PyTorch's ops call. One order K9 cannot follow: a
// torch.sum over the rows of a transposed [R,3] tensor (K1's normals, and
// what elementwise ops inherit of their layout) adds x + y first. On an
// H100 94-100% of the lanes of the card tests' scenes equal the plain
// version bit for bit and the rest differ by a few ulp; only a decision
// taken on a rounded value (light_pdf's edge test above all) can make a
// lane differ by more.
//
// Bound. A ray reads 12 B each of p, normal, direction and albedo, 1 B
// each of front and valid, 4 B each of mat and mt, the 9 uniform slots it
// uses (36 B) and, under dispersion, 4 B of ior_shift, and writes 25 B:
// 119 B a ray in an RGB render (the material rows and the lights, a few
// hundred bytes, are read once), 42.8 MB at the scan's 360,000 rays,
// 12.8 us at 3.35 TB/s. Its arithmetic, ~300 FP32 instructions a ray on
// the Cornell box with cosf, sinf and powf counted as ~20 each, is ~3 us at
// 33.5e12 per s; the bytes would bound it at up to ~1,000 a ray. The design
// moves each byte once: a thread a ray, no intermediate written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr double PI_D = 3.14159265358979323846;
// Python floats as PyTorch hands them to a float32 op
constexpr float TWO_PI = static_cast<float>(2.0 * PI_D);
constexpr float PI_F = static_cast<float>(PI_D);
constexpr float INV_4PI = static_cast<float>(1.0 / (4.0 * PI_D));
// materials.py / scene.py constants
constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_GLOSS = 3,
              MAT_ISOTROPIC = 4;
constexpr int SLOT_DECISION = 0, SLOT_DIR1 = 1, SLOT_DIR2 = 2, SLOT_MIS = 3,
              SLOT_LIGHT_U = 4, SLOT_LIGHT_V = 5, SLOT_FUZZ1 = 6, SLOT_FUZZ2 = 7,
              SLOT_LIGHT_PICK = 8;
// shared floats a quad light takes: corner, eu, ev, unorm, evw, weu (18),
// area, d_plane, c_a, c_b
constexpr int QF = 22;
constexpr int SF = 4;  // a sphere light: center, radius

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp's: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// an [R,3] input's element strides: rows of 3 (the CPU's layout) or the
// columns of a transposed [3,R] block (K1's hit rows, and what PyTorch's
// elementwise ops keep of that layout on the card)
struct Strides {
  int row, col;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int r, Strides s) {
  const float* x = a + (size_t)r * s.row;
  return {x[0], x[s.col], x[2 * s.col]};
}
__device__ __forceinline__ V3 load3(const float* __restrict__ a, int r) {
  return load3(a, r, {3, 1});
}
__device__ __forceinline__ void store3(float* __restrict__ a, int r, V3 v) {
  a[3 * r] = v.x;
  a[3 * r + 1] = v.y;
  a[3 * r + 2] = v.z;
}
__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 scale3(float s, V3 a) { return {mul(s, a.x), mul(s, a.y), mul(s, a.z)}; }
__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }
// vm.dot (torch.sum over the last axis): on the card two threads reduce a
// row of 3, the first x + z, and the shuffle adds y
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.z, b.z)), mul(a.y, b.y));
}
// vm.outer_dot: three elementwise products summed left to right
__device__ __forceinline__ float outer3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
// torch.linalg.cross on the card: a_i b_j - a_j b_i as fma(a_i, b_j, -(a_j b_i))
__device__ __forceinline__ float cross1(float ai, float bj, float aj, float bi) {
  return __fmaf_rn(ai, bj, -mul(aj, bi));
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {cross1(a.y, b.z, a.z, b.y), cross1(a.z, b.x, a.x, b.z), cross1(a.x, b.y, a.y, b.x)};
}
// vm.normalize: a / sqrt(|a|^2 + 1e-12)
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float s = sqrtf(add(dot3(a, a), 1e-12f));
  return {a.x / s, a.y / s, a.z / s};
}
// vm.reflect: v - 2 (v.n) n
__device__ __forceinline__ V3 reflect3(V3 v, V3 n) {
  return sub3(v, scale3(mul(dot3(v, n), 2.0f), n));
}
// vm.refract (|.| under the root, floored at 1e-12)
__device__ __forceinline__ V3 refract3(V3 v, V3 n, float eta) {
  const float c = clamp_max(dot3(neg3(v), n), 1.0f);
  const V3 perp = scale3(eta, add3(v, scale3(c, n)));
  const float k = clamp_min(fabsf(sub(1.0f, dot3(perp, perp))), 1e-12f);
  return sub3(perp, scale3(sqrtf(k), n));
}
// vm.onb_from_normal: y = unit(n), z = unit(y x a), x = y x z
__device__ __forceinline__ void onb3(V3 n, V3& x, V3& y, V3& z) {
  y = normalize3(n);
  const V3 a = fabsf(y.x) > 0.9f ? V3{0.f, 0.f, 1.f} : V3{1.f, 0.f, 0.f};
  z = normalize3(cross3(y, a));
  x = cross3(y, z);
}
// vm.onb_transform: l0 x + l1 y + l2 z
__device__ __forceinline__ V3 onb_apply(V3 l, V3 x, V3 y, V3 z) {
  return add3(add3(scale3(l.x, x), scale3(l.y, y)), scale3(l.z, z));
}
// sampling.unit_sphere_dir
__device__ __forceinline__ V3 unit_sphere_dir(float u1, float u2) {
  const float c = sub(1.0f, mul(u1, 2.0f));
  const float s = sqrtf(clamp_min(sub(1.0f, mul(c, c)), 0.0f));
  const float phi = mul(u2, TWO_PI);
  return {mul(s, cosf(phi)), c, mul(s, sinf(phi))};
}
// sampling.cosine_dir, both constructions
__device__ __forceinline__ V3 cosine_dir(V3 n, float u1, float u2, bool onb) {
  if (onb) {
    V3 x, y, z;
    onb3(n, x, y, z);
    const float phi = mul(u1, TWO_PI);
    const float sq = sqrtf(u2);
    const V3 l = {mul(cosf(phi), sq), sqrtf(clamp_min(sub(1.0f, u2), 0.0f)),
                  mul(sinf(phi), sq)};
    return onb_apply(l, x, y, z);
  }
  const V3 d = add3(n, unit_sphere_dir(u1, u2));
  return normalize3(dot3(d, d) < 1e-12f ? n : d);
}
// sampling.cosine_pdf: max(0, cos / pi), the division PyTorch's multiply
// by the reciprocal of the Python scalar
__device__ __forceinline__ float cosine_pdf(V3 n, V3 d) {
  return clamp_min(mul(dot3(normalize3(d), n), 1.0f / PI_F), 0.0f);
}
// materials._safe_div
__device__ __forceinline__ float safe_div(float num, float den) {
  return fabsf(den) > 1e-20f ? num / den : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
scatter_mixture_kernel(const float* __restrict__ p, Strides p_s,
                       const float* __restrict__ normal, Strides n_s,
                       const uint8_t* __restrict__ front, const uint8_t* __restrict__ valid,
                       const int* __restrict__ mat, const float* __restrict__ ray_dir,
                       Strides d_s, const float* __restrict__ u, Strides u_s,
                       const int* __restrict__ mt, const float* __restrict__ atten,
                       Strides a_s, const float* __restrict__ ior_shift,
                       const float* __restrict__ m_fuzz, const float* __restrict__ m_ior,
                       const float* __restrict__ m_disp, const float* __restrict__ m_smooth,
                       const float* __restrict__ m_spec, const int* __restrict__ lights,
                       int n_quad, const float* __restrict__ q_corner,
                       const float* __restrict__ q_eu, const float* __restrict__ q_ev,
                       const int* __restrict__ sphere_lights, int n_sph,
                       const float* __restrict__ s_c0, const float* __restrict__ s_rad,
                       int cosine_onb, int R, float* __restrict__ new_dir,
                       float* __restrict__ weight, uint8_t* __restrict__ continues) {
  extern __shared__ float lsh[];  // n_quad * QF, then n_sph * SF
  float* sph = lsh + n_quad * QF;
  for (int l = threadIdx.x; l < n_quad; l += blockDim.x) {
    // light_pdf's per-light constants, as its [L] tensor ops round them
    const int q = lights[l];
    const V3 c = load3(q_corner, q), eu = load3(q_eu, q), ev = load3(q_ev, q);
    const V3 n = cross3(eu, ev);
    const float nn = dot3(n, n);
    const V3 un = normalize3(n);
    const float inv = clamp_min(nn, 1e-20f);
    const V3 w = {n.x / inv, n.y / inv, n.z / inv};
    const V3 evw = cross3(ev, w), weu = cross3(w, eu);
    float* s = lsh + l * QF;
    const float vals[QF] = {c.x,   c.y,   c.z,   eu.x,  eu.y,       eu.z,          ev.x,
                            ev.y,  ev.z,  un.x,  un.y,  un.z,       evw.x,         evw.y,
                            evw.z, weu.x, weu.y, weu.z, sqrtf(nn),  dot3(un, c),   dot3(c, evw),
                            dot3(c, weu)};
#pragma unroll
    for (int i = 0; i < QF; ++i) s[i] = vals[i];
  }
  for (int l = threadIdx.x; l < n_sph; l += blockDim.x) {
    const int i = sphere_lights[l];
    sph[l * SF] = s_c0[3 * i];
    sph[l * SF + 1] = s_c0[3 * i + 1];
    sph[l * SF + 2] = s_c0[3 * i + 2];
    sph[l * SF + 3] = s_rad[i];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ur = u + (size_t)r * u_s.row;
  const auto slot = [&](int i) { return ur[i * u_s.col]; };
  const int m = mat[r];
  const int kind = mt[r];
  const V3 n = load3(normal, r, n_s), d = load3(ray_dir, r, d_s), alb = load3(atten, r, a_s);
  const V3 unit_d = normalize3(d);
  const float u0 = slot(SLOT_DECISION), u1 = slot(SLOT_DIR1), u2 = slot(SLOT_DIR2);

  // _sample_lobes: the kDetermined candidate and the kRandom material sample
  const V3 cos_sample = cosine_dir(n, u1, u2, cosine_onb != 0);
  V3 det_dir = cos_sample, det_w = alb;
  bool is_det = false, is_rand = kind == MAT_LAMBERTIAN;
  const bool is_iso = kind == MAT_ISOTROPIC;
  if (kind == MAT_METAL) {
    const V3 fv = unit_sphere_dir(slot(SLOT_FUZZ1), slot(SLOT_FUZZ2));
    det_dir = add3(normalize3(reflect3(d, n)), scale3(m_fuzz[m], fv));
    is_det = true;
  } else if (kind == MAT_DIELECTRIC) {
    float ior = m_ior[m];
    if (ior_shift) ior = add(ior, mul(m_disp[m], ior_shift[r]));
    const float ri = front[r] ? 1.0f / ior : ior;
    const float c = clamp_max(dot3(neg3(unit_d), n), 1.0f);
    const float s = sqrtf(clamp_min(sub(1.0f, mul(c, c)), 0.0f));
    const bool cant_refract = mul(ri, s) > 1.0f;
    float r0 = sub(1.0f, ri) / add(1.0f, ri);
    r0 = mul(r0, r0);
    const float refl = add(r0, mul(sub(1.0f, r0), powf(sub(1.0f, c), 5.0f)));
    const bool must_reflect = cant_refract || refl > u0;
    det_dir = must_reflect ? reflect3(unit_d, n) : refract3(unit_d, n, ri);
    is_det = true;
  } else if (kind == MAT_GLOSS) {
    const float t = m_smooth[m], spec = m_spec[m];
    if (u0 <= spec) {
      // lerp(smoothness, cosine sample, the unnormalized mirror direction)
      const V3 raw = reflect3(d, n);
      det_dir = normalize3(add3(scale3(sub(1.0f, t), cos_sample), scale3(t, raw)));
      det_w = {1.0f, 1.0f, 1.0f};
      is_det = true;
    } else {
      is_rand = true;
    }
  }
  is_rand = is_rand || is_iso;
  const V3 mat_sample = is_iso ? unit_sphere_dir(u1, u2) : cos_sample;

  // the random lobe: the 50/50 mixture of the material and light pdfs
  const int total = n_quad + n_sph;
  V3 rnd_dir = mat_sample;
  float pl = 0.0f;  // light_pdf(p, rnd_dir)
  if (total > 0) {
    const V3 o = load3(p, r, p_s);
    const bool pick_light = slot(SLOT_MIS) < 0.5f;
    if (pick_light) {
      // light_sample: a uniform light, then a point on its quad or a
      // direction in its sphere's cone
      const float lu = slot(SLOT_LIGHT_U), lv = slot(SLOT_LIGHT_V);
      const int lidx =
          min(static_cast<int>(mul(slot(SLOT_LIGHT_PICK), static_cast<float>(total))), total - 1);
      if (lidx < n_quad) {
        const float* s = lsh + lidx * QF;
        rnd_dir = sub3(add3(add3(V3{s[0], s[1], s[2]}, scale3(lu, V3{s[3], s[4], s[5]})),
                            scale3(lv, V3{s[6], s[7], s[8]})),
                       o);
      } else {
        const float* s = sph + (lidx - n_quad) * SF;
        const float rad = s[3];
        const V3 dc = sub3(V3{s[0], s[1], s[2]}, o);
        const float dist_sq = clamp_min(dot3(dc, dc), 1e-20f);
        const float cos_max = sqrtf(clamp_min(sub(1.0f, mul(rad, rad) / dist_sq), 0.0f));
        const float z = add(1.0f, mul(lv, sub(cos_max, 1.0f)));
        const float phi = mul(lu, TWO_PI);
        const float sz = sqrtf(clamp_min(sub(1.0f, mul(z, z)), 0.0f));
        V3 x, y, zb;
        onb3(normalize3(dc), x, y, zb);
        rnd_dir = onb_apply({mul(cosf(phi), sz), z, mul(sinf(phi), sz)}, x, y, zb);
      }
    }
    // light_pdf: the mean over every light of its solid-angle pdf
    const V3 ud = normalize3(rnd_dir);
    const float len_sq = dot3(rnd_dir, rnd_dir);
    float sum = 0.0f;
    for (int l = 0; l < n_quad; ++l) {
      const float* s = lsh + l * QF;
      const V3 un = {s[9], s[10], s[11]}, evw = {s[12], s[13], s[14]},
               weu = {s[15], s[16], s[17]};
      const float area = s[18], d_plane = s[19], c_a = s[20], c_b = s[21];
      const float o_n = outer3(o, un), d_n = outer3(rnd_dir, un);
      const bool ok0 = fabsf(d_n) > 1e-20f;
      const float t = ok0 ? sub(d_plane, o_n) / d_n : 1e30f;
      const float a = sub(add(outer3(o, evw), mul(t, outer3(rnd_dir, evw))), c_a);
      const float b = sub(add(outer3(o, weu), mul(t, outer3(rnd_dir, weu))), c_b);
      const bool hit = ok0 && t >= 1e-3f && t < 1e29f && a >= 0.0f && a <= 1.0f && b >= 0.0f &&
                       b <= 1.0f;
      if (hit) {
        const float dist_sq = mul(mul(t, t), len_sq);
        const float cosine = fabsf(outer3(ud, un));
        sum = add(sum, safe_div(dist_sq, mul(cosine, area)));
      } else {
        sum = add(sum, 0.0f);
      }
    }
    float sph_sum = 0.0f;
    for (int l = 0; l < n_sph; ++l) {
      const float* s = sph + l * SF;
      const float rad = s[3], rad2 = mul(rad, rad);
      const V3 dc = sub3(V3{s[0], s[1], s[2]}, o);
      const float dist_sq = clamp_min(dot3(dc, dc), 1e-20f);
      const float proj = dot3(ud, dc);
      const float disc = sub(mul(proj, proj), sub(dist_sq, rad2));
      const bool hits = disc > 0.0f && add(proj, sqrtf(clamp_min(disc, 0.0f))) > 1e-3f;
      const float cos_max = sqrtf(clamp_min(sub(1.0f, rad2 / dist_sq), 0.0f));
      const float pdf = 1.0f / mul(clamp_min(sub(1.0f, cos_max), 1e-8f), TWO_PI);
      sph_sum = add(sph_sum, hits ? pdf : 0.0f);
    }
    if (n_sph) sum = n_quad ? add(sum, sph_sum) : sph_sum;
    pl = mul(add(sum, 0.0f), 1.0f / static_cast<float>(total));
  }
  // p_scattered, and the material sampler's pdf of the same direction
  const float p_scat = is_iso ? INV_4PI : cosine_pdf(n, rnd_dir);
  const float pdf_val = total > 0 ? add(mul(0.5f, p_scat), mul(0.5f, pl)) : p_scat;
  const V3 rnd_w = scale3(safe_div(p_scat, pdf_val), alb);

  continues[r] = valid[r] && (is_det || is_rand);
  store3(new_dir, r, is_det ? det_dir : rnd_dir);
  store3(weight, r, is_det ? det_w : rnd_w);
}

}  // namespace

// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue when the lights do not fit in a
// block's 48 KB of static shared memory; nothing synchronises. ior_shift
// may be null (the RGB render). front, valid and continues are torch.bool
// (one byte, 0 or 1). p, normal, ray_dir, u and atten come with their row
// and column strides (elements); every other input is contiguous.
extern "C" int crt_scatter(const float* p, int p_row, int p_col, const float* normal,
                           int n_row, int n_col, const uint8_t* front, const uint8_t* valid,
                           const int* mat, const float* ray_dir, int d_row, int d_col,
                           const float* u, int u_row, int u_col, const int* mt,
                           const float* atten,
                           int a_row, int a_col, const float* ior_shift, const float* m_fuzz,
                           const float* m_ior,
                           const float* m_disp, const float* m_smooth, const float* m_spec,
                           const int* lights, int n_quad, const float* q_corner,
                           const float* q_eu, const float* q_ev, const int* sphere_lights,
                           int n_sph, const float* s_c0, const float* s_rad, int cosine_onb,
                           int R, float* new_dir, float* weight, uint8_t* continues,
                           void* stream) {
  if (R <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)n_quad * QF + (size_t)n_sph * SF);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + THREADS - 1) / THREADS);
  scatter_mixture_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, {p_row, p_col}, normal, {n_row, n_col}, front, valid, mat, ray_dir, {d_row, d_col}, u,
      {u_row, u_col}, mt, atten, {a_row, a_col}, ior_shift, m_fuzz, m_ior,
      m_disp, m_smooth, m_spec, lights, n_quad, q_corner, q_eu, q_ev, sphere_lights, n_sph,
      s_c0, s_rad, cosine_onb, R, new_dir, weight, continues);
  return static_cast<int>(cudaGetLastError());
}
