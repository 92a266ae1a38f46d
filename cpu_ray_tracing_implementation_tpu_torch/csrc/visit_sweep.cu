// Per-ray visit-list sweep for Hopper (sm_90a): kernel K4.
//
// Replaces cpu_ray_tracing_implementation_tpu/ops/pallas_sweep.py:_kernel
// (pallas_sweep.py:94-239). Plain version: ops/fused_sweep.py sweep_plain;
// wrapper: ops/fused_sweep.py sweep.
//
// Layouts are the Pallas kernel's: rays [R,8] f32 (org xyz, dir xyz, time,
// pad), ids [R,V] int32 (clipped to [0, K-1] here), nears [R,V] f32, best
// [R,8] f32, table [K,F,C] f32 with C = 128 (planar F = 9: corner, eu, ev;
// sphere F = 7: c0, c1, rad) -> out [R,8] f32. Best columns: planar t, unit
// normal xyz, u, v, mat, pid; sphere t, center xyz at ray time, rad, v
// (untouched), mat, pid. mat passes through; pid = id*C + lane in f32.
//
// What it computes, per ray and slot s in order: the slot's chunk row is
// intersected (the planar test of _planar_slot, quads or triangles, or the
// sphere test of _sphere_slot), each candidate within [tmin, t_best]; the
// first-index minimum (t_c, idx) replaces the best when t_c < t_best and
// the slot's entry near < t_best.
//
// Design. One warp per ray. The Pallas kernel DMAs each ray's row into VMEM,
// double-buffered; here lane l owns primitives 4l..4l+3 of the row, so each
// of the F component rows is one coalesced 512 B load (a float4 per lane).
// The test near < t_best is uniform across the warp: a slot that fails it
// reads and computes nothing (the Pallas kernel read the row and skipped
// the compute; results are the same). Each lane keeps its own first-index
// minimum over its 4 primitives with that primitive's attributes; a
// butterfly of warp shuffles on (t, idx) in lexicographic order gives every
// lane the row's first-index minimum, and the winning lane's attributes are
// broadcast from it. The best hit lives in registers across the V slots.
//
// Rounding. The colonnade spans +-1,200 units and recentering starts only
// at 2,000, so the edge coefficients a = q.(ev x w) with q = o + t d - c,
// and the sphere's |o - c|^2, cancel. Every multiply and add is written
// with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into a
// multiply-add, in the plain version's left-to-right order; divisions and
// sqrtf are IEEE, and 1/|n| is rsqrtf, which torch.rsqrt runs on the card.
// So kernel and plain version round alike and give the same hit masks.
//
// Bound. Per visited (ray, slot): a 128-primitive row, F*512 B (4.6 KB
// planar), of which the colonnade's 9.3 MB table fits the 50 MB L2, and
// ~130 FP32 instructions per planar primitive test (~50 per sphere; an FMA
// counts once). The instructions bound it: at V = 16 the colonnade's
// 40,000 primary rays visit 449,504 (ray, slot) pairs, 7.5 G instructions,
// 0.2233 ms at 33.5e12 FP32 instructions per s (the data sheet's 67
// TFLOP/s, which count an FMA as two operations); the bytes each input
// needs once (the rows visited, rays, lists, best) are far less.
// chip_smoke.py computes the bound from the visits of its run.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int C = 128;
constexpr int WARPS = 4;  // rays per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}
// torch.clamp: a NaN operand stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clip_big(float x) {
  return x != x ? x : fminf(fmaxf(x, -BIG), BIG);
}
__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

// one planar primitive: its candidate t (inf = miss) and attributes
template <bool TRIANGLE>
__device__ __forceinline__ float planar_test(const Ray& q, float cx, float cy,
                                             float cz, float eux, float euy,
                                             float euz, float evx, float evy,
                                             float evz, float tmin,
                                             float t_best, float (&att)[5]) {
  const float nx = sub(mul(euy, evz), mul(euz, evy));
  const float ny = sub(mul(euz, evx), mul(eux, evz));
  const float nz = sub(mul(eux, evy), mul(euy, evx));
  const float nn = add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz));
  const float inv_len = rsqrtf(clamp_min(nn, 1e-30f));
  const float unx = mul(nx, inv_len), uny = mul(ny, inv_len),
              unz = mul(nz, inv_len);
  const float d_plane = dot3(unx, uny, unz, cx, cy, cz);
  const float inv_nn = 1.0f / clamp_min(nn, 1e-20f);
  const float wx = mul(nx, inv_nn), wy = mul(ny, inv_nn), wz = mul(nz, inv_nn);
  const float ewx = sub(mul(evy, wz), mul(evz, wy));   // ev x w
  const float ewy = sub(mul(evz, wx), mul(evx, wz));
  const float ewz = sub(mul(evx, wy), mul(evy, wx));
  const float wex = sub(mul(wy, euz), mul(wz, euy));   // w x eu
  const float wey = sub(mul(wz, eux), mul(wx, euz));
  const float wez = sub(mul(wx, euy), mul(wy, eux));

  const float o_n = dot3(unx, uny, unz, q.ox, q.oy, q.oz);
  const float d_n = dot3(unx, uny, unz, q.dx, q.dy, q.dz);
  const bool ok0 = fabsf(d_n) > 1e-20f;
  const float t = ok0 ? sub(d_plane, o_n) / d_n : BIG;
  const float a = clip_big(sub(
      add(dot3(ewx, ewy, ewz, q.ox, q.oy, q.oz),
          mul(t, dot3(ewx, ewy, ewz, q.dx, q.dy, q.dz))),
      dot3(ewx, ewy, ewz, cx, cy, cz)));
  const float b = clip_big(sub(
      add(dot3(wex, wey, wez, q.ox, q.oy, q.oz),
          mul(t, dot3(wex, wey, wez, q.dx, q.dy, q.dz))),
      dot3(wex, wey, wez, cx, cy, cz)));
  const bool interior = TRIANGLE
      ? (a >= 0.f && b >= 0.f && add(a, b) <= 1.f)
      : (a >= 0.f && a <= 1.f && b >= 0.f && b <= 1.f);
  att[0] = unx; att[1] = uny; att[2] = unz; att[3] = a; att[4] = b;
  return (ok0 && t >= tmin && t <= t_best && interior) ? t : inf();
}

// one moving sphere: its candidate t (inf = miss) and attributes
__device__ __forceinline__ float sphere_test(const Ray& q, float a_q,
                                             float c0x, float c0y, float c0z,
                                             float c1x, float c1y, float c1z,
                                             float rad, float tmin,
                                             float t_best, float (&att)[5]) {
  const float ctx = add(c0x, mul(q.tm, sub(c1x, c0x)));
  const float cty = add(c0y, mul(q.tm, sub(c1y, c0y)));
  const float ctz = add(c0z, mul(q.tm, sub(c1z, c0z)));
  const float ocx = sub(q.ox, ctx), ocy = sub(q.oy, cty), ocz = sub(q.oz, ctz);
  const float b_q = mul(2.f, dot3(q.dx, q.dy, q.dz, ocx, ocy, ocz));
  const float c_q = sub(dot3(ocx, ocy, ocz, ocx, ocy, ocz), mul(rad, rad));
  const float disc = sub(mul(b_q, b_q), mul(mul(4.f, a_q), c_q));
  const bool has = disc > 0.f;
  const float sq = sqrtf(has ? disc : 1.f);
  const float two_a = mul(2.f, a_q);
  const float t0 = sub(-b_q, sq) / two_a;
  const float t1 = add(-b_q, sq) / two_a;
  const bool in0 = t0 >= tmin && t0 <= t_best;
  const bool in1 = t1 >= tmin && t1 <= t_best;
  att[0] = ctx; att[1] = cty; att[2] = ctz; att[3] = rad; att[4] = 0.f;
  return has ? (in0 ? t0 : (in1 ? t1 : inf())) : inf();
}

template <bool SPHERE, bool TRIANGLE>
__global__ void __launch_bounds__(WARPS * 32)
visit_sweep_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
                   const float* __restrict__ nears,
                   const float* __restrict__ best,
                   const float* __restrict__ table, int R, int V, int K,
                   float tmin, float* __restrict__ out) {
  constexpr int F = SPHERE ? 7 : 9;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp

  const float4 ra = reinterpret_cast<const float4*>(rays)[2 * r];
  const float4 rb = reinterpret_cast<const float4*>(rays)[2 * r + 1];
  const Ray q{ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z};
  const float a_q = dot3(q.dx, q.dy, q.dz, q.dx, q.dy, q.dz);
  const float4 ba = reinterpret_cast<const float4*>(best)[2 * r];
  const float4 bb = reinterpret_cast<const float4*>(best)[2 * r + 1];
  float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};

  for (int s = 0; s < V; ++s) {
    if (!(nears[(size_t)r * V + s] < b[0])) continue;  // cannot improve
    const int id = min(max(ids[(size_t)r * V + s], 0), K - 1);
    const float4* row = reinterpret_cast<const float4*>(table + (size_t)id * F * C);
    float4 comp[F];
#pragma unroll
    for (int f = 0; f < F; ++f) comp[f] = row[f * (C / 4) + lane];

    float lt = inf();
    int lidx = 4 * lane;
    float latt[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x[F];
#pragma unroll
      for (int f = 0; f < F; ++f)
        x[f] = j == 0 ? comp[f].x : j == 1 ? comp[f].y : j == 2 ? comp[f].z : comp[f].w;
      float att[5];
      float t;
      if constexpr (SPHERE)
        t = sphere_test(q, a_q, x[0], x[1], x[2], x[3], x[4], x[5], x[6], tmin,
                        b[0], att);
      else
        t = planar_test<TRIANGLE>(q, x[0], x[1], x[2], x[3], x[4], x[5], x[6],
                                  x[7], x[8], tmin, b[0], att);
      if (t < lt) {
        lt = t;
        lidx = 4 * lane + j;
#pragma unroll
        for (int i = 0; i < 5; ++i) latt[i] = att[i];
      }
    }
    // first-index minimum over the warp: lexicographic (t, idx)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(FULL, lt, off);
      const int oi = __shfl_xor_sync(FULL, lidx, off);
      if (ot < lt || (ot == lt && oi < lidx)) {
        lt = ot;
        lidx = oi;
      }
    }
    const int src = lidx >> 2;
    float watt[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) watt[i] = __shfl_sync(FULL, latt[i], src);
    if (lt < b[0]) {
      b[0] = lt;
      b[1] = watt[0];
      b[2] = watt[1];
      b[3] = watt[2];
      if constexpr (SPHERE) {
        b[4] = fmaxf(watt[3], 1e-20f);
      } else {
        b[4] = watt[3];
        b[5] = watt[4];
      }
      b[7] = add(mul(static_cast<float>(id), static_cast<float>(C)),
                 static_cast<float>(lidx));
    }
  }
  if (lane == 0) {
    reinterpret_cast<float4*>(out)[2 * r] = make_float4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<float4*>(out)[2 * r + 1] = make_float4(b[4], b[5], b[6], b[7]);
  }
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = success); nothing synchronises.
extern "C" int crt_visit_sweep(const float* rays, const int* ids,
                               const float* nears, const float* best,
                               const float* table, int R, int V, int K,
                               float tmin, int triangle, int sphere,
                               float* out, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sphere)
    visit_sweep_kernel<true, false><<<grid, block, 0, st>>>(
        rays, ids, nears, best, table, R, V, K, tmin, out);
  else if (triangle)
    visit_sweep_kernel<false, true><<<grid, block, 0, st>>>(
        rays, ids, nears, best, table, R, V, K, tmin, out);
  else
    visit_sweep_kernel<false, false><<<grid, block, 0, st>>>(
        rays, ids, nears, best, table, R, V, K, tmin, out);
  return static_cast<int>(cudaGetLastError());
}
