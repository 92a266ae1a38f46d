// Per-primitive ray tests shared by the closest-hit kernels: K1 and K2
// (closest_hit.cu) and K6 (packet_closest.cu) test a ray against a staged
// live lane with the same device code, so a winner rounds alike in all.
// Included inside each source's anonymous namespace.

#pragma once

constexpr float BIG = 1e30f;
constexpr int NROWS = 16;
constexpr int TILE_C = 128;

// planar pack rows
constexpr int ROW_UNORM = 0, ROW_EVW = 3, ROW_WEU = 6, ROW_DPLANE = 9,
              ROW_CA = 10, ROW_CB = 11, ROW_ACTIVE = 12, ROW_MAT = 13;
// sphere pack rows
constexpr int SROW_C0 = 0, SROW_DC = 3, SROW_C0C0 = 6, SROW_C0DC = 7,
              SROW_DCDC = 8, SROW_RAD2 = 9, SROW_RAD = 10, SROW_ACTIVE = 11,
              SROW_MAT = 12;

__device__ __forceinline__ float clip_big(float x) {
  return fminf(fmaxf(x, -BIG), BIG);
}

// One rounding per product and per sum, never contracted into an FMA.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// One ray of K1's RAYS_K1 (or of a K6 tile), with its running best.
struct PlanarRay {
  float ox, oy, oz, dx, dy, dz;
  float t, nx, ny, nz, u, v, m, valid;
  int p;
};

// Test the staged live lane j (constants nd = (unorm, d_plane), ea = (evw,
// c_a), wb = (weu, c_b)) against one ray; keep it when strictly nearer.
template <bool TRIANGLE, bool WITH_PID>
__device__ __forceinline__ void planar_lane(PlanarRay& q, const float4& nd,
                                            const float4& ea, const float4& wb,
                                            const float* s_mat, int j,
                                            float tmin, int prim) {
  const float d_n = q.dx * nd.x + q.dy * nd.y + q.dz * nd.z;
  if (!(fabsf(d_n) > 1e-20f)) return;
  const float o_n = q.ox * nd.x + q.oy * nd.y + q.oz * nd.z;
  const float t = (nd.w - o_n) / d_n;
  if (!(t >= tmin && t < q.t)) return;
  const float a = clip_big((q.ox * ea.x + q.oy * ea.y + q.oz * ea.z)
                           + t * (q.dx * ea.x + q.dy * ea.y + q.dz * ea.z)
                           - ea.w);
  const float b = clip_big((q.ox * wb.x + q.oy * wb.y + q.oz * wb.z)
                           + t * (q.dx * wb.x + q.dy * wb.y + q.dz * wb.z)
                           - wb.w);
  const bool interior = TRIANGLE
      ? (a >= 0.f && b >= 0.f && a + b <= 1.f)
      : (a >= 0.f && a <= 1.f && b >= 0.f && b <= 1.f);
  if (!interior) return;
  q.t = t;
  q.nx = nd.x; q.ny = nd.y; q.nz = nd.z;
  q.u = a; q.v = b;
  q.m = s_mat[j];
  q.valid = 1.f;
  if (WITH_PID) q.p = prim;
}

// One ray of K2's RAYS_K2 (or of a K6 tile), with its ray-only terms and its
// running best.
struct SphereRay {
  float ox, oy, oz, dx, dy, dz, tm;
  float a4, oo, dor, two_a, tm2, tmtm;  // 4a, |o|^2, d.o, 2a, 2 time, time^2
  float t, cx, cy, cz, r, m, valid;
  int p;
};

// The ray-only terms of the quadratic from the ray's direction, origin and
// time (4a, |o|^2, d.o, 2a, 2 time, time^2), each product and sum rounded on
// its own.
__device__ __forceinline__ void sphere_ray_terms(SphereRay& x) {
  const float a = dot3(x.dx, x.dy, x.dz, x.dx, x.dy, x.dz);
  x.a4 = mul(4.f, a);
  x.oo = dot3(x.ox, x.oy, x.oz, x.ox, x.oy, x.oz);
  x.dor = dot3(x.dx, x.dy, x.dz, x.ox, x.oy, x.oz);
  x.two_a = 2.f * fmaxf(a, 1e-20f);
  x.tm2 = mul(2.f, x.tm);
  x.tmtm = mul(x.tm, x.tm);
}

// Test the staged live lane (constants c0 = (c0 xyz, c0.c0), dc = (dc xyz,
// c0.dc), rm = (dc.dc, rad^2, rad, mat)) against one ray; keep it when
// strictly nearer. Every product and sum rounds on its own, in the order of
// the plain version (ops/chunked.py _sphere_chunk_ts).
template <bool WITH_PID>
__device__ __forceinline__ void sphere_lane(SphereRay& q, const float4& c0,
                                            const float4& dc, const float4& rm,
                                            float tmin, int prim) {
  const float d_c = add(dot3(q.dx, q.dy, q.dz, c0.x, c0.y, c0.z),
                        mul(q.tm, dot3(q.dx, q.dy, q.dz, dc.x, dc.y, dc.z)));
  const float o_c = add(dot3(q.ox, q.oy, q.oz, c0.x, c0.y, c0.z),
                        mul(q.tm, dot3(q.ox, q.oy, q.oz, dc.x, dc.y, dc.z)));
  const float cc = add(add(c0.w, mul(q.tm2, dc.w)), mul(q.tmtm, rm.x));
  const float b = mul(2.f, sub(q.dor, d_c));
  const float c = sub(add(sub(q.oo, mul(2.f, o_c)), cc), rm.y);
  const float disc = sub(mul(b, b), mul(q.a4, c));
  if (!(disc > 0.f)) return;
  const float sq = sqrtf(disc);
  const float t0 = (-b - sq) / q.two_a;
  const float t1 = (-b + sq) / q.two_a;
  float t;
  if (t0 >= tmin && t0 < q.t) t = t0;
  else if (t1 >= tmin && t1 < q.t) t = t1;
  else return;
  q.t = t;
  q.cx = add(c0.x, mul(q.tm, dc.x));
  q.cy = add(c0.y, mul(q.tm, dc.y));
  q.cz = add(c0.z, mul(q.tm, dc.z));
  q.r = fmaxf(rm.z, 1e-20f);
  q.m = rm.w;
  q.valid = 1.f;
  if (WITH_PID) q.p = prim;
}
