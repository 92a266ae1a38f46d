// Fused closest-hit kernels for Hopper (sm_90a): K1 (planar) and K2 (sphere).
//
// K1 replaces cpu_ray_tracing_implementation_tpu/ops/pallas_intersect.py:_kernel
// (closest hit of each ray against K chunks of C quads or triangles);
// K2 replaces pallas_intersect.py:_sphere_kernel (the same for moving spheres).
// Plain versions: ops/chunked.py planar_closest / sphere_closest.
//
// Layouts are the Pallas kernels': rays [8,R] f32 (org xyz, dir xyz, time,
// pad), primitive constants [K,16,C] f32 (ops/fused_intersect.py pack_*),
// output [8,R] f32 (K1: t, unit normal xyz, u, v, mat, valid; K2: t, center
// xyz at ray time, rad, mat, valid, 0), and, when the caller passes a pid
// buffer, [R] int32 chunk-order index k*C + lane of each ray's winner (0 on
// a miss, as the plain versions give it). The gradient path's winner replay
// (ops/replay.py) reads pid to re-intersect that one primitive. The pid is
// a template parameter: the forward render passes a null pointer and runs
// the instantiation without it, unchanged (tracking the index in the lane
// loop costs K1 ~26% at the Cornell shape: 0.0265 ms without, 0.0334 ms
// with, in one chip_smoke.py call; PERF.md).
//
// Design. The TPU kernel's grid walks the chunk axis in order and carries
// the running hit in the revisited VMEM output block; CUDA blocks run in no
// order, so each block loops over all K chunks itself. Each ray keeps its
// running (t, payload) in registers and writes its 8 output rows once,
// coalesced. The Pallas kernel's six depth-3 contractions per (ray,
// primitive) become per-thread FMAs; no [R,C] intermediate exists anywhere.
//  - K1 and K2 (both redesigned for Hopper): each thread carries several
//    rays (RAYS_K1 = 2, RAYS_K2 = 4), so every staged constant feeds
//    several tests and the rays' IEEE divides overlap. Per 128-lane slice of a chunk,
//    thread c reads lane c's active flag; an active lane's read rows go to
//    shared memory as three float4s (K1: unorm | d_plane, evw | c_a,
//    weu | c_b, and its material apart; K2: c0 | c0.c0, dc | c0.dc,
//    dc.dc | rad^2 | rad | mat), and a ballot per warp records which lanes
//    are active. The lane loop then visits the active lanes only, lowest
//    first (find-first-set over the ballot words): padded lanes and holes
//    cost nothing, the walk ends at the highest active lane, and lane
//    numbering (pid = k*C + lane) is unchanged. K2's ray-only terms (4a,
//    |o|^2, d.o, 2a, 2 time, time^2) are computed once per ray. (The first
//    designs took one ray per thread and walked all 128 lanes; K2's staged
//    the whole [16,128] slice. K2 with 1, 2 and 4 rays per thread, timed
//    in one call by utils/kernel_ab.py: PERF.md; four take 118 registers,
//    no spill.)
//
// Bound. At Cornell's shape (R = 262144 rays, one chunk of C = 128 lanes of
// which 18 hold the quads) K1 reads 24 B of ray rows and writes 32 B of hit
// rows per ray, 14.7 MB in all (~4.4 us of HBM at 3.35 TB/s), and issues
// ~36 FP32 instructions per (ray, live quad) once the pack's per-primitive
// constants are precomputed (chip_smoke.py's OPS), 0.17 G instructions,
// ~5.1 us at 33.5e12 per s: the larger term. On one H100 (700 W) the
// redesigned K1 took 0.0146 ms there (0.0149 with pid; the first design
// 0.0266 and 0.0334 in the same run) and 0.0034 ms at the colonnade's light view (40,000
// rays, 1 live lane), so a launch costs ~3 us beyond its bytes; by a count
// from the source, the IEEE divide and the branches put ~50 instructions
// on each live (ray, quad), not 36 (PERF.md). K2 at three_material_ball's
// shape (262144 rays, 4 live lanes of 128) is bound by its bytes (28 B of
// ray rows read, 32 B written per ray: ~4.7 us); at random_motion_ball's
// (337 live lanes of 384) by its operations: 38 FP32 instructions of the
// quadratic and its compare per (ray, sphere), each product and sum rounded
// on its own, and 9 more for the root only where the discriminant is
// positive (under 1% of the pairs of its primary rays), ~0.100 ms at 262144
// rays (chip_smoke.py's OPS; PERF.md).
//
// Rounding. K1 is compiled with nvcc's default multiply-add contraction. K2
// writes its expanded quadratic (|o|^2 - 2 o.c + |c|^2 - r^2, which cancels
// heavily) with __fmul_rn/__fadd_rn, which are never contracted, so it
// rounds as its plain PyTorch version does (one kernel per operation) and
// grazing rays hit or miss on both alike.
//
// The per-primitive tests (planar_lane, sphere_lane) live in hit_tests.cuh,
// which the tile-packet kernel K6 (packet_closest.cu) includes too.
//
// Ties: a candidate replaces the running hit only when strictly nearer, and
// primitives are visited in index order, so the first index of the minimum
// wins, as jnp.argmin does in the Pallas kernel.

#include <cuda_runtime.h>

namespace {

#include "hit_tests.cuh"

constexpr int THREADS = 128;
constexpr int RAYS_K1 = 2;  // rays per thread in K1
constexpr int RAYS_K2 = 4;  // rays per thread in K2

template <bool TRIANGLE, bool WITH_PID>
__global__ void __launch_bounds__(THREADS)
planar_closest_kernel(const float* __restrict__ rays, int R,
                      const float* __restrict__ pack, int K, int C,
                      float tmin, float tmax, float* __restrict__ out,
                      int* __restrict__ pid) {
  static_assert(THREADS == TILE_C, "one staging thread per lane");
  __shared__ float4 s_nd[TILE_C], s_ea[TILE_C], s_wb[TILE_C];
  __shared__ float s_mat[TILE_C];
  __shared__ unsigned s_live[TILE_C / 32];  // active-lane bits by warp
  const int r0 = blockIdx.x * THREADS * RAYS_K1 + threadIdx.x;
  PlanarRay q[RAYS_K1];
#pragma unroll
  for (int i = 0; i < RAYS_K1; ++i) {
    const int r = r0 + i * THREADS;
    PlanarRay& x = q[i];
    x.ox = x.oy = x.oz = x.dx = x.dy = x.dz = 0.f;
    if (r < R) {
      x.ox = rays[0 * (size_t)R + r]; x.oy = rays[1 * (size_t)R + r];
      x.oz = rays[2 * (size_t)R + r]; x.dx = rays[3 * (size_t)R + r];
      x.dy = rays[4 * (size_t)R + r]; x.dz = rays[5 * (size_t)R + r];
    }
    x.t = fminf(BIG, tmax);
    x.nx = x.ny = x.nz = x.u = x.v = x.m = x.valid = 0.f;
    x.p = 0;
  }

  for (int k = 0; k < K; ++k) {
    for (int c0 = 0; c0 < C; c0 += TILE_C) {
      const int nc = min(TILE_C, C - c0);
      __syncthreads();  // previous slice fully consumed
      // thread c stages lane c0 + c, and only if it is active
      const int c = threadIdx.x;
      const float* pk = pack + (size_t)k * NROWS * C + c0 + c;
      const bool act = c < nc && pk[(size_t)ROW_ACTIVE * C] > 0.5f;
      if (act) {
        s_nd[c] = make_float4(pk[(size_t)(ROW_UNORM + 0) * C], pk[(size_t)(ROW_UNORM + 1) * C],
                              pk[(size_t)(ROW_UNORM + 2) * C], pk[(size_t)ROW_DPLANE * C]);
        s_ea[c] = make_float4(pk[(size_t)(ROW_EVW + 0) * C], pk[(size_t)(ROW_EVW + 1) * C],
                              pk[(size_t)(ROW_EVW + 2) * C], pk[(size_t)ROW_CA * C]);
        s_wb[c] = make_float4(pk[(size_t)(ROW_WEU + 0) * C], pk[(size_t)(ROW_WEU + 1) * C],
                              pk[(size_t)(ROW_WEU + 2) * C], pk[(size_t)ROW_CB * C]);
        s_mat[c] = pk[(size_t)ROW_MAT * C];
      }
      const unsigned bits = __ballot_sync(0xffffffffu, act);
      if (c % 32 == 0) s_live[c / 32] = bits;
      __syncthreads();
      // the active lanes only, in index order: padded lanes and holes cost
      // nothing, and the loop ends at the highest active lane
      for (int w = 0; w < TILE_C / 32; ++w) {
        for (unsigned live = s_live[w]; live; live &= live - 1) {
          const int j = w * 32 + __ffs(live) - 1;
          const float4 nd = s_nd[j], ea = s_ea[j], wb = s_wb[j];
#pragma unroll
          for (int i = 0; i < RAYS_K1; ++i)
            planar_lane<TRIANGLE, WITH_PID>(q[i], nd, ea, wb, s_mat, j, tmin,
                                            k * C + c0 + j);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RAYS_K1; ++i) {
    const int r = r0 + i * THREADS;
    if (r >= R) continue;
    const PlanarRay& x = q[i];
    if (WITH_PID) pid[r] = x.p;
    out[0 * (size_t)R + r] = x.t;
    out[1 * (size_t)R + r] = x.nx;
    out[2 * (size_t)R + r] = x.ny;
    out[3 * (size_t)R + r] = x.nz;
    out[4 * (size_t)R + r] = x.u;
    out[5 * (size_t)R + r] = x.v;
    out[6 * (size_t)R + r] = x.m;
    out[7 * (size_t)R + r] = x.valid;
  }
}

template <bool WITH_PID>
__global__ void __launch_bounds__(THREADS)
sphere_closest_kernel(const float* __restrict__ rays, int R,
                      const float* __restrict__ pack, int K, int C,
                      float tmin, float tmax, float* __restrict__ out,
                      int* __restrict__ pid) {
  static_assert(THREADS == TILE_C, "one staging thread per lane");
  __shared__ float4 s_c0[TILE_C], s_dc[TILE_C], s_rm[TILE_C];
  __shared__ unsigned s_live[TILE_C / 32];  // active-lane bits by warp
  const int r0 = blockIdx.x * THREADS * RAYS_K2 + threadIdx.x;
  SphereRay q[RAYS_K2];
#pragma unroll
  for (int i = 0; i < RAYS_K2; ++i) {
    const int r = r0 + i * THREADS;
    SphereRay& x = q[i];
    x.ox = x.oy = x.oz = x.dx = x.dy = x.dz = x.tm = 0.f;
    if (r < R) {
      x.ox = rays[0 * (size_t)R + r]; x.oy = rays[1 * (size_t)R + r];
      x.oz = rays[2 * (size_t)R + r]; x.dx = rays[3 * (size_t)R + r];
      x.dy = rays[4 * (size_t)R + r]; x.dz = rays[5 * (size_t)R + r];
      x.tm = rays[6 * (size_t)R + r];
    }
    sphere_ray_terms(x);
    x.t = fminf(BIG, tmax);
    x.cx = x.cy = x.cz = x.m = x.valid = 0.f;
    x.r = 1.f;
    x.p = 0;
  }

  for (int k = 0; k < K; ++k) {
    for (int c0 = 0; c0 < C; c0 += TILE_C) {
      const int nc = min(TILE_C, C - c0);
      __syncthreads();  // previous slice fully consumed
      // thread c stages lane c0 + c, and only if it is active
      const int c = threadIdx.x;
      const float* pk = pack + (size_t)k * NROWS * C + c0 + c;
      const bool act = c < nc && pk[(size_t)SROW_ACTIVE * C] > 0.5f;
      if (act) {
        s_c0[c] = make_float4(pk[(size_t)(SROW_C0 + 0) * C], pk[(size_t)(SROW_C0 + 1) * C],
                              pk[(size_t)(SROW_C0 + 2) * C], pk[(size_t)SROW_C0C0 * C]);
        s_dc[c] = make_float4(pk[(size_t)(SROW_DC + 0) * C], pk[(size_t)(SROW_DC + 1) * C],
                              pk[(size_t)(SROW_DC + 2) * C], pk[(size_t)SROW_C0DC * C]);
        s_rm[c] = make_float4(pk[(size_t)SROW_DCDC * C], pk[(size_t)SROW_RAD2 * C],
                              pk[(size_t)SROW_RAD * C], pk[(size_t)SROW_MAT * C]);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, act);
      if (c % 32 == 0) s_live[c / 32] = bits;
      __syncthreads();
      // the active lanes only, in index order (the first-index tie rule)
      for (int w = 0; w < TILE_C / 32; ++w) {
        for (unsigned live = s_live[w]; live; live &= live - 1) {
          const int j = w * 32 + __ffs(live) - 1;
          const float4 sc0 = s_c0[j], sdc = s_dc[j], srm = s_rm[j];
#pragma unroll
          for (int i = 0; i < RAYS_K2; ++i)
            sphere_lane<WITH_PID>(q[i], sc0, sdc, srm, tmin, k * C + c0 + j);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RAYS_K2; ++i) {
    const int r = r0 + i * THREADS;
    if (r >= R) continue;
    const SphereRay& x = q[i];
    if (WITH_PID) pid[r] = x.p;
    out[0 * (size_t)R + r] = x.t;
    out[1 * (size_t)R + r] = x.cx;
    out[2 * (size_t)R + r] = x.cy;
    out[3 * (size_t)R + r] = x.cz;
    out[4 * (size_t)R + r] = x.r;
    out[5 * (size_t)R + r] = x.m;
    out[6 * (size_t)R + r] = x.valid;
    out[7 * (size_t)R + r] = 0.f;
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises. ``pid`` may be null.
extern "C" int crt_planar_closest(const float* rays, int R, const float* pack,
                                  int K, int C, float tmin, float tmax,
                                  int triangle, float* out, int* pid,
                                  void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + THREADS * RAYS_K1 - 1) / (THREADS * RAYS_K1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (triangle && pid)
    planar_closest_kernel<true, true><<<grid, THREADS, 0, st>>>(
        rays, R, pack, K, C, tmin, tmax, out, pid);
  else if (triangle)
    planar_closest_kernel<true, false><<<grid, THREADS, 0, st>>>(
        rays, R, pack, K, C, tmin, tmax, out, pid);
  else if (pid)
    planar_closest_kernel<false, true><<<grid, THREADS, 0, st>>>(
        rays, R, pack, K, C, tmin, tmax, out, pid);
  else
    planar_closest_kernel<false, false><<<grid, THREADS, 0, st>>>(
        rays, R, pack, K, C, tmin, tmax, out, pid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crt_sphere_closest(const float* rays, int R, const float* pack,
                                  int K, int C, float tmin, float tmax,
                                  float* out, int* pid, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + THREADS * RAYS_K2 - 1) / (THREADS * RAYS_K2));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pid)
    sphere_closest_kernel<true><<<grid, THREADS, 0, st>>>(rays, R, pack, K, C,
                                                          tmin, tmax, out, pid);
  else
    sphere_closest_kernel<false><<<grid, THREADS, 0, st>>>(rays, R, pack, K, C,
                                                           tmin, tmax, out, pid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
