// Tile-packet closest hit for Hopper (sm_90a): K6, planar and sphere.
//
// K6 is the port's kernel for the JAX package's XLA packet route,
// cpu_ray_tracing_implementation_tpu/ops/packet.py (_planar_tile and
// _sphere_tile under lax.map, packet.py:110-203); it has no Pallas
// counterpart. Plain versions: ops/packet.py _planar_tile / _sphere_tile.
//
// What it computes. Rays come in tiles of T consecutive lanes (the last
// tile padded with zero rays of cap 0, as the plain version pads it). For
// each tile:
//  1. cull: every chunk AABB is slab-tested against every ray of the tile
//     (ops/packet.py _chunk_hits: the 1e-20 reciprocal guard, then
//     near <= far, far >= tmin and near <= the ray's cap), and each chunk
//     keeps the least max(near, tmin) over the rays that pass (+inf when
//     none does);
//  2. sort: the chunks by (that near, chunk id), so the order is that of a
//     stable argsort;
//  3. front to back: while the next chunk's near is finite and not above
//     the tile's largest running best (each ray's best hit so far, or its
//     cap while it has none), the chunk's primitives are tested against
//     every ray of the tile, and a ray keeps a primitive only where it is
//     strictly nearer than its best. Within a chunk the lanes are visited
//     in index order, so the first index of the chunk's minimum wins.
// Outputs: [8,R] hit rows as K1's / K2's (planar: t, unit normal xyz, u,
// v, mat, valid; sphere: t, center xyz at ray time, rad, mat, valid, 0),
// the winner's chunk-order index k*C + lane [R] int32 (0 on a miss), and
// the chunks each tile visited [G] int32.
//
// Design. One tile per block: the TPU's per-tile while_loop becomes the
// block's own loop, and tiles run in parallel on the SMs. The tile's chunk
// keys and ids sit in shared memory (a bitonic sort over the next power of
// two of K; at most MAX_CHUNKS chunks). The cull reduces each chunk's near
// over a warp with __reduce_min_sync and over the block with a shared
// atomicMin, on an order-preserving unsigned image of the float. Each
// visited chunk is staged into shared memory 128 lanes at a time, as K1
// and K2 stage it (active lanes only, a ballot of live lanes), and each
// ray is tested with K1's / K2's own device code (hit_tests.cuh), so a
// winner rounds as it does there; K2's quadratic stays unfused. The
// running best of each ray lives in the output rows in device memory
// between chunk visits (read and written back by its thread, mostly from
// L1/L2); a block max of it decides the early exit after every chunk.
//
// Bound. Per tile, T x K slab tests (the cull), then T x (live primitives
// of each visited chunk) ray tests: chip_smoke.py counts both from the
// run's visit lists. Bytes: 28 B of ray rows and 4 B of cap read, 36 B of
// hit rows written per ray.

#include <cuda_runtime.h>

#include <cmath>

namespace {

#include "hit_tests.cuh"

constexpr int PK_THREADS = 256;
constexpr int PK_WARPS = PK_THREADS / 32;
constexpr int MAX_CHUNKS = 4096;  // the sort's shared keys and ids: 32 KB

// An unsigned image of a float that orders as the float does.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float block_max(float x, float* s_wmax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) s_wmax[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = s_wmax[0];
#pragma unroll
  for (int w = 1; w < PK_WARPS; ++w) m = fmaxf(m, s_wmax[w]);
  return m;
}

// Steps 1 and 2: the tile's chunk keys (ordered near) and ids in s_key /
// s_id, sorted ascending by (key, id) over P (a power of two >= K; slots
// past K hold +inf). Returns the tile's largest cap.
__device__ float cull_and_sort(const float* __restrict__ rays,
                               const float* __restrict__ cap, int R, int r0,
                               int T, const float* __restrict__ lo,
                               const float* __restrict__ hi, int K, int P,
                               float tmin, unsigned* s_key, int* s_id,
                               float* s_wmax) {
  const unsigned none = ordered(INFINITY);
  for (int i = threadIdx.x; i < P; i += PK_THREADS) {
    s_key[i] = none;
    s_id[i] = i;
  }
  __syncthreads();
  float cmax = -INFINITY;
  for (int base = 0; base < T; base += PK_THREADS) {
    const int l = base + threadIdx.x;
    const int r = r0 + l;
    const bool in_tile = l < T;
    // a padded lane (r >= R) is a zero ray with cap 0, as the plain
    // version pads the last tile
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, cp = 0.f;
    if (in_tile && r < R) {
      ox = rays[0 * (size_t)R + r]; oy = rays[1 * (size_t)R + r];
      oz = rays[2 * (size_t)R + r]; dx = rays[3 * (size_t)R + r];
      dy = rays[4 * (size_t)R + r]; dz = rays[5 * (size_t)R + r];
      cp = cap[r];
    }
    if (in_tile) cmax = fmaxf(cmax, cp);
    const float ix = 1.f / (fabsf(dx) > 1e-20f ? dx : 1e-20f);
    const float iy = 1.f / (fabsf(dy) > 1e-20f ? dy : 1e-20f);
    const float iz = 1.f / (fabsf(dz) > 1e-20f ? dz : 1e-20f);
    for (int k = 0; k < K; ++k) {
      const float t0x = (lo[3 * k + 0] - ox) * ix, t1x = (hi[3 * k + 0] - ox) * ix;
      const float t0y = (lo[3 * k + 1] - oy) * iy, t1y = (hi[3 * k + 1] - oy) * iy;
      const float t0z = (lo[3 * k + 2] - oz) * iz, t1z = (hi[3 * k + 2] - oz) * iz;
      const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool ok = in_tile && near <= far && far >= tmin && near <= cp;
      const unsigned key = __reduce_min_sync(0xffffffffu,
                                             ok ? ordered(fmaxf(near, tmin)) : none);
      if ((threadIdx.x & 31) == 0 && key != none) atomicMin(&s_key[k], key);
    }
  }
  __syncthreads();
  // bitonic sort of (key, id) pairs, ascending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += PK_THREADS) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const unsigned ki = s_key[i], kj = s_key[j];
        const int ii = s_id[i], ij = s_id[j];
        const bool greater = ki > kj || (ki == kj && ii > ij);
        if (greater == ((i & size) == 0)) {
          s_key[i] = kj; s_key[j] = ki;
          s_id[i] = ij; s_id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  return block_max(cmax, s_wmax);
}

template <bool TRIANGLE>
__global__ void __launch_bounds__(PK_THREADS)
packet_planar_kernel(const float* __restrict__ rays, const float* __restrict__ cap,
                     int R, const float* __restrict__ pack,
                     const float* __restrict__ lo, const float* __restrict__ hi,
                     int K, int C, int P, float tmin, int T,
                     float* __restrict__ out, int* __restrict__ pid,
                     int* __restrict__ visits) {
  extern __shared__ unsigned s_sort[];
  unsigned* s_key = s_sort;
  int* s_id = reinterpret_cast<int*>(s_sort + P);
  __shared__ float4 s_nd[TILE_C], s_ea[TILE_C], s_wb[TILE_C];
  __shared__ float s_mat[TILE_C];
  __shared__ unsigned s_live[TILE_C / 32];
  __shared__ float s_wmax[PK_WARPS];
  const int r0 = blockIdx.x * T;
  for (int l = threadIdx.x; l < T; l += PK_THREADS) {
    const int r = r0 + l;
    if (r >= R) break;
    out[0 * (size_t)R + r] = fminf(BIG, cap[r]);
    for (int row = 1; row < 8; ++row) out[row * (size_t)R + r] = 0.f;
    pid[r] = 0;
  }
  float bmax = cull_and_sort(rays, cap, R, r0, T, lo, hi, K, P, tmin, s_key, s_id,
                             s_wmax);
  const bool pads = r0 + T > R;  // this tile holds padded lanes (best 0)
  int visited = 0;
  for (int s = 0; s < K; ++s) {
    const float ns = unordered(s_key[s]);
    if (!(isfinite(ns) && ns <= bmax)) break;
    const int k = s_id[s];
    ++visited;
    for (int c0 = 0; c0 < C; c0 += TILE_C) {
      const int nc = min(TILE_C, C - c0);
      __syncthreads();  // previous slice fully consumed
      const int c = threadIdx.x;
      if (c < TILE_C) {
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
      }
      __syncthreads();
      for (int l = threadIdx.x; l < T; l += PK_THREADS) {
        const int r = r0 + l;
        if (r >= R) break;
        PlanarRay q;
        q.ox = rays[0 * (size_t)R + r]; q.oy = rays[1 * (size_t)R + r];
        q.oz = rays[2 * (size_t)R + r]; q.dx = rays[3 * (size_t)R + r];
        q.dy = rays[4 * (size_t)R + r]; q.dz = rays[5 * (size_t)R + r];
        const float t_in = out[0 * (size_t)R + r];
        q.t = t_in;
        q.valid = 0.f;
        q.p = 0;
        for (int w = 0; w < TILE_C / 32; ++w) {
          for (unsigned live = s_live[w]; live; live &= live - 1) {
            const int j = w * 32 + __ffs(live) - 1;
            planar_lane<TRIANGLE, true>(q, s_nd[j], s_ea[j], s_wb[j], s_mat, j, tmin,
                                        k * C + c0 + j);
          }
        }
        if (q.t < t_in) {
          out[0 * (size_t)R + r] = q.t;
          out[1 * (size_t)R + r] = q.nx;
          out[2 * (size_t)R + r] = q.ny;
          out[3 * (size_t)R + r] = q.nz;
          out[4 * (size_t)R + r] = q.u;
          out[5 * (size_t)R + r] = q.v;
          out[6 * (size_t)R + r] = q.m;
          out[7 * (size_t)R + r] = 1.f;
          pid[r] = q.p;
        }
      }
    }
    // the tile's largest running best: a ray's best hit, or its cap while it
    // has none (padded lanes: 0)
    float m = (pads && threadIdx.x == 0) ? 0.f : -INFINITY;
    for (int l = threadIdx.x; l < T; l += PK_THREADS) {
      const int r = r0 + l;
      if (r >= R) break;
      m = fmaxf(m, out[7 * (size_t)R + r] > 0.5f ? out[0 * (size_t)R + r] : cap[r]);
    }
    bmax = block_max(m, s_wmax);
  }
  if (threadIdx.x == 0) visits[blockIdx.x] = visited;
}

__global__ void __launch_bounds__(PK_THREADS)
packet_sphere_kernel(const float* __restrict__ rays, const float* __restrict__ cap,
                     int R, const float* __restrict__ pack,
                     const float* __restrict__ lo, const float* __restrict__ hi,
                     int K, int C, int P, float tmin, int T,
                     float* __restrict__ out, int* __restrict__ pid,
                     int* __restrict__ visits) {
  extern __shared__ unsigned s_sort[];
  unsigned* s_key = s_sort;
  int* s_id = reinterpret_cast<int*>(s_sort + P);
  __shared__ float4 s_c0[TILE_C], s_dc[TILE_C], s_rm[TILE_C];
  __shared__ unsigned s_live[TILE_C / 32];
  __shared__ float s_wmax[PK_WARPS];
  const int r0 = blockIdx.x * T;
  for (int l = threadIdx.x; l < T; l += PK_THREADS) {
    const int r = r0 + l;
    if (r >= R) break;
    out[0 * (size_t)R + r] = fminf(BIG, cap[r]);
    for (int row = 1; row < 8; ++row) out[row * (size_t)R + r] = row == 4 ? 1.f : 0.f;
    pid[r] = 0;
  }
  float bmax = cull_and_sort(rays, cap, R, r0, T, lo, hi, K, P, tmin, s_key, s_id,
                             s_wmax);
  const bool pads = r0 + T > R;
  int visited = 0;
  for (int s = 0; s < K; ++s) {
    const float ns = unordered(s_key[s]);
    if (!(isfinite(ns) && ns <= bmax)) break;
    const int k = s_id[s];
    ++visited;
    for (int c0 = 0; c0 < C; c0 += TILE_C) {
      const int nc = min(TILE_C, C - c0);
      __syncthreads();  // previous slice fully consumed
      const int c = threadIdx.x;
      if (c < TILE_C) {
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
      }
      __syncthreads();
      for (int l = threadIdx.x; l < T; l += PK_THREADS) {
        const int r = r0 + l;
        if (r >= R) break;
        SphereRay q;
        q.ox = rays[0 * (size_t)R + r]; q.oy = rays[1 * (size_t)R + r];
        q.oz = rays[2 * (size_t)R + r]; q.dx = rays[3 * (size_t)R + r];
        q.dy = rays[4 * (size_t)R + r]; q.dz = rays[5 * (size_t)R + r];
        q.tm = rays[6 * (size_t)R + r];
        sphere_ray_terms(q);
        const float t_in = out[0 * (size_t)R + r];
        q.t = t_in;
        q.valid = 0.f;
        q.p = 0;
        for (int w = 0; w < TILE_C / 32; ++w) {
          for (unsigned live = s_live[w]; live; live &= live - 1) {
            const int j = w * 32 + __ffs(live) - 1;
            sphere_lane<true>(q, s_c0[j], s_dc[j], s_rm[j], tmin, k * C + c0 + j);
          }
        }
        if (q.t < t_in) {
          out[0 * (size_t)R + r] = q.t;
          out[1 * (size_t)R + r] = q.cx;
          out[2 * (size_t)R + r] = q.cy;
          out[3 * (size_t)R + r] = q.cz;
          out[4 * (size_t)R + r] = q.r;
          out[5 * (size_t)R + r] = q.m;
          out[6 * (size_t)R + r] = 1.f;
          pid[r] = q.p;
        }
      }
    }
    float m = (pads && threadIdx.x == 0) ? 0.f : -INFINITY;
    for (int l = threadIdx.x; l < T; l += PK_THREADS) {
      const int r = r0 + l;
      if (r >= R) break;
      m = fmaxf(m, out[6 * (size_t)R + r] > 0.5f ? out[0 * (size_t)R + r] : cap[r]);
    }
    bmax = block_max(m, s_wmax);
  }
  if (threadIdx.x == 0) visits[blockIdx.x] = visited;
}

int next_pow2(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace

// Plain C interface for ctypes. rays [8,R] f32, cap [R] f32, pack [K,16,C]
// f32, lo and hi [K,3] f32, tile T; out [8,R] f32, pid [R] int32, visits
// [ceil(R/T)] int32. Returns cudaGetLastError() after the launch (0 =
// success), or cudaErrorInvalidValue for K above MAX_CHUNKS or a tile
// below 1; nothing synchronises.
extern "C" int crt_packet_max_chunks() { return MAX_CHUNKS; }

extern "C" int crt_packet_planar(const float* rays, const float* cap, int R,
                                 const float* pack, const float* lo,
                                 const float* hi, int K, int C, float tmin,
                                 int tile, int triangle, float* out, int* pid,
                                 int* visits, void* stream) {
  if (R <= 0) return 0;
  if (K > MAX_CHUNKS || K < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = next_pow2(K);
  const dim3 grid((R + tile - 1) / tile);
  const size_t smem = (size_t)P * (sizeof(unsigned) + sizeof(int));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (triangle)
    packet_planar_kernel<true><<<grid, PK_THREADS, smem, st>>>(
        rays, cap, R, pack, lo, hi, K, C, P, tmin, tile, out, pid, visits);
  else
    packet_planar_kernel<false><<<grid, PK_THREADS, smem, st>>>(
        rays, cap, R, pack, lo, hi, K, C, P, tmin, tile, out, pid, visits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crt_packet_sphere(const float* rays, const float* cap, int R,
                                 const float* pack, const float* lo,
                                 const float* hi, int K, int C, float tmin,
                                 int tile, float* out, int* pid, int* visits,
                                 void* stream) {
  if (R <= 0) return 0;
  if (K > MAX_CHUNKS || K < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = next_pow2(K);
  const dim3 grid((R + tile - 1) / tile);
  const size_t smem = (size_t)P * (sizeof(unsigned) + sizeof(int));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  packet_sphere_kernel<<<grid, PK_THREADS, smem, st>>>(
      rays, cap, R, pack, lo, hi, K, C, P, tmin, tile, out, pid, visits);
  return static_cast<int>(cudaGetLastError());
}
