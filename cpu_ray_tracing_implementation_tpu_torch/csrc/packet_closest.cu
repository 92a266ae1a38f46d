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
// Bound. Per tile, T x K slab tests (the cull), then T x (live primitives
// of each visited chunk) ray tests: chip_smoke.py counts both from the
// run's visit lists; the ray tests dominate, so K6 is bound by its FP32
// operations. Bytes: 28 B of ray rows and 4 B of cap read, 36 B of hit rows
// written per ray, the pack once (it sits in L2 across the tiles).
//
// Design. One tile per block, its loop the block's own; tiles run in
// parallel on the SMs. What bounds it on this card is the longest tiles:
// a tile's visits run one after another, so the kernel ends with the SMs
// that hold the tiles of most visits, and the design shortens each visit.
//  - Registers hold each ray for the whole loop: a thread owns RPT rays of
//    the tile, their origin, direction and time, the sphere's ray-only
//    terms, the cap and the running best (t, payload, mat, valid, pid).
//    Each primitive read from shared memory feeds RPT independent tests,
//    and the rows and pid are written once, at the end.
//  - SPLIT sets of threads, each whole warps, hold the same rays, and set
//    p tests the lanes j = p (mod SPLIT) of every slice, so a visit takes
//    1/SPLIT of the time; a warp tests one primitive at a time against its
//    own rays (broadcast reads, branches shared by coherent rays). A set
//    keeps its own best and the visit it came from; at the end the sets
//    merge (the nearest, then the earliest visit, then the least pid),
//    which is the best of the lanes taken in order, since a candidate's t
//    does not depend on the running best, only its acceptance does.
//    Instances (shape_of): tiles up to 64 rays take one ray a thread and
//    four sets (128 threads at the automatic tile of 32), up to 256 two
//    rays and two sets, up to 512 two rays, above four rays (a tile of more
//    than 1,024 rays takes them in groups of 1,024 and keeps each group's
//    best in the output rows between visits).
//  - The early exit reads registers: after each unit every thread posts
//    its rays' terms (the best hit, or the cap while there is none; 0 for a
//    padded lane) to shared memory, and after the one barrier that
//    separates two units each warp takes the max over the rays of the least
//    term over the sets (two sets of slots).
//  - The visit order comes without a sort: every warp picks the next chunk
//    as the least (key, id) above the current one from the shared keys.
//  - Staging is double-buffered and asynchronous: while the block tests one
//    (chunk, 128-lane slice) the whole block copies the next with 4-byte
//    cp.async straight into the float4 layout K1 and K2 test from (the copy
//    transposes the pack's rows). The next chunk is copied only while its
//    near does not exceed the tile's current largest best; the early exit
//    can still drop it after the visit (at most one chunk copied in vain
//    per tile). Each warp builds the ballot of live lanes from the staged
//    ACTIVE row.
//  - The cull: set p slab-tests chunks k = p (mod SPLIT) against its rays
//    and reduces each chunk's near over a warp (__reduce_min_sync) and the
//    block (a shared atomicMin) on an order-preserving unsigned image of
//    the float (at most MAX_CHUNKS chunks).
// The per-primitive tests are K1's / K2's own device code (hit_tests.cuh),
// so outputs, pid and visits are bit for bit those of the one-ray-a-thread
// design it replaces, at every tile.

#include <cuda_runtime.h>

#include <cmath>

namespace {

#include "hit_tests.cuh"

constexpr int PK_MAX_THREADS = 256;
constexpr int MAX_CHUNKS = 4096;  // the tile's shared chunk keys: 16 KB
// floats of one staging buffer: three float4 rows of TILE_C lanes, then two
// float rows (ACTIVE, and the planar material)
constexpr int STAGE_F4 = 3 * 4 * TILE_C;
constexpr int STAGE_FLOATS = STAGE_F4 + 2 * TILE_C;

// An unsigned image of a float that orders as the float does.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The lanes j = 0 (mod split) of a 32-lane word.
__host__ __device__ constexpr unsigned every(int split) {
  unsigned m = 0;
  for (int i = 0; i < 32; i += split) m |= 1u << i;
  return m;
}

// The chunk visited after `cur` in (near, chunk id) order: the least
// (key << 32 | id) + 1 above `cur` (0 before the first; ~0 when none is
// left). Every warp computes it from the shared keys, so no barrier
// broadcasts it and no sort precedes the visits.
__device__ __forceinline__ unsigned long long next_chunk(const unsigned* s_key, int K,
                                                         unsigned long long cur, int lane) {
  unsigned long long best = ~0ull;
  for (int k = lane; k < K; k += 32) {
    const unsigned long long v = ((static_cast<unsigned long long>(s_key[k]) << 32) | k) + 1;
    if (v > cur && v < best) best = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, best, o);
    best = w < best ? w : best;
  }
  return best;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The float offset in a staging buffer of lane 0 of pack row `row`, and
// its lane stride: a component of one of the three float4 rows (stride 4),
// or a float row (stride 1).
struct Dst {
  int base, stride;
};

template <bool TRIANGLE>
struct Planar {
  using Ray = PlanarRay;
  static constexpr int ROWS = ROW_MAT + 1;
  // nd = (unorm, d_plane), ea = (evw, c_a), wb = (weu, c_b); ACTIVE; mat
  __device__ static Dst dst(int row) {
    if (row < ROW_DPLANE) return {(row / 3) * 4 * TILE_C + row % 3, 4};
    if (row < ROW_ACTIVE) return {(row - ROW_DPLANE) * 4 * TILE_C + 3, 4};
    return {STAGE_F4 + (row - ROW_ACTIVE) * TILE_C, 1};
  }
  __device__ static void load(Ray& q, const float* rays, size_t R, int r) {
    q.ox = rays[0 * R + r]; q.oy = rays[1 * R + r]; q.oz = rays[2 * R + r];
    q.dx = rays[3 * R + r]; q.dy = rays[4 * R + r]; q.dz = rays[5 * R + r];
  }
  __device__ static void init(Ray& q, float cap) {
    q.t = fminf(BIG, cap);
    q.nx = q.ny = q.nz = q.u = q.v = q.m = q.valid = 0.f;
    q.p = 0;
  }
  __device__ static void load_best(Ray& q, const float* out, const int* pid, size_t R,
                                   int r) {
    q.t = out[0 * R + r]; q.nx = out[1 * R + r]; q.ny = out[2 * R + r];
    q.nz = out[3 * R + r]; q.u = out[4 * R + r]; q.v = out[5 * R + r];
    q.m = out[6 * R + r]; q.valid = out[7 * R + r];
    q.p = pid[r];
  }
  __device__ static void store(const Ray& q, float* out, int* pid, size_t R, int r) {
    out[0 * R + r] = q.t; out[1 * R + r] = q.nx; out[2 * R + r] = q.ny;
    out[3 * R + r] = q.nz; out[4 * R + r] = q.u; out[5 * R + r] = q.v;
    out[6 * R + r] = q.m; out[7 * R + r] = q.valid;
    pid[r] = q.p;
  }
  __device__ static void test(Ray& q, const float4& a, const float4& b, const float4& c,
                              const float* s_rows, int j, float tmin, int prim) {
    planar_lane<TRIANGLE, true>(q, a, b, c, s_rows + TILE_C, j, tmin, prim);
  }
};

struct Sphere {
  using Ray = SphereRay;
  static constexpr int ROWS = SROW_MAT + 1;
  // c0 = (c0, c0.c0), dc = (dc, c0.dc), rm = (dc.dc, rad^2, rad, mat); ACTIVE
  __device__ static Dst dst(int row) {
    if (row < SROW_C0C0) return {(row / 3) * 4 * TILE_C + row % 3, 4};
    if (row < SROW_DCDC) return {(row - SROW_C0C0) * 4 * TILE_C + 3, 4};
    if (row < SROW_ACTIVE) return {2 * 4 * TILE_C + row - SROW_DCDC, 4};
    if (row == SROW_ACTIVE) return {STAGE_F4, 1};
    return {2 * 4 * TILE_C + 3, 4};  // SROW_MAT
  }
  __device__ static void load(Ray& q, const float* rays, size_t R, int r) {
    q.ox = rays[0 * R + r]; q.oy = rays[1 * R + r]; q.oz = rays[2 * R + r];
    q.dx = rays[3 * R + r]; q.dy = rays[4 * R + r]; q.dz = rays[5 * R + r];
    q.tm = rays[6 * R + r];
    sphere_ray_terms(q);
  }
  __device__ static void init(Ray& q, float cap) {
    q.t = fminf(BIG, cap);
    q.cx = q.cy = q.cz = q.m = q.valid = 0.f;
    q.r = 1.f;
    q.p = 0;
  }
  __device__ static void load_best(Ray& q, const float* out, const int* pid, size_t R,
                                   int r) {
    q.t = out[0 * R + r]; q.cx = out[1 * R + r]; q.cy = out[2 * R + r];
    q.cz = out[3 * R + r]; q.r = out[4 * R + r]; q.m = out[5 * R + r];
    q.valid = out[6 * R + r];
    q.p = pid[r];
  }
  __device__ static void store(const Ray& q, float* out, int* pid, size_t R, int r) {
    out[0 * R + r] = q.t; out[1 * R + r] = q.cx; out[2 * R + r] = q.cy;
    out[3 * R + r] = q.cz; out[4 * R + r] = q.r; out[5 * R + r] = q.m;
    out[6 * R + r] = q.valid; out[7 * R + r] = 0.f;
    pid[r] = q.p;
  }
  __device__ static void test(Ray& q, const float4& a, const float4& b, const float4& c,
                              const float*, int, float tmin, int prim) {
    sphere_lane<true>(q, a, b, c, tmin, prim);
  }
};

// Copy (chunk k, lanes c0 .. c0+nc) of the pack into staging buffer `buf`,
// every thread of the block taking part; commits one cp.async group.
template <class Kind>
__device__ __forceinline__ void stage(const float* __restrict__ pack, int k, int C, int c0,
                                      int nc, float* buf) {
  const float* src = pack + (size_t)k * NROWS * C + c0;
#pragma unroll
  for (int row = 0; row < Kind::ROWS; ++row) {
    const Dst d = Kind::dst(row);
    for (int c = threadIdx.x; c < nc; c += blockDim.x)
      cp_async4(buf + d.base + c * d.stride, src + (size_t)row * C + c);
  }
  cp_async_commit();
}

template <class Kind, int RPT, int SPLIT>
__global__ void __launch_bounds__(PK_MAX_THREADS)
packet_kernel(const float* __restrict__ rays, const float* __restrict__ cap, int R,
              const float* __restrict__ pack, const float* __restrict__ lo,
              const float* __restrict__ hi, int K, int C, float tmin, int T,
              float* __restrict__ out, int* __restrict__ pid, int* __restrict__ visits) {
  using Ray = typename Kind::Ray;
  extern __shared__ unsigned s_key[];
  __shared__ __align__(16) float s_stage[2][STAGE_FLOATS];
  // each ray's term in the tile's largest running best, by set: written
  // after a unit, read after the barrier that follows it
  __shared__ float s_val[2][4 * PK_MAX_THREADS];
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31;
  // SPLIT sets of `slots` threads (whole warps) hold the same rays; set
  // `part` tests the lanes j = part (mod SPLIT) of each slice and culls the
  // chunks k = part (mod SPLIT), so a warp tests one primitive at a time
  const int slots = NT / SPLIT, part = tid / slots, slot = tid % slots;
  const unsigned mine = every(SPLIT) << part;
  const int n = slots * RPT;  // rays of a group, of a set
  const int groups = (T + n - 1) / n;
  const int r0 = blockIdx.x * T;
  const size_t Rs = R;
  const unsigned none = ordered(INFINITY);
  // the lane in the tile of this thread's ray i of group g
  auto lane_of = [&](int g, int i) { return g * n + i * slots + slot; };

  Ray q[RPT];
  float cp[RPT];
  // a ray's term in the tile's largest running best: its best hit, or its
  // cap while it has none (a padded lane's cap is 0); -inf past the tile.
  // Over the sets, the least term is the ray's.
  auto term = [&](int g, int i) {
    return lane_of(g, i) < T ? (q[i].valid > 0.5f ? q[i].t : cp[i]) : -INFINITY;
  };
  auto tile_max = [&](const float* v) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) {
      float x = v[r];
#pragma unroll
      for (int p = 1; p < SPLIT; ++p) x = fminf(x, v[p * n + r]);
      m = fmaxf(m, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    return m;
  };
  auto load_group = [&](int g, bool best) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int l = lane_of(g, i), r = r0 + l;
      // lanes past R (padding) and past the tile are zero rays of cap 0: no
      // test can hit them (a zero direction fails every primitive test)
      const bool real = l < T && r < R;
      q[i] = Ray{};
      if (real) Kind::load(q[i], rays, Rs, r);
      cp[i] = real ? cap[r] : 0.f;
      if (best && real) Kind::load_best(q[i], out, pid, Rs, r);
      else Kind::init(q[i], cp[i]);
    }
  };
  auto store_group = [&](int g) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int l = lane_of(g, i), r = r0 + l;
      if (part == 0 && l < T && r < R) Kind::store(q[i], out, pid, Rs, r);
    }
  };

  // step 1: the cull, each chunk's key the least ordered near of the rays
  // that cross it
  for (int i = tid; i < K; i += NT) s_key[i] = none;
  __syncthreads();
  float vmax[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) vmax[i] = -INFINITY;
  for (int g = 0; g < groups; ++g) {
    load_group(g, false);
    if (groups > 1) store_group(g);
#pragma unroll
    for (int i = 0; i < RPT; ++i) vmax[i] = fmaxf(vmax[i], term(g, i));
    float ix[RPT], iy[RPT], iz[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      ix[i] = 1.f / (fabsf(q[i].dx) > 1e-20f ? q[i].dx : 1e-20f);
      iy[i] = 1.f / (fabsf(q[i].dy) > 1e-20f ? q[i].dy : 1e-20f);
      iz[i] = 1.f / (fabsf(q[i].dz) > 1e-20f ? q[i].dz : 1e-20f);
    }
    for (int k = part; k < K; k += SPLIT) {
      const float lx = lo[3 * k + 0], ly = lo[3 * k + 1], lz = lo[3 * k + 2];
      const float hx = hi[3 * k + 0], hy = hi[3 * k + 1], hz = hi[3 * k + 2];
      unsigned key = none;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float t0x = (lx - q[i].ox) * ix[i], t1x = (hx - q[i].ox) * ix[i];
        const float t0y = (ly - q[i].oy) * iy[i], t1y = (hy - q[i].oy) * iy[i];
        const float t0z = (lz - q[i].oz) * iz[i], t1z = (hz - q[i].oz) * iz[i];
        const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        const bool ok = lane_of(g, i) < T && near <= far && far >= tmin && near <= cp[i];
        if (ok) key = min(key, ordered(fmaxf(near, tmin)));
      }
      key = __reduce_min_sync(0xffffffffu, key);
      if (lane == 0 && key != none) atomicMin(&s_key[k], key);
    }
  }
  // the cull's terms go to the slots the first visit reads
#pragma unroll
  for (int i = 0; i < RPT; ++i) s_val[1][part * n + i * slots + slot] = vmax[i];
  __syncthreads();

  // steps 2 and 3: the chunks in (near, id) order, each (chunk, 128-lane
  // slice) unit staged while the one before it is tested
  const int slices = (C + TILE_C - 1) / TILE_C;
  float bmax = tile_max(s_val[1]);
  // a chunk may still be visited: its near is finite and not above the
  // tile's current largest best (which only falls)
  auto may_visit = [&](unsigned long long v) {
    if (v == ~0ull) return false;
    const float ns = unordered(static_cast<unsigned>((v - 1) >> 32));
    return isfinite(ns) && ns <= bmax;
  };
  auto id_of = [](unsigned long long v) { return static_cast<int>((v - 1) & 0xffffffffu); };
  unsigned long long cur = next_chunk(s_key, K, 0, lane), nxt = 0;
  if (may_visit(cur)) stage<Kind>(pack, id_of(cur), C, 0, min(TILE_C, C), s_stage[0]);
  int visited = 0;
  // with SPLIT sets, the visit each ray's best of this set came from
  int vis[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) vis[i] = 0;
  for (int u = 0;; ++u) {
    const int c0 = (u % slices) * TILE_C;
    cp_async_wait_all();
    // unit u's copy has landed for every thread; every thread is done with
    // the other buffer and has posted its terms of unit u - 1
    __syncthreads();
    if (c0 == 0) {
      if (u > 0) {
        cur = nxt;
        bmax = tile_max(s_val[(u + 1) & 1]);
      }
      if (!may_visit(cur)) break;
      ++visited;
      nxt = next_chunk(s_key, K, cur, lane);
    }
    const int k = id_of(cur);
    if (c0 + TILE_C < C)
      stage<Kind>(pack, k, C, c0 + TILE_C, min(TILE_C, C - c0 - TILE_C),
                  s_stage[(u + 1) & 1]);
    else if (may_visit(nxt))
      stage<Kind>(pack, id_of(nxt), C, 0, min(TILE_C, C), s_stage[(u + 1) & 1]);
    const float* buf = s_stage[u & 1];
    const float4* f4 = reinterpret_cast<const float4*>(buf);
    const float* rows = buf + STAGE_F4;
    const int nc = min(TILE_C, C - c0);
    unsigned live[TILE_C / 32];
#pragma unroll
    for (int w = 0; w < TILE_C / 32; ++w) {
      const int c = w * 32 + lane;
      live[w] = __ballot_sync(0xffffffffu, c < nc && rows[c] > 0.5f) & mine;
    }
    const int pbase = k * C + c0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) vmax[i] = -INFINITY;
    for (int g = 0; g < groups; ++g) {
      if (groups > 1) load_group(g, true);
      float t_in[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) t_in[i] = q[i].t;
#pragma unroll
      for (int w = 0; w < TILE_C / 32; ++w) {
        for (unsigned bits = live[w]; bits; bits &= bits - 1) {
          const int j = w * 32 + __ffs(bits) - 1;
          const float4 a = f4[j], b = f4[TILE_C + j], c = f4[2 * TILE_C + j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) Kind::test(q[i], a, b, c, rows, j, tmin, pbase + j);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (q[i].t < t_in[i]) vis[i] = visited;
        vmax[i] = fmaxf(vmax[i], term(g, i));
      }
      if (groups > 1) store_group(g);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) s_val[u & 1][part * n + i * slots + slot] = vmax[i];
  }
  if (SPLIT > 1) {
    // each ray's best over the sets: the nearest, then the earliest visit,
    // then the least pid (the lowest lane of the chunk). A candidate's t
    // does not depend on the ray's running best, only its acceptance does,
    // so this is the best of the lanes taken in visit and index order. The
    // staging buffers hold one set's rows, pid and visit at a time.
    float* s_rows = &s_stage[0][0];
    int* s_pid = reinterpret_cast<int*>(s_rows + 8 * n);
    int* s_vis = s_pid + n;
    for (int p = 1; p < SPLIT; ++p) {
      __syncthreads();
      if (part == p) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          Kind::store(q[i], s_rows, s_pid, n, i * slots + slot);
          s_vis[i * slots + slot] = vis[i];
        }
      }
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          Ray o = q[i];
          Kind::load_best(o, s_rows, s_pid, n, i * slots + slot);
          const int ov = s_vis[i * slots + slot];
          if (o.t < q[i].t ||
              (o.t == q[i].t && (ov < vis[i] || (ov == vis[i] && o.p < q[i].p)))) {
            q[i] = o;
            vis[i] = ov;
          }
        }
      }
    }
  }
  if (groups == 1) store_group(0);
  if (tid == 0) visits[blockIdx.x] = visited;
}

// The instance a tile takes: RPT rays a thread, SPLIT sets of threads,
// blocks of `threads` (whole warps a set). Up to 64 rays one ray a thread
// and four sets, up to 256 two rays and two sets, up to 512 two rays and
// one set, above four rays and one set (at most 256 threads: a tile of
// more than 1,024 rays goes in groups).
struct Shape {
  int rpt, split, threads;
};

int warps_of(int threads) { return (threads + 31) / 32 * 32; }

Shape shape_of(int tile) {
  if (tile <= 64) return {1, 4, 4 * warps_of(tile)};
  if (tile <= 256) return {2, 2, 2 * warps_of((tile + 1) / 2)};
  if (tile <= 512) return {2, 1, warps_of((tile + 1) / 2)};
  const int slots = warps_of((tile + 3) / 4);
  return {4, 1, slots < PK_MAX_THREADS ? slots : PK_MAX_THREADS};
}

using KernelFn = void (*)(const float*, const float*, int, const float*, const float*,
                          const float*, int, int, float, int, float*, int*, int*);

template <class Kind>
KernelFn kernel_for(const Shape& sh) {
  if (sh.rpt == 1) return packet_kernel<Kind, 1, 4>;
  if (sh.rpt == 4) return packet_kernel<Kind, 4, 1>;
  return sh.split == 2 ? packet_kernel<Kind, 2, 2> : packet_kernel<Kind, 2, 1>;
}

// kind: 0 quad, 1 triangle, 2 sphere
KernelFn kernel_of(int kind, const Shape& sh) {
  if (kind == 2) return kernel_for<Sphere>(sh);
  return kind == 1 ? kernel_for<Planar<true>>(sh) : kernel_for<Planar<false>>(sh);
}

int launch(int kind, const float* rays, const float* cap, int R, const float* pack,
           const float* lo, const float* hi, int K, int C, float tmin, int tile, float* out,
           int* pid, int* visits, void* stream) {
  if (R <= 0) return 0;
  if (K > MAX_CHUNKS || K < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(tile);
  const dim3 grid((R + tile - 1) / tile);
  kernel_of(kind, sh)<<<grid, sh.threads, K * sizeof(unsigned),
                        static_cast<cudaStream_t>(stream)>>>(
      rays, cap, R, pack, lo, hi, K, C, tmin, tile, out, pid, visits);
  return static_cast<int>(cudaGetLastError());
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
  return launch(triangle ? 1 : 0, rays, cap, R, pack, lo, hi, K, C, tmin, tile, out, pid,
                visits, stream);
}

extern "C" int crt_packet_sphere(const float* rays, const float* cap, int R,
                                 const float* pack, const float* lo,
                                 const float* hi, int K, int C, float tmin,
                                 int tile, float* out, int* pid, int* visits,
                                 void* stream) {
  return launch(2, rays, cap, R, pack, lo, hi, K, C, tmin, tile, out, pid, visits, stream);
}

// What a launch at this tile and chunk count takes (kind: 0 quad, 1
// triangle, 2 sphere): info = {registers per thread, threads per block,
// rays per thread, threads per ray, resident blocks per SM}. Returns a
// cudaError_t.
extern "C" int crt_packet_info(int kind, int tile, int K, int* info) {
  if (K > MAX_CHUNKS || K < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(tile);
  const KernelFn fn = kernel_of(kind, sh);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, sh.threads,
                                                      K * sizeof(unsigned));
  info[0] = attr.numRegs;
  info[1] = sh.threads;
  info[2] = sh.rpt;
  info[3] = sh.split;
  info[4] = blocks;
  return static_cast<int>(err);
}
