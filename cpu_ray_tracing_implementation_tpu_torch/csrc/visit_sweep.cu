// Per-ray visit-list sweep for Hopper (sm_90a): kernels K4, K7 and K8.
//
// K4 replaces cpu_ray_tracing_implementation_tpu/ops/pallas_sweep.py:_kernel
// (pallas_sweep.py:94-239). Plain version: ops/fused_sweep.py sweep_plain
// (its decomposition into the stages below: sweep_fold_plain); wrapper:
// ops/fused_sweep.py sweep.
//
// K7 and K8 sweep other rows:
//  - K7, the sub-tile sweep (CRT_SUBTILE; it replaces the XLA
//    _planar_sweep_sub / _sphere_sweep_sub, perray.py:567-638): rows of CS
//    lanes (any CS dividing 128, passed at run time), a table [K*G, F, CS]
//    of G = 128/CS slices of each chunk, one sub-tile a slot, pid =
//    sub-tile id * CS + lane (the global chunk-major index). The JAX
//    package tests P = 128/CS selected sub-tiles as one 128-lane row whose
//    lanes run sub-tile by sub-tile; the in-order fold over single
//    sub-tiles below gives that row's first-index minimum (the first
//    sub-tile attaining the minimum, and its first lane). Its own count,
//    scatter and tile stages (see "K7" below) and K4's fold at that width;
//    entry crt_subtile_sweep. Plain version: sweep_plain at that width;
//    wrapper fused_sweep.sweep_sub.
//  - K8, K4's four stages on quantized rows (CRT_SWEEP_Q16; it replaces the
//    XLA _planar_sweep_q16, perray.py:786-873): planar rows of 5 x 128 u32
//    words, each two u16 coordinates of the three points (corner,
//    corner + eu, corner + ev) in the chunk box's frame, with the chunk's
//    lo and scale [K, 3]. Stage 3 dequantizes a row once while deriving
//    its constants (corner = lo + q0 * scale, edges = (q1 - q0) * scale,
//    integer differences times the scale), stage 4 the winner's lane the
//    same way; every later operation is K4's on those floats. 2,560 bytes
//    a row against 4,608. Plain version: sweep_q16_plain; wrapper
//    fused_sweep.sweep_q16.
//
// Layouts are the Pallas kernel's: rays [R,8] f32 (org xyz, dir xyz, time,
// pad), ids [R,V] int32 (clipped to [0, K-1] here), nears [R,V] f32, best
// [R,8] f32, table [K,F,C] f32 with C = 128 for K4, C dividing 128 for K7
// (planar F = 9: corner, eu, ev; sphere F = 7: c0, c1, rad) -> out [R,8]
// f32. Best columns: planar t, unit
// normal xyz, u, v, mat, pid; sphere t, center xyz at ray time, rad, v
// (untouched), mat, pid. mat passes through; pid = id*C + lane in f32.
//
// What it computes, per ray and slot s in order: the slot's chunk row is
// intersected (the planar test of _planar_slot, quads or triangles, or the
// sphere test of _sphere_slot), each candidate within [tmin, t_run], t_run
// the running best t; the first-index minimum (t_c, lane) replaces the best
// when t_c < t_run and the slot's entry near < t_run.
//
// Design: work per visited slot, one chunk row per block. The old kernel
// (a warp per ray walking its V slots) left warps idle on sparse lists
// (sphereflake: 0.62 visits per ray of 16 slots) and derived every
// primitive's constants again for every (ray, primitive) pair, though
// they belong to the chunk (colonnade phase 1: 449,504 visits of 385
// rows). Four kernels and a memset, all on the caller's stream (C = 128,
// the row width of K4 and K8):
//   1. count, SLOTS slots a thread: each slot with near < t_in (t_in the
//      INPUT best t; NaN and inf nears drop out) takes its place in its
//      chunk's bucket. A block counts in shared memory, one atomic per
//      warp and chunk (__match_any_sync), then adds its non-zero counts to
//      the global ones (the atomics' old values are the block's bases).
//      The last block to finish (a ticket) scans the counts into bucket
//      offsets and tile offsets (a tile: up to 32 visits of one chunk).
//   2. scatter: each visited slot's index r*V+s goes to its bucket.
//   3. tile: a persistent grid, as many blocks as fit on the card at once
//      (sized without reading the visit count on the host); each block
//      walks a contiguous range of tiles. Per chunk row its C threads
//      read the F x C raw floats once and derive each primitive's
//      ray-independent constants into shared memory (planar: unit normal
//      and n.c, ev x w and w x eu with their dot products with the corner;
//      sphere: c0 with rad^2, c1 - c0). Lane v of each of the four warps
//      takes the tile's visit v; warp w tests primitives w, w+4, ..., so a
//      warp reads one primitive's constants at a time (a shared-memory
//      broadcast). The four partial first-index minima (t, lane), each
//      candidate within [tmin, t_in], meet in shared memory; the slot's
//      minimum goes out as 8 bytes. A test stops where its result is
//      decided: a plane whose t is out of range takes no edge tests, a
//      sphere missed no root. (A warp-uniform skip, skipping the divide
//      for planes behind the origin, two visits a lane and other loop
//      unrollings each measured slower: PERF.md.)
//   4. fold: a thread per ray folds its slots in order with the sequential
//      rule (accept when t_s < t_run and near_s < t_run) and re-derives the
//      winner's columns from (chunk, lane) with the same operations in the
//      same order, so every column is the sequential sweep's.
// Scratch (counts, offsets, the visit list, (t, lane) per slot) comes from
// the wrapper.
//
// Exactness (whatever the row width). The sequential sweep limits slot s's
// candidates to [tmin,
// t_run]; stage 3 limits them to [tmin, t_in], t_run <= t_in. Each
// primitive's candidate under the smaller limit is its candidate under the
// larger one when that is <= t_run, else none: planar t and the sphere's
// roots do not depend on the limit, and a sphere's nearer root t0 > t_run
// leaves t1 >= t0 > t_run too. So the sequential row minimum is stage 3's
// minimum m whenever m <= t_run, with the same first-index lane (every
// primitive tied at m is under both limits); when m > t_run the sequential
// row has no candidate, and m < t_run fails in the fold: both reject the
// slot. m == t_run is rejected by both. Ties across slots keep the earlier
// slot (strict <), as the sequential loop does.
//
// Rounding. The colonnade spans +-1,200 units and recentering starts only
// at 2,000, so the edge coefficients a = q.(ev x w) with q = o + t d - c,
// and the sphere's |o - c|^2, cancel. Every multiply and add is written
// with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into a
// multiply-add, in the plain version's left-to-right order; divisions and
// sqrtf are IEEE, and 1/|n| is rsqrtf, which torch.rsqrt runs on the card.
// The derived constants are the same operations on the same floats, so
// kernel and plain version round alike and give the same bits. Tensor
// cores do not fit: the per-pair dot products would have to round like
// __fmul_rn/__fadd_rn left to right, and TF32 (or 3xTF32) products and
// their wide accumulation do not.
//
// Bound: operations, counted from this source per (ray, primitive) of a
// slot the sequential sweep visits (a divide, square root or compare
// counted once, an integer op not at all). Planar: 14 for n.o, n.d, the
// numerator, their compares and the running minimum; 3 more (the divide
// and the range) where the plane lies ahead; 30 more (the two edge
// coefficients and the interior test) where its t lies in [tmin, t_run].
// Sphere: 26 up to the discriminant's sign and the running minimum; 9 more
// for the root (a square root, two sums, two divides, up to four
// compares) where the discriminant is positive. Per distinct row visited,
// the constants: planar 57 per primitive, sphere 4. chip_smoke.py counts
// these from its run (sweep_needs: the sequential sweep replayed) and
// prints the bound beside the count before this redesign (130 and 50 per
// pair, whatever the data). The bytes each input needs once (rays, lists,
// best in and out, the rows visited) are ~11 MB at colonnade phase 1, ~3 us
// at 3.35 TB/s; 36 MB at sphereflake's 160,000 rays.
//
// K7 (redesigned for Hopper after K4's stages on sub-tile rows: a tile
// block derived a CS-lane row and met its four warps, two barriers and a
// merge in shared memory, every 32 visits, each warp testing CS/4
// primitives between them; and its count kept one bucket a sub-tile, in
// global atomics above 8,192). Same memset, four kernels and scratch:
//   1. count and 2. scatter as K4's, bucketed by CHUNK (sub-tile id >>
//      log2 G): 2,015 buckets on the colonnade at every width, in shared
//      memory, against 257,920 sub-tiles at CS 1.
//   3. tile: a persistent grid as K4's, its tiles split among WARPS: a warp
//      walks a contiguous range of the chunk buckets' tiles, derives the
//      128 primitives' constants of each chunk it reaches once (four a
//      lane, into its own shared memory) and serves every sub-tile of that
//      chunk from them; lane v takes visit v of a tile and tests the CS
//      primitives of its own sub-tile's slice in order, so the slot's
//      first-index minimum stays in the lane: no merge and no block
//      barrier. Measured on the H100 (PERF.md section 6): a block sharing
//      its range among its four warps, a barrier pair a chunk, took 1.6x
//      this stage's time at CS 32 (its slowest block 1.8x its median);
//      ordering a block's visits by sub-tile (lanes reading one slice,
//      branching alike) lost 15%, padding the slices apart against bank
//      conflicts gained 1-3% (at the cost of occupancy here), limiting
//      each candidate to the lane's running minimum gained nothing.
//   4. fold: K4's, at the width passed at run time.
// One instance per row kind (quad, triangle, sphere) serves every width.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int CHUNK_C = 128;        // K4's and K8's row width; K7's divides it
constexpr int TILE = 32;            // visits per tile: a warp's lanes
constexpr int GROUP = 4;            // warps per tile block, each C / GROUP primitives
constexpr int TILE_THREADS = TILE * GROUP;
constexpr int RAY_THREADS = 256;    // threads per block of the other stages
constexpr int SLOTS = 4;            // slots per thread of the count
constexpr int SMEM_CHUNKS = 8192;   // up to this K a block counts in shared memory
constexpr int SCAN_PER = 8;         // chunks per thread in a round of the scan
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE_THREADS == CHUNK_C, "a tile block derives one primitive per thread");

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
__device__ __forceinline__ int clip_id(int id, int K) { return min(max(id, 0), K - 1); }

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

__device__ __forceinline__ Ray load_ray(const float* rays, int r) {
  const float4 a = reinterpret_cast<const float4*>(rays)[2 * r];
  const float4 b = reinterpret_cast<const float4*>(rays)[2 * r + 1];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

// Where the rows come from: a float table [K, F, C], or (K8) a quantized
// planar table [K, 5, C] of u32 words with the chunks' lo and scale [K, 3].
struct Rows {
  const float* table;
  const float* qlo;
  const float* qscale;
};

// Lane ``lane`` of row k as the F floats the tests read. A quantized row is
// dequantized: corner = lo + q0 * scale, eu = (q1 - q0) * scale, ev = (q2 -
// q0) * scale per axis, the u16 coordinates exact in f32 (the plain
// version's dequant_q16, operation for operation).
template <bool SPHERE, bool Q16>
__device__ __forceinline__ void load_row(const Rows& rows, int k, int lane, int C,
                                         float (&x)[SPHERE ? 7 : 9]) {
  if constexpr (Q16) {
    const unsigned* src =
        reinterpret_cast<const unsigned*>(rows.table) + (size_t)k * 5 * C + lane;
    float q[10];
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      const unsigned w = src[f * C];
      q[2 * f] = static_cast<float>(w >> 16);
      q[2 * f + 1] = static_cast<float>(w & 0xffffu);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = rows.qlo[3 * (size_t)k + a], sc = rows.qscale[3 * (size_t)k + a];
      x[a] = __fadd_rn(lo, __fmul_rn(q[a], sc));
      x[3 + a] = __fmul_rn(__fsub_rn(q[3 + a], q[a]), sc);
      x[6 + a] = __fmul_rn(__fsub_rn(q[6 + a], q[a]), sc);
    }
  } else {
    constexpr int F = SPHERE ? 7 : 9;
    const float* src = rows.table + (size_t)k * F * C + lane;
#pragma unroll
    for (int f = 0; f < F; ++f) x[f] = src[f * C];
  }
}

// A planar primitive's ray-independent constants: (unit normal, n.c),
// (ev x w, (ev x w).c), (w x eu, (w x eu).c), w = n / |n|^2.
struct Planar {
  float4 n, ew, we;
};

__device__ __forceinline__ Planar planar_constants(const float (&x)[9]) {
  const float cx = x[0], cy = x[1], cz = x[2];
  const float eux = x[3], euy = x[4], euz = x[5];
  const float evx = x[6], evy = x[7], evz = x[8];
  const float nx = sub(mul(euy, evz), mul(euz, evy));
  const float ny = sub(mul(euz, evx), mul(eux, evz));
  const float nz = sub(mul(eux, evy), mul(euy, evx));
  const float nn = add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz));
  const float inv_len = rsqrtf(clamp_min(nn, 1e-30f));
  const float unx = mul(nx, inv_len), uny = mul(ny, inv_len),
              unz = mul(nz, inv_len);
  const float inv_nn = 1.0f / clamp_min(nn, 1e-20f);
  const float wx = mul(nx, inv_nn), wy = mul(ny, inv_nn), wz = mul(nz, inv_nn);
  const float ewx = sub(mul(evy, wz), mul(evz, wy));   // ev x w
  const float ewy = sub(mul(evz, wx), mul(evx, wz));
  const float ewz = sub(mul(evx, wy), mul(evy, wx));
  const float wex = sub(mul(wy, euz), mul(wz, euy));   // w x eu
  const float wey = sub(mul(wz, eux), mul(wx, euz));
  const float wez = sub(mul(wx, euy), mul(wy, eux));
  return Planar{make_float4(unx, uny, unz, dot3(unx, uny, unz, cx, cy, cz)),
                make_float4(ewx, ewy, ewz, dot3(ewx, ewy, ewz, cx, cy, cz)),
                make_float4(wex, wey, wez, dot3(wex, wey, wez, cx, cy, cz))};
}

// an edge coefficient at t: e.o + t e.d - e.c
__device__ __forceinline__ float edge(const float4& e, const Ray& q, float t) {
  return sub(add(dot3(e.x, e.y, e.z, q.ox, q.oy, q.oz),
                 mul(t, dot3(e.x, e.y, e.z, q.dx, q.dy, q.dz))),
             e.w);
}

// one planar primitive's candidate t within [tmin, t_lim] (inf = miss).
// The edge coefficients are computed only where the plane's t is in range
// (the result is the same), and enter only compares with 0 and 1, where
// the plain version's clip to +-1e30 changes nothing, so they are tested
// unclipped.
template <bool TRIANGLE>
__device__ __forceinline__ float planar_t(const Planar& k, const Ray& q,
                                          float tmin, float t_lim) {
  const float o_n = dot3(k.n.x, k.n.y, k.n.z, q.ox, q.oy, q.oz);
  const float d_n = dot3(k.n.x, k.n.y, k.n.z, q.dx, q.dy, q.dz);
  const float t = sub(k.n.w, o_n) / d_n;  // used only where |n.d| > 1e-20
  if (!(fabsf(d_n) > 1e-20f && t >= tmin && t <= t_lim)) return inf();
  const float a = edge(k.ew, q, t);
  const float b = edge(k.we, q, t);
  const bool interior = TRIANGLE
      ? (a >= 0.f && b >= 0.f && add(a, b) <= 1.f)
      : (a >= 0.f && a <= 1.f && b >= 0.f && b <= 1.f);
  return interior ? t : inf();
}

// one moving sphere's candidate t within [tmin, t_lim] (inf = miss), from
// (c0, rad^2) and (c1 - c0, 0); fa = 4 d.d, two_a = 2 d.d
__device__ __forceinline__ float sphere_t(const float4& c0, const float4& dc,
                                          const Ray& q, float fa, float two_a,
                                          float tmin, float t_lim) {
  const float ocx = sub(q.ox, add(c0.x, mul(q.tm, dc.x)));
  const float ocy = sub(q.oy, add(c0.y, mul(q.tm, dc.y)));
  const float ocz = sub(q.oz, add(c0.z, mul(q.tm, dc.z)));
  const float b_q = mul(2.f, dot3(q.dx, q.dy, q.dz, ocx, ocy, ocz));
  const float c_q = sub(dot3(ocx, ocy, ocz, ocx, ocy, ocz), c0.w);
  const float disc = sub(mul(b_q, b_q), mul(fa, c_q));
  if (!(disc > 0.f)) return inf();
  const float sq = sqrtf(disc);
  const float t0 = sub(-b_q, sq) / two_a;
  const float t1 = add(-b_q, sq) / two_a;
  if (t0 >= tmin && t0 <= t_lim) return t0;
  return (t1 >= tmin && t1 <= t_lim) ? t1 : inf();
}

// Exclusive block-wide scans of two per-thread values; every thread gets
// its prefixes and the block's totals.
template <int THREADS>
__device__ __forceinline__ void block_scan2(int n, int t, int& ex_n, int& ex_t,
                                            int& tot_n, int& tot_t) {
  __shared__ int warp_n[THREADS / 32], warp_t[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int in = n, it = t;  // inclusive scans within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(FULL, in, off);
    const int b = __shfl_up_sync(FULL, it, off);
    if (lane >= off) {
      in += a;
      it += b;
    }
  }
  if (lane == 31) {
    warp_n[warp] = in;
    warp_t[warp] = it;
  }
  __syncthreads();
  ex_n = in - n;
  ex_t = it - t;
  tot_n = tot_t = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) {
      ex_n += warp_n[w];
      ex_t += warp_t[w];
    }
    tot_n += warp_n[w];
    tot_t += warp_t[w];
  }
  __syncthreads();  // the next call may overwrite warp_n
}

// Stage 1, SLOTS slots a thread, and the offsets in the last block to
// finish. A block counts its visits per chunk in shared memory (when K <=
// SMEM_CHUNKS; above that in the global counts directly), one atomic per
// warp and chunk; it then adds each of its non-zero counts to the global
// ones, four atomics in flight per thread, and a visit's place in its
// chunk's bucket is the block's base there plus its place in the block. It
// goes to the .y of the slot's 8 bytes. K4 and K8 bucket by the slot's id
// (K buckets); K7 (SUB) by its sub-tile's chunk, id (clipped to the KG
// sub-tiles) >> shift.
template <bool SUB>
__device__ __forceinline__ int bucket_of(int id, int K, int KG, int shift) {
  if constexpr (SUB) return clip_id(id, KG) >> shift;
  return clip_id(id, K);
}

template <bool SUB>
__global__ void __launch_bounds__(RAY_THREADS)
visit_sweep_count(const int* __restrict__ ids, const float* __restrict__ nears,
                  const float* __restrict__ best, int RV, int V, int K, int KG,
                  int shift, int* counts, unsigned* ticket, int* __restrict__ bucket_off,
                  int* __restrict__ tile_off, int2* __restrict__ slots) {
  extern __shared__ int local[];  // K block counts, then the block's bases
  const bool priv = K <= SMEM_CHUNKS;
  const int lane = threadIdx.x & 31;
  if (priv) {
    for (int k = threadIdx.x; k < K; k += RAY_THREADS) local[k] = 0;
    __syncthreads();
  }
  int* cnt = priv ? local : counts;
  int id[SLOTS], pos[SLOTS];
  bool vis[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = (blockIdx.x * SLOTS + j) * RAY_THREADS + threadIdx.x;
    vis[j] = i < RV && nears[i] < best[(size_t)(i / V) * 8];
    id[j] = vis[j] ? bucket_of<SUB>(ids[i], K, KG, shift) : 0;
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const unsigned vm = __ballot_sync(FULL, vis[j]);
    pos[j] = 0;
    if (vis[j]) {
      const unsigned peers = __match_any_sync(vm, id[j]);
      const int leader = __ffs(peers) - 1;
      if (lane == leader) pos[j] = atomicAdd(cnt + id[j], __popc(peers));
      pos[j] = __shfl_sync(peers, pos[j], leader) + __popc(peers & ((1u << lane) - 1u));
    }
  }
  if (priv) {
    __syncthreads();
    for (int k0 = threadIdx.x; k0 < K; k0 += 4 * RAY_THREADS) {
      int c[4], base[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * RAY_THREADS;
        c[j] = k < K ? local[k] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        base[j] = c[j] ? atomicAdd(counts + k0 + j * RAY_THREADS, c[j]) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c[j]) local[k0 + j * RAY_THREADS] = base[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    if (vis[j])
      slots[(blockIdx.x * SLOTS + j) * RAY_THREADS + threadIdx.x].y =
          pos[j] + (priv ? local[id[j]] : 0);

  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // exclusive scans of the counts and of the tiles per chunk, SCAN_PER
  // consecutive chunks a thread, RAY_THREADS * SCAN_PER a round
  int carry_n = 0, carry_t = 0;
  for (int first = 0; first < K; first += RAY_THREADS * SCAN_PER) {
    const int k0 = first + threadIdx.x * SCAN_PER;
    int c[SCAN_PER], n = 0, t = 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER; ++j) c[j] = k0 + j < K ? __ldcg(counts + k0 + j) : 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER; ++j) {
      n += c[j];
      t += (c[j] + TILE - 1) / TILE;
    }
    int on, ot, tot_n, tot_t;
    block_scan2<RAY_THREADS>(n, t, on, ot, tot_n, tot_t);
    on += carry_n;
    ot += carry_t;
#pragma unroll
    for (int j = 0; j < SCAN_PER; ++j) {
      if (k0 + j < K) {
        bucket_off[k0 + j] = on;
        tile_off[k0 + j] = ot;
      }
      on += c[j];
      ot += (c[j] + TILE - 1) / TILE;
    }
    carry_n += tot_n;
    carry_t += tot_t;
  }
  if (threadIdx.x == 0) {
    bucket_off[K] = carry_n;
    tile_off[K] = carry_t;
  }
}

// Stage 2, a thread per slot: each visited slot's index into its chunk's
// bucket.
template <bool SUB>
__global__ void __launch_bounds__(RAY_THREADS)
visit_sweep_scatter(const int* __restrict__ ids, const float* __restrict__ nears,
                    const float* __restrict__ best, int RV, int V, int K, int KG,
                    int shift, const int* __restrict__ bucket_off,
                    const int2* __restrict__ slots, int* __restrict__ visits) {
  const int i = blockIdx.x * RAY_THREADS + threadIdx.x;
  if (i < RV && nears[i] < best[(size_t)(i / V) * 8])
    visits[bucket_off[bucket_of<SUB>(ids[i], K, KG, shift)] + slots[i].y] = i;
}

// the chunk of tile ``tile``: the last k with tile_off[k] <= tile
__device__ __forceinline__ int chunk_of_tile(const int* __restrict__ tile_off, int K,
                                             int tile) {
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_off[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Stage 3: each visit's row minimum (t, lane) against the input best t. A
// tile is TILE visits of one chunk; lane v of every warp takes visit v,
// and warp w of the block primitives w, w + GROUP, ... (so a warp's
// threads read one primitive's constants at a time: a shared-memory
// broadcast); the GROUP partial minima meet in shared memory and the first
// warp takes their first-index minimum in order.
template <bool SPHERE, bool TRIANGLE, bool Q16>
__global__ void __launch_bounds__(TILE_THREADS)
visit_sweep_tile(const float* __restrict__ rays, const float* __restrict__ best,
                 const Rows rows, int V, int K, float tmin,
                 const int* __restrict__ bucket_off,
                 const int* __restrict__ tile_off,
                 const int* __restrict__ visits, int2* __restrict__ slots) {
  constexpr int C = CHUNK_C;
  constexpr int Q = SPHERE ? 2 : 3;  // float4 constants per primitive
  __shared__ float4 cst[C * Q];
  __shared__ float part_t[GROUP][TILE];
  __shared__ int part_j[GROUP][TILE];
  const int v = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int total = tile_off[K];
  const int begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;  // uniform across the block
  int k = chunk_of_tile(tile_off, K, begin);
  int row_k = -1;
  for (int tile = begin; tile < end; ++tile) {
    while (tile_off[k + 1] <= tile) ++k;  // chunks without visits hold no tile
    if (k != row_k) {  // uniform: derive the row's constants once
      __syncthreads();  // every thread is done with the last row's
      {
        float x[SPHERE ? 7 : 9];
        load_row<SPHERE, Q16>(rows, k, threadIdx.x, C, x);
        if constexpr (SPHERE) {
          cst[threadIdx.x * Q] = make_float4(x[0], x[1], x[2], mul(x[6], x[6]));
          cst[threadIdx.x * Q + 1] =
              make_float4(sub(x[3], x[0]), sub(x[4], x[1]), sub(x[5], x[2]), 0.f);
        } else {
          const Planar p = planar_constants(x);
          cst[threadIdx.x * Q] = p.n;
          cst[threadIdx.x * Q + 1] = p.ew;
          cst[threadIdx.x * Q + 2] = p.we;
        }
      }
      __syncthreads();
      row_k = k;
    }
    const int p = bucket_off[k] + (tile - tile_off[k]) * TILE + v;
    const bool has = p < bucket_off[k + 1];  // the bucket's last tile is partial
    float bt = inf();
    int bj = g;
    int i = 0;
    if (has) {
      i = visits[p];
      const int r = i / V;
      const Ray q = load_ray(rays, r);
      const float t_in = best[(size_t)r * 8];
      if constexpr (SPHERE) {
        const float a_q = dot3(q.dx, q.dy, q.dz, q.dx, q.dy, q.dz);
        const float fa = mul(4.f, a_q), two_a = mul(2.f, a_q);
#pragma unroll 4
        for (int j = g; j < C; j += GROUP) {
          const float t = sphere_t(cst[j * Q], cst[j * Q + 1], q, fa, two_a, tmin, t_in);
          if (t < bt) {
            bt = t;
            bj = j;
          }
        }
      } else {
#pragma unroll 4
        for (int j = g; j < C; j += GROUP) {
          const Planar pc{cst[j * Q], cst[j * Q + 1], cst[j * Q + 2]};
          const float t = planar_t<TRIANGLE>(pc, q, tmin, t_in);
          if (t < bt) {
            bt = t;
            bj = j;
          }
        }
      }
    }
    part_t[g][v] = bt;
    part_j[g][v] = bj;
    __syncthreads();
    if (g == 0 && has) {  // first-index minimum: lexicographic (t, lane)
#pragma unroll
      for (int w = 1; w < GROUP; ++w) {
        const float ot = part_t[w][v];
        const int oj = part_j[w][v];
        if (ot < bt || (ot == bt && oj < bj)) {
          bt = ot;
          bj = oj;
        }
      }
      slots[i] = make_int2(__float_as_int(bt), bj);
    }
    __syncthreads();  // part_t is read before the next tile writes it
  }
}

// K7's stage 3: each visit's first-index minimum (t, lane) over its
// sub-tile's CS = 128 >> shift primitives against the input best t. The
// buckets are chunks (2^shift sub-tiles each), and each WARP walks a
// contiguous range of their tiles: per chunk it reaches, it derives the
// chunk's 128 primitives' constants into its own shared memory (primitive
// p = sub-tile p >> (7 - shift), lane p & (CS - 1), at index p), then lane v
// takes visit v of each tile. Only __syncwarp orders the warp's writes and
// reads; no block barrier.
template <bool SPHERE, bool TRIANGLE>
__global__ void __launch_bounds__(TILE_THREADS)
subtile_sweep_tile(const float* __restrict__ rays, const float* __restrict__ best,
                   const Rows rows, const int* __restrict__ ids, int V, int K, int KG,
                   int shift, float tmin, const int* __restrict__ bucket_off,
                   const int* __restrict__ tile_off, const int* __restrict__ visits,
                   int2* __restrict__ slots) {
  constexpr int Q = SPHERE ? 2 : 3;  // float4 constants per primitive
  __shared__ float4 cst_warps[GROUP][Q][CHUNK_C];
  const int cs = CHUNK_C >> shift;
  const int v = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  float4 (*cst)[CHUNK_C] = cst_warps[w];
  const int total = tile_off[K];
  const long long warps = (long long)gridDim.x * GROUP;
  const long long gw = (long long)blockIdx.x * GROUP + w;
  const int begin = (int)(total * gw / warps);
  const int end = (int)(total * (gw + 1) / warps);
  if (begin >= end) return;  // uniform across the warp
  int k = chunk_of_tile(tile_off, K, begin);
  for (int seg = begin, seg_end; seg < end; seg = seg_end) {
    while (tile_off[k + 1] <= seg) ++k;  // chunks without visits hold no tile
    seg_end = min(end, tile_off[k + 1]);  // this chunk's tiles in the range
    __syncwarp();  // the warp is done with the last chunk's constants
    for (int p = v; p < CHUNK_C; p += TILE) {
      float x[SPHERE ? 7 : 9];
      load_row<SPHERE, false>(rows, (k << shift) + (p >> (7 - shift)), p & (cs - 1), cs,
                              x);
      if constexpr (SPHERE) {
        cst[0][p] = make_float4(x[0], x[1], x[2], mul(x[6], x[6]));
        cst[1][p] = make_float4(sub(x[3], x[0]), sub(x[4], x[1]), sub(x[5], x[2]), 0.f);
      } else {
        const Planar pc = planar_constants(x);
        cst[0][p] = pc.n;
        cst[1][p] = pc.ew;
        cst[2][p] = pc.we;
      }
    }
    __syncwarp();
    for (int tile = seg; tile < seg_end; ++tile) {
      const int p = bucket_off[k] + (tile - tile_off[k]) * TILE + v;
      if (p >= bucket_off[k + 1]) continue;  // the bucket's last tile is partial
      const int i = visits[p];
      const int r = i / V;
      const int base = (clip_id(ids[i], KG) - (k << shift)) * cs;  // its slice
      const Ray q = load_ray(rays, r);
      const float t_in = best[(size_t)r * 8];
      float bt = inf();
      int bj = 0;
      if constexpr (SPHERE) {
        const float a_q = dot3(q.dx, q.dy, q.dz, q.dx, q.dy, q.dz);
        const float fa = mul(4.f, a_q), two_a = mul(2.f, a_q);
#pragma unroll 4
        for (int j = 0; j < cs; ++j) {
          const float t = sphere_t(cst[0][base + j], cst[1][base + j], q, fa, two_a,
                                   tmin, t_in);
          if (t < bt) {
            bt = t;
            bj = j;
          }
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < cs; ++j) {
          const Planar pc{cst[0][base + j], cst[1][base + j], cst[2][base + j]};
          const float t = planar_t<TRIANGLE>(pc, q, tmin, t_in);
          if (t < bt) {
            bt = t;
            bj = j;
          }
        }
      }
      slots[i] = make_int2(__float_as_int(bt), bj);
    }
  }
}

// Stage 4: the in-order fold per ray and the winner's columns. The nears of
// a ray come as float4s where V is a multiple of 4 and they are aligned.
// The row width is C, or (C = 0, K7) ``width``; ids are clipped to K rows.
template <bool SPHERE, bool Q16, int C>
__global__ void __launch_bounds__(RAY_THREADS)
visit_sweep_fold(const float* __restrict__ rays, const int* __restrict__ ids,
                 const float* __restrict__ nears, const float* __restrict__ best,
                 const Rows rows, int R, int V, int K, int width,
                 const int2* __restrict__ slots, float* __restrict__ out) {
  const int r = blockIdx.x * RAY_THREADS + threadIdx.x;
  if (r >= R) return;
  const int c = C ? C : width;
  const float4 ba = reinterpret_cast<const float4*>(best)[2 * r];
  const float4 bb = reinterpret_cast<const float4*>(best)[2 * r + 1];
  float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
  int ws = -1, wl = 0;
  const size_t row = (size_t)r * V;
  auto fold = [&](int s, float near) {
    if (!(near < b[0])) return;  // near < t_run <= t_in: visited
    const int2 sl = slots[row + s];
    if (__int_as_float(sl.x) < b[0]) {
      b[0] = __int_as_float(sl.x);
      ws = s;
      wl = sl.y;
    }
  };
  if ((V & 3) == 0 && (reinterpret_cast<size_t>(nears) & 15) == 0) {
    const float4* n4 = reinterpret_cast<const float4*>(nears + row);
    for (int s = 0; s < V; s += 4) {
      const float4 n = n4[s >> 2];
      fold(s, n.x);
      fold(s + 1, n.y);
      fold(s + 2, n.z);
      fold(s + 3, n.w);
    }
  } else {
    for (int s = 0; s < V; ++s) fold(s, nears[row + s]);
  }
  if (ws >= 0) {
    const int id = clip_id(ids[row + ws], K);
    float x[SPHERE ? 7 : 9];
    load_row<SPHERE, Q16>(rows, id, wl, c, x);
    const Ray q = load_ray(rays, r);
    if constexpr (SPHERE) {
      b[1] = add(x[0], mul(q.tm, sub(x[3], x[0])));
      b[2] = add(x[1], mul(q.tm, sub(x[4], x[1])));
      b[3] = add(x[2], mul(q.tm, sub(x[5], x[2])));
      b[4] = fmaxf(x[6], 1e-20f);
    } else {
      const Planar p = planar_constants(x);
      b[1] = p.n.x;
      b[2] = p.n.y;
      b[3] = p.n.z;
      b[4] = clip_big(edge(p.ew, q, b[0]));
      b[5] = clip_big(edge(p.we, q, b[0]));
    }
    b[7] = add(mul(static_cast<float>(id), static_cast<float>(c)),
               static_cast<float>(wl));
  }
  reinterpret_cast<float4*>(out)[2 * r] = make_float4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<float4*>(out)[2 * r + 1] = make_float4(b[4], b[5], b[6], b[7]);
}

// blocks of a persistent tile grid: as many of ``kernel`` as fit on the
// card at once (``cached`` per device)
template <typename Kernel>
int resident_grid(Kernel kernel, int dev, int (&cached)[64]) {
  if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE_THREADS, 0);
  const int grid = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev >= 0 && dev < 64) cached[dev] = grid;
  return grid;
}

// Stages 3 and 4 of K4 (Q16 = false) or K8 (Q16 = true).
template <bool SPHERE, bool TRIANGLE, bool Q16>
cudaError_t launch_rows(const float* rays, const int* ids, const float* nears,
                        const float* best, const Rows& rows, int R, int V, int K,
                        float tmin, const int* bucket_off, const int* tile_off,
                        const int* visits, int2* slots, float* out, cudaStream_t st) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(visit_sweep_tile<SPHERE, TRIANGLE, Q16>, dev, cached);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  visit_sweep_tile<SPHERE, TRIANGLE, Q16><<<grid, TILE_THREADS, 0, st>>>(
      rays, best, rows, V, K, tmin, bucket_off, tile_off, visits, slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ray_blocks = (R + RAY_THREADS - 1) / RAY_THREADS;
  visit_sweep_fold<SPHERE, Q16, CHUNK_C><<<ray_blocks, RAY_THREADS, 0, st>>>(
      rays, ids, nears, best, rows, R, V, K, CHUNK_C, slots, out);
  return cudaGetLastError();
}

// Stages 3 and 4 of K7 (KG sub-tile rows of 128 >> shift lanes, K chunks).
template <bool SPHERE, bool TRIANGLE>
cudaError_t launch_sub(const float* rays, const int* ids, const float* nears,
                       const float* best, const Rows& rows, int R, int V, int K, int KG,
                       int shift, float tmin, const int* bucket_off, const int* tile_off,
                       const int* visits, int2* slots, float* out, int stages,
                       cudaStream_t st) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(subtile_sweep_tile<SPHERE, TRIANGLE>, dev, cached);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  subtile_sweep_tile<SPHERE, TRIANGLE><<<grid, TILE_THREADS, 0, st>>>(
      rays, best, rows, ids, V, K, KG, shift, tmin, bucket_off, tile_off, visits, slots);
  if ((err = cudaGetLastError()) != cudaSuccess || stages < 4) return err;
  const int ray_blocks = (R + RAY_THREADS - 1) / RAY_THREADS;
  visit_sweep_fold<SPHERE, false, 0><<<ray_blocks, RAY_THREADS, 0, st>>>(
      rays, ids, nears, best, rows, R, V, KG, CHUNK_C >> shift, slots, out);
  return cudaGetLastError();
}

// The memset and stages 1 and 2 (bucketed by id, or by K7's chunks), then,
// up to ``stages`` (0 the memset alone, 1 with the count, 2 with the
// scatter, 3 with the tile stage, 4 all), K4's or K8's stages 3 and 4, or
// (SUB) K7's. Scratch layout: crt_visit_sweep's note.
template <bool SUB>
cudaError_t sweep_stages(const float* rays, const int* ids, const float* nears,
                         const float* best, const Rows& rows, int R, int V, int K,
                         int KG, int shift, float tmin, bool triangle, bool sphere,
                         bool q16, int* scratch, float* out, int stages,
                         cudaStream_t st) {
  if (R <= 0) return cudaSuccess;
  const size_t RV = (size_t)R * V;
  int2* slots = reinterpret_cast<int2*>(scratch);
  int* visits = scratch + 2 * RV;
  int* counts = visits + RV;
  unsigned* ticket = reinterpret_cast<unsigned*>(counts + K);
  int* bucket_off = counts + K + 1;
  int* tile_off = bucket_off + K + 1;
  cudaError_t err = cudaMemsetAsync(counts, 0, (K + 1) * sizeof(int), st);
  if (err != cudaSuccess || stages < 1) return err;
  const int slot_blocks = (int)((RV + RAY_THREADS - 1) / RAY_THREADS);
  const int count_blocks = (int)((RV + SLOTS * RAY_THREADS - 1) / (SLOTS * RAY_THREADS));
  const size_t local = K <= SMEM_CHUNKS ? K * sizeof(int) : 0;
  if (RV > 0) {
    visit_sweep_count<SUB><<<count_blocks, RAY_THREADS, local, st>>>(
        ids, nears, best, (int)RV, V, K, KG, shift, counts, ticket, bucket_off,
        tile_off, slots);
    if ((err = cudaGetLastError()) != cudaSuccess || stages < 2) return err;
    visit_sweep_scatter<SUB><<<slot_blocks, RAY_THREADS, 0, st>>>(
        ids, nears, best, (int)RV, V, K, KG, shift, bucket_off, slots, visits);
    err = cudaGetLastError();
  } else {  // no slots: no tile
    err = cudaMemsetAsync(bucket_off, 0, 2 * (K + 1) * sizeof(int), st);
  }
  if (err != cudaSuccess || stages < 3) return err;
  if constexpr (SUB) {
    if (sphere)
      return launch_sub<true, false>(rays, ids, nears, best, rows, R, V, K, KG, shift,
                                     tmin, bucket_off, tile_off, visits, slots, out,
                                     stages, st);
    if (triangle)
      return launch_sub<false, true>(rays, ids, nears, best, rows, R, V, K, KG, shift,
                                     tmin, bucket_off, tile_off, visits, slots, out,
                                     stages, st);
    return launch_sub<false, false>(rays, ids, nears, best, rows, R, V, K, KG, shift,
                                    tmin, bucket_off, tile_off, visits, slots, out,
                                    stages, st);
  } else {
    if (q16)
      return triangle
          ? launch_rows<false, true, true>(rays, ids, nears, best, rows, R, V, K, tmin,
                                           bucket_off, tile_off, visits, slots, out, st)
          : launch_rows<false, false, true>(rays, ids, nears, best, rows, R, V, K, tmin,
                                            bucket_off, tile_off, visits, slots, out, st);
    if (sphere)
      return launch_rows<true, false, false>(rays, ids, nears, best, rows, R, V, K, tmin,
                                             bucket_off, tile_off, visits, slots, out, st);
    if (triangle)
      return launch_rows<false, true, false>(rays, ids, nears, best, rows, R, V, K, tmin,
                                             bucket_off, tile_off, visits, slots, out, st);
    return launch_rows<false, false, false>(rays, ids, nears, best, rows, R, V, K, tmin,
                                            bucket_off, tile_off, visits, slots, out, st);
  }
}

}  // namespace

// Plain C interface for ctypes. scratch holds 3*R*V + 3*K + 3 int32 (the
// wrapper's fused_sweep.scratch_ints, K the buckets: chunks): (t, lane) per
// slot as 2*R*V ints, the visit list (R*V), the counts (K) and the
// last-block ticket (1), the bucket offsets (K+1) and the tile offsets
// (K+1). Each returns the first CUDA error of the memset and the four
// launches (0 = success), or cudaErrorInvalidValue for rows it does not
// take; nothing synchronises.

// K4 (q16 = 0): table [K, F, 128] f32, qlo and qscale unused. K8 (q16 = 1,
// planar): table [K, 5, 128] u32 words, qlo and qscale [K, 3] f32.
extern "C" int crt_visit_sweep(const float* rays, const int* ids,
                               const float* nears, const float* best,
                               const float* table, const float* qlo,
                               const float* qscale, int R, int V, int K, int C,
                               float tmin, int triangle, int sphere, int q16,
                               int* scratch, float* out, void* stream) {
  if (C != CHUNK_C || (q16 && sphere)) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{table, qlo, qscale};
  return static_cast<int>(sweep_stages<false>(
      rays, ids, nears, best, rows, R, V, K, K, 0, tmin, triangle != 0, sphere != 0,
      q16 != 0, scratch, out, 4, static_cast<cudaStream_t>(stream)));
}

// K7: table [KG, F, CS] f32, CS = 128 >> shift (shift 0..7), KG a multiple
// of 2^shift (KG >> shift chunks, the buckets); ``stages`` as sweep_stages
// (4 for the sweep; fewer only to time the stages apart).
extern "C" int crt_subtile_sweep(const float* rays, const int* ids, const float* nears,
                                 const float* best, const float* table, int R, int V,
                                 int KG, int shift, float tmin, int triangle, int sphere,
                                 int* scratch, float* out, int stages, void* stream) {
  if (shift < 0 || shift > 7 || KG <= 0 || (KG & ((1 << shift) - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{table, nullptr, nullptr};
  return static_cast<int>(sweep_stages<true>(
      rays, ids, nears, best, rows, R, V, KG >> shift, KG, shift, tmin, triangle != 0,
      sphere != 0, false, scratch, out, stages, static_cast<cudaStream_t>(stream)));
}
