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
//  - K8, the quantized-row sweep (CRT_SWEEP_Q16; it replaces the XLA
//    _planar_sweep_q16, perray.py:786-873): planar rows of 5 x 128 u32
//    words, each two u16 coordinates of the three points (corner,
//    corner + eu, corner + ev) in the chunk box's frame, with the chunk's
//    lo and scale [K, 3]. K4's count, scatter and fold, and a tile stage
//    of its own that skips groups of primitives by their boxes (see "K8"
//    below). A row is dequantized once while its constants are derived
//    (corner = lo + q0 * scale, edges = (q1 - q0) * scale, integer
//    differences times the scale), the winner's lane in the fold the same
//    way; every later operation is K4's on those floats. 2,560 bytes a row
//    against 4,608. Plain version: sweep_q16_plain; wrapper
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
//
// K8 (redesigned for Hopper after K4's stages on quantized rows, whose tile
// stage tested all 128 primitives of every visited row and met its four
// warps in shared memory every 32 visits: 0.82 of its time). Same memset,
// count, scatter and fold as K4; then, as stage 3, two kernels:
//   - q16_derive, the row stage: a block per chunk with visits derives its
//     128 primitives' constants (load_row's and planar_constants'
//     operations, so the same bits) and the box of each group of 32 (G = 4
//     a row; a warp each): the integer min and max per axis of the group's
//     u16 points (q0, q1, q2 and, for quads, q1 + q2 - q0), one warp
//     reduction each, dequantized as lo + q * scale, with a pad per axis
//     (below). Primitives whose float normal n = eu x ev is zero are left
//     out of the boxes: with n = 0 the unit normal is 0, so |n.d| > 1e-20
//     fails and they are never hit (the inactive lanes, quantized with
//     three equal points, are such); a group of them only is flagged and
//     skipped by the whole warp. Into the scratch, once a row.
//   - q16_sweep_tile: a warp a tile, lane v taking visit v and testing
//     primitives 0..127 in order, its first-index minimum kept in the lane:
//     no block barrier, no merge. The row's constants and boxes are read
//     from the row stage's output, the same address in every lane (one
//     read a warp, through the read-only cache). Before a group each lane
//     slab-tests the padded box for its ray (the reciprocal 1/d per
//     component in IEEE division, once a visit; a zero or subnormal
//     component takes +-inf, the sign of d: then (lo - o) * inv is +-inf,
//     and NaN only for a ray in the plane of a padded face, where fminf /
//     fmaxf drop it and the axis admits no t, which is exact because no hit
//     point lies on a padded face, below). A lane enters when exit >= tmin
//     and entry <= its limit, the smaller of t_in and its running minimum
//     so far, and tests nothing in a group it does not enter; the warp
//     skips a group no lane enters (__any_sync). Its candidates are limited
//     to that limit too. The tiles are claimed, not split into ranges: a
//     warp claims a run of consecutive tiles, its length what was left at
//     its last claim over twice the warps (at least 1: guided
//     self-scheduling), with an atomic add on the count stage's ticket; the
//     row stage gives each tile's chunk and slots.
// Measured on the H100 (PERF.md section 6), each step against the last:
// with a contiguous range of tiles a warp (as K7's) and its rows derived
// in its own shared memory, the skip made tiles unequal (the median warp
// done at 89 us, the slowest at 190, which the stage waited for); claimed
// tiles balanced the warps but put a row's derivation in nearly every tile
// (15,083 for 15,108 tiles), which the row stage does once a row (311 at
// colonnade phase 1); an isotropic pad (growing with S on every axis) left
// the colonnade's groups of column sides unskipped. Groups of 16
// primitives, the limit t_in alone, and the next tile's visits loaded
// during the current one measured no faster.
//
// K8's skip is exact. Every t that planar_t accepts lies in the group's
// padded [entry, exit] as the lane computes it (the lemma below). A group
// the lane does not enter therefore holds no candidate t >= tmin with t <=
// t_in, and none with t < its running minimum bt: entry > bt means every
// candidate there has t > bt, which the strict t < bt of the in-order
// minimum rejects, as it rejects t == bt of a later lane (the first index
// wins). Limiting candidates to min(t_in, bt) rejects only such t. So the
// lane's (t, lane) is the row's first-index minimum over [tmin, t_in], K4's
// stage 3 result, and the exactness note above carries over. Rays with a
// non-finite component accept no finite t (the plane or edge terms turn
// inf or NaN and fail their compares), and t = inf never lowers a minimum.
//
// The pad (lemma). Let c, eu, ev be a primitive's dequantized floats,
// n* = eu x ev exactly, S = |eu| |ev| / |n*| (1 / sin of their angle), L =
// |eu| + |ev|, and per axis i r_i = |eu_i| / |eu|, s_i = |ev_i| / |ev|,
// nu_i = |n*_i| / |n*|; R = max |o_i| of the ray's origin, B the largest
// magnitude of the group box's corners and of the chunk's lo, u = 2^-24.
// With float rounding at every multiply and add (__fmul_rn etc., no
// contraction):
//   - the computed normal n is within 2.5 u |eu| |ev| of n*, so its
//     direction within 2.5 u S; w = n / |n|^2 (with |n|^2 >= 1e-20: the
//     case below it ends this note) then has w.n* within 2.5 u S
//     + 5 u of 1, and the rounded cross products ev x w, w x eu are off by
//     at most 1.5 u S in units of the edges: the computed frame reads the
//     point c + alpha eu + beta ev as an a within (4 u S + 5 u) |alpha| +
//     1.5 u S |beta| |ev| / |eu| of alpha, and b likewise;
//   - t = (n.c - n.o) / n.d leaves the point p = o + t d (exact) within
//     5.1 u M of the computed plane, M = |o| + |t d| + |c|, whatever n.d
//     (the errors of the numerator and of n.d both scale with t n.d), so
//     within that plus 2.5 u S |p - c| of the exact one;
//   - a = (ev x w).(p - c) is evaluated within 4.1 u |ev x w| M + u, and
//     |ev x w| |eu| = S; b likewise, with |w x eu| |ev| = S.
// Write p - q = (alpha - a) eu + (beta - b) ev + gamma n*/|n*| (the exact
// frame), where the accepted (a, b) name the point q = c + a eu + b ev of
// the primitive. Per axis, with M <= sqrt 3 (2 R + 2 B) + X, X = |p - q|:
// |p_i - q_i| <= u S (r_i + s_i) (14.3 (R + B) + 11.5 L) + nu_i u (17.7 (R
// + B) + 2.5 S L) + kappa_i X, kappa_i <= 7.6 u S (r_i + s_i + nu_i). Summing
// over the axes bounds X by 1.02 u S (94 (R + B) + 61 L) + 43 u (R + B)
// while S <= Q16_MAX_SKEW = 8192 (the sum of the kappa_i stays below 0.02),
// so kappa_i X <= u S (r_i + s_i + nu_i) (0.35 (R + B) + 0.23 L) there. The
// group box holds q up to the rounding of the dequantization (6 u B: a
// corner is lo + q0 * scale rounded twice, an edge (q1 - q0) * scale once).
// The slab test computes each face's t as ((lo - pad) - o) * (1 / d), three
// roundings: the exact t of the face moved inward by at most 3.01 u |lo -
// pad - o|; the padded face itself is rounded once. So p lies inside the
// box as the lane tests it, and t in [entry, exit], whenever on every axis
//   pad_i >= u S (r_i + s_i) (18.1 (R + B) + 11.8 L) + u S nu_i (0.35 (R +
//            B) + 2.73 L) + 31.8 u (R + B) + 5 u pad_i.
// Its terms grow with S only along the edges (r_i, s_i) and, through the
// tilt of the computed plane, along the normal (nu_i): the colonnade's
// column sides, 500 units long and 0.09 wide (S up to 6,045), err along
// their length, not across it. K8 pads axis i by
//   u (64 S (r_i + s_i) (R + B + L) + 8 S nu_i L + S nu_i (R + B) + 128 (R +
//   B)),
// each term over 2.8 times what it covers. Per group the warp keeps the
// maxima A_i of 64 S (r_i + s_i) + S nu_i + 128 and D_i of (64 S (r_i + s_i)
// + 8 S nu_i) L over its live primitives, C_i = u (A_i B + D_i), and a lane
// pads axis i by C_i + u A_i R. A group holding a primitive with S > 8192
// (or S^2 not finite: |n|^2 underflowed) gets an infinite pad and is never
// skipped. So does one holding a primitive whose computed |n|^2 is below
// 1e-20, where the lemma's w = n / |n|^2 does not hold: planar_constants
// (and the plain version) divide by max(|n|^2, 1e-20), which shrinks a and
// b by |n|^2 / 1e-20, so planar_t accepts the primitive scaled about its
// corner by 1e-20 / |n|^2 (a one-quantum triangle of a chunk 0.01 wide,
// |n|^2 ~ 5e-28, is hit ~3 units from its corner), far outside its box.
// S stays near 1 there, so the skew limit alone would not catch it.
// fused_sweep.q16_group_boxes builds the same boxes in PyTorch:
// tests/test_torch_cuda.py holds the row stage's boxes, pads and flags to
// them bit for bit, and tests/test_torch_sweep.py every candidate of the
// plain slot test inside them, on grazing and axis-aligned rays and on
// quantum-wide primitives.

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
// K8's tile stage (see "K8" above): a group box per warp's worth of
// primitives (G = 4 a row), the pad's factor, and the S above which a
// group is never skipped
constexpr int Q16_GROUPS = CHUNK_C / TILE;
constexpr float Q16_U = 1.0f / 16777216.0f;  // u = 2^-24, the pad's unit
constexpr float Q16_MAX_SKEW = 8192.f;

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

// The u16 coordinates q0 xyz, q1 xyz, q2 xyz of a primitive's five words.
__device__ __forceinline__ void q16_unpack(const unsigned (&w)[5], int (&q)[9]) {
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    q[2 * f] = static_cast<int>(w[f] >> 16);
    if (f < 4) q[2 * f + 1] = static_cast<int>(w[f] & 0xffffu);
  }
}

// The words of lane ``lane`` of quantized row k.
__device__ __forceinline__ void q16_words(const Rows& rows, int k, int lane, int C,
                                          unsigned (&w)[5]) {
  const unsigned* src =
      reinterpret_cast<const unsigned*>(rows.table) + (size_t)k * 5 * C + lane;
#pragma unroll
  for (int f = 0; f < 5; ++f) w[f] = src[f * C];
}

// Dequantized: corner = lo + q0 * scale, eu = (q1 - q0) * scale, ev = (q2 -
// q0) * scale per axis, the u16 coordinates exact in f32 (the plain
// version's dequant_q16, operation for operation).
__device__ __forceinline__ void q16_dequant(const Rows& rows, int k, const int (&q)[9],
                                            float (&x)[9]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = rows.qlo[3 * (size_t)k + a], sc = rows.qscale[3 * (size_t)k + a];
    const float q0 = static_cast<float>(q[a]);
    x[a] = __fadd_rn(lo, __fmul_rn(q0, sc));
    x[3 + a] = __fmul_rn(__fsub_rn(static_cast<float>(q[3 + a]), q0), sc);
    x[6 + a] = __fmul_rn(__fsub_rn(static_cast<float>(q[6 + a]), q0), sc);
  }
}

// Lane ``lane`` of row k as the F floats the tests read; a quantized row
// dequantized.
template <bool SPHERE, bool Q16>
__device__ __forceinline__ void load_row(const Rows& rows, int k, int lane, int C,
                                         float (&x)[SPHERE ? 7 : 9]) {
  if constexpr (Q16) {
    unsigned w[5];
    int q[9];
    q16_words(rows, k, lane, C, w);
    q16_unpack(w, q);
    q16_dequant(rows, k, q, x);
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
template <bool SPHERE, bool TRIANGLE>
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
        load_row<SPHERE, false>(rows, k, threadIdx.x, C, x);
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

// K8's stage 3 (see "K8" above). The group box of the 32 primitives p =
// base + lane of row k (q: the lane's u16 coordinates, x: its dequantized
// floats): box = ((lo xyz, A.x), (hi xyz, A.y), (C xyz, A.z)), a ray with
// origin magnitude R padding axis i by C_i + A_i R; returns whether the
// group holds a primitive with a non-zero normal (warp-uniform).
template <bool TRIANGLE>
__device__ __forceinline__ bool q16_group_box(const Rows& rows, int k, const int (&q)[9],
                                              const float (&x)[9], float4 (&box)[3]) {
  constexpr int BIGQ = 1 << 30;
  const float eux = x[3], euy = x[4], euz = x[5], evx = x[6], evy = x[7], evz = x[8];
  const float nx = sub(mul(euy, evz), mul(euz, evy));
  const float ny = sub(mul(euz, evx), mul(eux, evz));
  const float nz = sub(mul(eux, evy), mul(euy, evx));
  const bool live = nx != 0.f || ny != 0.f || nz != 0.f;
  // S = |eu| |ev| / |n| (at least 1); a primitive beyond Q16_MAX_SKEW (S^2
  // inf or NaN too: |n|^2 underflowed), or whose |n|^2 (planar_constants'
  // bits) lies below the 1e-20 that w = n / |n|^2 clamps it to, makes its
  // group unskippable
  const float nn = dot3(nx, ny, nz, nx, ny, nz);
  const float uu = dot3(eux, euy, euz, eux, euy, euz);
  const float vv = dot3(evx, evy, evz, evx, evy, evz);
  const float ratio = mul(uu, vv) / nn;
  const bool ill = live && (!(ratio <= Q16_MAX_SKEW * Q16_MAX_SKEW) || nn < 1e-20f);
  const bool ok = live && !ill;
  const float skew = sqrtf(fmaxf(ratio, 1.f));
  const float lu = sqrtf(uu), lv = sqrtf(vv), ln = sqrtf(nn), len = add(lu, lv);
  // the pad's terms in units of u (see "The pad"): A_i = 64 S (r_i + s_i) +
  // S nu_i + 128 and D_i = (64 S (r_i + s_i) + 8 S nu_i) L, maxima over the
  // group as non-negative floats (their bits order as ints)
  const float eu_a[3] = {eux, euy, euz}, ev_a[3] = {evx, evy, evz}, n_a[3] = {nx, ny, nz};
  float pa[3], pd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float srs = mul(skew, add(fabsf(eu_a[a]) / lu, fabsf(ev_a[a]) / lv));
    const float snu = mul(skew, fabsf(n_a[a]) / ln);
    const float ta = ok ? add(add(mul(64.f, srs), snu), 128.f) : 0.f;
    const float td = ok ? mul(add(mul(64.f, srs), mul(8.f, snu)), len) : 0.f;
    pa[a] = __int_as_float(__reduce_max_sync(FULL, __float_as_int(ta)));
    pd[a] = __int_as_float(__reduce_max_sync(FULL, __float_as_int(td)));
  }
  int lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int mn = min(q[a], min(q[3 + a], q[6 + a]));
    int mx = max(q[a], max(q[3 + a], q[6 + a]));
    if constexpr (!TRIANGLE) {  // the fourth corner, q1 + q2 - q0
      const int q3 = q[3 + a] + q[6 + a] - q[a];
      mn = min(mn, q3);
      mx = max(mx, q3);
    }
    lo[a] = __reduce_min_sync(FULL, live ? mn : BIGQ);
    hi[a] = __reduce_max_sync(FULL, live ? mx : -BIGQ);
  }
  const bool g_live = __any_sync(FULL, live);
  const bool g_ill = __any_sync(FULL, ill);
  if ((threadIdx.x & 31) == 0 && g_live) {
    float bl[3], bh[3], B = 0.f, A[3], C[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l = rows.qlo[3 * (size_t)k + a], sc = rows.qscale[3 * (size_t)k + a];
      bl[a] = add(l, mul(static_cast<float>(lo[a]), sc));
      bh[a] = add(l, mul(static_cast<float>(hi[a]), sc));
      B = fmaxf(B, fmaxf(fabsf(l), fmaxf(fabsf(bl[a]), fabsf(bh[a]))));
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {  // pad_i = u (A_i (R + B) + D_i) = C_i + A_i R
      A[a] = g_ill ? 0.f : mul(Q16_U, pa[a]);
      C[a] = g_ill ? inf() : mul(Q16_U, add(mul(pa[a], B), pd[a]));
    }
    box[0] = make_float4(bl[0], bl[1], bl[2], A[0]);
    box[1] = make_float4(bh[0], bh[1], bh[2], A[1]);
    box[2] = make_float4(C[0], C[1], C[2], A[2]);
  }
  return g_live;
}

// 1/d in IEEE division for a normal d; +-inf (the sign of d) for a zero or
// subnormal one
__device__ __forceinline__ float q16_recip(float d) {
  return fabsf(d) >= 1.17549435e-38f ? 1.0f / d : copysignf(inf(), d);
}

// K8's row stage, before its tile stage: a block per chunk with visits
// derives the row's constants (one primitive a thread, load_row's and
// planar_constants' operations, so the same bits) and its four group boxes
// (a warp each) into the scratch: cst [K, 3, 128] float4, boxes [K, G, 3]
// float4, a flag per group, set where it holds a primitive that can be
// hit, and for each of its tiles (chunk, first slot, slots).
template <bool TRIANGLE>
__global__ void __launch_bounds__(CHUNK_C)
q16_derive(const Rows rows, const int* __restrict__ bucket_off,
           const int* __restrict__ tile_off, float4* __restrict__ cst,
           float4* __restrict__ boxes, int* __restrict__ live, int4* __restrict__ tiles) {
  const int k = blockIdx.x;
  const int b0 = bucket_off[k], b1 = bucket_off[k + 1];
  if (b0 == b1) return;  // no visit: the row is never read
  const int p = threadIdx.x;
  for (int t = tile_off[k] + p, t0 = tile_off[k]; t < tile_off[k + 1]; t += CHUNK_C) {
    const int first = b0 + (t - t0) * TILE;  // each tile: (chunk, first slot, slots)
    tiles[t] = make_int4(k, first, min(TILE, b1 - first), 0);
  }
  unsigned wd[5];
  int q[9];
  float x[9];
  q16_words(rows, k, p, CHUNK_C, wd);
  q16_unpack(wd, q);
  q16_dequant(rows, k, q, x);
  const Planar pc = planar_constants(x);
  float4* c = cst + (size_t)k * 3 * CHUNK_C;
  c[p] = pc.n;
  c[CHUNK_C + p] = pc.ew;
  c[2 * CHUNK_C + p] = pc.we;
  float4 box[3];
  const bool g_live = q16_group_box<TRIANGLE>(rows, k, q, x, box);
  const int g = (size_t)k * Q16_GROUPS + (p >> 5);
  if ((p & 31) == 0) {
    live[g] = g_live;
    if (g_live) {
      boxes[3 * (size_t)g] = box[0];
      boxes[3 * (size_t)g + 1] = box[1];
      boxes[3 * (size_t)g + 2] = box[2];
    }
  }
}

// K8's tile stage: each visit's first-index minimum (t, lane) over its
// quantized row against the input best t. The warps share the tiles by
// guided self-scheduling: a warp claims a run of consecutive tiles, a share
// of what was left at its last claim over twice the warps (at least one
// tile), by an atomic add on the count stage's ticket, which that stage
// leaves at its block count ``base``. Lane v takes visit v of each tile
// (the row stage gives its chunk and slots) and reads the row's constants
// and boxes from the row stage's output, the same address in every lane
// (one read a warp, through the read-only cache), skipping the groups its
// ray does not enter.
template <bool TRIANGLE>
__global__ void __launch_bounds__(TILE_THREADS)
q16_sweep_tile(const float* __restrict__ rays, const float* __restrict__ best, int V, int K,
               float tmin, const int* __restrict__ tile_off,
               const int* __restrict__ visits, const float4* __restrict__ cst,
               const float4* __restrict__ boxes, const int* __restrict__ live_g,
               const int4* __restrict__ tiles, unsigned* ticket, unsigned base,
               int2* __restrict__ slots) {
  const int v = threadIdx.x & 31;
  const int total = tile_off[K];
  const int warps = gridDim.x * GROUP;
  // a claim of lane 0: [start, start + n), broadcast by the caller
  auto claim = [&](int left, int& n) {
    n = max(1, left / (2 * warps));
    return (int)(atomicAdd(ticket, (unsigned)n) - base);
  };
  int start = 0, n = 0;
  if (v == 0) start = claim(total, n);
  start = __shfl_sync(FULL, start, 0);
  n = __shfl_sync(FULL, n, 0);
  while (start < total) {  // uniform across the warp
    int next = 0, next_n = 0;
    const int stop = min(total, start + n);
    for (int tile = start; tile < stop; ++tile) {
      const int4 ti = tiles[tile];
      const int k = ti.x;
      const int i = v < ti.z ? visits[ti.y + v] : -1;
      unsigned live = 0;  // the row's groups with a primitive that can be hit
#pragma unroll
      for (int g = 0; g < Q16_GROUPS; ++g)
        if (live_g[(size_t)k * Q16_GROUPS + g]) live |= 1u << g;
      const float4* ck = cst + (size_t)k * 3 * CHUNK_C;
      const float4* bk = boxes + (size_t)k * Q16_GROUPS * 3;
      const bool has = i >= 0;
      Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float t_in = 0.f;
      if (has) {
        ray = load_ray(rays, i / V);
        t_in = best[(size_t)(i / V) * 8];
      }
      const float ro = fmaxf(fabsf(ray.ox), fmaxf(fabsf(ray.oy), fabsf(ray.oz)));
      const float ix = q16_recip(ray.dx), iy = q16_recip(ray.dy), iz = q16_recip(ray.dz);
      float bt = inf();
      int bj = 0;
#pragma unroll 1
      for (int g = 0; g < Q16_GROUPS; ++g) {
        if (!((live >> g) & 1u)) continue;
        const float4 lo_g = bk[3 * g], hi_g = bk[3 * g + 1], cp_g = bk[3 * g + 2];  // uniform: no primitive there can be hit
        const float lim = fminf(t_in, bt);
        const float px = add(cp_g.x, mul(lo_g.w, ro)), py = add(cp_g.y, mul(hi_g.w, ro)),
                    pz = add(cp_g.z, mul(cp_g.w, ro));
        const float t0x = mul(sub(sub(lo_g.x, px), ray.ox), ix);
        const float t1x = mul(sub(add(hi_g.x, px), ray.ox), ix);
        const float t0y = mul(sub(sub(lo_g.y, py), ray.oy), iy);
        const float t1y = mul(sub(add(hi_g.y, py), ray.oy), iy);
        const float t0z = mul(sub(sub(lo_g.z, pz), ray.oz), iz);
        const float t1z = mul(sub(add(hi_g.z, pz), ray.oz), iz);
        const float entry = fmaxf(fminf(t0x, t1x), fmaxf(fminf(t0y, t1y), fminf(t0z, t1z)));
        const float leave = fminf(fmaxf(t0x, t1x), fminf(fmaxf(t0y, t1y), fmaxf(t0z, t1z)));
        const bool enter = has && leave >= tmin && entry <= lim;
        if (!__any_sync(FULL, enter)) continue;
        if (enter) {
#pragma unroll 4
          for (int j = g * TILE; j < (g + 1) * TILE; ++j) {
            const Planar pc{ck[j], ck[CHUNK_C + j], ck[2 * CHUNK_C + j]};
            const float t = planar_t<TRIANGLE>(pc, ray, tmin, lim);
            if (t < bt) {
              bt = t;
              bj = j;
            }
          }
        }
      }
      if (has) slots[i] = make_int2(__float_as_int(bt), bj);
    }
    if (v == 0) next = claim(total - start, next_n);
    start = __shfl_sync(FULL, next, 0);
    n = __shfl_sync(FULL, next_n, 0);
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

// K8's row stage output (the scratch after K4's layout; crt_visit_sweep's
// note)
struct Q16Scratch {
  float4* cst;
  float4* boxes;
  int* live;
  int4* tiles;
};

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

// Stages 3 and 4 of K4, up to ``stages``.
template <bool SPHERE, bool TRIANGLE>
cudaError_t launch_rows(const float* rays, const int* ids, const float* nears,
                        const float* best, const Rows& rows, int R, int V, int K,
                        float tmin, const int* bucket_off, const int* tile_off,
                        const int* visits, int2* slots, float* out, int stages,
                        cudaStream_t st) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(visit_sweep_tile<SPHERE, TRIANGLE>, dev, cached);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  visit_sweep_tile<SPHERE, TRIANGLE><<<grid, TILE_THREADS, 0, st>>>(
      rays, best, rows, V, K, tmin, bucket_off, tile_off, visits, slots);
  if ((err = cudaGetLastError()) != cudaSuccess || stages < 4) return err;
  const int ray_blocks = (R + RAY_THREADS - 1) / RAY_THREADS;
  visit_sweep_fold<SPHERE, false, CHUNK_C><<<ray_blocks, RAY_THREADS, 0, st>>>(
      rays, ids, nears, best, rows, R, V, K, CHUNK_C, slots, out);
  return cudaGetLastError();
}

// Stages 3 and 4 of K8: its row stage into ``q16``, q16_sweep_tile (its
// tiles claimed on ``ticket`` from ``base``) and K4's fold on quantized
// rows, up to ``stages``.
template <bool TRIANGLE>
cudaError_t launch_q16(const float* rays, const int* ids, const float* nears,
                       const float* best, const Rows& rows, int R, int V, int K,
                       float tmin, const int* bucket_off, const int* tile_off,
                       const int* visits, unsigned* ticket, unsigned base,
                       const Q16Scratch& q16, int2* slots, float* out, int stages,
                       cudaStream_t st) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(q16_sweep_tile<TRIANGLE>, dev, cached);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  q16_derive<TRIANGLE><<<K, CHUNK_C, 0, st>>>(rows, bucket_off, tile_off, q16.cst,
                                              q16.boxes, q16.live, q16.tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  q16_sweep_tile<TRIANGLE><<<grid, TILE_THREADS, 0, st>>>(
      rays, best, V, K, tmin, tile_off, visits, q16.cst, q16.boxes, q16.live, q16.tiles,
      ticket, base, slots);
  if ((err = cudaGetLastError()) != cudaSuccess || stages < 4) return err;
  const int ray_blocks = (R + RAY_THREADS - 1) / RAY_THREADS;
  visit_sweep_fold<false, true, CHUNK_C><<<ray_blocks, RAY_THREADS, 0, st>>>(
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
  // the ticket after the count: one per count block (0 without slots)
  const unsigned base = RV > 0 ? (unsigned)count_blocks : 0u;
  // K8's rows after that layout, from a 16-byte boundary (the wrapper
  // allocates them only for K8)
  float4* q16_cst = reinterpret_cast<float4*>(
      scratch + (((size_t)(tile_off + K + 1 - scratch) + 3) & ~(size_t)3));
  float4* q16_boxes = q16_cst + (size_t)K * 3 * CHUNK_C;
  int* q16_live = reinterpret_cast<int*>(q16_boxes + (size_t)K * Q16_GROUPS * 3);
  const Q16Scratch q16s{q16_cst, q16_boxes, q16_live,
                        reinterpret_cast<int4*>(q16_live + (size_t)K * Q16_GROUPS)};
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
          ? launch_q16<true>(rays, ids, nears, best, rows, R, V, K, tmin, bucket_off,
                             tile_off, visits, ticket, base, q16s, slots, out, stages, st)
          : launch_q16<false>(rays, ids, nears, best, rows, R, V, K, tmin, bucket_off,
                              tile_off, visits, ticket, base, q16s, slots, out, stages, st);
    if (sphere)
      return launch_rows<true, false>(rays, ids, nears, best, rows, R, V, K, tmin,
                                      bucket_off, tile_off, visits, slots, out, stages, st);
    if (triangle)
      return launch_rows<false, true>(rays, ids, nears, best, rows, R, V, K, tmin,
                                      bucket_off, tile_off, visits, slots, out, stages, st);
    return launch_rows<false, false>(rays, ids, nears, best, rows, R, V, K, tmin,
                                     bucket_off, tile_off, visits, slots, out, stages, st);
  }
}

}  // namespace

// Plain C interface for ctypes. scratch holds 3*R*V + 3*K + 3 int32 (the
// wrapper's fused_sweep.scratch_ints, K the buckets: chunks): (t, lane) per
// slot as 2*R*V ints, the visit list (R*V), the counts (K) and the
// last-block ticket (1), the bucket offsets (K+1) and the tile offsets
// (K+1); for K8 then, from the next multiple of 4 ints (the scratch itself
// 16-byte aligned), its rows: constants [K, 3, 128] and boxes [K, 4, 3]
// float4, a flag per group [K, 4] int32 and the tiles' (chunk, first slot,
// slots, 0) [R*V/32 + K] int4, 3 + 1,592 K + 4 (R*V/32) int32 more in all
// (fused_sweep.q16_scratch_ints). Each returns the first CUDA error of the
// memset and the launches (0 = success), or cudaErrorInvalidValue for rows
// it does not take; nothing synchronises.

// K4 (q16 = 0): table [K, F, 128] f32, qlo and qscale unused. K8 (q16 = 1,
// planar): table [K, 5, 128] u32 words, qlo and qscale [K, 3] f32.
// ``stages`` as sweep_stages (4 for the sweep; fewer only to time the
// stages apart).
extern "C" int crt_visit_sweep(const float* rays, const int* ids,
                               const float* nears, const float* best,
                               const float* table, const float* qlo,
                               const float* qscale, int R, int V, int K, int C,
                               float tmin, int triangle, int sphere, int q16,
                               int* scratch, float* out, int stages, void* stream) {
  if (C != CHUNK_C || (q16 && sphere)) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{table, qlo, qscale};
  return static_cast<int>(sweep_stages<false>(
      rays, ids, nears, best, rows, R, V, K, K, 0, tmin, triangle != 0, sphere != 0,
      q16 != 0, scratch, out, stages, static_cast<cudaStream_t>(stream)));
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
