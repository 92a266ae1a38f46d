// Fused per-ray chunk cull + top-V select for Hopper (sm_90a): kernel K3.
//
// Replaces cpu_ray_tracing_implementation_tpu/ops/pallas_select.py:_kernel
// (pallas_select.py:48-133). Plain version: ops/fused_select.py
// cull_select_plain; wrapper: ops/fused_select.py cull_select.
//
// Layouts are the Pallas kernel's: rays [R,8] f32 (org xyz, dir xyz, cap,
// pad), boxes [8,Kp] f32 (lo xyz, hi xyz, pad; Kp a multiple of 128, padded
// chunks inverted), excl [R,2] f32 (threshold, last id) -> ids [R,V] int32,
// nears [R,V] f32 ascending, rest [R] f32.
//
// What it computes, per ray: the slab test against every box,
// ok = near<=far & far>=tmin & near<=cap & col<K_real and
// nearm = ok ? max(near, tmin) : +inf; then the V smallest keys and the
// (V+1)-th (rest) after the phase exclusion.
//  - packed (tmin > 0): key = (bits(nearm) & HMASK) | col, IDB =
//    max(11, bitlen(Kp-1)) low bits for the id. Keys at or below the
//    exclusion key (bits(thr) & HMASK) | max(lid, 0) (thr >= 0; NaN thr:
//    all; negative thr: none) become MASKV = 0x7FFFFFFF and are never
//    selected; a culled box keeps its +inf key, above every finite one. A
//    slot returns id = m & ~HMASK and near = bitcast(m & HMASK): NaN for
//    an exhausted (MASKV) slot.
//  - exact: lexicographic (near, id) with a first-index tie-break;
//    (nearm < thr) | (nearm == thr & col <= lid) is excluded. An exhausted
//    slot returns (+inf, id 0), as the Pallas kernel's rounds do.
//
// Design. The Pallas kernel builds the [RB, K] near matrix in VMEM and runs
// V min-and-mask rounds over it. On the card a block has at most 227 KB of
// shared memory, and the colonnade's six box rows alone are 48 KB, so no
// [R, K] exists anywhere. Eight consecutive lanes of a warp (a group) share
// a ray; lane g walks boxes g, g+8, g+16, ... in column order from tiles of
// 512 boxes staged in shared memory as two float4 arrays (lo, hi: 16 KB;
// the eight lanes of a group read eight neighbouring float4s,
// conflict-free), and keeps its own V+1 smallest keys in a sorted list in
// registers: an accepted key enters at the tail and bubbles up through V
// unrolled compare-and-swaps with no dynamic index, so the list stays out of
// local memory; a key that cannot beat the tail costs one compare. The
// ray's V+1 smallest lie in the union of its eight lists: V+1 merge rounds
// each take the smallest head over the group (three xor-shuffles) and pop
// it from the one lane that holds it (ids are unique, packed keys too). In
// exact mode a lane's later column with an equal near sorts after its
// earlier ones, and the merge breaks ties by id, so the order is (near,
// id). The list's capacity N is a template parameter: N = V for V in
// 1..16 (the per-ray path's default takes min(16, K)), and N = 24 or 32 for
// V in 17..24 or 25..32 (CRT_RAYV up to 32, and the sub-tile route's 24 at
// its defaults), which then selects only V: a lane's N+1 smallest hold its
// share of the ray's V+1 smallest whenever N >= V, so the outputs are those
// of a list of V+1. What bounds it is the FP32 instruction rate of the
// walk, and two changes of the Hopper redesign go at that:
//  - NaN-free fast path. min/max must propagate NaN as torch.minimum /
//    maximum do, and fminf/fmaxf drop it: twelve NaN-propagating min/max
//    of ~5 instructions each per (ray, box) were most of the first
//    design's issue. A NaN can only reach the slab test through a
//    non-finite origin, a zero reciprocal (an infinite direction
//    component: 1/inf = 0, and inf * 0 is NaN) or a NaN box. So a ray with
//    a finite origin and non-zero reciprocals walks a tile with no NaN box
//    (one flag per tile, from the staging barrier) with fminf/fmaxf, which
//    then give the same bits; any other keeps the NaN-propagating forms.
//  - Rays that are done. The phase loop (ops/perray.py) marks a ray whose
//    rest was not below its best t as exhausted: an exclusion key that
//    excludes every box (NaN thr in packed mode, +inf thr with last id >=
//    Kp-1 in exact mode). Warp 0 of a block reads its 16 rays' keys,
//    writes the exhausted slots the plain version gives such a ray, and
//    packs the other rays into the block's first groups (a ballot and a
//    popcount), so the live rays of a late phase fill the first warps and
//    the rest issue nothing; a block with no live ray returns at once.
// Steps measured on the card that did not pay (a group-wide tail, two rays
// per group, 16 or 32 lanes per ray) are in PERF.md.
//
// Rounding: the slab arithmetic is (lo - o) * inv with inv = 1/d in IEEE
// division, never contracted, so the kernel is bit-equal to its plain
// version on both paths (fast and NaN-propagating).
//
// Bound. At the colonnade's primary rays (R = 40,000, Kp = 2,048) the work
// is R*Kp = 82 M (ray, box) pairs of ~30 FP32 instructions (6
// subtractions, 6 multiplications, 12 min/max, 4 compares, the key):
// ~2.5 G instructions, 0.0722 ms at 33.5e12 per s. Bytes are small (32 B in,
// 2*V*4 + 4 B out per ray, 64 KB of boxes): ~7 MB, ~2 us. Arithmetic bounds
// it. On one H100 (700 W) this design took 0.1672 ms there (phase 1, packed,
// V 16) and 0.0731 ms at phase 2 with the done rays marked, against 0.3974
// for the first design in the same run (PERF.md): 2.3x its bound. By a count from
// the source the fast path still issues ~40 instructions per pair (the
// bound counts 30; the loop, shared loads and the key's compare and branch
// are the rest), and insertions diverge within the warp.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 128;
constexpr int GROUP = 8;  // lanes per ray, consecutive lanes of one warp
constexpr int RAYS_PER_BLOCK = THREADS / GROUP;
constexpr int TILE_K = 512;
constexpr int MASKV = 0x7FFFFFFF;
constexpr int V_EXACT = 16;  // up to this V the capacity is V itself
constexpr int V_MAX = 32;
static_assert(RAYS_PER_BLOCK <= 32, "one warp compacts the block's rays");
static_assert(GROUP < 32 && 32 % GROUP == 0, "a group lies inside one warp");

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
template <bool FAST>
__device__ __forceinline__ float vmin(float a, float b) {
  return FAST ? fminf(a, b) : nan_min(a, b);
}
template <bool FAST>
__device__ __forceinline__ float vmax(float a, float b) {
  return FAST ? fmaxf(a, b) : nan_max(a, b);
}

// L ascending; the caller checked key < L[N-1]
template <int N>
__device__ __forceinline__ void insert_key(int (&L)[N], int key) {
  L[N - 1] = key;
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    const int a = L[i - 1], b = L[i];
    L[i - 1] = min(a, b);
    L[i] = max(a, b);
  }
}

// (Ln, Li) ascending by near, ties in insertion (column) order; the caller
// checked near < Ln[N-1]
template <int N>
__device__ __forceinline__ void insert_pair(float (&Ln)[N], int (&Li)[N],
                                            float near, int id) {
  Ln[N - 1] = near;
  Li[N - 1] = id;
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    const bool sw = Ln[i] < Ln[i - 1];
    const float n0 = sw ? Ln[i] : Ln[i - 1], n1 = sw ? Ln[i - 1] : Ln[i];
    const int i0 = sw ? Li[i] : Li[i - 1], i1 = sw ? Li[i - 1] : Li[i];
    Ln[i - 1] = n0;
    Ln[i] = n1;
    Li[i - 1] = i0;
    Li[i] = i1;
  }
}

// (bits(thr) & HMASK) | max(lid, 0) for thr >= 0; MASKV (all) for a NaN
// thr; 0 (none) for a negative thr
__device__ __forceinline__ int excl_key_of(float thr, int lid, int hmask) {
  if (thr >= 0.f) return (__float_as_int(thr) & hmask) | max(lid, 0);
  return thr != thr ? MASKV : 0;
}

// One ray, as one lane of its group sees it; N is the lists' capacity.
template <int N>
struct Ray {
  float o[3], inv[3];
  float cap, thr;
  int lid, excl_key;
  int L[N + 1];     // this lane's N+1 smallest: packed keys, or exact ids
  float Ln[N + 1];  // exact nears
};

// Lane g's boxes g, g+GROUP, ... of a staged tile of nk boxes.
template <int N, bool PACKED, bool FAST>
__device__ __forceinline__ void walk(Ray<N>& q, const float4* s_lo,
                                     const float4* s_hi, int nk, int k0, int g,
                                     int K_real, float tmin, int hmask) {
#pragma unroll 4
  for (int j = g; j < nk; j += GROUP) {
    const float4 lo = s_lo[j], hi = s_hi[j];
    const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
    const int col = k0 + j;
    float near = -BIG, far = BIG;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t0 = __fmul_rn(__fsub_rn(l[a], q.o[a]), q.inv[a]);
      const float t1 = __fmul_rn(__fsub_rn(h[a], q.o[a]), q.inv[a]);
      near = vmax<FAST>(near, vmin<FAST>(t0, t1));
      far = vmin<FAST>(far, vmax<FAST>(t0, t1));
    }
    const bool ok = near <= far && far >= tmin && near <= q.cap && col < K_real;
    if (PACKED) {
      const float nearm = ok ? fmaxf(near, tmin) : inf();
      const int key = (__float_as_int(nearm) & hmask) | col;
      if (key > q.excl_key && key < q.L[N]) insert_key(q.L, key);
    } else if (ok) {
      const float nearm = fmaxf(near, tmin);
      const bool visited = nearm < q.thr || (nearm == q.thr && col <= q.lid);
      if (!visited && nearm < q.Ln[N]) insert_pair(q.Ln, q.L, nearm, col);
    }
  }
}

template <int N, bool PACKED>
__global__ void __launch_bounds__(THREADS)
cull_select_kernel(const float* __restrict__ rays,
                   const float* __restrict__ boxes,
                   const float* __restrict__ excl, int R, int Kp, int K_real,
                   int v_sel, float tmin, int hmask, int* __restrict__ ids,
                   float* __restrict__ nears, float* __restrict__ rest) {
  // the slots selected: N itself up to V_EXACT (a constant), else v_sel <= N
  const int V = N <= V_EXACT ? N : v_sel;
  __shared__ float4 s_lo[TILE_K], s_hi[TILE_K];
  __shared__ int s_ray[RAYS_PER_BLOCK];  // the block's rays that walk boxes
  __shared__ int s_n;
  // Warp 0 reads the block's exclusion keys. An exhausted ray gets its
  // exhausted slots here and walks nothing; the others are packed into
  // slots 0..n-1, so they fill the first groups and the rest stay idle.
  if (threadIdx.x < 32) {
    const int r = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x;
    bool walks = false;
    if (threadIdx.x < RAYS_PER_BLOCK && r < R) {
      const float thr = excl[2 * r];
      const int lid = static_cast<int>(excl[2 * r + 1]);
      walks = !(PACKED ? excl_key_of(thr, lid, hmask) == MASKV
                       : thr == inf() && lid >= Kp - 1);
      if (!walks) {
        const int id = PACKED ? MASKV & ~hmask : 0;
        const float near = PACKED ? __int_as_float(MASKV & hmask) : inf();
        for (int v = 0; v < V; ++v) {
          ids[(size_t)r * V + v] = id;
          nears[(size_t)r * V + v] = near;
        }
        rest[r] = near;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, walks);
    if (walks) s_ray[__popc(m & ((1u << threadIdx.x) - 1u))] = r;
    if (threadIdx.x == 0) s_n = __popc(m);
  }
  __syncthreads();
  const int n = s_n;
  if (n == 0) return;  // the same for the whole block

  const int g = threadIdx.x % GROUP;  // this thread's place in its group
  const int slot = threadIdx.x / GROUP;
  const unsigned gmask = ((1u << GROUP) - 1u) << (threadIdx.x % 32 - g);
  const bool live = slot < n;
  const int r = live ? s_ray[slot] : 0;
  Ray<N> q;
  q.o[0] = q.o[1] = q.o[2] = 0.f;
  q.inv[0] = q.inv[1] = q.inv[2] = 1.f;
  q.cap = -BIG;
  q.thr = -BIG;
  q.lid = -1;
  if (live) {
    const float4 a = reinterpret_cast<const float4*>(rays)[2 * r];
    const float4 b = reinterpret_cast<const float4*>(rays)[2 * r + 1];
    q.o[0] = a.x; q.o[1] = a.y; q.o[2] = a.z;
    const float d[3] = {a.w, b.x, b.y};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      q.inv[k] = 1.0f / (fabsf(d[k]) > 1e-20f ? d[k] : 1e-20f);
    q.cap = b.z;
    q.thr = excl[2 * r];
    q.lid = static_cast<int>(excl[2 * r + 1]);
  }
  q.excl_key = excl_key_of(q.thr, q.lid, hmask);
  // no NaN can come from this ray (see the note at the top)
  const bool fast = isfinite(q.o[0]) && isfinite(q.o[1]) && isfinite(q.o[2]) &&
                    q.inv[0] != 0.f && q.inv[1] != 0.f && q.inv[2] != 0.f;
#pragma unroll
  for (int i = 0; i <= N; ++i) {
    q.L[i] = MASKV;
    q.Ln[i] = inf();
  }

  for (int k0 = 0; k0 < Kp; k0 += TILE_K) {
    const int nk = min(TILE_K, Kp - k0);
    __syncthreads();  // the previous tile is consumed
    bool nan_box = false;
    for (int c = threadIdx.x; c < nk; c += THREADS) {
      const float* b = boxes + k0 + c;
      const float4 lo = make_float4(b[0], b[(size_t)Kp], b[2 * (size_t)Kp], 0.f);
      const float4 hi = make_float4(b[3 * (size_t)Kp], b[4 * (size_t)Kp],
                                    b[5 * (size_t)Kp], 0.f);
      nan_box = nan_box || lo.x != lo.x || lo.y != lo.y || lo.z != lo.z ||
                hi.x != hi.x || hi.y != hi.y || hi.z != hi.z;
      s_lo[c] = lo;
      s_hi[c] = hi;
    }
    const bool tile_nan = __syncthreads_or(nan_box);
    if (!live) continue;  // the same for the whole group
    if (fast && !tile_nan)
      walk<N, PACKED, true>(q, s_lo, s_hi, nk, k0, g, K_real, tmin, hmask);
    else
      walk<N, PACKED, false>(q, s_lo, s_hi, nk, k0, g, K_real, tmin, hmask);
  }
  if (!live) return;  // the same for the whole group

  // Merge the group's GROUP lists: V+1 rounds, each takes the smallest head
  // over the group (ids are unique, so one thread owns it) and pops it.
  for (int v = 0; v <= V; ++v) {
    int mk = q.L[0];
    float mn = q.Ln[0];
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1) {
      const int ok_ = __shfl_xor_sync(gmask, mk, off);
      if (PACKED) {
        mk = min(mk, ok_);
      } else {
        const float on = __shfl_xor_sync(gmask, mn, off);
        if (on < mn || (on == mn && ok_ < mk)) {
          mn = on;
          mk = ok_;
        }
      }
    }
    if (mk != MASKV && q.L[0] == mk) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        q.L[i] = q.L[i + 1];
        q.Ln[i] = q.Ln[i + 1];
      }
      q.L[N] = MASKV;
      q.Ln[N] = inf();
    }
    if (g != 0) continue;
    const size_t o = (size_t)r * V + v;
    if (PACKED) {
      const float near = __int_as_float(mk & hmask);
      if (v < V) {
        ids[o] = mk & ~hmask;
        nears[o] = near;
      } else {
        rest[r] = near;
      }
    } else if (v < V) {
      ids[o] = mk == MASKV ? 0 : mk;
      nears[o] = mn;
    } else {
      rest[r] = mn;
    }
  }
}

struct Args {
  const float *rays, *boxes, *excl;
  int R, Kp, K_real, V;
  float tmin;
  int hmask;
  int* ids;
  float *nears, *rest;
};

template <int N>
void launch_capacity(bool packed, const Args& a, cudaStream_t st) {
  const dim3 grid((a.R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK);
  if (packed)
    cull_select_kernel<N, true><<<grid, THREADS, 0, st>>>(
        a.rays, a.boxes, a.excl, a.R, a.Kp, a.K_real, a.V, a.tmin, a.hmask,
        a.ids, a.nears, a.rest);
  else
    cull_select_kernel<N, false><<<grid, THREADS, 0, st>>>(
        a.rays, a.boxes, a.excl, a.R, a.Kp, a.K_real, a.V, a.tmin, a.hmask,
        a.ids, a.nears, a.rest);
}

// capacity V for V up to V_EXACT, then 24 and 32
template <int N>
void launch(bool packed, const Args& a, cudaStream_t st) {
  if (a.V == N)
    launch_capacity<N>(packed, a, st);
  else if constexpr (N > 1)
    launch<N - 1>(packed, a, st);
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue for a V outside 1..32; nothing
// synchronises. In exact mode the id lists start as MASKV and an exhausted
// slot reports id 0.
extern "C" int crt_cull_select(const float* rays, const float* boxes,
                               const float* excl, int R, int Kp, int K_real,
                               int V, float tmin, int packed, int id_bits,
                               int* ids, float* nears, float* rest,
                               void* stream) {
  if (V < 1 || V > V_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Args a{rays, boxes, excl, R, Kp, K_real, V, tmin,
               static_cast<int>(~((1u << id_bits) - 1u)), ids, nears, rest};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= V_EXACT)
    launch<V_EXACT>(packed != 0, a, st);
  else if (V <= 24)
    launch_capacity<24>(packed != 0, a, st);
  else
    launch_capacity<V_MAX>(packed != 0, a, st);
  return static_cast<int>(cudaGetLastError());
}
