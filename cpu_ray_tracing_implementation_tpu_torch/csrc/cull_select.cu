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
// shared memory, and the colonnade's six box rows alone are 48 KB. So no
// [R, K] exists anywhere. Eight consecutive lanes of a warp share a ray;
// lane g walks boxes g, g+8, g+16, ... in column order, from tiles of 512
// boxes staged in shared memory (12 KB; the eight lanes of a ray read eight
// neighbouring words, conflict-free), and keeps its own V+1 smallest keys
// in a sorted list in registers. An accepted key enters at the tail and
// bubbles up through V unrolled compare-and-swaps with no dynamic index, so
// the list stays out of local memory; a key that cannot beat the tail costs
// one compare. The ray's V+1 smallest lie in the union of its eight lists:
// V+1 merge rounds each take the smallest head over the eight lanes (three
// xor-shuffles) and pop it from the one lane that holds it (ids are unique,
// packed keys too). In exact mode a lane's later column with an equal near
// sorts after its earlier ones, and the merge breaks ties by id, so the
// order is (near, id). A first version with one thread per ray (1,250 warps
// for 132 SMs) could not hide the shared-load and compare chains: 0.7585 ms
// at the colonnade's primary rays on one H100 (PERF.md). V is a template
// parameter, 1..16 (the per-ray path takes min(16, K)).
//
// Rounding: the slab arithmetic is (lo - o) * inv with inv = 1/d in IEEE
// division, and min/max propagate NaN as torch.minimum/maximum do (fminf
// and fmaxf alone drop it), so the kernel is bit-equal to its plain version.
//
// Bound. At the colonnade's primary rays (R = 40,000, Kp = 2,048) the work
// is R*Kp = 82 M (ray, box) pairs of ~30 FP32 operations (6 subtractions,
// 6 multiplications, 12 min/max, 4 compares, the key): ~2.5 G operations,
// ~37 us at the card's 67 TFLOP/s. Bytes are small (32 B in, 2*V*4 + 4 B
// out per ray, 64 KB of boxes): ~7 MB, ~2 us. Arithmetic bounds it.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 128;
constexpr int GROUP = 8;  // threads per ray, consecutive lanes of one warp
constexpr int RAYS_PER_BLOCK = THREADS / GROUP;
constexpr int TILE_K = 512;
constexpr int MASKV = 0x7FFFFFFF;
constexpr int V_MAX = 16;
constexpr unsigned FULL = 0xffffffffu;

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
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

template <int V, bool PACKED>
__global__ void __launch_bounds__(THREADS)
cull_select_kernel(const float* __restrict__ rays,
                   const float* __restrict__ boxes,
                   const float* __restrict__ excl, int R, int Kp, int K_real,
                   float tmin, int hmask, int* __restrict__ ids,
                   float* __restrict__ nears, float* __restrict__ rest) {
  __shared__ float s[6][TILE_K];
  const int g = threadIdx.x % GROUP;  // this thread's place in its ray's group
  const int r = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x / GROUP;
  const bool live = r < R;

  float o[3] = {0.f, 0.f, 0.f}, inv[3] = {1.f, 1.f, 1.f};
  float cap = -BIG, thr = -BIG;
  int lid = -1;
  if (live) {
    const float4 a = reinterpret_cast<const float4*>(rays)[2 * r];
    const float4 b = reinterpret_cast<const float4*>(rays)[2 * r + 1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z;
    const float d[3] = {a.w, b.x, b.y};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      inv[k] = 1.0f / (fabsf(d[k]) > 1e-20f ? d[k] : 1e-20f);
    cap = b.z;
    thr = excl[2 * r];
    lid = static_cast<int>(excl[2 * r + 1]);
  }
  int excl_key = 0;
  if (thr >= 0.f)
    excl_key = (__float_as_int(thr) & hmask) | max(lid, 0);
  else if (thr != thr)
    excl_key = MASKV;

  // this thread's V+1 smallest: packed keys in L; exact (near, id) in (Ln, L)
  int L[V + 1];
  float Ln[V + 1];
#pragma unroll
  for (int i = 0; i <= V; ++i) {
    L[i] = MASKV;
    Ln[i] = __int_as_float(0x7f800000);  // +inf
  }

  for (int k0 = 0; k0 < Kp; k0 += TILE_K) {
    const int nk = min(TILE_K, Kp - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < 6 * TILE_K; i += THREADS) {
      const int row = i / TILE_K, c = i % TILE_K;
      s[row][c] = c < nk ? boxes[(size_t)row * Kp + k0 + c] : 0.f;
    }
    __syncthreads();
    for (int j = g; j < nk; j += GROUP) {
      const int col = k0 + j;
      float near = -BIG, far = BIG;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = __fmul_rn(__fsub_rn(s[a][j], o[a]), inv[a]);
        const float t1 = __fmul_rn(__fsub_rn(s[3 + a][j], o[a]), inv[a]);
        near = nan_max(near, nan_min(t0, t1));
        far = nan_min(far, nan_max(t0, t1));
      }
      const bool ok = near <= far && far >= tmin && near <= cap &&
                      col < K_real;
      if (PACKED) {
        const float nearm = ok ? fmaxf(near, tmin) : __int_as_float(0x7f800000);
        const int key = (__float_as_int(nearm) & hmask) | col;
        if (key > excl_key && key < L[V]) insert_key(L, key);
      } else {
        if (!ok) continue;
        const float nearm = fmaxf(near, tmin);
        const bool visited = nearm < thr || (nearm == thr && col <= lid);
        if (!visited && nearm < Ln[V]) insert_pair(Ln, L, nearm, col);
      }
    }
  }

  // Merge the group's GROUP lists: V+1 rounds, each takes the smallest head
  // over the group (ids are unique, so one thread owns it) and pops it.
  for (int v = 0; v <= V; ++v) {
    int mk = L[0];
    float mn = Ln[0];
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1) {
      const int ok_ = __shfl_xor_sync(FULL, mk, off);
      if (PACKED) {
        mk = min(mk, ok_);
      } else {
        const float on = __shfl_xor_sync(FULL, mn, off);
        if (on < mn || (on == mn && ok_ < mk)) {
          mn = on;
          mk = ok_;
        }
      }
    }
    const bool pop = mk != MASKV && L[0] == mk;
    if (pop) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        L[i] = L[i + 1];
        Ln[i] = Ln[i + 1];
      }
      L[V] = MASKV;
      Ln[V] = __int_as_float(0x7f800000);
    }
    if (!live || g != 0) continue;
    if (PACKED) {
      const float near = __int_as_float(mk & hmask);
      if (v < V) {
        ids[(size_t)r * V + v] = mk & ~hmask;
        nears[(size_t)r * V + v] = near;
      } else {
        rest[r] = near;
      }
    } else if (v < V) {
      ids[(size_t)r * V + v] = mk == MASKV ? 0 : mk;
      nears[(size_t)r * V + v] = mn;
    } else {
      rest[r] = mn;
    }
  }
}

struct Args {
  const float *rays, *boxes, *excl;
  int R, Kp, K_real;
  float tmin;
  int hmask;
  int* ids;
  float *nears, *rest;
};

template <int V>
void launch(int v, bool packed, const Args& a, cudaStream_t st) {
  if (v == V) {
    const dim3 grid((a.R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK);
    if (packed)
      cull_select_kernel<V, true><<<grid, THREADS, 0, st>>>(
          a.rays, a.boxes, a.excl, a.R, a.Kp, a.K_real, a.tmin, a.hmask,
          a.ids, a.nears, a.rest);
    else
      cull_select_kernel<V, false><<<grid, THREADS, 0, st>>>(
          a.rays, a.boxes, a.excl, a.R, a.Kp, a.K_real, a.tmin, a.hmask,
          a.ids, a.nears, a.rest);
  } else if constexpr (V > 1) {
    launch<V - 1>(v, packed, a, st);
  }
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue for a V outside 1..16; nothing
// synchronises. In exact mode the id lists start as MASKV and an exhausted
// slot reports id 0.
extern "C" int crt_cull_select(const float* rays, const float* boxes,
                               const float* excl, int R, int Kp, int K_real,
                               int V, float tmin, int packed, int id_bits,
                               int* ids, float* nears, float* rest,
                               void* stream) {
  if (V < 1 || V > V_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Args a{rays, boxes, excl, R, Kp, K_real, tmin,
               static_cast<int>(~((1u << id_bits) - 1u)), ids, nears, rest};
  launch<V_MAX>(V, packed != 0, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
