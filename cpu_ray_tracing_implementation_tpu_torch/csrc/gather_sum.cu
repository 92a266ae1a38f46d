// Per-ray gather-sum probe for Hopper (sm_90a): K5.
//
// Replaces tools/dma_gather_probe.py:_kernel (via pallas_gather_sum), the
// TPU probe of per-ray dynamic row-gather bandwidth that decided the per-ray
// sweep's design (K4). Plain version: utils/gather_probe.py
// gather_sum_plain.
//
// out[r] = sum over the V slots s of sum over the ROWF floats of the row
// table[ids[r, s]] of a [K, ROWF] f32 table; ids [R, V] int32 (clamped to
// [0, K-1], as XLA's gather clamps), out [R] f32.
//
// Design. The TPU kernel issues one row DMA per (ray, slot) from the scalar
// core. The first Hopper kernel did the same from device memory, a warp a
// ray reading each of its V rows: R*V*ROWF*4 bytes (3.69 GB at the probe's
// defaults) for a function that needs each named row once. The card's
// sweeps (K4, K7, K8) no longer gather a row per (ray, slot) either: they
// bucket visits by row and read a row once for every ray that names it.
// So the row gather left this kernel; the probe's embedding_bag call still
// gathers a row per (ray, slot) and gives the card's row-gather rate. Now a
// call is two kernels on the caller's stream, with no synchronisation:
//   1. row sums: a warp a row, the row read once as float4s, neighbouring
//      lanes on neighbouring 16 bytes, ROW_UNROLL loads in flight per lane
//      before their adds; rowsum[K] f64. This stage moves the table, once.
//      It sums every row, named or not: at the probe's shapes (R*V >= K)
//      nearly every row is named, and a stage that flagged the named rows
//      first cost more than it saved (on an H100 80GB HBM3 at 700 W, 0.1001
//      ms against 0.0084-0.0088 at the defaults, whose 655,360 flag stores
//      land on 2,048 bytes);
//   2. fold: a thread a ray; its V ids (int4 loads when V % 4 == 0 and the
//      ids are 16-byte aligned, else int loads), V f64 row sums gathered
//      (16 KB at K 2,048, 1 MB at K 131,072: from L1/L2) and added in slot
//      order, one rounding to f32 and one store. On that card the int4
//      loads take the fold from 4.0 to 3.65 us at the defaults (K5 from
//      0.0088-0.0091 to 0.0084 ms) and change nothing at K 131,072; a
//      block's ids staged in shared memory by coalesced loads, a warp
//      folding 32 rays, took 5.1 us.
//
// Rounding. A ray sums V*ROWF floats (22,528 at the defaults) whose partial
// sums grow to ~150 while the total can be near 0, so two f32 summation
// orders differ by ~1e-4 of the result there. Each float is converted and
// added in f64 in a fixed order (lane-strided, then an xor-shuffle tree),
// and the fold adds the row sums in f64 in slot order; the plain version
// takes each slot's row sum in f64 and adds the slots in order too, so both
// round a near-exact total once to f32 (an output can differ by its last
// bit where the two f64 totals straddle an f32 rounding boundary).
//
// Bound (utils/gather_probe.py bound). The function needs each named row
// read once, the ids read once and the output written once: 4*(R*V + N*ROWF
// + R) bytes for N distinct named rows (14.3 MB at the defaults, 4.3 us at
// 3.35 TB/s); and one add per float of a named row plus R*V adds to fold:
// N*ROWF + R*V operations, 40x under the bytes' time. The bytes bound it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW_THREADS = 256;  // 8 rows a block, a warp a row
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_UNROLL = 4;     // float4 loads in flight per lane
constexpr int FOLD_THREADS = 128;

__device__ __forceinline__ int clamp_id(int id, int K) { return min(max(id, 0), K - 1); }

__global__ void __launch_bounds__(ROW_THREADS)
k5_row_sums(const float* __restrict__ table, int K, int rowf,
            double* __restrict__ rowsum) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= K) return;
  const int n4 = rowf >> 2;
  const float4* src = reinterpret_cast<const float4*>(table + (size_t)row * rowf);
  double acc = 0.0;
  for (int base = lane; base < n4; base += 32 * ROW_UNROLL) {
    float4 x[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u)
      if (base + 32 * u < n4) x[u] = __ldg(src + base + 32 * u);
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u)
      if (base + 32 * u < n4)
        acc += (static_cast<double>(x[u].x) + static_cast<double>(x[u].y))
               + (static_cast<double>(x[u].z) + static_cast<double>(x[u].w));
  }
  // every lane ends with the same bits: each step adds two lanes' values,
  // and an f64 add is commutative
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) rowsum[row] = acc;
}

__global__ void __launch_bounds__(FOLD_THREADS)
k5_fold(const int* __restrict__ ids, int R, int V, int K,
        const double* __restrict__ rowsum, float* __restrict__ out) {
  const int ray = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (ray >= R) return;
  const int* mine = ids + (size_t)ray * V;
  double acc = 0.0;
  if (V % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0) {
    for (int s = 0; s < V; s += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(mine + s));
      const double a = rowsum[clamp_id(q.x, K)], b = rowsum[clamp_id(q.y, K)],
                   c = rowsum[clamp_id(q.z, K)], d = rowsum[clamp_id(q.w, K)];
      acc += a;
      acc += b;
      acc += c;
      acc += d;
    }
  } else {
    for (int s = 0; s < V; ++s) acc += rowsum[clamp_id(__ldg(mine + s), K)];
  }
  out[ray] = static_cast<float>(acc);
}

}  // namespace

// Plain C interface for ctypes: returns the first CUDA error of the chain
// (0 = success); nothing synchronises. rowf must be a multiple of 4, the
// table 16-byte aligned and K at least 1 (the wrapper checks all three).
// The wrapper allocates the scratch, rowsum [K] f64.
extern "C" int crt_gather_sum(const int* ids, int R, int V, const float* table,
                              int K, int rowf, double* rowsum, float* out,
                              void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k5_row_sums<<<(K + ROW_WARPS - 1) / ROW_WARPS, ROW_THREADS, 0, s>>>(table, K, rowf,
                                                                      rowsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k5_fold<<<(R + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, s>>>(ids, R, V, K,
                                                                          rowsum, out);
  return static_cast<int>(cudaGetLastError());
}
