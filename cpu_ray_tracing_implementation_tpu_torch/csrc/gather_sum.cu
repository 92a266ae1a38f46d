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
// core into double-buffered VMEM. Hopper gathers from device memory
// directly: one warp per ray; per slot, the warp reads the row as float4s,
// neighbouring lanes on neighbouring 16 bytes (one 512-byte coalesced
// request per pass), and keeps a running sum in registers; an xor-shuffle
// reduction and one store per ray end it. No shared memory.
//
// Rounding. A ray sums V*ROWF floats (22,528 at the defaults) whose partial
// sums grow to ~150 while the total can be near 0, so two f32 summation
// orders differ by ~1e-4 of the result there. Each float is converted and
// added in f64 (four f64 adds per 16 bytes read, ~54 us of the card's f64
// rate at the defaults, under the gather's own time); the plain version
// sums in f64 too, so both round the same near-exact total once to f32.
//
// Bound. Each input read once and the output written once is R*V*4 + K*ROWF*4
// + R*4 bytes (14.3 MB at the probe's defaults, 4.3 us at 3.35 TB/s); the
// adds are R*V*ROWF FP32 instructions (0.92e9, 27.5 us at 33.5e12/s), so the
// operations bound it on paper. The gather itself reads R*V*ROWF*4 bytes
// (3.69 GB at the defaults) from L2 when the table fits its 50 MB and from
// HBM when it does not: what the probe measures.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const int* __restrict__ ids, int R, int V,
                  const float* __restrict__ table, int K, int rowf,
                  float* __restrict__ out) {
  const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= R) return;
  const int n4 = rowf >> 2;
  double acc = 0.0;
  for (int s = 0; s < V; ++s) {
    const int id = min(max(ids[(size_t)ray * V + s], 0), K - 1);
    const float4* row = reinterpret_cast<const float4*>(table + (size_t)id * rowf);
    for (int i = lane; i < n4; i += 32) {
      const float4 x = __ldg(row + i);
      acc += (static_cast<double>(x.x) + static_cast<double>(x.y))
             + (static_cast<double>(x.z) + static_cast<double>(x.w));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[ray] = static_cast<float>(acc);
}

}  // namespace

// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 = success); nothing synchronises. rowf must be a multiple of 4 and the
// table 16-byte aligned (the wrapper checks both).
extern "C" int crt_gather_sum(const int* ids, int R, int V, const float* table,
                              int K, int rowf, float* out, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + WARPS - 1) / WARPS);
  gather_sum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, R, V, table, K, rowf, out);
  return static_cast<int>(cudaGetLastError());
}
