// Weighted one-hot bucket sum for Hopper (sm_90a):
//   E[c, u] = sum_k w[c, k] * 1[v[c, k] == u],  u in [0, D)
// Values outside [0, D) match no bucket (the JAX package's padding
// convention).  The energy of every minibatch Gibbs variant has this form:
// Local Minibatch Gibbs (w = W[i, j], v = x[j]), the MGPMH proposal
// (w = (L/lambda) * mask, v = x[j]) and the exact conditional pass
// (w = W[i, :], v = x).  In the port it is the energy of the single-site
// reference steps; the local-gibbs engine runs local_sweep.cu instead.
//
// Replaces bucket_energy_pallas (src/repro/kernels/minibatch_energy.py,
// body _kernel).  The TPU kernel builds a (BC, BK, 128) one-hot block in
// VMEM and contracts it on the MXU, with C padded to 8, K to 128-512 and D
// to 128 by its wrapper.  Here nothing is padded: one block per (row c,
// chunk of kChunk buckets) reads w[c, :] and v[c, :] coalesced, each thread
// keeps kChunk partial sums in registers over a fixed k-stride, and the
// block reduces them in a fixed order (warp shuffle tree, then the warps'
// partials summed in warp order by one thread).  No float atomics: two runs
// on the same inputs give the same bits.  The K tail is the stride loop's
// bound, the D tail a mask on the store, so any (C, K, D) works.
//
// Bound: bytes (C*K*8 read once, C*D*4 written); C*K*D compare-selects and
// C*K adds are far below the FP32 rate.  At the minibatch shapes (K <= 128)
// the launch, not the device work, sets the time.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// buckets one block accumulates in registers: gridDim.y = ceil(D / kChunk)
constexpr int kChunk = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
bucket_energy_kernel(const float* __restrict__ w, const int* __restrict__ v,
                     float* __restrict__ out, int K, int D) {
  __shared__ float partial[kWarps][kChunk];
  const size_t row = static_cast<size_t>(blockIdx.x) * K;
  const int u0 = blockIdx.y * kChunk;
  float acc[kChunk];
#pragma unroll
  for (int b = 0; b < kChunk; ++b) acc[b] = 0.0f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float wk = w[row + k];
    const int d = v[row + k] - u0;   // bucket within this chunk, if any
#pragma unroll
    for (int b = 0; b < kChunk; ++b)
      if (d == b) acc[b] += wk;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < kChunk; ++b) {
    const float s = warp_sum(acc[b]);
    if (lane == 0) partial[warp][b] = s;
  }
  __syncthreads();
  const int u = u0 + threadIdx.x;
  if (threadIdx.x < kChunk && u < D) {
    float s = partial[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += partial[q][threadIdx.x];
    out[static_cast<size_t>(blockIdx.x) * D + u] = s;
  }
}

}  // namespace

extern "C" {

// w (C, K) float32, v (C, K) int32, out (C, D) float32, all contiguous on
// the card.  C >= 1, K >= 0, 1 <= D; ceil(D / kChunk) <= 65535.
int bucket_energy_launch(const float* w, const int* v, float* out, int C,
                         int K, int D, cudaStream_t stream) {
  const dim3 grid(C, (D + kChunk - 1) / kChunk);
  bucket_energy_kernel<<<grid, kThreads, 0, stream>>>(w, v, out, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
