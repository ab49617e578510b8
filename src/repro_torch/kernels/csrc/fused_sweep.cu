// Fused multi-site sweep kernels for Hopper (sm_90a): vanilla Gibbs and
// MGPMH, S sequentially composed site updates per chain in one launch.
//
// Replace the TPU kernels gibbs_sweep_pallas / mgpmh_sweep_pallas
// (src/repro/kernels/fused_sweep.py, body _sweep_kernel).  Semantics are
// those of the plain versions in ../ref.py: same pre-drawn inputs, same
// decisions.
//
// Layout: one thread block per chain; the chain's state row x lives in
// shared memory for all S sub-steps (sub-steps are sequential, so the loop
// over s replaces the TPU kernel's fori_loop).  The (n, n) tables stay in
// global memory and each sub-step reads only what it needs: the W row of
// the updated site (4n bytes) and, for MGPMH, the B alias entries it draws.
// Site ids and alias entries are int32 throughout.
//
// Determinism: float partial sums are reduced in a fixed order (per-thread
// strided sums, warp shuffles, then warp partials summed in order by one
// thread); the only atomics are integer counts, whose result does not
// depend on order.  Argmax takes the first maximum.  Build with
// -fmad=false: the plain versions round every product and sum separately.
//
// Plain C interface (loaded with ctypes); every launch returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// value buckets one pass over the W row accumulates in registers
constexpr int kChunk = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum each of kChunk per-thread partials over the block, in a fixed order.
// out[k] = total of acc[k] for k < nout.  Called by every thread.
__device__ __forceinline__ void block_sum_chunk(const float (&acc)[kChunk],
                                                float* red, float* out,
                                                int nout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) red[warp * kChunk + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kChunk && threadIdx.x < nout) {
    float t = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) t += red[w * kChunk + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ void load_row(int* xs, const int* src, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) xs[j] = src[j];
  __syncthreads();
}

__device__ __forceinline__ void store_row(int* dst, const int* xs, int n) {
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = xs[j];
}

// ---------------------------------------------------------------------------
// Gibbs: eps_u = sum_j W[i,j] 1[x_j = u] for all u; x_i <- argmax eps + g.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
gibbs_sweep_kernel(const int* __restrict__ x_in, const float* __restrict__ W,
                   const int* __restrict__ i_sites,
                   const float* __restrict__ gumbel, int* __restrict__ x_out,
                   int n, int S, int D) {
  extern __shared__ int smem[];
  int* xs = smem;                                   // n
  float* eps = reinterpret_cast<float*>(xs + n);    // D
  float* red = eps + D;                             // kWarps * kChunk
  const long long c = blockIdx.x;
  load_row(xs, x_in + c * n, n);
  for (int s = 0; s < S; ++s) {
    const int i = i_sites[c * S + s];
    const float* wrow = W + (long long)i * n;
    for (int u0 = 0; u0 < D; u0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const float w = wrow[j];
        const int v = xs[j] - u0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) acc[k] += (v == k) ? w : 0.f;
      }
      block_sum_chunk(acc, red, eps + u0, D - u0);
    }
    if (threadIdx.x == 0) {
      const float* g = gumbel + (c * S + s) * D;
      int best = 0;
      float top = __fadd_rn(eps[0], g[0]);
      for (int u = 1; u < D; ++u) {
        const float sc = __fadd_rn(eps[u], g[u]);
        if (sc > top) { top = sc; best = u; }
      }
      xs[i] = best;
    }
    __syncthreads();
  }
  store_row(x_out + c * n, xs, n);
}

// ---------------------------------------------------------------------------
// MGPMH: alias-draw B neighbours of i from row i's table, count their values
// (eps_u = scale * count_u), Gumbel-argmax proposal v, exact pass at v and
// x_i only, accept iff logu < (exact_v - exact_xi) + (eps_xi - eps_v).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mgpmh_sweep_kernel(const int* __restrict__ x_in, const float* __restrict__ W,
                   const float* __restrict__ row_prob,
                   const int* __restrict__ row_alias,
                   const int* __restrict__ i_sites, const int* __restrict__ B,
                   const float* __restrict__ u_idx,
                   const float* __restrict__ u_alias,
                   const float* __restrict__ gumbel,
                   const float* __restrict__ logu, int* __restrict__ x_out,
                   int* __restrict__ accepts, int n, int S, int K, int D,
                   float scale) {
  extern __shared__ int smem[];
  int* xs = smem;                                   // n
  int* cnt = xs + n;                                // D
  float* red = reinterpret_cast<float*>(cnt + D);   // kWarps * 2
  __shared__ int sh_v, sh_xi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = blockIdx.x;
  const float fn = static_cast<float>(n);
  int acc = 0;
  load_row(xs, x_in + c * n, n);
  for (int s = 0; s < S; ++s) {
    const long long cs = c * S + s;
    const int i = i_sites[cs];
    const int b = min(max(B[cs], 0), K);
    for (int u = threadIdx.x; u < D; u += kThreads) cnt[u] = 0;
    __syncthreads();
    // stage 1+2: local alias minibatch over A[i], bucketed by value
    const float* u1 = u_idx + cs * K;
    const float* u2 = u_alias + cs * K;
    const float* prow = row_prob + (long long)i * n;
    const int* arow = row_alias + (long long)i * n;
    for (int k = threadIdx.x; k < b; k += kThreads) {
      const int idx = min(static_cast<int>(__fmul_rn(u1[k], fn)), n - 1);
      const int j = (u2[k] < prow[idx]) ? idx : arow[idx];
      const int val = xs[j];
      if (val >= 0 && val < D) atomicAdd(&cnt[val], 1);
    }
    __syncthreads();
    // stage 3: Gumbel-max proposal
    if (threadIdx.x == 0) {
      const float* g = gumbel + cs * D;
      int best = 0;
      float top = __fadd_rn(__fmul_rn(scale, static_cast<float>(cnt[0])), g[0]);
      for (int u = 1; u < D; ++u) {
        const float sc =
            __fadd_rn(__fmul_rn(scale, static_cast<float>(cnt[u])), g[u]);
        if (sc > top) { top = sc; best = u; }
      }
      sh_v = best;
      sh_xi = xs[i];
    }
    __syncthreads();
    const int v = sh_v, xi = sh_xi;
    // stage 4: exact conditional pass, only at v and x_i
    const float* wrow = W + (long long)i * n;
    float ev = 0.f, ex = 0.f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float w = wrow[j];
      const int xj = xs[j];
      ev += (xj == v) ? w : 0.f;
      ex += (xj == xi) ? w : 0.f;
    }
    ev = warp_sum(ev);
    ex = warp_sum(ex);
    if (lane == 0) { red[2 * warp] = ev; red[2 * warp + 1] = ex; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float exact_v = red[0], exact_xi = red[1];
      for (int w = 1; w < kWarps; ++w) {
        exact_v += red[2 * w];
        exact_xi += red[2 * w + 1];
      }
      const float eps_xi = __fmul_rn(scale, static_cast<float>(cnt[xi]));
      const float eps_v = __fmul_rn(scale, static_cast<float>(cnt[v]));
      const float log_a = __fadd_rn(__fsub_rn(exact_v, exact_xi),
                                    __fsub_rn(eps_xi, eps_v));
      if (logu[cs] < log_a) {
        xs[i] = v;
        ++acc;
      }
    }
    __syncthreads();
  }
  store_row(x_out + c * n, xs, n);
  if (threadIdx.x == 0) accepts[c] = acc;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace

extern "C" {

int gibbs_sweep_launch(const int* x, const float* W, const int* i_sites,
                       const float* gumbel, int* x_out, int C, int n, int S,
                       int D, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)n + sizeof(float) * (size_t)D +
                      sizeof(float) * kWarps * kChunk;
  cudaError_t err = prepare(gibbs_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gibbs_sweep_kernel<<<C, kThreads, smem, stream>>>(x, W, i_sites, gumbel,
                                                    x_out, n, S, D);
  return static_cast<int>(cudaGetLastError());
}

int mgpmh_sweep_launch(const int* x, const float* W, const float* row_prob,
                       const int* row_alias, const int* i_sites, const int* B,
                       const float* u_idx, const float* u_alias,
                       const float* gumbel, const float* logu, int* x_out,
                       int* accepts, int C, int n, int S, int K, int D,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(int) * ((size_t)n + (size_t)D) +
                      sizeof(float) * kWarps * 2;
  cudaError_t err = prepare(mgpmh_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mgpmh_sweep_kernel<<<C, kThreads, smem, stream>>>(
      x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias, gumbel, logu,
      x_out, accepts, n, S, K, D, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
