// Local Minibatch Gibbs (Algorithm 3) for Hopper (sm_90a): S sequential
// sub-steps per chain in one launch, every draw made in-kernel by Philox.
//
// Replaces bucket_energy_pallas (src/repro/kernels/minibatch_energy.py:54)
// on the local path of src/repro/core/samplers.py:161 (make_local_gibbs_step,
// which the JAX engine scans S times with one bucket-energy call each).  Per
// chain and sub-step s at site i:
//   1. Floyd's algorithm draws B distinct k from {0 .. n-2}: at step t, with
//      r = n-1-B+t, k = umulhi(bits_t, r+1) from lane t of stream 0 (raw
//      32-bit words), inserted unless already drawn, then r is inserted;
//   2. j_t = k_t + (k_t >= i) skips the site;
//   3. eps_u = scale * sum_t W[i, j_t] 1[x[j_t] = u], bucket u summed over
//      t = 0 .. B-1 in order (the plain version's order, so the two are
//      bit-equal);
//   4. x_i <- argmax_u eps_u + gumbel_u (first maximum), Gumbels from
//      stream 1.
// Semantics and the Philox layout are those of ../ref.py
// (local_gibbs_sweep_ref) and ../philox.py (LOCAL_GIBBS_STREAMS).
//
// Only step 3's x[j_t] and step 4 depend on the chain's state; the site,
// the subset, the B weights W[i, j_t] and the Gumbels do not.  So one block
// of kWarps warps runs each chain as a pipeline: warps 1 .. kWarps-1
// (producers) draw the subsets, gather the weights and draw the Gumbels of
// a chunk of sub-steps into shared memory, while warp 0 (the consumer) runs
// the previous chunk's state-dependent steps, one sub-step after another;
// the block synchronises once per chunk (two chunk buffers).  The chain's
// x row stays in shared memory for all S sub-steps; W stays in global
// memory (64 MiB at potts-64x64).
//
// Floyd's steps depend on each other, but only through the subset drawn so
// far, so a producer warp resolves 32 of them at once against its own
// bitmap of the n-1 candidate sites: lane t collides iff k_t was drawn in
// an earlier round (bitmap), or a lower lane drew the same k
// (__match_any_sync), or k_t is the r of a lower lane t' (k_t - r_0 = t')
// that collided itself.  The last is a pointer chain to lower lanes,
// resolved by at most five rounds of pointer jumping over shuffles.  The
// result is the sequential algorithm's, step for step.
//
// The consumer's chain per sub-step: replace each j_t by x[j_t], then
// each lane (= bucket) adds the (w_t, x[j_t]) pairs in order from
// broadcast shared-memory reads, with no shuffle and no branch per term,
// then a warp argmax (__reduce_max_sync over order-preserving int keys).
//
// Bound: the consumer's S dependent sub-steps (about a shared-memory
// round trip, B dependent adds and a warp reduction each) keep the kernel
// latency-bound far above its byte bound (4 bytes per distinct W entry
// read, 8*C*n of x, 4*C*S of sites).
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                   // warp 0 consumes, 1.. produce
constexpr int kProducers = kWarps - 1;
constexpr int kThreads = 32 * kWarps;
// 32-lane Floyd rounds whose W gathers are in flight together
constexpr int kRounds = 4;
// sub-steps per chunk: two per producer
constexpr int kChunk = 2 * kProducers;
constexpr uint32_t kSubStream = 0, kGumbelStream = 1;

// One round of Floyd's algorithm: lanes t = t0 + lane < B draw their k and
// insert their pick into the bitmap.  Returns the pick in [0, n-1) on a
// valid lane, -1 on the others.  Called by the whole warp; the caller
// synchronises the warp before the bitmap is read again.
__device__ __forceinline__ int floyd_round(uint32_t* bitmap, uint32_t seed,
                                           int c, int s, int t0, int B,
                                           int m) {
  const int lane = threadIdx.x & 31;
  const int t = t0 + lane;
  const bool valid = t < B;
  const int r0 = m - B + t0;             // r of lane 0
  const int r = r0 + lane;
  const uint32_t bits = philox::bits(seed, kSubStream, c, s, t);
  // 0xffffffff equals no valid lane's draw
  const uint32_t k = valid ? __umulhi(bits, static_cast<uint32_t>(r) + 1u)
                           : 0xffffffffu;
  bool hit = valid && ((bitmap[k >> 5] >> (k & 31)) & 1u);  // earlier round
  const unsigned same = __match_any_sync(kFull, k);
  hit = hit || (same & ((1u << lane) - 1u)) != 0u;  // a lower lane's k
  // k == r of lower lane d: drawn iff lane d collided (rare: skip the
  // jumps when no lane points anywhere)
  const int d = valid ? static_cast<int>(k) - r0 : -1;
  int p = (d >= 0 && d < lane) ? d : -1;
  if (__any_sync(kFull, p >= 0)) {
#pragma unroll
    for (int jump = 0; jump < 5; ++jump) {
      const int src = p >= 0 ? p : lane;
      const bool hit_p = __shfl_sync(kFull, hit, src);
      const int p_p = __shfl_sync(kFull, p, src);
      if (p >= 0) {
        hit = hit || hit_p;
        p = p_p;
      }
    }
  }
  if (!valid) return -1;
  const int pick = hit ? r : static_cast<int>(k);
  atomicOr(&bitmap[pick >> 5], 1u << (pick & 31));
  return pick;
}

// ints of one chunk buffer: per sub-step B (j, w) pairs, D Gumbels and the
// site; even, so the next buffer's pairs stay 8-byte aligned
__host__ __device__ __forceinline__ size_t chunk_ints(int T, int B, int D) {
  const size_t v = static_cast<size_t>(T) *
                   (2 * static_cast<size_t>(B) + static_cast<size_t>(D) + 1);
  return v + (v & 1);
}

// ints before the chunk buffers: the x row and the producers' bitmaps
__host__ __device__ __forceinline__ size_t fixed_ints(int n) {
  const size_t v = static_cast<size_t>(n) +
                   static_cast<size_t>(kProducers) * ((n + 30) / 32);
  return v + (v & 1);
}

struct Chunk {
  int2* pair;      // (T, B): (j, w bits); the consumer replaces j by x[j]
  float* gumbel;   // (T, D)
  int* site;       // (T,)
};

__device__ __forceinline__ Chunk chunk_at(int* base, int b, int T, int B,
                                          int D) {
  int* p = base + b * chunk_ints(T, B, D);
  Chunk ch;
  ch.pair = reinterpret_cast<int2*>(p);
  ch.gumbel = reinterpret_cast<float*>(p + 2 * static_cast<size_t>(T) * B);
  ch.site = p + static_cast<size_t>(T) * (2 * B + D);
  return ch;
}

// Producer warp q: sub-steps s0 + q, s0 + q + kProducers, ... < s1.
__device__ __forceinline__ void produce(Chunk ch, uint32_t* bitmap, int n,
                                        const float* __restrict__ W,
                                        const int* __restrict__ i_sites,
                                        uint32_t seed, int c, int s0, int s1,
                                        int q, int S, int B, int D) {
  const int lane = threadIdx.x & 31;
  const int m = n - 1;
  const int words = (n + 30) / 32;
  for (int s = s0 + q; s < s1; s += kProducers) {
    const int slot = s - s0;
    const int i = __ldg(i_sites + static_cast<long long>(c) * S + s);
    for (int u = lane; u < D; u += 32)
      ch.gumbel[slot * D + u] =
          philox::gumbel(philox::uniform(seed, kGumbelStream, c, s, u));
    const float* wrow = W + static_cast<long long>(i) * n;
    int2* pair = ch.pair + static_cast<size_t>(slot) * B;
    for (int g0 = 0; g0 < B; g0 += 32 * kRounds) {
      int pick[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        pick[r] = -1;
        if (g0 + 32 * r < B) {
          pick[r] = floyd_round(bitmap, seed, c, s, g0 + 32 * r, B, m);
          __syncwarp();
        }
      }
      float w[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (pick[r] >= 0) {
          pick[r] += pick[r] >= i;                  // j: skip the site
          w[r] = __ldg(wrow + pick[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        if (pick[r] >= 0)
          pair[g0 + 32 * r + lane] = make_int2(pick[r], __float_as_int(w[r]));
    }
    for (int k = lane; k < words; k += 32) bitmap[k] = 0u;
    if (lane == 0) ch.site[slot] = i;
    __syncwarp();
  }
}

// The consumer warp: sub-steps s0 .. s1-1 in order.
__device__ __forceinline__ void consume(Chunk ch, int* xs, int s0, int s1,
                                        int B, int D, float scale) {
  const int lane = threadIdx.x & 31;
  for (int s = s0; s < s1; ++s) {
    const int slot = s - s0;
    int2* pair = ch.pair + static_cast<size_t>(slot) * B;
    for (int t = lane; t < B; t += 32) pair[t].x = xs[pair[t].x];
    __syncwarp();
    // lane u0 + lane sums bucket u over t in order; each lane keeps the
    // first maximum of its buckets
    float best = -INFINITY;
    int best_u = INT_MAX;
    for (int u0 = 0; u0 < D; u0 += 32) {
      const int u = u0 + lane;
      float a = 0.f;
#pragma unroll 8
      for (int t = 0; t < B; ++t) {
        const int2 e = pair[t];
        a = __fadd_rn(a, e.x == u ? __int_as_float(e.y) : 0.f);
      }
      if (u < D) {
        const float sc =
            __fadd_rn(__fmul_rn(scale, a), ch.gumbel[slot * D + u]);
        if (best_u == INT_MAX || sc > best) {
          best = sc;
          best_u = u;
        }
      }
    }
    if (D <= 32) {
      // lane = bucket: the largest score as an order-preserving int key
      // (+0 for -0, which compares equal), then the lowest lane holding it
      const int b = __float_as_int(__fadd_rn(best, 0.f));
      const int key = lane < D ? (b >= 0 ? b : b ^ 0x7fffffff) : INT_MIN;
      const int top = __reduce_max_sync(kFull, key);
      best_u = __ffs(__ballot_sync(kFull, key == top)) - 1;
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int ou = __shfl_xor_sync(kFull, best_u, off);
        if (ou != INT_MAX &&
            (best_u == INT_MAX || ob > best || (ob == best && ou < best_u))) {
          best = ob;
          best_u = ou;
        }
      }
    }
    if (lane == 0) xs[ch.site[slot]] = best_u;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
local_gibbs_sweep_kernel(const int* __restrict__ x_in,
                         const float* __restrict__ W,
                         const int* __restrict__ i_sites,
                         const int* __restrict__ seed_ptr,
                         int* __restrict__ x_out, int n, int S, int B, int D,
                         float scale, int T, int nbuf) {
  extern __shared__ __align__(16) int smem[];
  const int words = (n + 30) / 32;
  int* xs = smem;                                             // n
  uint32_t* bitmaps = reinterpret_cast<uint32_t*>(xs + n);    // producers'
  int* bufs = smem + fixed_ints(n);                           // nbuf chunks
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const long long row = static_cast<long long>(c) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) xs[j] = x_in[row + j];
  for (int k = threadIdx.x; k < kProducers * words; k += kThreads)
    bitmaps[k] = 0u;
  __syncthreads();
  uint32_t* bitmap = bitmaps + (warp > 0 ? (warp - 1) * words : 0);
  const int chunks = (S + T - 1) / T;
  // step k: the producers fill chunk k while the consumer runs chunk k-1
  // (one buffer: first the consumer, then the producers)
  for (int k = 0; k <= chunks; ++k) {
    if (warp == 0 && k >= 1)
      consume(chunk_at(bufs, (k - 1) % nbuf, T, B, D), xs, (k - 1) * T,
              min(k * T, S), B, D, scale);
    if (nbuf == 1) __syncthreads();
    if (warp > 0 && k < chunks)
      produce(chunk_at(bufs, k % nbuf, T, B, D), bitmap, n, W, i_sites, seed,
              c, k * T, min((k + 1) * T, S), warp - 1, S, B, D);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += kThreads) x_out[row + j] = xs[j];
}

// Opt-in shared memory one block may use on the current device (cached).
int smem_allowance() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}

}  // namespace

extern "C" {

// x (C, n) int32, W (n, n) float32, i_sites (C, S) int32, seed (1,) int32,
// x_out (C, n) int32, all contiguous on the card.  C >= 1, n >= 2,
// 1 <= B <= n - 1, D >= 1; sites in [0, n).  Chunks of kChunk sub-steps in
// two buffers; fewer sub-steps per chunk, then one buffer, when shared
// memory runs short; cudaErrorInvalidValue when one sub-step does not fit.
int local_gibbs_sweep_launch(const int* x, const float* W, const int* i_sites,
                             const int* seed, int* x_out, int C, int n, int S,
                             int B, int D, float scale, cudaStream_t stream) {
  const size_t allowance = static_cast<size_t>(smem_allowance());
  const auto bytes = [&](int T, int nbuf) {
    return sizeof(int) * (fixed_ints(n) + nbuf * chunk_ints(T, B, D));
  };
  int T = S < kChunk ? (S > 0 ? S : 1) : kChunk, nbuf = 2;
  while (T > 1 && bytes(T, 2) > allowance) --T;
  if (bytes(T, 2) > allowance) nbuf = 1;
  if (bytes(T, nbuf) > allowance)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bytes(T, nbuf);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_gibbs_sweep_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  local_gibbs_sweep_kernel<<<C, kThreads, smem, stream>>>(
      x, W, i_sites, seed, x_out, n, S, B, D, scale, T, nbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
