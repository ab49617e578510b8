// One chromatic Gibbs color class for Hopper (sm_90a): every (chain, site)
// of the class updated at once, in place.
//
// Replaces gibbs_sweep_pallas (src/repro/kernels/fused_sweep.py:577, body
// _sweep_kernel with mh=False) on the chromatic path
// (src/repro/core/samplers.py, make_chromatic_gibbs_sweep), where the JAX
// engine feeds a whole color class through the sequential sweep.  Same-color
// sites share no factor, so every update of a class reads only the state
// the class started from: for every chain c and site i of the class
//   eps_u = sum_j W[i, j] 1[x_j = u],  x_i <- argmax_u eps_u + g[c, k, u]
// (first maximum; values of x outside [0, D) match no bucket).  That is the
// sequential kernel's result for the class in any order: an in-class j has
// W[i, j] = 0, and a skipped term adds +0.
//
// The sum walks only the non-zero entries of row i, from a CSR neighbour
// table (MatchGraph.nbr_pack): row offsets (n + 1) and one 8-byte record
// (j, W[i, j]'s bits) per non-zero, j ascending, summed in that order.
// Threads take (chain, site) items with the chain as the outer index, so
// neighbouring threads take neighbouring sites of one chain and read the
// Gumbel rows and x in order.  A row of degree <= kThreadDegree is one
// thread's; a warp's rows above it are taken in turn by the whole warp
// (records strided over the lanes, each bucket summed by a fixed shuffle
// tree).  D buckets sit in registers up to kD; above it, D-chunks of kD
// walk the row's records again, from cache.
//
// In place: the kernel writes x[c, i] for the class sites and reads x[c, j]
// for their neighbours only, which are never class sites under a proper
// coloring (the engine checks it at build time), so no thread reads what
// another writes.
//
// Bound: bytes -- x read and written once, the Gumbels (4*C*|class|*D),
// the class rows' records (8 per non-zero) and the sites; about 12.6 MB,
// 3.8 us, for one class of lattice-ising-64x64 at C=256.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClassThreads = 256;
constexpr int kThreadDegree = 32;

// Argmax of eps + g over buckets [u0, u0 + kD) of D, merged into (top,
// best) with the first maximum kept (`first`: no earlier chunk).
template <int kD>
__device__ __forceinline__ void merge_argmax(const float (&acc)[kD],
                                             const float* g, int u0, int D,
                                             bool first, float& top,
                                             int& best) {
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    if (u0 + k >= D) break;
    const float sc = __fadd_rn(acc[k], __ldg(g + u0 + k));
    if ((first && k == 0) || sc > top) { top = sc; best = u0 + k; }
  }
}

// The new value of site i of chain row xc, by one thread.
template <int kD>
__device__ __forceinline__ int site_update_thread(
    const int* xc, const int2* __restrict__ rec, int lo, int hi,
    const float* g, int D) {
  float top = 0.f;
  int best = 0;
  for (int u0 = 0; u0 < D; u0 += kD) {
    float acc[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) acc[k] = 0.f;
    for (int r = lo; r < hi; ++r) {
      const int2 e = __ldg(rec + r);
      const int v = xc[e.x] - u0;
      const float w = __int_as_float(e.y);
#pragma unroll
      for (int k = 0; k < kD; ++k)
        if (v == k) acc[k] += w;
    }
    merge_argmax<kD>(acc, g, u0, D, u0 == 0, top, best);
  }
  return best;
}

// The same by the whole warp: lane l sums records lo + l, lo + l + 32, ...,
// then a butterfly gives every lane the bucket totals.
template <int kD>
__device__ __forceinline__ int site_update_warp(
    const int* xc, const int2* __restrict__ rec, int lo, int hi,
    const float* g, int D, int lane) {
  float top = 0.f;
  int best = 0;
  for (int u0 = 0; u0 < D; u0 += kD) {
    float acc[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) acc[k] = 0.f;
    for (int r = lo + lane; r < hi; r += 32) {
      const int2 e = __ldg(rec + r);
      const int v = xc[e.x] - u0;
      const float w = __int_as_float(e.y);
#pragma unroll
      for (int k = 0; k < kD; ++k)
        if (v == k) acc[k] += w;
    }
#pragma unroll
    for (int k = 0; k < kD; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    merge_argmax<kD>(acc, g, u0, D, u0 == 0, top, best);
  }
  return best;
}

template <int kD>
__global__ void __launch_bounds__(kClassThreads)
gibbs_class_sweep_kernel(int* x, const int* __restrict__ offsets,
                         const int2* __restrict__ rec,
                         const int* __restrict__ sites,
                         const float* __restrict__ gumbel, int n, int m,
                         int D, long long items) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kClassThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = item < items;
  long long c = 0;
  int i = 0, lo = 0, hi = 0;
  if (live) {
    c = item / m;
    i = __ldg(sites + (item - c * m));
    lo = __ldg(offsets + i);
    hi = __ldg(offsets + i + 1);
  }
  const bool heavy = live && hi - lo > kThreadDegree;
  if (live && !heavy) {
    int* xc = x + c * n;
    xc[i] = site_update_thread<kD>(xc, rec, lo, hi, gumbel + item * D, D);
  }
  // the warp's high-degree items, one after another, by all its lanes
  for (unsigned todo = __ballot_sync(0xffffffffu, heavy); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const long long it = __shfl_sync(0xffffffffu, item, src);
    const long long cc = __shfl_sync(0xffffffffu, c, src);
    const int ii = __shfl_sync(0xffffffffu, i, src);
    const int l2 = __shfl_sync(0xffffffffu, lo, src);
    const int h2 = __shfl_sync(0xffffffffu, hi, src);
    int* xc = x + cc * n;
    const int v = site_update_warp<kD>(xc, rec, l2, h2, gumbel + it * D, D,
                                       lane);
    if (lane == src) xc[ii] = v;
  }
}

template <int kD>
int launch_class(int* x, const int* offsets, const int* records,
                 const int* sites, const float* gumbel, int C, int n, int m,
                 int D, cudaStream_t stream) {
  const long long items = static_cast<long long>(C) * m;
  const long long blocks = (items + kClassThreads - 1) / kClassThreads;
  gibbs_class_sweep_kernel<kD><<<static_cast<unsigned>(blocks), kClassThreads,
                                 0, stream>>>(
      x, offsets, reinterpret_cast<const int2*>(records), sites, gumbel, n, m,
      D, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (C, n) updated in place; offsets (n + 1); records (nnz, 2) int32 as
// 8-byte (j, W bits) records; sites (m); gumbel (C, m, D).
int gibbs_class_sweep_launch(int* x, const int* offsets, const int* records,
                             const int* sites, const float* gumbel, int C,
                             int n, int m, int D, cudaStream_t stream) {
  if (D <= 2)
    return launch_class<2>(x, offsets, records, sites, gumbel, C, n, m, D,
                           stream);
  if (D <= 4)
    return launch_class<4>(x, offsets, records, sites, gumbel, C, n, m, D,
                           stream);
  if (D <= 8)
    return launch_class<8>(x, offsets, records, sites, gumbel, C, n, m, D,
                           stream);
  return launch_class<16>(x, offsets, records, sites, gumbel, C, n, m, D,
                          stream);
}

}  // extern "C"
