// One chromatic Gibbs color class for Hopper (sm_90a): every (chain, site)
// of the class updated at once, in place.
//
// Replaces gibbs_sweep_pallas (src/repro/kernels/fused_sweep.py:577, body
// _sweep_kernel with mh=False) on the chromatic path
// (src/repro/core/samplers.py, make_chromatic_gibbs_sweep), where the JAX
// engine feeds a whole color class through the sequential sweep.  Same-color
// sites share no factor, so every update of a class reads only the state
// the class started from: for every chain c and site i = sites[k]
//   eps_u = sum_j W[i, j] 1[x_j = u],  x_i <- argmax_u eps_u + g[c, k, u]
// (first maximum; values of x outside [0, D) match no bucket).  That is the
// sequential kernel's result for the class in any order: an in-class j has
// W[i, j] = 0, and a skipped term adds +0.
//
// The kernel takes the class's uniforms u (C, m, D), as torch.rand drew
// them, and makes each Gumbel itself: g = -logf(-logf(fmaxf(u, FLT_MIN))),
// the operations of samplers.gumbel (clamp_min_, log_, neg_, log_, neg_;
// ATen's float32 log is logf), so the engine's draws and its states keep
// their bits while the five elementwise passes over the class's noise go.
//
// The sum walks only the non-zero entries of row i, from a CSR neighbour
// table (MatchGraph.nbr_pack): row offsets (n + 1) and one 8-byte record
// (j, W[i, j]'s bits) per non-zero, j ascending, summed in that order with
// round-to-nearest adds.
//
// Bound: bytes -- x read and written once, the uniforms (4*C*|class|*D),
// the class rows' records (8 per non-zero) and the sites; about 12.7 MB,
// 3.8 us, for one class of lattice-ising-64x64 at C=256.  What the chain
// does not change -- a site, its offsets, its records -- is the same for
// every chain, so a block takes a tile of kClassThreads class sites (one a
// thread) and a group of at least kMinChains chains: each thread loads its
// row once, keeps up to kRowRecords records in registers and walks the
// group's chains, kChainBatch at a time (each chain's four x gathers and
// its uniform row, one 8- or 16-byte load where D fills the bucket
// registers, issued together).  The group's size is picked so that the
// grid is one wave of the card's resident blocks.  Measured on an H100
// (PERF.md, row 1b): threads hide the gathers' latency better than more
// chains in flight a thread, which cost registers; and the bucket sums
// are written without branches, since ptxas kept `if (v == b) acc[b] +=
// w` as an indexed update of a local-memory array, twice the kernel's
// time.  A row of more records (up to kThreadDegree) is walked from memory
// per chain; a warp's rows above that are taken in turn by the whole warp
// (records strided over the lanes, each bucket summed by a fixed shuffle
// tree).  D buckets sit in registers up to kD; above it, D-chunks of kD
// walk the row's records again, from cache.
//
// In place: the kernel writes x[c, i] for the class sites and reads x[c, j]
// for their neighbours, which are never class sites under a proper
// coloring (the engine checks it at build time), and x[c, i] of its own
// site before writing it, so no thread reads what another writes.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kClassThreads = 128;   // class sites of a tile, one a thread
constexpr int kThreadDegree = 32;    // rows above it are summed by a warp
constexpr int kRowRecords = 4;       // records of a row kept in registers
constexpr int kChainBatch = 1;       // chains whose loads fly together
constexpr int kMinChains = 8;        // fewest chains a block takes
// ptxas's register budget: told that one block an SM must fit, it keeps
// the kD = 2 instance's hot loop in 56 registers; left to its own
// heuristic it chose fewer and spilled to local memory, 23% slower on an
// H100 (PERF.md, row 1b)
constexpr int kMinBlocks = 1;
constexpr int kMaxGridY = 65535;

// samplers.gumbel's float32 operations on one uniform, in its order
__device__ __forceinline__ float gumbel_of(float u) {
  return -logf(-logf(fmaxf(u, FLT_MIN)));
}

// The Gumbels of buckets [u0, u0 + kD) of D from one (chain, site) row of
// uniforms; kVec: the row is 16-byte aligned and D == kD, one vector load.
template <int kD, bool kVec>
__device__ __forceinline__ void load_gumbels(const float* row, int u0, int D,
                                             float (&g)[kD]) {
  if constexpr (kVec) {
    if constexpr (kD == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(row));
      g[0] = v.x;
      g[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < kD / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row) + q);
        g[4 * q] = v.x;
        g[4 * q + 1] = v.y;
        g[4 * q + 2] = v.z;
        g[4 * q + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kD; ++k)
      g[k] = u0 + k < D ? __ldg(row + u0 + k) : 1.f;
  }
#pragma unroll
  for (int k = 0; k < kD; ++k)
    if (u0 + k < D) g[k] = gumbel_of(g[k]);
}

template <int kD>
__device__ __forceinline__ void load_gumbels(const float* row, int u0, int D,
                                             bool vec, float (&g)[kD]) {
  if (vec)
    load_gumbels<kD, true>(row, u0, D, g);
  else
    load_gumbels<kD, false>(row, u0, D, g);
}

// Argmax of eps + g over buckets [u0, u0 + kD) of D, merged into (top,
// best) with the first maximum kept (`first`: no earlier chunk).
template <int kD>
__device__ __forceinline__ void merge_argmax(const float (&acc)[kD],
                                             const float (&g)[kD], int u0,
                                             int D, bool first, float& top,
                                             int& best) {
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    if (u0 + k >= D) break;
    const float sc = __fadd_rn(acc[k], g[k]);
    if ((first && k == 0) || sc > top) { top = sc; best = u0 + k; }
  }
}

// The new value of site i of chain row xc, by one thread, the row's
// records read from memory (degree above kRowRecords, or D above kD).
template <int kD>
__device__ __forceinline__ int site_update_thread(
    const int* xc, const int2* __restrict__ rec, int lo, int hi,
    const float* urow, int D, bool vec) {
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
    float g[kD];
    load_gumbels<kD>(urow, u0, D, vec, g);
    merge_argmax<kD>(acc, g, u0, D, u0 == 0, top, best);
  }
  return best;
}

// The same by the whole warp: lane l sums records lo + l, lo + l + 32, ...,
// then a butterfly gives every lane the bucket totals.
template <int kD>
__device__ __forceinline__ int site_update_warp(
    const int* xc, const int2* __restrict__ rec, int lo, int hi,
    const float* urow, int D, bool vec, int lane) {
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
    float g[kD];
    load_gumbels<kD>(urow, u0, D, vec, g);
    merge_argmax<kD>(acc, g, u0, D, u0 == 0, top, best);
  }
  return best;
}

// Site i (class index k) of chains [c0, c1): the row's records held in
// registers (degree <= kRowRecords, D <= kD), padded to kRowRecords with
// (i, +0) -- x[c, i] is this thread's own site, read before it is written,
// and a +0 term leaves every bucket's bits as they were -- so that every
// chain runs the same unpredicated loads; kChainBatch chains' gathers and
// uniform rows are issued before their sums.
template <int kD, bool kVec>
__device__ __forceinline__ void site_update_chains(
    int* x, const int2* __restrict__ rec, const float* __restrict__ u, int n,
    int m, int D, int k, int i, int lo, int deg, int c0, int c1) {
  int rj[kRowRecords];
  float rw[kRowRecords];
#pragma unroll
  for (int q = 0; q < kRowRecords; ++q) {
    const int2 e = q < deg ? __ldg(rec + lo + q) : make_int2(i, 0);
    rj[q] = e.x;
    rw[q] = __int_as_float(e.y);
  }
  const long long ustep = static_cast<long long>(m) * D;
  int* xc = x + static_cast<long long>(c0) * n;
  const float* ur = u + static_cast<long long>(c0) * ustep +
                    static_cast<long long>(k) * D;
  for (int c = c0; c < c1; c += kChainBatch) {
    int v[kChainBatch][kRowRecords];
    float g[kChainBatch][kD];
#pragma unroll
    for (int t = 0; t < kChainBatch; ++t) {
      if (kChainBatch > 1 && c + t >= c1) break;
#pragma unroll
      for (int q = 0; q < kRowRecords; ++q)
        v[t][q] = xc[static_cast<long long>(t) * n + rj[q]];
      load_gumbels<kD, kVec>(ur + t * ustep, 0, D, g[t]);
    }
#pragma unroll
    for (int t = 0; t < kChainBatch; ++t) {
      if (kChainBatch > 1 && c + t >= c1) break;
      float acc[kD];
#pragma unroll
      for (int b = 0; b < kD; ++b) acc[b] = 0.f;
      // every bucket takes every record, w where it matches and +0 where
      // not: the same bits as the plain sum (no bucket is ever -0), and
      // no branch for the compiler to fold into an indexed update of a
      // local-memory array (which it did to `if (v == b) acc[b] += w`)
#pragma unroll
      for (int q = 0; q < kRowRecords; ++q)
#pragma unroll
        for (int b = 0; b < kD; ++b)
          acc[b] = __fadd_rn(acc[b], v[t][q] == b ? rw[q] : 0.f);
      float top = 0.f;
      int best = 0;
      merge_argmax<kD>(acc, g[t], 0, D, true, top, best);
      xc[static_cast<long long>(t) * n + i] = best;
    }
    xc += static_cast<long long>(kChainBatch) * n;
    ur += kChainBatch * ustep;
  }
}

template <int kD>
__global__ void __launch_bounds__(kClassThreads, kMinBlocks)
gibbs_class_sweep_kernel(int* x, const int* __restrict__ offsets,
                         const int2* __restrict__ rec,
                         const int* __restrict__ sites,
                         const float* __restrict__ u, int C, int n, int m,
                         int D, int chains) {
  const int k = blockIdx.x * kClassThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * chains;
  const int c1 = min(C, c0 + chains);
  const bool live = k < m;
  const bool vec =
      D == kD && (reinterpret_cast<uintptr_t>(u) & 15) == 0;
  int i = 0, lo = 0, hi = 0;
  if (live) {
    i = __ldg(sites + k);
    lo = __ldg(offsets + i);
    hi = __ldg(offsets + i + 1);
  }
  const int deg = hi - lo;
  const bool heavy = live && deg > kThreadDegree;
  if (live && !heavy) {
    if (deg <= kRowRecords && D <= kD) {
      if (vec)
        site_update_chains<kD, true>(x, rec, u, n, m, D, k, i, lo, deg, c0,
                                     c1);
      else
        site_update_chains<kD, false>(x, rec, u, n, m, D, k, i, lo, deg, c0,
                                      c1);
    } else {
      for (int c = c0; c < c1; ++c) {
        int* xc = x + static_cast<long long>(c) * n;
        xc[i] = site_update_thread<kD>(
            xc, rec, lo, hi, u + (static_cast<long long>(c) * m + k) * D, D,
            vec);
      }
    }
  }
  // the warp's high-degree sites, one after another, by all its lanes
  for (unsigned todo = __ballot_sync(0xffffffffu, heavy); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int kk = __shfl_sync(0xffffffffu, k, src);
    const int ii = __shfl_sync(0xffffffffu, i, src);
    const int l2 = __shfl_sync(0xffffffffu, lo, src);
    const int h2 = __shfl_sync(0xffffffffu, hi, src);
    for (int c = c0; c < c1; ++c) {
      int* xc = x + static_cast<long long>(c) * n;
      const int v = site_update_warp<kD>(
          xc, rec, l2, h2, u + (static_cast<long long>(c) * m + kk) * D, D,
          vec, lane);
      if (lane == src) xc[ii] = v;
    }
  }
}

// The launch's shape: (chains a block, site tiles, chain groups, resident
// blocks an SM).  Chains a block: the fewest that fit the whole grid into
// one wave of resident blocks, at least kMinChains, a multiple of
// kChainBatch.
template <int kD>
int plan_class(int C, int m, int* out) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gibbs_class_sweep_kernel<kD>, kClassThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  const long long tiles = (m + kClassThreads - 1) / kClassThreads;
  const long long slots = static_cast<long long>(sms) * per_sm;
  long long chains = (static_cast<long long>(C) * tiles + slots - 1) / slots;
  if (chains < kMinChains) chains = kMinChains;
  chains = (chains + kChainBatch - 1) / kChainBatch * kChainBatch;
  const long long fewest = (static_cast<long long>(C) + kMaxGridY - 1) /
                           kMaxGridY;
  if (chains < fewest) chains = fewest;
  if (chains > C) chains = C;
  out[0] = static_cast<int>(chains);
  out[1] = static_cast<int>(tiles);
  out[2] = static_cast<int>((C + chains - 1) / chains);
  out[3] = per_sm;
  return 0;
}

template <int kD>
int launch_class(int* x, const int* offsets, const int* records,
                 const int* sites, const float* u, int C, int n, int m,
                 int D, cudaStream_t stream) {
  int plan[4];
  const int err = plan_class<kD>(C, m, plan);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(plan[1]),
                  static_cast<unsigned>(plan[2]));
  gibbs_class_sweep_kernel<kD><<<grid, kClassThreads, 0, stream>>>(
      x, offsets, reinterpret_cast<const int2*>(records), sites, u, C, n, m,
      D, plan[0]);
  return static_cast<int>(cudaGetLastError());
}

__global__ void gumbel_transform_kernel(const float* __restrict__ u,
                                        float* __restrict__ g,
                                        long long count) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < count; t += static_cast<long long>(gridDim.x) * blockDim.x)
    g[t] = gumbel_of(u[t]);
}

}  // namespace

extern "C" {

// x (C, n) updated in place; offsets (n + 1); records (nnz, 2) int32 as
// 8-byte (j, W bits) records; sites (m); u (C, m, D) float32 uniforms.
int gibbs_class_sweep_launch(int* x, const int* offsets, const int* records,
                             const int* sites, const float* u, int C, int n,
                             int m, int D, cudaStream_t stream) {
  if (D <= 2)
    return launch_class<2>(x, offsets, records, sites, u, C, n, m, D, stream);
  if (D <= 4)
    return launch_class<4>(x, offsets, records, sites, u, C, n, m, D, stream);
  if (D <= 8)
    return launch_class<8>(x, offsets, records, sites, u, C, n, m, D, stream);
  return launch_class<16>(x, offsets, records, sites, u, C, n, m, D, stream);
}

// The class launch's plan for (C, m, D): out (4 int32) = chains a block,
// site tiles, chain groups, resident blocks an SM.
int gibbs_class_plan(int C, int m, int D, int* out) {
  if (D <= 2) return plan_class<2>(C, m, out);
  if (D <= 4) return plan_class<4>(C, m, out);
  if (D <= 8) return plan_class<8>(C, m, out);
  return plan_class<16>(C, m, out);
}

// g[t] = the class kernel's Gumbel of u[t], for t < count (the check of the
// in-kernel transform against samplers.gumbel's operations).
int gumbel_transform_launch(const float* u, float* g, long long count,
                            cudaStream_t stream) {
  if (count > 0)
    gumbel_transform_kernel<<<1056, 256, 0, stream>>>(u, g, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
