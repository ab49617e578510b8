// One streaming telemetry update for Hopper (sm_90a): the whole of
// diagnostics/telemetry.py::telemetry_update_plain in one launch.
//
// Replaces no Pallas kernel: the JAX package computes the update in jnp
// (src/repro/diagnostics/telemetry.py:125, telemetry_update), where XLA
// fuses it.  Eager PyTorch issues it as ~30-40 operations, and on the card
// their host issue, not their device time, set the telemetry'd sweep
// call's pace.  Here one launch reads x_old and x_new once and, for each
// (chain, site), updates both Welford halves (the second only when the host
// says the snapshot falls in it), the K lag sums from ring slots head ..
// head+K-1 and the new snapshot into the double ring at slots head' and
// head'+K; per site, over its chains, the flip count and the sweep's
// proposal / acceptance counters; per chain, the acceptances; and the
// scalars (samples, samples_h, updates, the live lags' pair counts, the
// windowed acceptance and the sticky bad-state flag).  An engine's
// instrumented sweep hands over the sites it updated rather than counts
// (SiteDraws): the launch counts them too, one float atomicAdd of 1 per
// (chain, sub-step), and takes a sweep's accepted moves from the flips it
// counts anyway, so the counting costs the host no operation.
//
// The host keeps the carry's head, sample count and split and passes every
// branch as an argument (the new counts, whether the snapshot is in the
// second half, the lags that are live), so no thread reads a device scalar
// that another thread writes.  One thread writes the scalars.
//
// Bits: the arithmetic is the plain version's, operation for operation,
// each written with an explicit round-to-nearest intrinsic (the build's
// -fmad=false contracts nothing): d = x - mean; mean += d / k (IEEE
// division, as ATen's true division on the card); m2 += d * (x - mean) and
// cross += prev * x as one fused multiply-add each, because ATen's
// addcmul_ kernel is built with contraction on and rounds once (with a
// rounded product instead, m2 left the plain version's bits on the H100).
// Column sums of flips and the per-chain acceptance sum are sums of
// integers below 2^24, exact in any order, so float atomicAdd changes no
// bit; so are the site hits counted from the sites.  The mean of the
// acceptance increments is the sum times the float factor 1/C, as ATen's
// mean on the card computes it.  bad_state only ever becomes 1.0.
//
// Bound: bytes.  Per (chain, site) x_old and x_new are read (8 B), the
// first-half Welford pair read and written (16 B), the K ring slots read
// (4K B), the K lag sums read and written (8K B) and two ring slots written
// (8 B); the second-half pair adds 16 B.  At C=256, n=4096, K=8: 128 MiB
// (first half) or 144 MiB (second half), ~0.04-0.045 ms at 3.35 TB/s.  A
// thread takes one site of kChains consecutive chains, so a warp reads 128
// contiguous bytes per field and the K ring and lag loads of one element
// are independent (issued together).
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // sites per block
constexpr int kChains = 4;      // chains per block (a thread's loop)
constexpr int kLagUnroll = 8;   // ring slots / lag sums loaded together

struct Carry {
  float* mean;
  float* m2;
  float* mean_h;
  float* m2_h;
  float* prev;        // (2K, C, n)
  float* cross;       // (K, C, n)
  float* cross_n;     // (K,)
  float* accepts;     // (C,)
  float* site_prop;   // (n,)
  float* site_acc;    // (n,)
  float* site_flips;  // (n,)
  float* samples;
  float* samples_h;
  float* updates;
  float* bad_state;
  float* win_prop;
  float* win_acc;
};

struct Inputs {
  const int* x_old;        // (C, n)
  const int* x_new;        // (C, n)
  const void* delta;       // (C,) int32 or float32, or null
  const float* stat_prop;  // (n,) counters (stats_kind 1)
  const float* stat_acc;   // (n,) counters (stats_kind 1)
  const int* sites;        // (C, S) sites updated (stats_kind 2 and 3)
  const float* cache;      // (C,) or null
};

// what the sweep reports per site: nothing, counts, or the sites it updated
// with acceptances = the hits (exact accept) or = the value changes
enum StatsKind { kNoStats = 0, kCounts = 1, kSitesHits = 2, kSitesMoves = 3 };

struct Plan {
  int C, n, K;
  int head;         // ring slot of x_{t-1} before this update
  int new_head;     // (head - 1) mod K: slots new_head and new_head + K
  int live;         // lags whose pair count grows: min(count, K)
  int count_new;    // samples after this update
  int second;       // 1 when the snapshot feeds the second half
  int count_h_new;  // samples_h after this update (when second)
  int hi;           // site values must lie below hi (D, or INT_MAX)
  int delta_kind;   // 0: no accept_delta, 1: int32, 2: float32
  int stats_kind;   // StatsKind
  int S;            // sub-steps per chain in ``sites``
  float upd;        // site updates per chain in this call
  float decay;      // HEALTH_DECAY, rounded to float as ATen's mul_ does
};

__device__ __forceinline__ float delta_at(const Inputs& in, int kind,
                                          int c) {
  return kind == 1
             ? static_cast<float>(static_cast<const int*>(in.delta)[c])
             : static_cast<const float*>(in.delta)[c];
}

// The scalars, written by lane 0 of the first warp after the warp sums
// the acceptance increments (integers: exact in any order).  No other
// thread reads them.
__device__ void update_scalars(const Carry& t, const Inputs& in,
                               const Plan& p) {
  const int lane = threadIdx.x;
  float sum = 0.0f;
  if (p.delta_kind != 0)
    for (int c = lane; c < p.C; c += 32)
      sum = __fadd_rn(sum, delta_at(in, p.delta_kind, c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (lane != 0) return;
  *t.samples = static_cast<float>(p.count_new);
  if (p.second) *t.samples_h = static_cast<float>(p.count_h_new);
  for (int l = 0; l < p.live; ++l)
    t.cross_n[l] = __fadd_rn(t.cross_n[l], 1.0f);
  *t.win_prop = __fadd_rn(__fmul_rn(*t.win_prop, p.decay), p.upd);
  const float win = __fmul_rn(*t.win_acc, p.decay);
  // ATen's mean on the card: the sum times float(1) / C
  *t.win_acc = __fadd_rn(win, p.delta_kind == 0 ? p.upd : __fmul_rn(
      sum, __fdiv_rn(1.0f, static_cast<float>(p.C))));
  *t.updates = __fadd_rn(*t.updates, p.upd);
}

__global__ void __launch_bounds__(kThreads)
telemetry_update_kernel(Carry t, Inputs in, Plan p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c0 = blockIdx.y * kChains;
  const int c1 = min(p.C, c0 + kChains);
  const size_t plane = static_cast<size_t>(p.C) * p.n;
  const float k = static_cast<float>(p.count_new);
  const float kh = static_cast<float>(p.count_h_new);
  bool bad = false;
  if (i < p.n) {
    float flips = 0.0f;
    for (int c = c0; c < c1; ++c) {
      const size_t e = static_cast<size_t>(c) * p.n + i;
      const int xo = in.x_old[e];
      const int xn = in.x_new[e];
      flips = __fadd_rn(flips, xo != xn ? 1.0f : 0.0f);
      bad = bad || xn < 0 || xn >= p.hi;
      const float xf = static_cast<float>(xn);

      float mu = t.mean[e];
      const float d = __fsub_rn(xf, mu);
      mu = __fadd_rn(mu, __fdiv_rn(d, k));
      t.mean[e] = mu;
      t.m2[e] = __fmaf_rn(d, __fsub_rn(xf, mu), t.m2[e]);
      if (p.second) {
        float muh = t.mean_h[e];
        const float dh = __fsub_rn(xf, muh);
        muh = __fadd_rn(muh, __fdiv_rn(dh, kh));
        t.mean_h[e] = muh;
        t.m2_h[e] = __fmaf_rn(dh, __fsub_rn(xf, muh), t.m2_h[e]);
      }

      // lag l + 1 pairs x_t with slot head + l (x_{t-l-1}); an unfilled
      // slot holds +0 and adds +0, as in the plain version
      for (int l0 = 0; l0 < p.K; l0 += kLagUnroll) {
        float pv[kLagUnroll], cv[kLagUnroll];
#pragma unroll
        for (int j = 0; j < kLagUnroll; ++j) {
          if (l0 + j < p.K) {
            pv[j] = t.prev[(p.head + l0 + j) * plane + e];
            cv[j] = t.cross[(l0 + j) * plane + e];
          }
        }
#pragma unroll
        for (int j = 0; j < kLagUnroll; ++j)
          if (l0 + j < p.K)
            t.cross[(l0 + j) * plane + e] = __fmaf_rn(pv[j], xf, cv[j]);
      }
      // slot new_head + K is x_{t-K}, read above by this thread only
      t.prev[p.new_head * plane + e] = xf;
      t.prev[(p.new_head + p.K) * plane + e] = xf;
    }
    if (flips != 0.0f) {
      atomicAdd(&t.site_flips[i], flips);
      if (p.stats_kind == kSitesMoves) atomicAdd(&t.site_acc[i], flips);
    }
    if (blockIdx.y == 0 && p.stats_kind == kCounts) {
      t.site_prop[i] = __fadd_rn(t.site_prop[i], in.stat_prop[i]);
      t.site_acc[i] = __fadd_rn(t.site_acc[i], in.stat_acc[i]);
    }
  }
  if (p.stats_kind == kSitesHits || p.stats_kind == kSitesMoves) {
    // the site hits, over the whole grid: one entry per thread here
    const int draws = p.C * p.S;
    const int stride = gridDim.x * gridDim.y * kThreads;
    for (int e = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads +
                 threadIdx.x;
         e < draws; e += stride) {
      const int site = in.sites[e];
      if (site < 0 || site >= p.n) continue;   // the plain version raises
      atomicAdd(&t.site_prop[site], 1.0f);
      if (p.stats_kind == kSitesHits) atomicAdd(&t.site_acc[site], 1.0f);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < c1 - c0) {
    const int c = c0 + threadIdx.x;
    if (p.delta_kind != 0)
      t.accepts[c] =
          __fadd_rn(t.accepts[c], delta_at(in, p.delta_kind, c));
    if (in.cache != nullptr) bad = bad || !isfinite(in.cache[c]);
  }
  if (bad) *t.bad_state = 1.0f;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 32)
    update_scalars(t, in, p);
}

}  // namespace

extern "C" {

// Carry fields (float32, contiguous, on the card): mean, m2, mean_h, m2_h
// (C, n); prev (2K, C, n); cross (K, C, n); cross_n (K,); accepts (C,);
// site_prop, site_acc, site_flips (n,); samples, samples_h, updates,
// bad_state, win_prop, win_acc ().  Inputs: x_old, x_new (C, n) int32;
// delta (C,) int32 (delta_kind 1) or float32 (2) or null (0); stat_prop,
// stat_acc (n,) float32 (stats_kind 1) or null; sites (C, S) int32
// (stats_kind 2, 3) or null; cache (C,) float32 or null.
// C >= 1, n >= 1, 1 <= K, 0 <= head, new_head < K; ceil(C / 4) <= 65535.
int telemetry_update_launch(
    float* mean, float* m2, float* mean_h, float* m2_h, float* prev,
    float* cross, float* cross_n, float* accepts, float* site_prop,
    float* site_acc, float* site_flips, float* samples, float* samples_h,
    float* updates, float* bad_state, float* win_prop, float* win_acc,
    const int* x_old, const int* x_new, const void* delta,
    const float* stat_prop, const float* stat_acc, const int* sites,
    const float* cache, int C, int n, int K, int head, int new_head,
    int live, int count_new, int second, int count_h_new, int hi,
    int delta_kind, int stats_kind, int S, float upd, float decay,
    cudaStream_t stream) {
  const Carry t{mean, m2, mean_h, m2_h, prev, cross, cross_n, accepts,
                site_prop, site_acc, site_flips, samples, samples_h,
                updates, bad_state, win_prop, win_acc};
  const Inputs in{x_old, x_new, delta, stat_prop, stat_acc, sites, cache};
  const Plan p{C,  n,   K,          head,       new_head, live,
               count_new, second, count_h_new, hi, delta_kind, stats_kind,
               S,  upd, decay};
  const dim3 grid((n + kThreads - 1) / kThreads,
                  (C + kChains - 1) / kChains);
  telemetry_update_kernel<<<grid, kThreads, 0, stream>>>(t, in, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
