// Fused multi-site sweep kernels for Hopper (sm_90a): vanilla Gibbs, MGPMH,
// MIN-Gibbs and DoubleMIN, S sequentially composed site updates per chain
// in one launch.
//
// Replace the TPU kernels of src/repro/kernels/fused_sweep.py:
//   gibbs_sweep_pallas, mgpmh_sweep_pallas(_rng)    body _sweep_kernel
//   min_gibbs_sweep_pallas(_rng)                    body _min_gibbs_kernel
//   double_min_sweep_pallas(_rng)                   body _double_min_kernel
// Semantics are those of the plain versions in ../ref.py: same pre-drawn
// inputs, same decisions.
//
// Layout: one thread block per chain; the chain's state row x lives in
// shared memory for all S sub-steps (sub-steps are sequential, so the loop
// over s replaces the TPU kernel's fori_loop).  The (n, n) tables stay in
// global memory and each sub-step reads only what it needs: the W row of
// the updated site (4n bytes), the alias entries its draws land on.  The
// Gibbs and MGPMH bodies know every row they will read at launch (the
// sites are drawn before it) and stream them through one ring of
// shared-memory stages with TMA copies ahead of the sub-steps (the row
// ring below); MGPMH's local draws read row i's packed 8-byte records.
// MIN-Gibbs and DoubleMIN, whose sub-steps each make up to D*K (K2)
// independent two-stage pair draws, take four consecutive lanes per thread
// and read one packed 8-byte row record (prob's bits, alias) per draw: one
// memory sector where two separate tables would cost two.
// Site ids and alias entries are int32 throughout.
//
// Random source: the three minibatch bodies are templates over where their
// uniforms come from, as the TPU file builds each body with host_rng
// True/False.  HostStreams reads pre-drawn streams (bit-comparable to the
// plain versions); PhiloxStreams computes the same lanes in-kernel from a
// (1,) int32 device seed (philox.cuh, layout in ../philox.py), so no
// (C, S, K)-sized stream exists in device memory.
//
// Determinism: float partial sums are reduced in a fixed order (per-thread
// strided sums, warp shuffles, then warp partials summed in warp order);
// counts are integers, added per warp and per block, whose sum
// does not depend on order or on how the draws are split.  Argmax takes
// the first maximum.
// Build with -fmad=false: the plain versions round every product and sum
// separately.
//
// Plain C interface (loaded with ctypes); every launch returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "philox.cuh"

namespace {

// the global-minibatch bodies (MIN-Gibbs, DoubleMIN) run ~10^5 independent
// random gathers per sub-step: more warps per block hide more latency
constexpr int kDrawThreads = 512;
constexpr int kDrawWarps = kDrawThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block size is a compile-time stride: read from blockDim.x, the stride
// slowed the whole Gibbs sweep on the H100 (PERF.md Findings).
template <int kBlock>
__device__ __forceinline__ void load_row(int* xs, const int* src, int n) {
  for (int j = threadIdx.x; j < n; j += kBlock) xs[j] = src[j];
  __syncthreads();
}

template <int kBlock>
__device__ __forceinline__ void store_row(int* dst, const int* xs, int n) {
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kBlock) dst[j] = xs[j];
}

// ---------------------------------------------------------------------------
// Random sources.  A body asks for lane `lane` of stream `st` at sub-step s
// of its chain; the stream ids are the table of ../philox.py.
// ---------------------------------------------------------------------------
constexpr int kMaxStreams = 8;

// Pre-drawn streams: p[st] holds (C, S, lanes[st]) values, chain-major.
// Gumbel and log-uniform streams hold the transformed values.
struct HostStreams {
  const float* p[kMaxStreams];
  int lanes[kMaxStreams];
  bool vec;       // the pair-draw streams: 16-byte rows (lanes % 4 == 0)
  long long row;  // c * S, set by begin()

  __device__ void begin(int c, int S) { row = static_cast<long long>(c) * S; }
  __device__ float at(int st, int s, int lane) const {
    return p[st][(row + s) * lanes[st] + lane];
  }
  __device__ float uniform(int st, int s, int lane) const {
    return at(st, s, lane);
  }
  __device__ float gumbel(int st, int s, int lane) const {
    return at(st, s, lane);
  }
  __device__ float logu(int st, int s) const { return at(st, s, 0); }
  // Lanes 4q..4q+3 (0 past the row's end; lane 4q lies in it): one 16-byte
  // load where the rows allow it.  Each stream value is read once, so the
  // loads stream past the caches (evict-first) and leave L2 to the row
  // table's records.
  __device__ float4 quad(int st, int s, int q) const {
    const float* r = p[st] + (row + s) * lanes[st];
    if (vec) return __ldcs(reinterpret_cast<const float4*>(r) + q);
    const int l = 4 * q, L = lanes[st];
    return make_float4(__ldcs(r + l), l + 1 < L ? __ldcs(r + l + 1) : 0.f,
                       l + 2 < L ? __ldcs(r + l + 2) : 0.f,
                       l + 3 < L ? __ldcs(r + l + 3) : 0.f);
  }
};

// In-kernel Philox4x32-10 keyed by (seed, stream), counter (lane/4, s, c).
struct PhiloxStreams {
  const int* seed_ptr;  // (1,) int32 on the device: no host sync
  uint32_t seed;
  int c;

  __device__ void begin(int c_, int) {
    c = c_;
    seed = static_cast<uint32_t>(__ldg(seed_ptr));
  }
  __device__ float uniform(int st, int s, int lane) const {
    return philox::uniform(seed, static_cast<uint32_t>(st), c, s, lane);
  }
  __device__ float gumbel(int st, int s, int lane) const {
    return philox::gumbel(uniform(st, s, lane));
  }
  __device__ float logu(int st, int s) const {
    return philox::log_uniform(uniform(st, s, 0));
  }
  // Lanes 4q..4q+3: the four words of one Philox call.
  __device__ float4 quad(int st, int s, int q) const {
    return philox::uniforms4(seed, static_cast<uint32_t>(st), c, s, q);
  }
};

__device__ __forceinline__ int scaled_index(float u, float fn, int n) {
  return min(static_cast<int>(__fmul_rn(u, fn)), n - 1);
}

// Two-stage global factor draws of lanes 4q..4q+3 of streams st0..st0+3:
// endpoint a from the node alias table (p_a = L_a / 2Psi), endpoint b from
// row a's alias table (p_b = W_ab / L_a).  Every table entry is one packed
// 8-byte record (prob's bits, alias): the node records (8n bytes) stay in
// cache, a row record is one random sector.  The four lanes' loads do not
// depend on each other, so a thread keeps four gather chains in flight.  A
// lane that is not live loads no record and draws (0, 0).
template <class Src>
__device__ __forceinline__ void pair_draw4(const Src& rng, int st0, int s,
                                           int q, const bool (&live)[4],
                                           const int2* __restrict__ node,
                                           const int2* __restrict__ row,
                                           int n, float fn, int (&a)[4],
                                           int (&b)[4]) {
  const float4 q0 = rng.quad(st0, s, q), q1 = rng.quad(st0 + 1, s, q);
  const float4 q2 = rng.quad(st0 + 2, s, q), q3 = rng.quad(st0 + 3, s, q);
  const float u0[4] = {q0.x, q0.y, q0.z, q0.w};
  const float u1[4] = {q1.x, q1.y, q1.z, q1.w};
  const float u2[4] = {q2.x, q2.y, q2.z, q2.w};
  const float u3[4] = {q3.x, q3.y, q3.z, q3.w};
  int idx[4];
  int2 rec[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    idx[j] = scaled_index(u0[j], fn, n);
    rec[j] = live[j] ? __ldg(node + idx[j]) : make_int2(0, 0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = u1[j] < __int_as_float(rec[j].x) ? idx[j] : rec[j].y;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    idx[j] = scaled_index(u2[j], fn, n);
    rec[j] = live[j]
                 ? __ldg(row + static_cast<long long>(a[j]) * n + idx[j])
                 : make_int2(0, 0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = u3[j] < __int_as_float(rec[j].x) ? idx[j] : rec[j].y;
}

// Sum of one int per thread over the block, returned on thread 0 (0 on the
// others): one reduction per warp, then the warp totals.  Integer sums do
// not depend on order.
template <int kBlock>
__device__ __forceinline__ int block_count(int m, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = __reduce_add_sync(0xffffffffu, m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBlock / 32; ++w) total += red[w];
  return total;
}

// ---------------------------------------------------------------------------
// The row ring, shared by the Gibbs and MGPMH bodies.
//
// The sites are drawn before the launch, so every W row a chain will read
// is known when it starts.  One producer warp (one thread of it) streams
// them through a ring of kStages = 2 stages in shared memory with 1-D bulk
// copies (TMA), one full and one empty mbarrier per stage, one sub-step
// ahead of the kConsumerThreads consumer threads; a stage is refilled when
// every consumer warp has arrived on its empty barrier.  (A deeper ring,
// up to 8 rows ahead, and no prefetch at all were measured against it on
// the Gibbs body: the consumers' sub-step, not the row stream, bounds the
// kernel, and rows one sub-step ahead hide the stream; PERF.md, Findings.)
// A row that fits twice beside the state is one stage; a longer row
// streams as fixed-size chunks, a multiple of the block, so every thread
// reads the same j in the same order either way and the bits do not depend
// on the plan.  Rows start anywhere (n need not be a multiple of 4): a
// stage holds the 16-byte aligned span around its row, and the float after
// the last aligned word of W (odd n only) is stored by the producer itself.
//
// Per pass each consumer thread sums its strided j (j = tid + k*block,
// ascending) into kD register buckets over the staged row (bucket_pass);
// each bucket is summed over the warp by a shuffle tree and the warp
// totals, in warp order, by lane u of every warp (bucket_total).  D > kD
// takes D-chunks of kD buckets over the staged row (over the row's chunks
// again where the row is chunked), one barrier per chunk.
//
// The state row lives in shared memory as int16 (n <= 2 * the int32 row of
// the other kernels): a value outside [0, D) is stored as -1, which
// matches no bucket, and is written back from x_in at the end (only
// updated sites change, and they take values in [0, D)).
// ---------------------------------------------------------------------------
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kStages = 2;
constexpr size_t kMaxSmem = 232448;                 // one block's most

struct RingPlan {
  int chunk;    // floats of a row per stage (n: whole rows)
  int chunks;   // Q = ceil(n / chunk)
  int stride;   // floats between stages: chunk + 3 rounded up to 32
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the consumer threads only (the producer warp leaves early)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
}

// First maximum of (score, index) over the warp: every lane gets it.
__device__ __forceinline__ void warp_argmax(float& sc, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, sc, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (o > sc || (o == sc && oi < idx)) { sc = o; idx = oi; }
  }
}

// Shared-memory layout: ring (kStages * stride floats, 128-byte aligned),
// full and empty mbarriers (kStages each), the site of each stage, the
// warp partials (2 x warps x kD), `extra` bytes of the body's own (a
// multiple of 4), the int16 state row (n).
size_t ring_smem(const RingPlan& p, int n, int kD, size_t extra) {
  return sizeof(float) * kStages * static_cast<size_t>(p.stride) +
         (2 * sizeof(uint64_t) + sizeof(int)) * kStages +
         sizeof(float) * 2 * kConsumerWarps * kD + extra +
         sizeof(int16_t) * n;
}

// Whole rows where two fit beside the state, else chunks of a multiple of
// the block; false when not even a block's width fits.
bool plan_ring(int n, int kD, size_t extra, RingPlan* p, size_t* smem) {
  p->stride = (n + 3 + 31) / 32 * 32;
  p->chunk = n;
  p->chunks = 1;
  if ((*smem = ring_smem(*p, n, kD, extra)) <= kMaxSmem) return true;
  p->stride = 0;
  const size_t fixed = ring_smem(*p, n, kD, extra);  // all but the ring
  if (fixed >= kMaxSmem) return false;
  // stride <= chunk + 3 + 31
  const long long fit = static_cast<long long>(
      (kMaxSmem - fixed) / (sizeof(float) * kStages)) - 34;
  p->chunk = static_cast<int>(fit / kConsumerThreads * kConsumerThreads);
  if (p->chunk < kConsumerThreads) return false;
  p->stride = (p->chunk + 3 + 31) / 32 * 32;
  p->chunks = (n + p->chunk - 1) / p->chunk;
  *smem = ring_smem(*p, n, kD, extra);
  return true;
}

// The ring's pieces of a block's dynamic shared memory (ring_smem's order).
struct Ring {
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  int* site;         // the site each stage holds a row (chunk) of
  float* red;        // warp partials, 2 x kConsumerWarps x kD
  void* extra;
  int16_t* xs;       // the state row
  int stride;
};

__device__ __forceinline__ Ring ring_carve(unsigned char* buf,
                                           const RingPlan& plan, int kD,
                                           size_t extra) {
  Ring r;
  r.stride = plan.stride;
  r.stages = reinterpret_cast<float*>(buf);
  r.full = reinterpret_cast<uint64_t*>(
      r.stages + static_cast<size_t>(kStages) * plan.stride);
  r.empty = r.full + kStages;
  r.site = reinterpret_cast<int*>(r.empty + kStages);
  r.red = reinterpret_cast<float*>(r.site + kStages);
  r.extra = r.red + 2 * kConsumerWarps * kD;
  r.xs = reinterpret_cast<int16_t*>(static_cast<unsigned char*>(r.extra) +
                                    extra);
  return r;
}

// Thread 0 sets up the barriers; the caller syncs the block after it.
__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(smem_u32(r.full + k), 1);
      mbar_init(smem_u32(r.empty + k), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// One thread of the producer warp: stages the S * per_s ring items of a
// chain (item t: sub-step t / per_s, row chunk (t % per_s) % Q of site
// sites[t / per_s]), each into stage t % kStages once every consumer warp
// has released that stage's previous item.
__device__ void ring_produce(const Ring& r, const float* __restrict__ W,
                             const int* __restrict__ sites, int n, int S,
                             int per_s, const RingPlan& plan) {
  const int Q = plan.chunks, chunk = plan.chunk;
  const long long last = static_cast<long long>(n) * n & ~3LL;
  const long long T = static_cast<long long>(S) * per_s;
  int i = 0;
  for (long long t = 0; t < T; ++t) {
    const int slot = static_cast<int>(t % kStages);
    if (t >= kStages)
      mbar_wait(smem_u32(r.empty + slot), ((t / kStages) - 1) & 1);
    const int e = static_cast<int>(t % per_s), q = e % Q;
    if (e == 0) i = __ldg(sites + t / per_s);
    r.site[slot] = i;
    // the chunk's floats [g0, g0 + len) of flat W, staged at
    // stage[mis ..]: the copy starts at the aligned word a = g0 - mis
    const long long g0 = static_cast<long long>(i) * n +
                         static_cast<long long>(q) * chunk;
    const long long g1 = g0 + min(chunk, n - q * chunk);
    const int mis = static_cast<int>(g0 & 3);
    const long long a = g0 - mis, b = min((g1 + 3) & ~3LL, last);
    float* stage = r.stages + static_cast<size_t>(slot) * plan.stride;
    for (long long f = max(b, g0); f < g1; ++f)
      stage[mis + (f - g0)] = __ldg(W + f);
    const uint32_t bar = smem_u32(r.full + slot);
    if (b > a) {
      const uint32_t bytes = static_cast<uint32_t>(4 * (b - a));
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(stage), W + a, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  }
}

// Wait for ring item t; returns its stage.
__device__ __forceinline__ int ring_wait(const Ring& r, long long t) {
  const int slot = static_cast<int>(t % kStages);
  mbar_wait(smem_u32(r.full + slot), (t / kStages) & 1);
  return slot;
}

// This warp is done with the stage.
__device__ __forceinline__ void ring_release(const Ring& r, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(r.empty + slot));
}

// The staged floats of site i's row (chunk) in stage `slot`.
__device__ __forceinline__ const float* ring_row(const Ring& r, int slot,
                                                 int i, int n) {
  const int mis = static_cast<int>(static_cast<long long>(i) * n & 3);
  return r.stages + static_cast<size_t>(slot) * r.stride + mis;
}

// The consumers load the chain's state as int16 (-1 outside [0, D)).
__device__ __forceinline__ void load_state(int16_t* xs, const int* xrow,
                                           int n, int D) {
  for (int j = threadIdx.x; j < n; j += kConsumerThreads) {
    const int v = xrow[j];
    xs[j] = static_cast<int16_t>(v >= 0 && v < D ? v : -1);
  }
}

// ... and store it back (a -1 from x_in: never updated).
__device__ __forceinline__ void store_state(int* out, const int16_t* xs,
                                            const int* xrow, int n) {
  for (int j = threadIdx.x; j < n; j += kConsumerThreads) {
    const int v = xs[j];
    out[j] = v >= 0 ? v : xrow[j];
  }
}

// acc[k] += w[j] for each of this thread's j < len with xq[j] == u0 + k.
template <int kD>
__device__ __forceinline__ void bucket_pass(const float* w,
                                            const int16_t* xq, int len,
                                            int u0, float (&acc)[kD]) {
#pragma unroll 4     // four j in flight per thread (6-8% faster, PERF.md)
  for (int j = threadIdx.x; j < len; j += kConsumerThreads) {
    const float wj = w[j];
    const int v = xq[j] - u0;
#pragma unroll
    for (int k = 0; k < kD; ++k)
      if (v == k) acc[k] += wj;
  }
}

// Each bucket summed over the warp; lane 0 stores the warp's kD partials.
template <int kD>
__device__ __forceinline__ void bucket_partials(float* rb,
                                                const float (&acc)[kD]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) rb[warp * kD + k] = v;
  }
}

// Lane k < kD: bucket k's block total, the warp partials in warp order.
template <int kD>
__device__ __forceinline__ float bucket_total(const float* rb, int lane) {
  float tot = rb[lane];
  for (int w2 = 1; w2 < kConsumerWarps; ++w2) tot += rb[w2 * kD + lane];
  return tot;
}

// ---------------------------------------------------------------------------
// Gibbs: eps_u = sum_j W[i,j] 1[x_j = u] for all u; x_i <- argmax eps + g.
//
// The row ring above feeds the consumers each sub-step's W row; lane u of
// every warp adds the Gumbel to bucket u's total and takes the first
// maximum with shuffles.  Every warp reaches the same argmax and writes it
// to x_i itself, so the sub-step ends at its single block barrier
// (partials double-buffered by pass).
// ---------------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kConsumerThreads + 32)
gibbs_sweep_kernel(const int* __restrict__ x_in, const float* __restrict__ W,
                   const int* __restrict__ i_sites,
                   const float* __restrict__ gumbel, int* __restrict__ x_out,
                   int n, int S, int D, RingPlan plan) {
  extern __shared__ __align__(128) unsigned char ring_buf[];
  const Ring r = ring_carve(ring_buf, plan, kD, 0);
  const int Q = plan.chunks, chunk = plan.chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = blockIdx.x;
  // D-chunks per sub-step; ring items per sub-step: one whole row read by
  // every D-chunk, or the row's Q chunks once per D-chunk
  const int P = (D + kD - 1) / kD;
  const int per_s = Q == 1 ? 1 : P * Q;
  ring_init(r);
  __syncthreads();
  if (warp == kConsumerWarps) {                     // the producer
    if (lane == 0) ring_produce(r, W, i_sites + c * S, n, S, per_s, plan);
    return;
  }

  // the consumers
  const int* xrow = x_in + c * n;
  load_state(r.xs, xrow, n, D);
  consumer_sync();
  long long t0 = 0;                                 // first item of s
  int pc = 0;                                       // passes so far
  for (int s = 0; s < S; ++s) {
    const float* g = gumbel + (c * S + s) * D;
    const float gpre = lane < kD && lane < D ? __ldg(g + lane) : 0.f;
    int i = 0, best = 0;
    float top = 0.f;
    for (int p = 0; p < P; ++p) {
      const int u0 = p * kD;
      float acc[kD];
#pragma unroll
      for (int k = 0; k < kD; ++k) acc[k] = 0.f;
      for (int q = 0; q < Q; ++q) {
        const long long t = t0 + (Q == 1 ? 0 : p * Q + q);
        const int slot = static_cast<int>(t % kStages);
        if (Q > 1 || p == 0) {
          ring_wait(r, t);
          if (p == 0 && q == 0) i = r.site[slot];
        }
        bucket_pass<kD>(ring_row(r, slot, i, n), r.xs + q * chunk,
                        min(chunk, n - q * chunk), u0, acc);
        if (Q > 1 || p == P - 1) ring_release(r, slot);
      }
      float* rb = r.red + (pc & 1) * kConsumerWarps * kD;
      bucket_partials<kD>(rb, acc);
      consumer_sync();
      float sc = -INFINITY;
      int idx = INT_MAX;
      if (lane < kD && u0 + lane < D) {
        sc = __fadd_rn(bucket_total<kD>(rb, lane),
                       p == 0 ? gpre : __ldg(g + u0 + lane));
        idx = u0 + lane;
      }
      warp_argmax(sc, idx);
      if (p == 0 || sc > top) { top = sc; best = idx; }
      ++pc;
    }
    t0 += per_s;
    if (lane == 0) r.xs[i] = static_cast<int16_t>(best);
    __syncwarp();
  }
  consumer_sync();
  store_state(x_out + c * n, r.xs, xrow, n);
}

// ---------------------------------------------------------------------------
// MGPMH: alias-draw B neighbours of i from row i's table, count their values
// (eps_u = scale * count_u), Gumbel-argmax proposal v, exact energies at v
// and x_i, accept iff logu < (exact_v - exact_xi) + (eps_xi - eps_v).
// Streams: 0 u_idx (K), 1 u_alias (K), 2 gumbel (D), 3 logu (1).
//
// The row ring feeds the consumers site i's W row one sub-step ahead.  One
// pass over it per sub-step does both jobs, which read only the state
// before x_i changes, so neither waits for the other:
//  (a) the exact energy of every value, into kD register buckets
//      (bucket_pass, as Gibbs);
//  (b) the draws: thread t makes draw t (then t + 256, ...) from row i's
//      packed 8-byte record (prob's bits, alias; one memory sector) and
//      counts its value with one shared add per value and warp
//      (__match_any_sync).  Its record load is issued before the row loop
//      and read after it; its uniforms, Gumbel and logu were loaded (the
//      Philox form: computed) in the sub-step before, B two before.
//      (Fetching them in their own sub-step was as fast for the host
//      form and 7% slower for the Philox form; loading each record a
//      whole sub-step ahead gained 1% and cost the Philox form 7%: the
//      draws' remaining cost is the random-sector traffic and the counts,
//      not the gather's latency; PERF.md, Findings.)
// Then one barrier: lane u of every warp forms scale * count_u + g_u and
// warp_argmax gives the first maximum v; exact_v and exact_xi are buckets
// v's and x_i's totals (warp partials in warp order), and the accept test
// is the parent's expression.  Every warp reaches the same decision and
// writes x_i itself.  Counts live in three buffers (sub-step s adds to
// s % 3 and zeroes (s + 1) % 3, which nobody reads or adds to until after
// the next barrier).  D > kD: D-chunks of the row as Gibbs; the draws are
// made in the first, v is known after its barrier, and each chunk gives
// the totals of v and x_i where it holds them.
//
// Bits: bucket u of a thread gets the adds of the first kernel's
// `(x_j == u) ? w : 0` in the same order (a skipped term is its +0, which
// leaves a sum that starts at +0 unchanged), then the same warp tree and
// warp order, so exact_v and exact_xi are the same floats.  The updated
// sites may hold anything: a value outside [0, D) matches no draw and no
// bucket (an updated site's current value then has energies 0 and 0) and
// is written back unchanged unless the site takes a proposal.
// ---------------------------------------------------------------------------
template <class Src, int kD>
__global__ void __launch_bounds__(kConsumerThreads + 32)
mgpmh_sweep_kernel(const int* __restrict__ x_in, const float* __restrict__ W,
                   const int2* __restrict__ row,
                   const int* __restrict__ i_sites, const int* __restrict__ B,
                   Src src, int* __restrict__ x_out,
                   int* __restrict__ accepts, int n, int S, int K, int D,
                   float scale, RingPlan plan) {
  extern __shared__ __align__(128) unsigned char ring_buf[];
  const Ring r = ring_carve(ring_buf, plan, kD, 3 * sizeof(int) * D);
  int* cnt = static_cast<int*>(r.extra);            // 3 x D
  const int Q = plan.chunks, chunk = plan.chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long c = blockIdx.x;
  const float fn = static_cast<float>(n);
  const int P = (D + kD - 1) / kD;
  const int per_s = Q == 1 ? 1 : P * Q;
  ring_init(r);
  __syncthreads();
  if (warp == kConsumerWarps) {                     // the producer
    if (lane == 0) ring_produce(r, W, i_sites + c * S, n, S, per_s, plan);
    return;
  }

  // the consumers
  Src rng = src;
  rng.begin(static_cast<int>(c), S);
  const int* xrow = x_in + c * n;
  const int* brow = B + c * S;
  auto total = [&](int s) { return s < S ? min(max(__ldg(brow + s), 0), K)
                                         : 0; };
  // sub-step s + 1's first-round uniforms, Gumbel of value `lane`, logu
  float ua = 0.f, ub = 0.f, gl = 0.f, lu = 0.f;
  auto fetch = [&](int s1, int b1) {
    if (s1 >= S) return;
    if (tid < b1) {
      ua = rng.uniform(0, s1, tid);
      ub = rng.uniform(1, s1, tid);
    }
    if (lane < D) gl = rng.gumbel(2, s1, lane);
    lu = rng.logu(3, s1);
  };
  int b_now = total(0), b_next = total(1);
  fetch(0, b_now);
  load_state(r.xs, xrow, n, D);
  for (int u = tid; u < 3 * D; u += kConsumerThreads) cnt[u] = 0;
  consumer_sync();
  long long t0 = 0;                                 // first item of s
  int pc = 0, acc_n = 0;                            // passes, accepts
  for (int s = 0; s < S; ++s) {
    const int b = b_now;
    const float u_idx = ua, u_alias = ub, g_lane = gl, logu = lu;
    b_now = b_next;
    b_next = total(s + 2);
    fetch(s + 1, b_now);
    int* cs = cnt + (s % 3) * D;
    for (int u = tid; u < D; u += kConsumerThreads)
      cnt[((s + 1) % 3) * D + u] = 0;
    int i = 0, xi = 0, v = 0;
    float ev = 0.f, ex = 0.f;
    for (int p = 0; p < P; ++p) {
      const int u0 = p * kD;
      float acc[kD];
#pragma unroll
      for (int k = 0; k < kD; ++k) acc[k] = 0.f;
      int idx = 0;
      int2 rec = make_int2(0, 0);
      for (int q = 0; q < Q; ++q) {
        const long long t = t0 + (Q == 1 ? 0 : p * Q + q);
        const int slot = static_cast<int>(t % kStages);
        if (Q > 1 || p == 0) {
          ring_wait(r, t);
          if (p == 0 && q == 0) {
            i = r.site[slot];
            xi = r.xs[i];
            if (tid < b) {                          // first draw: issue
              idx = scaled_index(u_idx, fn, n);
              rec = __ldg(row + static_cast<long long>(i) * n + idx);
            }
          }
        }
        bucket_pass<kD>(ring_row(r, slot, i, n), r.xs + q * chunk,
                        min(chunk, n - q * chunk), u0, acc);
        if (Q > 1 || p == P - 1) ring_release(r, slot);
      }
      if (p == 0) {                                 // the draws' values
        for (int k0 = 0; k0 < b; k0 += kConsumerThreads) {
          const int k = k0 + tid;
          int val = -1;
          if (k < b) {
            float ua2 = u_alias;
            if (k0 > 0) {
              idx = scaled_index(rng.uniform(0, s, k), fn, n);
              rec = __ldg(row + static_cast<long long>(i) * n + idx);
              ua2 = rng.uniform(1, s, k);
            }
            val = r.xs[ua2 < __int_as_float(rec.x) ? idx : rec.y];
          }
          // one add per value and warp
          const unsigned grp = __match_any_sync(0xffffffffu, val);
          if (val >= 0 && lane == __ffs(grp) - 1)
            atomicAdd(cs + val, __popc(grp));
        }
      }
      float* rb = r.red + (pc & 1) * kConsumerWarps * kD;
      bucket_partials<kD>(rb, acc);
      consumer_sync();
      if (p == 0) {                                 // the proposal
        float top = -INFINITY;
        for (int m = 0; m < D; m += 32) {
          float sc = -INFINITY;
          int id = INT_MAX;
          if (m + lane < D) {
            sc = __fadd_rn(__fmul_rn(scale, static_cast<float>(cs[m + lane])),
                           m == 0 ? g_lane : rng.gumbel(2, s, m + lane));
            id = m + lane;
          }
          warp_argmax(sc, id);
          if (m == 0 || sc > top) { top = sc; v = id; }
        }
      }
      const float tot = lane < kD ? bucket_total<kD>(rb, lane) : 0.f;
      const float tv = __shfl_sync(0xffffffffu, tot, (v - u0) & 31);
      const float tx = __shfl_sync(0xffffffffu, tot, (xi - u0) & 31);
      if (v >= u0 && v < u0 + kD) ev = tv;
      if (xi >= u0 && xi < u0 + kD) ex = tx;
      ++pc;
    }
    t0 += per_s;
    // a current value outside [0, D) (loaded as -1) counts no draw
    const float eps_xi =
        __fmul_rn(scale, static_cast<float>(xi >= 0 ? cs[xi] : 0));
    const float eps_v = __fmul_rn(scale, static_cast<float>(cs[v]));
    const float log_a = __fadd_rn(__fsub_rn(ev, ex), __fsub_rn(eps_xi, eps_v));
    if (logu < log_a) {
      if (lane == 0) r.xs[i] = static_cast<int16_t>(v);
      ++acc_n;
    }
    __syncwarp();
  }
  consumer_sync();
  store_state(x_out + c * n, r.xs, xrow, n);
  if (tid == 0) accepts[c] = acc_n;
}

// ---------------------------------------------------------------------------
// MIN-Gibbs (Algorithm 2): per candidate u, B[c,s,u] two-stage pair draws
// on x[i <- u]; eps_u = lscale * matches; eps[x_i] <- cache; Gumbel-argmax
// v; cache <- eps_v.  The D*K draw lanes of a sub-step are independent:
// lane l = u*K + k is draw k of candidate u, live iff k < B[c,s,u]; one
// flat walk covers them all, a quad of four consecutive lanes per thread
// and 32 quads per warp and pass.  A quad within one candidate adds its
// matches through a warp-aggregated shared counter (one add per candidate
// the warp saw); a quad across a candidate boundary adds lane by lane.
// Streams: 0 u_node, 1 u_nacc, 2 u_row, 3 u_racc (D*K), 4 gumbel (D).
// ---------------------------------------------------------------------------
template <class Src>
__global__ void __launch_bounds__(kDrawThreads)
min_gibbs_sweep_kernel(const int* __restrict__ x_in,
                       const int2* __restrict__ node,
                       const int2* __restrict__ row,
                       const int* __restrict__ i_sites,
                       const int* __restrict__ B, Src src,
                       const float* __restrict__ cache_in,
                       int* __restrict__ x_out, float* __restrict__ cache_out,
                       int n, int S, int K, int D, float lscale) {
  extern __shared__ int smem[];
  int* xs = smem;                                   // n
  int* cnt = xs + n;                                // D
  int* bs = cnt + D;                                // D: clamped totals
  float* gs = reinterpret_cast<float*>(bs + D);     // D
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  const float fn = static_cast<float>(n);
  const int L = D * K, Q = (L + 3) >> 2;
  Src rng = src;
  rng.begin(c, S);
  float cache = threadIdx.x == 0 ? cache_in[c] : 0.f;   // thread 0's
  load_row<kDrawThreads>(xs, x_in + static_cast<long long>(c) * n, n);
  for (int s = 0; s < S; ++s) {
    const long long cs = static_cast<long long>(c) * S + s;
    const int i = i_sites[cs];
    for (int u = threadIdx.x; u < D; u += kDrawThreads) {
      cnt[u] = 0;
      bs[u] = min(max(B[cs * D + u], 0), K);
      gs[u] = rng.gumbel(4, s, u);
    }
    __syncthreads();
    for (int q0 = (threadIdx.x >> 5) * 32; q0 < Q; q0 += kDrawThreads) {
      const int q = q0 + lane, l0 = 4 * q;
      int u[4];
      bool live[4], any = false;
      int k = l0 % K;                // K > 0: else the row has no quad
      u[0] = l0 / K;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j) {
          u[j] = u[j - 1];
          if (++k == K) { k = 0; ++u[j]; }
        }
        live[j] = l0 + j < L && k < bs[u[j]];
        any |= live[j];
      }
      int m = 0, key = -1;
      if (any) {
        int a[4], b[4];
        pair_draw4(rng, 0, s, q, live, node, row, n, fn, a, b);
        bool hit[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xa = a[j] == i ? u[j] : xs[a[j]];
          const int xb = b[j] == i ? u[j] : xs[b[j]];
          hit[j] = live[j] && xa == xb;
        }
        if (u[0] == u[3]) {
          m = hit[0] + hit[1] + hit[2] + hit[3];
          key = m ? u[0] : -1;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (hit[j]) atomicAdd(&cnt[u[j]], 1);
        }
      }
      // m < 8: three ballots give each group's sum to its first lane
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      const int sum = __popc(__ballot_sync(0xffffffffu, m & 1) & grp) +
                      2 * __popc(__ballot_sync(0xffffffffu, m & 2) & grp) +
                      4 * __popc(__ballot_sync(0xffffffffu, m & 4) & grp);
      if (key >= 0 && lane == __ffs(grp) - 1) atomicAdd(&cnt[key], sum);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int xi = xs[i];
      int best = 0;
      float best_eps = 0.f, top = 0.f;
      for (int u = 0; u < D; ++u) {
        const float e =
            u == xi ? cache : __fmul_rn(lscale, static_cast<float>(cnt[u]));
        const float sc = __fadd_rn(e, gs[u]);
        if (u == 0 || sc > top) { top = sc; best = u; best_eps = e; }
      }
      cache = best_eps;
      xs[i] = best;
    }
    __syncthreads();
  }
  store_row<kDrawThreads>(x_out + static_cast<long long>(c) * n, xs, n);
  if (threadIdx.x == 0) cache_out[c] = cache;
}

// ---------------------------------------------------------------------------
// DoubleMIN (Algorithm 5): MGPMH proposal over K1 local draws (no exact
// pass), then K2 two-stage pair draws at y = x[i <- v];
// xi_y = lscale2 * matches; accept iff
// logu < (xi_y - cache) + (eps_xi - eps_v); on accept cache <- xi_y.
// The B2 pair draws go four consecutive lanes per thread, counted in
// registers and reduced once per sub-step.
// Streams: 0 u_idx, 1 u_alias (K1), 2 gumbel (D), 3 u_node, 4 u_nacc,
// 5 u_row, 6 u_racc (K2), 7 logu (1).
// ---------------------------------------------------------------------------
template <class Src>
__global__ void __launch_bounds__(kDrawThreads)
double_min_sweep_kernel(const int* __restrict__ x_in,
                        const int2* __restrict__ row,
                        const int2* __restrict__ node,
                        const int* __restrict__ i_sites,
                        const int* __restrict__ B1,
                        const int* __restrict__ B2, Src src,
                        const float* __restrict__ cache_in,
                        int* __restrict__ x_out,
                        float* __restrict__ cache_out,
                        int* __restrict__ accepts, int n, int S, int K1,
                        int K2, int D, float scale1, float lscale2) {
  extern __shared__ int smem[];
  int* xs = smem;                                   // n
  int* cnt = xs + n;                                // D
  float* gs = reinterpret_cast<float*>(cnt + D);    // D
  int* red = reinterpret_cast<int*>(gs + D);        // kDrawWarps
  __shared__ int sh_v;
  const int c = blockIdx.x;
  const float fn = static_cast<float>(n);
  Src rng = src;
  rng.begin(c, S);
  float cache = threadIdx.x == 0 ? cache_in[c] : 0.f;   // thread 0's
  int acc = 0;
  load_row<kDrawThreads>(xs, x_in + static_cast<long long>(c) * n, n);
  for (int s = 0; s < S; ++s) {
    const long long cs = static_cast<long long>(c) * S + s;
    const int i = i_sites[cs];
    const int b1 = min(max(B1[cs], 0), K1);
    const int b2 = min(max(B2[cs], 0), K2);
    for (int u = threadIdx.x; u < D; u += kDrawThreads) {
      cnt[u] = 0;
      gs[u] = rng.gumbel(2, s, u);
    }
    __syncthreads();
    // stage 1: local alias minibatch over A[i], bucketed by value
    const int2* arow = row + static_cast<long long>(i) * n;
    for (int k = threadIdx.x; k < b1; k += kDrawThreads) {
      const int idx = scaled_index(rng.uniform(0, s, k), fn, n);
      const int2 rec = __ldg(arow + idx);
      const int j = rng.uniform(1, s, k) < __int_as_float(rec.x) ? idx
                                                                 : rec.y;
      const int val = xs[j];
      if (val >= 0 && val < D) atomicAdd(&cnt[val], 1);
    }
    __syncthreads();
    // stage 2: Gumbel-max proposal
    if (threadIdx.x == 0) {
      int best = 0;
      float top = __fadd_rn(__fmul_rn(scale1, static_cast<float>(cnt[0])),
                            gs[0]);
      for (int u = 1; u < D; ++u) {
        const float sc =
            __fadd_rn(__fmul_rn(scale1, static_cast<float>(cnt[u])), gs[u]);
        if (sc > top) { top = sc; best = u; }
      }
      sh_v = best;
    }
    __syncthreads();
    const int v = sh_v;
    // stage 3: second (global) minibatch at y = x[i <- v]
    int m = 0;
    for (int q = threadIdx.x; 4 * q < b2; q += kDrawThreads) {
      const int l0 = 4 * q;
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = l0 + j < b2;
      int a[4], b[4];
      pair_draw4(rng, 3, s, q, live, node, row, n, fn, a, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ya = a[j] == i ? v : xs[a[j]];
        const int yb = b[j] == i ? v : xs[b[j]];
        m += live[j] && ya == yb;
      }
    }
    m = block_count<kDrawThreads>(m, red);
    // stage 4: MH accept against the cached xi_x
    if (threadIdx.x == 0) {
      const int xi = xs[i];
      const float xi_y = __fmul_rn(lscale2, static_cast<float>(m));
      // a current value outside [0, D) counts no draw
      const float eps_xi = __fmul_rn(
          scale1, static_cast<float>(xi >= 0 && xi < D ? cnt[xi] : 0));
      const float eps_v = __fmul_rn(scale1, static_cast<float>(cnt[v]));
      const float log_a = __fadd_rn(__fsub_rn(xi_y, cache),
                                    __fsub_rn(eps_xi, eps_v));
      if (rng.logu(7, s) < log_a) {
        xs[i] = v;
        cache = xi_y;
        ++acc;
      }
    }
    __syncthreads();
  }
  store_row<kDrawThreads>(x_out + static_cast<long long>(c) * n, xs, n);
  if (threadIdx.x == 0) {
    cache_out[c] = cache;
    accepts[c] = acc;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  return cudaSuccess;
}

// x, then D counts, D Gumbels and (MIN-Gibbs) D clamped totals, then the
// warp partials (DoubleMIN)
size_t draw_smem(int n, int D) {
  return sizeof(int) * (static_cast<size_t>(n) + 3 * static_cast<size_t>(D) +
                        kDrawWarps);
}

template <class Src>
int launch_min_gibbs(const int* x, const int2* node, const int2* row,
                     const int* i_sites, const int* B, Src src,
                     const float* cache, int* x_out, float* cache_out, int C,
                     int n, int S, int K, int D, float lscale,
                     cudaStream_t stream) {
  const size_t smem = draw_smem(n, D);
  cudaError_t err = prepare(min_gibbs_sweep_kernel<Src>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  min_gibbs_sweep_kernel<Src><<<C, kDrawThreads, smem, stream>>>(
      x, node, row, i_sites, B, src, cache, x_out, cache_out, n, S, K, D,
      lscale);
  return static_cast<int>(cudaGetLastError());
}

template <class Src>
int launch_double_min(const int* x, const int2* row, const int2* node,
                      const int* i_sites, const int* B1, const int* B2,
                      Src src, const float* cache, int* x_out,
                      float* cache_out, int* accepts, int C, int n, int S,
                      int K1, int K2, int D, float scale1, float lscale2,
                      cudaStream_t stream) {
  const size_t smem = draw_smem(n, D);
  cudaError_t err = prepare(double_min_sweep_kernel<Src>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  double_min_sweep_kernel<Src><<<C, kDrawThreads, smem, stream>>>(
      x, row, node, i_sites, B1, B2, src, cache, x_out, cache_out, accepts,
      n, S, K1, K2, D, scale1, lscale2);
  return static_cast<int>(cudaGetLastError());
}

// A ring body's launch: its ring planned at (n, kD, extra), all of the SM's
// shared memory preferred (several blocks per SM), one block of the
// consumers and the producer warp per chain.
template <typename Kernel, typename... Args>
int launch_ring(Kernel kernel, int C, int n, int kD, size_t extra,
                cudaStream_t stream, Args... args) {
  RingPlan plan;
  size_t smem = 0;
  if (!plan_ring(n, kD, extra, &plan, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<C, kConsumerThreads + 32, smem, stream>>>(args..., plan);
  return static_cast<int>(cudaGetLastError());
}

// kD: the register buckets of one pass, the smallest instance >= D (10
// and 2 on the main paths), 16 in D-chunks above it.  f(kD) with kD a
// std::integral_constant.
template <typename F>
int with_buckets(int D, F f) {
  if (D <= 2) return f(std::integral_constant<int, 2>{});
  if (D <= 4) return f(std::integral_constant<int, 4>{});
  if (D <= 8) return f(std::integral_constant<int, 8>{});
  if (D <= 10) return f(std::integral_constant<int, 10>{});
  return f(std::integral_constant<int, 16>{});
}

// the MGPMH body's own shared memory: three buffers of D counts
size_t mgpmh_extra(int D) { return 3 * sizeof(int) * static_cast<size_t>(D); }

template <class Src>
int launch_mgpmh(const int* x, const float* W, const int2* row,
                 const int* i_sites, const int* B, Src src, int* x_out,
                 int* accepts, int C, int n, int S, int K, int D,
                 float scale, cudaStream_t stream) {
  return with_buckets(D, [&](auto kd) {
    constexpr int kD = decltype(kd)::value;
    return launch_ring(mgpmh_sweep_kernel<Src, kD>, C, n, kD, mgpmh_extra(D),
                       stream, x, W, row, i_sites, B, src, x_out, accepts, n,
                       S, K, D, scale);
  });
}

// ``pair``: the id of the first of the four pair-draw streams (-1: none);
// their rows are read as 16-byte quads when every row starts 16-byte
// aligned.
HostStreams host_streams(std::initializer_list<const float*> p,
                         std::initializer_list<int> lanes, int pair = -1) {
  HostStreams h{};
  int k = 0;
  for (const float* q : p) h.p[k++] = q;
  k = 0;
  for (int l : lanes) h.lanes[k++] = l;
  h.vec = pair >= 0 && h.lanes[pair] % 4 == 0;
  for (int st = pair; h.vec && st < pair + 4; ++st)
    h.vec = reinterpret_cast<uintptr_t>(h.p[st]) % 16 == 0;
  return h;
}

PhiloxStreams philox_streams(const int* seed) {
  PhiloxStreams r{};
  r.seed_ptr = seed;
  return r;
}

}  // namespace

extern "C" {

int gibbs_sweep_launch(const int* x, const float* W, const int* i_sites,
                       const float* gumbel, int* x_out, int C, int n, int S,
                       int D, cudaStream_t stream) {
  return with_buckets(D, [&](auto kd) {
    constexpr int kD = decltype(kd)::value;
    return launch_ring(gibbs_sweep_kernel<kD>, C, n, kD, 0, stream, x, W,
                       i_sites, gumbel, x_out, n, S, D);
  });
}

// The ring of the Gibbs (mgpmh = 0) or MGPMH (mgpmh = 1) kernel at (n, D):
// out = {chunk floats, chunks per row, shared-memory bytes}; returns 0, or
// cudaErrorInvalidValue when no ring fits.
int sweep_ring_plan(int n, int D, int mgpmh, int* out) {
  return with_buckets(D, [&](auto kd) {
    RingPlan plan;
    size_t smem = 0;
    if (!plan_ring(n, decltype(kd)::value, mgpmh ? mgpmh_extra(D) : 0, &plan,
                   &smem))
      return static_cast<int>(cudaErrorInvalidValue);
    out[0] = plan.chunk;
    out[1] = plan.chunks;
    out[2] = static_cast<int>(smem);
    return 0;
  });
}

// The packed tables arrive as int32 (..., 2) buffers: record e at 8e bytes.
int mgpmh_sweep_launch(const int* x, const float* W, const int* row,
                       const int* i_sites, const int* B, const float* u_idx,
                       const float* u_alias, const float* gumbel,
                       const float* logu, int* x_out, int* accepts, int C,
                       int n, int S, int K, int D, float scale,
                       cudaStream_t stream) {
  return launch_mgpmh(x, W, reinterpret_cast<const int2*>(row), i_sites, B,
                      host_streams({u_idx, u_alias, gumbel, logu},
                                   {K, K, D, 1}),
                      x_out, accepts, C, n, S, K, D, scale, stream);
}

int mgpmh_sweep_rng_launch(const int* x, const float* W, const int* row,
                           const int* i_sites, const int* B, const int* seed,
                           int* x_out, int* accepts, int C, int n, int S,
                           int K, int D, float scale, cudaStream_t stream) {
  return launch_mgpmh(x, W, reinterpret_cast<const int2*>(row), i_sites, B,
                      philox_streams(seed), x_out, accepts, C, n, S, K, D,
                      scale, stream);
}

// The packed tables arrive as int32 (..., 2) buffers: record e at 8e bytes.
int min_gibbs_sweep_launch(const int* x, const int* node, const int* row,
                           const int* i_sites, const int* B,
                           const float* u_node, const float* u_nacc,
                           const float* u_row, const float* u_racc,
                           const float* gumbel, const float* cache,
                           int* x_out, float* cache_out, int C, int n, int S,
                           int K, int D, float lscale,
                           cudaStream_t stream) {
  const int DK = D * K;
  return launch_min_gibbs(
      x, reinterpret_cast<const int2*>(node),
      reinterpret_cast<const int2*>(row), i_sites, B,
      host_streams({u_node, u_nacc, u_row, u_racc, gumbel},
                   {DK, DK, DK, DK, D}, 0),
      cache, x_out, cache_out, C, n, S, K, D, lscale, stream);
}

int min_gibbs_sweep_rng_launch(const int* x, const int* node, const int* row,
                               const int* i_sites, const int* B,
                               const float* cache, const int* seed,
                               int* x_out, float* cache_out, int C, int n,
                               int S, int K, int D, float lscale,
                               cudaStream_t stream) {
  return launch_min_gibbs(x, reinterpret_cast<const int2*>(node),
                          reinterpret_cast<const int2*>(row), i_sites, B,
                          philox_streams(seed), cache, x_out, cache_out, C, n,
                          S, K, D, lscale, stream);
}

int double_min_sweep_launch(const int* x, const int* row, const int* node,
                            const int* i_sites, const int* B1,
                            const float* u_idx, const float* u_alias,
                            const float* gumbel, const int* B2,
                            const float* u_node, const float* u_nacc,
                            const float* u_row, const float* u_racc,
                            const float* logu, const float* cache,
                            int* x_out, float* cache_out, int* accepts, int C,
                            int n, int S, int K1, int K2, int D,
                            float scale1, float lscale2,
                            cudaStream_t stream) {
  return launch_double_min(
      x, reinterpret_cast<const int2*>(row),
      reinterpret_cast<const int2*>(node), i_sites, B1, B2,
      host_streams({u_idx, u_alias, gumbel, u_node, u_nacc, u_row, u_racc,
                    logu},
                   {K1, K1, D, K2, K2, K2, K2, 1}, 3),
      cache, x_out, cache_out, accepts, C, n, S, K1, K2, D, scale1,
      lscale2, stream);
}

int double_min_sweep_rng_launch(const int* x, const int* row, const int* node,
                                const int* i_sites, const int* B1,
                                const int* B2, const float* cache,
                                const int* seed, int* x_out, float* cache_out,
                                int* accepts, int C, int n, int S, int K1,
                                int K2, int D, float scale1,
                                float lscale2, cudaStream_t stream) {
  return launch_double_min(x, reinterpret_cast<const int2*>(row),
                           reinterpret_cast<const int2*>(node), i_sites, B1,
                           B2, philox_streams(seed), cache, x_out, cache_out,
                           accepts, C, n, S, K1, K2, D, scale1, lscale2,
                           stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
