// Flash-attention backward for Hopper (sm_90a), bf16: the gradients of
//
//   o[b, i, h, :] = sum_j P_ij v[b, j, h / G, :],  P_ij = softmax_j(s_ij),
//   s_ij = scale (q[b, i, h, :] . k[b, j, h / G, :]),  scale = hd^-0.5
//
// (G = H / KVH) over the keys j with j < Sk, (causal) i >= j and
// (window > 0) i - j < window, positions counted from 0 in q and in k, as
// the forward (flash_attention.cu) masks them.  With dO the gradient of o
// and D_i = sum_d dO_id o_id:
//
//   dV_j = sum_i P_ij dO_i,   dS_ij = P_ij (dO_i . v_j - D_i),
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i,
//
// dK and dV of a KV head summed over its G query heads.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// flash_attention scan (src/repro/models/attention.py) with jax.grad.  The
// port's forward is the hand-written kernel, so its gradient on the card
// is one too (models/attention.py, FlashAttention).
//
// Common to every head dim: no float atomics (every sum has a fixed
// order, so two launches give the same bits, which the trainer's bit-exact
// crash-resume needs); D comes from a first launch, `prep` (one block per
// 64 query rows of a head: D_i = rowsum(dO o) in float32, a fixed shuffle
// tree); the row log-sum-exp (base 2, of the scaled scores) is the forward
// kernel's optional lse2 output, which the autograd function saves; P =
// 2^(s scale log2(e) - lse2) and dS are rounded to bf16 for their
// products (as the forward rounds P for P V); every sum is float32; the
// outputs are bf16.  Rows with no valid key have lse2 = +inf, so P = 0 and
// a zero gradient.  Three launches per call: prep, dK/dV, dQ (the
// FlashAttention-2 split).
//
// Head dims 16, 32, 64 (padded to 64 columns), 120, 128 (padded to 128)
// and 256: wgmma and TMA, the forward's Hopper machinery (hopper.cuh).  Both
// kernels are persistent blocks of three warpgroups: one producer thread
// issues every copy (TMA through 4-D tensor maps with 128-byte swizzle,
// whose zero fill gives the ragged edges; prep writes each query row's
// (lse2, D) pair beside the other rows' so a tile's pairs are one bulk
// copy) into rings guarded by full / empty mbarriers, and two consumer
// warpgroups (setmaxnreg 232; the producer's drops to 40) run wgmma and
// the elementwise work.  Per consumer and step, the products of the step
// before run while this step's P and dS are formed; the consumers take
// turns to issue (named barriers, ping-pong), so one's exponentials run
// beside the other's products; no product is in flight across a loop's
// back edge (ptxas would serialise the wgmma).  Tiles that hold a masked
// pair set their scores to -inf first; the rest skip the mask.
//  * dK/dV: an item is 128 keys of one KV head and batch element, 64 per
//    consumer.  K and V load once per item; the block walks the G query
//    heads and, for each, the query tiles (64 rows at 64 columns, 32 at
//    128) that can see its keys, their Q and dO tiles and (lse2, D) pairs
//    streaming through a 4-stage ring.  Per step: S^T = K Q^T and dP^T =
//    V dO^T (wgmma; at 64 columns with K and V as register A operands,
//    loaded once per item by ldmatrix, so that those products read only Q
//    and dO from shared memory, and the K and V tiles are free for the
//    next item at once), P^T and dS^T in registers, dV += P^T dO and
//    dK += dS^T Q (wgmma with P^T and dS^T as register A operands: the
//    accumulator layout of S^T is the A fragment layout; dO, Q read
//    MN-major).  dK and dV stay in registers over the whole walk, every
//    column.  Blocks take items from an int32 work counter (zeroed by
//    prep) in ascending order, key tiles slowest, so causal items (key
//    tile 0 sees every query) go longest first.
//    At 256 columns the dK and dV of 64 keys (2 x 64 x 256 float32, 128
//    registers a thread each) do not both fit in one warpgroup, so an item
//    is 64 keys that both consumers share (the pair form, no ping-pong):
//    consumer 0 forms S^T and P^T and sums dV, consumer 1 forms dP^T and
//    dS^T and sums dK, every column; P^T passes from 0 to 1 as float32
//    through shared memory (8 KB a step, two buffers under named
//    barriers), so dS is formed from the unrounded P as at the other head
//    dims, and each of S and dP is still formed once per pair.
//  * dQ: an item is 128 query rows of one head and batch element (the
//    forward's items, longest first, a static round robin), 64 rows per
//    consumer; Q and dO load once (at 64 columns into registers, as K and
//    V above), the K and V tiles of the 64-key tiles (32 at 256 columns)
//    the rows can see stream through a 3-stage ring.  Per tile: S = Q K^T,
//    dP = dO V^T, P and dS in registers, dQ += dS K with K read MN-major.
// Products per attended pair: 7 (S and dP in both kernels), against the
// bound's 5.  A one-pass form (dQ's part of each step in the dK/dV kernel,
// summed over the key tiles in a fixed order through a float32 buffer in
// global memory) was slower on the card (PERF.md, the flash backward
// row).
//
// Bound: the tensor cores, 2.5 times the forward's products (S, dP, dV, dK,
// dQ: 5 x 2 hd FLOPs per attended pair) at the bf16 dense rate.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError() after each of its three launches,
// cudaErrorInvalidConfiguration for a grid the card cannot take, or
// cudaErrorInvalidValue for a head dim it was not built for or a tensor
// map cuTensorMapEncodeTiled refuses.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

extern __shared__ __align__(16) unsigned char bwd_smem[];

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// 1. prep: (lse2, D) per query row
// ---------------------------------------------------------------------------

constexpr int kTile = 64;              // prep: query rows per block
constexpr int kThreads = 128;          // prep: 16 rows per warp

__device__ __forceinline__ bool valid(int i, int j, int Sq, int Sk,
                                      int window, int causal) {
  return i < Sq && j < Sk && (!causal || i >= j)
         && (window <= 0 || i - j < window);
}

// D_i = rowsum(dO o): a warp per row, lanes over column pairs, a fixed
// shuffle tree; 64 rows per block; into rows (B, H, Sqp) as (lse2_i, D_i)
// pairs beside the forward's lse2, the rows from Sq to Sqp as (+inf, 0)
// (P = 0 there), so a tile of them is one bulk copy.  Also zeroes the
// dK/dV launch's work counter (launched after this one)
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse2,
                      float2* __restrict__ rows, int* __restrict__ work,
                      int Sq, int Sqp, int H, int hd) {
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  if ((blockIdx.x | blockIdx.y | blockIdx.z) == 0 && threadIdx.x == 0)
    *work = 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * H + h;   // (b, h) row block
  // four rows at a time: their loads are in flight together
  for (int r0 = q0 + warp * 16; r0 < q0 + warp * 16 + 16; r0 += 4) {
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = r0 + u;
      acc[u] = 0.f;
      if (i >= Sq) continue;
      const size_t base = ((static_cast<size_t>(b) * Sq + i) * H + h) * hd;
      for (int d = 2 * lane; d < hd; d += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + d));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + base + d));
        acc[u] = fmaf(x.x, y.x, acc[u]);
        acc[u] = fmaf(x.y, y.y, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const int i = r0 + u;
      if (lane != 0 || i >= Sqp) continue;
      rows[row0 * Sqp + i] = i < Sq ? make_float2(lse2[row0 * Sq + i], acc[u])
                                    : make_float2(INFINITY, 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK/dV and dQ on wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;        // producer warpgroup + two consumers
// setmaxnreg: the consumers take the 128 x (168 - 40) registers the
// producer frees (168 a thread at launch: 65536 / 384, rounded down to 8)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxDevices = 64;        // launch settings cached per device

template <int HDP>
struct Wg {
  // at 64 columns the resident operands of S and dP (K and V in dK/dV, Q
  // and dO in dQ) are loaded into registers once per item: register A
  // operands halve the shared-memory reads of those products, which at
  // 64-wide tiles with both operands in shared memory take as many bytes
  // a clock as shared memory gives.  At 128 and 256 columns the registers
  // are taken by the accumulators
  static constexpr bool kRegA = HDP == 64;
  // dK/dV at 256 columns: the two consumers share one 64-key tile (kPair;
  // the dK and dV of 64 keys, 2 x 64 x 256 float32, fill both warpgroups'
  // registers), one forming P^T and dV, the other dS^T and dK
  static constexpr bool kPair = HDP == 256;
  // dK/dV: an item is BN keys (64 per consumer warpgroup, or 64 shared) of
  // one KV head and batch element; a step streams BQ queries of one query
  // head
  static constexpr int BN = kPair ? 64 : 128, BQ = HDP == 64 ? 64 : 32;
  static constexpr int ST = 4;
  static constexpr int kKVBytes = BN * HDP * 2;    // the K (or V) tile
  static constexpr int kQBytes = BQ * HDP * 2;     // a stage's Q (or dO)
  static constexpr int kStatBytes = BQ * 8;        // its rows' (lse2, D)
  // kPair: two buffers of a step's P^T (64 x BQ float32)
  static constexpr int kXBytes = kPair ? 2 * 64 * BQ * 4 : 0;
  // K, V | Q stages | dO stages | (lse2, D) rows | P^T buffers | mbarriers
  // | item slot, +1024 for the alignment the 128-byte swizzle needs
  static constexpr int kDkdvSmem = 1024 + 2 * kKVBytes + 2 * ST * kQBytes
                                   + ST * kStatBytes + kXBytes
                                   + (2 + 2 * ST) * 8 + 16;
  // dQ: an item is BM query rows (64 per consumer) of one query head and
  // batch element; a step streams BK keys of its KV head (32 at 256
  // columns: two 128 x 256 resident tiles and three stages fill 227 KB)
  static constexpr int BM = 128, BK = HDP == 256 ? 32 : 64, STQ = 3;
  static constexpr int kRowsBytes = BM * HDP * 2;  // the Q (or dO) tile
  static constexpr int kKBytes = BK * HDP * 2;     // a stage's K (or V)
  static constexpr int kDqSmem = 1024 + 2 * kRowsBytes + 2 * STQ * kKBytes
                                 + (2 + 2 * STQ) * 8;
};

// the A fragments (k16 steps of four registers) of the warpgroup's 64 rows
// at `a` of a tile of `a_rows` rows and HDP columns (128-byte swizzle),
// by ldmatrix: matrix m of a step is rows 8 (m % 2) .. + 7 of the warp's 16,
// 16-byte unit 2 (kk % 4) + m / 2 of the row
template <int HDP>
__device__ __forceinline__ void load_a(uint32_t (&f)[HDP / 16][4],
                                       uint32_t a, int a_rows, int wi,
                                       int lane) {
  const int m = lane >> 3, r = 16 * wi + 8 * (m & 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t unit = (2 * (kk % 4) + (m >> 1)) ^ (r & 7);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]), "=r"(f[kk][3])
        : "r"(a + (kk / 4) * a_rows * kRowBytes + r * kRowBytes + unit * 16)
        : "memory");
  }
}

// acc (64 x N) = A B^T over HDP columns, B a tile of N rows at `b`, K-major
// in shared memory (the S = Q K^T pattern), A either the warpgroup's 64
// rows at `a` of a tile of `a_rows` rows (K-major, shared memory) or, at
// kRegA, the fragments `af`.  Issued and committed.
template <int HDP, int N>
__device__ __forceinline__ void issue_rows(float (&acc)[N / 2], uint32_t a,
                                           int a_rows, uint32_t b,
                                           const uint32_t (&af)[HDP / 16][4]) {
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t db = desc_sw128(b + (kk / 4) * N * kRowBytes + col, 16,
                                   1024);
    if constexpr (Wg<HDP>::kRegA)
      Wgmma<N>::rs_k(acc, af[kk], db, kk > 0);
    else
      Wgmma<N>::ss(acc,
                   desc_sw128(a + (kk / 4) * a_rows * kRowBytes + col, 16,
                              1024),
                   db, kk > 0);
  }
  wgmma_commit();
  pin(acc);
}

// acc (64 x HDP) += X B: X (64 x K) as bf16 pairs in registers (the
// accumulator layout of a 64 x K product is the A fragment layout of its
// k16 steps), B the K rows x HDP columns at `b` read MN-major (the
// O += P V pattern).  Issued and committed.
template <int HDP, int K>
__device__ __forceinline__ void issue_reg(float (&acc)[HDP / 2],
                                          uint32_t (&x)[K / 4], uint32_t b) {
  pin(acc);
  pin(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Wgmma<HDP>::rs(acc, &x[4 * kk],
                   desc_sw128(b + kk * 16 * kRowBytes, K * kRowBytes, 1024));
  wgmma_commit();
  pin(acc);
}

// bf16 pairs of a 64 x HDP accumulator times `mul` into rows `row0`,
// `row0` + 8 (this thread's) of a (B, S, heads, hd) tensor at head `head`
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[HDP / 2],
                                           float mul, int b, int row0, int S,
                                           int heads, int head, int hd,
                                           int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* p = dst + ((static_cast<size_t>(b) * S + row) * heads + head) * hd;
#pragma unroll
    for (int y = 0; y < HDP / 8; ++y) {
      const int col = 8 * y + 2 * t4;
      if (col >= hd) continue;
      *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(
          acc[4 * y + 2 * r] * mul, acc[4 * y + 2 * r + 1] * mul);
    }
  }
}

// dK/dV item w (key tiles slowest: causal items longest first)
struct KvItem {
  int b, kh, j0;
  int t0, nq;     // query tiles t0 .. t0 + nq - 1 see a key of the item
};

template <int BN, int BQ>
__device__ __forceinline__ KvItem kv_item(int w, int Sq, int KVH, int B,
                                          int window, int causal) {
  const int t = w / (KVH * B), r = w % (KVH * B);
  KvItem x{r / KVH, r % KVH, t * BN, 0, 0};
  const int qlo = causal ? x.j0 : 0;
  const long long reach = static_cast<long long>(x.j0) + BN - 1 + window;
  const int qhi = window > 0 && reach < Sq ? static_cast<int>(reach) : Sq;
  x.t0 = qlo / BQ;
  x.nq = qhi > x.t0 * BQ ? (qhi - x.t0 * BQ + BQ - 1) / BQ : 0;
  return x;
}

template <int HDP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float2* __restrict__ rows_g,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int* __restrict__ work, int B, int Sq, int Sqp,
                         int Sk, int H, int KVH, int hd, int window,
                         int causal, float scale, float c) {
  using T = Wg<HDP>;
  constexpr int BN = T::BN, BQ = T::BQ, ST = T::ST;
  const uint32_t raw = smem_addr(bwd_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t ks = base, vs = ks + T::kKVBytes;
  const uint32_t qs = vs + T::kKVBytes;            // stage st: + st kQBytes
  const uint32_t dos = qs + ST * T::kQBytes;
  const uint32_t rows = dos + ST * T::kQBytes;     // stage st: (lse2, D)
  const uint32_t xs = rows + ST * T::kStatBytes;   // kPair: P^T buffers
  const uint32_t bars = xs + T::kXBytes;
  // kv_full, kv_empty, then full and empty per stage
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int st) { return bars + 16 + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 8 * (ST + st); };
  const float* rows_p = reinterpret_cast<const float*>(bwd_smem
                                                       + (rows - raw));
  // the item the producer took (-1: none left), read after kv_full
  volatile int* slot = reinterpret_cast<volatile int*>(
      bwd_smem + (bars - raw) + (2 + 2 * ST) * 8);
  const int G = H / KVH, W = (Sk + BN - 1) / BN * KVH * B;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);               // one arrival per consumer warp
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread takes items from the work counter in
    // ascending order, loads each item's K and V, then streams the Q and dO
    // tiles and their rows' (lse2, D) through the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                          // steps issued so far
      for (int j = 0;; ++j) {
        mbar_wait(kv_empty, (j & 1) ^ 1);  // the last item's K and V read
        const int w = atomicAdd(work, 1);
        if (w >= W) {
          *slot = -1;
          mbar_arrive(kv_full);
          break;
        }
        const KvItem x = kv_item<BN, BQ>(w, Sq, KVH, B, window, causal);
        *slot = w;
        mbar_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < HDP / 64; ++ch) {
          tma_load(ks + ch * BN * kRowBytes, &tk, kv_full, ch * 64, x.kh,
                   x.j0, x.b);
          tma_load(vs + ch * BN * kRowBytes, &tv, kv_full, ch * 64, x.kh,
                   x.j0, x.b);
        }
        // step i: query head kh G + i / nq, query tile t0 + i % nq
        for (int i = 0; i < G * x.nq; ++i, ++it) {
          const int st = it % ST;
          mbar_wait(empty(st), ((it / ST) & 1) ^ 1);   // the stage is free
          const int h = x.kh * G + i / x.nq, i0 = (x.t0 + i % x.nq) * BQ;
          mbar_expect_tx(full(st), 2 * T::kQBytes + T::kStatBytes);
          bulk_load(rows + st * T::kStatBytes,
                    rows_g + (static_cast<size_t>(x.b) * H + h) * Sqp + i0,
                    T::kStatBytes, full(st));
#pragma unroll
          for (int ch = 0; ch < HDP / 64; ++ch) {
            tma_load(qs + st * T::kQBytes + ch * BQ * kRowBytes, &tq,
                     full(st), ch * 64, h, i0, x.b);
            tma_load(dos + st * T::kQBytes + ch * BQ * kRowBytes, &tdo,
                     full(st), ch * 64, h, i0, x.b);
          }
        }
      }
    }
  } else if constexpr (T::kPair) {
    // ---- consumers on the same 64 keys: consumer 0 forms S^T = K Q^T and
    // P^T and sums dV += P^T dO, consumer 1 forms dP^T = V dO^T and dS^T =
    // P^T (dP^T - D) and sums dK += dS^T Q, each over all HDP columns.  P^T
    // passes from 0 to 1 as float32 through two shared-memory buffers
    // (step s in buffer s % 2; named barrier 1 + s % 2: it is written, 3 +
    // s % 2: it was read); S^T and dP^T have the same accumulator layout,
    // so thread t passes its entries to thread t.  Per step, the first
    // product (S^T or dP^T) runs beside the step before's second (dV or
    // dK), and no product is in flight across the loop's back edge
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;   // accumulator row group, pair
    // the resident A operand of the first product, the streamed B operands
    // of the first and the second
    const uint32_t a1 = w == 0 ? ks : vs;
    const uint32_t b1 = w == 0 ? qs : dos, b2 = w == 0 ? dos : qs;
    float4* xbuf = reinterpret_cast<float4*>(bwd_smem + (xs - raw));
    int it = 0;                              // steps consumed so far
    for (int j = 0;; ++j) {
      mbar_wait(kv_full, j & 1);
      const int wk = *slot;
      if (wk < 0) break;
      const KvItem x = kv_item<BN, BQ>(wk, Sq, KVH, B, window, causal);
      const int ja = x.j0 + 16 * wi + g;     // this thread's keys ja, ja + 8
      float acc[HDP / 2];                    // dV (consumer 0) or dK (1)
#pragma unroll
      for (int y = 0; y < HDP / 2; ++y) acc[y] = 0.0f;
      // S^T, then P^T (consumer 0); dP^T, then dS^T (1): sa[4 jj + e] is
      // key ja + 8 (e / 2), query i0 + 8 jj + 2 t4 + e % 2
      float sa[BQ / 2];
      uint32_t pa[BQ / 4];                   // bf16 P^T (0) or dS^T (1)
      uint32_t af[HDP / 16][4];              // (no register A operand)
      auto wait_full = [&](int i) {
        mbar_wait(full((it + i) % ST), ((it + i) / ST) & 1);
      };
      auto issue_first = [&](int i) {
        issue_rows<HDP, BQ>(sa, a1, BN, b1 + ((it + i) % ST) * T::kQBytes,
                            af);
      };
      auto issue_second = [&](int i) {
        issue_reg<HDP, BQ>(acc, pa, b2 + ((it + i) % ST) * T::kQBytes);
      };
      auto elementwise = [&](int i) {
        const int s = it + i, i0 = (x.t0 + i % x.nq) * BQ;
        const float* s_rows = rows_p + (s % ST) * 2 * BQ;   // (lse2, D)
        float4* buf = xbuf + (s & 1) * (BQ / 8) * 128;
        if (w == 0) {
          // a step that holds a masked (query, key) pair sets its scores to
          // -inf first (P = 0, and so dS = 0); the rest skip the mask
          if (x.j0 + 64 > Sk || (causal && i0 < x.j0 + 63)
              || (window > 0 && i0 + BQ - 1 - x.j0 >= window)) {
#pragma unroll
            for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (!valid(i0 + 8 * jj + 2 * t4 + (e & 1), ja + 8 * (e >> 1),
                           Sq, Sk, window, causal))
                  sa[4 * jj + e] = -INFINITY;
          }
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj) {
            // queries 8 jj + 2 t4 and + 1: lse2, D, lse2, D
            const float4 r =
                *reinterpret_cast<const float4*>(s_rows + 16 * jj + 4 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sa[4 * jj + e] =
                  ex2(fmaf(sa[4 * jj + e], c, -((e & 1) ? r.z : r.x)));
          }
          if (s >= 2) bar_sync(3 + (s & 1));   // step s - 2's P^T was read
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj)
            buf[jj * 128 + tid] = make_float4(sa[4 * jj], sa[4 * jj + 1],
                                              sa[4 * jj + 2], sa[4 * jj + 3]);
          bar_arrive(1 + (s & 1));
        } else {
          bar_sync(1 + (s & 1));               // step s's P^T is written
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj) {
            const float4 p = buf[jj * 128 + tid];
            const float4 r =
                *reinterpret_cast<const float4*>(s_rows + 16 * jj + 4 * t4);
            sa[4 * jj] = p.x * (sa[4 * jj] - r.y);
            sa[4 * jj + 1] = p.y * (sa[4 * jj + 1] - r.w);
            sa[4 * jj + 2] = p.z * (sa[4 * jj + 2] - r.y);
            sa[4 * jj + 3] = p.w * (sa[4 * jj + 3] - r.w);
          }
          bar_arrive(3 + (s & 1));
        }
      };
      auto pack = [&]() {
#pragma unroll
        for (int y = 0; y < BQ / 4; ++y)
          pa[y] = pack_bf16(sa[2 * y], sa[2 * y + 1]);
      };
      const int n_it = G * x.nq;
      if (n_it > 0) {
        wait_full(0);
        issue_first(0);
        wgmma_wait<0>();
        pin(sa);
        elementwise(0);
        pack();
        for (int i = 1; i < n_it; ++i) {
          wait_full(i);
          issue_first(i);
          issue_second(i - 1);
          wgmma_wait<1>();                  // step i's S^T (dP^T)
          pin(sa);
          elementwise(i);
          wgmma_wait<0>();                  // step i - 1's dV (dK)
          pin(acc);
          pin(pa);
          if (lane == 0) mbar_arrive(empty((it + i - 1) % ST));
          pack();
        }
        issue_second(n_it - 1);
        wgmma_wait<0>();
        pin(acc);
        pin(pa);
        if (lane == 0) mbar_arrive(empty((it + n_it - 1) % ST));
      }
      it += n_it;
      if (lane == 0) mbar_arrive(kv_empty);    // K and V read
      if (w == 0)
        store_rows<HDP>(dv, acc, 1.0f, x.b, ja, Sk, KVH, x.kh, hd, t4);
      else
        store_rows<HDP>(dk, acc, scale, x.b, ja, Sk, KVH, x.kh, hd, t4);
    }
    // consumer 1's last two "read" arrivals have no write to wait: take them
    if (w == 0)
      for (int s = it < 2 ? 0 : it - 2; s < it; ++s) bar_sync(3 + (s & 1));
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;   // accumulator row group, pair
    const uint32_t kw = ks + 64 * w * kRowBytes, vw = vs + 64 * w * kRowBytes;
    // consumer w issues its products after the other one (named barriers
    // 1 and 2, ping-pong); consumer 0 goes first
    auto turn = [&]() { bar_sync(1 + w); };
    auto pass = [&]() { bar_arrive(1 + (w + 1) % 2); };
    if (w == 1) bar_arrive(1);
    int it = 0;                              // steps consumed so far
    for (int j = 0;; ++j) {
      mbar_wait(kv_full, j & 1);
      const int wk = *slot;
      if (wk < 0) break;
      const KvItem x = kv_item<BN, BQ>(wk, Sq, KVH, B, window, causal);
      const int jw = x.j0 + 64 * w;          // the warpgroup's first key
      const int ja = jw + 16 * wi + g;       // this thread's keys ja, ja + 8
      // kRegA: this warpgroup's K and V rows as A fragments, once; the
      // tiles are then free for the next item's
      uint32_t kf[HDP / 16][4], vf[HDP / 16][4];
      if constexpr (T::kRegA) {
        load_a<HDP>(kf, kw, BN, wi, lane);
        load_a<HDP>(vf, vw, BN, wi, lane);
        if (lane == 0) mbar_arrive(kv_empty);
      }
      float dva[HDP / 2], dka[HDP / 2];
#pragma unroll
      for (int y = 0; y < HDP / 2; ++y) dva[y] = dka[y] = 0.0f;
      float sa[BQ / 2], dpa[BQ / 2];
      uint32_t p[BQ / 4], ds[BQ / 4];
      // step i's stage is in
      auto wait_full = [&](int i) {
        mbar_wait(full((it + i) % ST), ((it + i) / ST) & 1);
      };
      // S^T = K Q^T and dP^T = V dO^T of step i
      auto issue_sdp = [&](int i) {
        const int st = (it + i) % ST;
        issue_rows<HDP, BQ>(sa, kw, BN, qs + st * T::kQBytes, kf);
        issue_rows<HDP, BQ>(dpa, vw, BN, dos + st * T::kQBytes, vf);
      };
      // dV += P^T dO and dK += dS^T Q of step i
      auto issue_dkv = [&](int i) {
        const int st = (it + i) % ST;
        issue_reg<HDP, BQ>(dva, p, dos + st * T::kQBytes);
        issue_reg<HDP, BQ>(dka, ds, qs + st * T::kQBytes);
      };
      // P^T = 2^(s c - lse2) into sa and dS^T = P^T (dP^T - D) into dpa,
      // float32, for step i: sa[4 jj + e] is key ja + 8 (e / 2), query
      // i0 + 8 jj + 2 t4 + e % 2
      auto grads = [&](int i) {
        const int st = (it + i) % ST, i0 = (x.t0 + i % x.nq) * BQ;
        const float* s_rows = rows_p + st * 2 * BQ;   // (lse2, D) pairs
        // a step that holds a masked (query, key) pair for these keys sets
        // its scores to -inf first (P = 0); the rest skip the mask
        if (jw + 64 > Sk || (causal && i0 < jw + 63)
            || (window > 0 && i0 + BQ - 1 - jw >= window)) {
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!valid(i0 + 8 * jj + 2 * t4 + (e & 1), ja + 8 * (e >> 1),
                         Sq, Sk, window, causal))
                sa[4 * jj + e] = -INFINITY;
        }
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj) {
          // queries 8 jj + 2 t4 and + 1: lse2, D, lse2, D
          const float4 r =
              *reinterpret_cast<const float4*>(s_rows + 16 * jj + 4 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                ex2(fmaf(sa[4 * jj + e], c, -((e & 1) ? r.z : r.x)));
            sa[4 * jj + e] = pe;
            dpa[4 * jj + e] = pe * (dpa[4 * jj + e] - ((e & 1) ? r.w : r.y));
          }
        }
      };
      // bf16 A operands of the next issue_dkv
      auto pack = [&]() {
#pragma unroll
        for (int y = 0; y < BQ / 4; ++y) {
          p[y] = pack_bf16(sa[2 * y], sa[2 * y + 1]);
          ds[y] = pack_bf16(dpa[2 * y], dpa[2 * y + 1]);
        }
      };
      auto pin_products = [&]() {
        pin(dva);
        pin(dka);
        pin(p);
        pin(ds);
      };
      // step i's P^T and dS^T are computed while step i - 1's dV and dK
      // products run, and the two consumers take turns to issue their
      // products, so one's elementwise work runs beside the other's
      // products.  No product is in flight across the loop's back edge
      // (ptxas serialises wgmma whose accumulators a loop carries)
      const int n_it = G * x.nq;
      if (n_it > 0) {
        wait_full(0);
        turn();
        issue_sdp(0);
        pass();
        wgmma_wait<0>();
        pin(sa);
        pin(dpa);
        grads(0);
        pack();
        for (int i = 1; i < n_it; ++i) {
          wait_full(i);
          turn();
          issue_sdp(i);
          issue_dkv(i - 1);
          pass();
          wgmma_wait<2>();                  // S^T and dP^T of step i
          pin(sa);
          pin(dpa);
          grads(i);
          wgmma_wait<0>();                  // step i - 1's dV and dK
          pin_products();
          if (lane == 0) mbar_arrive(empty((it + i - 1) % ST));
          pack();
        }
        turn();
        issue_dkv(n_it - 1);
        pass();
        wgmma_wait<0>();
        pin_products();
        if (lane == 0) mbar_arrive(empty((it + n_it - 1) % ST));
      }
      it += n_it;
      if (!T::kRegA && lane == 0) mbar_arrive(kv_empty);   // K and V read
      store_rows<HDP>(dk, dka, scale, x.b, ja, Sk, KVH, x.kh, hd, t4);
      store_rows<HDP>(dv, dva, 1.0f, x.b, ja, Sk, KVH, x.kh, hd, t4);
    }
    // the last consumer's first arrival has no turn to match: take it
    if (w == 0) bar_sync(1);
  }
}

// dQ item w: (query tile, head, batch), query tiles slowest, causal grids
// longest first (the forward's order)
struct QItem {
  int q0, h, b;
};

__device__ __forceinline__ QItem q_item(int w, int nq, int H, int B,
                                        int causal, int bm) {
  const int tile = w / (H * B), hb = w % (H * B);
  return {(causal ? nq - 1 - tile : tile) * bm, hb % H, hb / H};
}

// [*t0, *t1): the key tiles of bk keys that hold a valid key for some row
// of [q0, q0 + rows); empty when no row has one
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sk,
                                          int window, int causal, int bk,
                                          int* t0, int* t1) {
  const int hi = causal ? min(Sk, q0 + rows) : Sk;   // keys < hi
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *t0 = lo / bk;
  *t1 = hi > lo ? (hi + bk - 1) / bk : *t0;
}

template <int HDP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float2* __restrict__ rows_g,
                       bf16* __restrict__ dq, int B, int Sq, int Sqp, int Sk,
                       int H, int KVH, int hd, int window, int causal,
                       float scale, float c) {
  using T = Wg<HDP>;
  constexpr int BM = T::BM, BK = T::BK, ST = T::STQ;
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  const uint32_t qs = base, dos = qs + T::kRowsBytes;
  const uint32_t ks = dos + T::kRowsBytes;        // stage st: + st kKBytes
  const uint32_t vs = ks + ST * T::kKBytes;
  const uint32_t bars = vs + ST * T::kKBytes;
  // q_full, q_empty, then full and empty per stage
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full = [&](int st) { return bars + 16 + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 8 * (ST + st); };
  const int nq = (Sq + BM - 1) / BM, W = nq * B * H, G = H / KVH;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                // one arrival per consumer warp
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy, in the consumers' order
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                          // K (and V) tiles issued so far
      for (int j = 0, w = blockIdx.x; w < W; ++j, w += gridDim.x) {
        const QItem x = q_item(w, nq, H, B, causal, BM);
        int t0, t1;
        key_tiles(x.q0, min(BM, Sq - x.q0), Sk, window, causal, BK, &t0,
                  &t1);
        mbar_wait(q_empty, (j & 1) ^ 1);          // the last Q, dO read
        mbar_expect_tx(q_full, 2 * T::kRowsBytes);
#pragma unroll
        for (int ch = 0; ch < HDP / 64; ++ch) {
          tma_load(qs + ch * BM * kRowBytes, &tq, q_full, ch * 64, x.h, x.q0,
                   x.b);
          tma_load(dos + ch * BM * kRowBytes, &tdo, q_full, ch * 64, x.h,
                   x.q0, x.b);
        }
        for (int i = 0; i < t1 - t0; ++i, ++it) {
          const int st = it % ST;
          mbar_wait(empty(st), ((it / ST) & 1) ^ 1);   // the stage is free
          mbar_expect_tx(full(st), 2 * T::kKBytes);
#pragma unroll
          for (int ch = 0; ch < HDP / 64; ++ch) {
            tma_load(ks + st * T::kKBytes + ch * BK * kRowBytes, &tk,
                     full(st), ch * 64, x.h / G, (t0 + i) * BK, x.b);
            tma_load(vs + st * T::kKBytes + ch * BK * kRowBytes, &tv,
                     full(st), ch * 64, x.h / G, (t0 + i) * BK, x.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;   // accumulator row group, pair
    const uint32_t qw = qs + 64 * w * kRowBytes, dow = dos + 64 * w * kRowBytes;
    int it = 0;                              // K (and V) tiles consumed
    // ping-pong, as in dK/dV
    auto turn = [&]() { bar_sync(1 + w); };
    auto pass = [&]() { bar_arrive(1 + (w + 1) % 2); };
    if (w == 1) bar_arrive(1);
    for (int j = 0, wk = blockIdx.x; wk < W; ++j, wk += gridDim.x) {
      const QItem x = q_item(wk, nq, H, B, causal, BM);
      int t0, t1;
      key_tiles(x.q0, min(BM, Sq - x.q0), Sk, window, causal, BK, &t0, &t1);
      const int n = t1 - t0;
      const int r0 = x.q0 + 64 * w;          // the warpgroup's first row
      const int ia = r0 + 16 * wi + g;       // this thread's rows ia, ia + 8
      // (lse2, D) of rows ia and ia + 8 (+inf, 0 past Sq: P = 0)
      float2 row_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        row_r[r] = rows_g[(static_cast<size_t>(x.b) * H + x.h) * Sqp + ia
                          + 8 * r];
      float dqa[HDP / 2];
#pragma unroll
      for (int y = 0; y < HDP / 2; ++y) dqa[y] = 0.0f;
      float sa[BK / 2], dpa[BK / 2];
      uint32_t ds[BK / 4];
      uint32_t qf[HDP / 16][4], dof[HDP / 16][4];   // kRegA: Q, dO rows
      auto wait_full = [&](int i) {
        mbar_wait(full((it + i) % ST), ((it + i) / ST) & 1);
      };
      // S = Q K^T and dP = dO V^T of tile i.  At 256 columns the A
      // addresses are made opaque at each issue, so that their descriptors
      // are formed there: the compiler would otherwise hold the 2 x 16
      // descriptors, invariant over the item, in registers that the
      // 64 x 256 dQ accumulators leave no room for (they spilled)
      auto issue_sdp = [&](int i) {
        const int st = (it + i) % ST;
        uint32_t qa = qw, da = dow;
        if constexpr (HDP == 256) {
          asm volatile("" : "+r"(qa));
          asm volatile("" : "+r"(da));
        }
        issue_rows<HDP, BK>(sa, qa, BM, ks + st * T::kKBytes, qf);
        issue_rows<HDP, BK>(dpa, da, BM, vs + st * T::kKBytes, dof);
      };
      // dQ += dS K of tile i
      auto issue_dq = [&](int i) {
        issue_reg<HDP, BK>(dqa, ds, ks + ((it + i) % ST) * T::kKBytes);
      };
      // P = 2^(s c - lse2) and dS = P (dP - D) of tile i, float32, in dpa:
      // sa[4 jj + e] is row ia + 8 (e / 2), key k0 + 8 jj + 2 t4 + e % 2
      auto grads = [&](int i) {
        const int k0 = (t0 + i) * BK;
        // a tile that holds a masked (row, key) pair for these rows sets its
        // scores to -inf first (P = 0); the rest skip the mask
        if (k0 + BK > Sk || (causal && k0 + BK - 1 > r0)
            || (window > 0 && r0 + 63 - k0 >= window)) {
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!valid(ia + 8 * (e >> 1), k0 + 8 * jj + 2 * t4 + (e & 1),
                         Sq, Sk, window, causal))
                sa[4 * jj + e] = -INFINITY;
        }
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 r = row_r[e >> 1];
            const float pe = ex2(fmaf(sa[4 * jj + e], c, -r.x));
            dpa[4 * jj + e] = pe * (dpa[4 * jj + e] - r.y);
          }
      };
      auto pack = [&]() {
#pragma unroll
        for (int y = 0; y < BK / 4; ++y)
          ds[y] = pack_bf16(dpa[2 * y], dpa[2 * y + 1]);
      };
      mbar_wait(q_full, j & 1);
      // kRegA: this warpgroup's Q and dO rows as A fragments, once; the
      // tiles are then free for the next item's
      if constexpr (T::kRegA) {
        load_a<HDP>(qf, qw, BM, wi, lane);
        load_a<HDP>(dof, dow, BM, wi, lane);
      }
      if ((T::kRegA || n == 0) && lane == 0) mbar_arrive(q_empty);
      // as in dK/dV: tile i's P and dS while tile i - 1's dQ product runs,
      // nothing in flight across the back edge
      if (n > 0) {
        wait_full(0);
        turn();
        issue_sdp(0);
        pass();
        wgmma_wait<0>();
        pin(sa);
        pin(dpa);
        if (!T::kRegA && n == 1 && lane == 0)
          mbar_arrive(q_empty);             // Q, dO read
        grads(0);
        pack();
        for (int i = 1; i < n; ++i) {
          wait_full(i);
          turn();
          issue_sdp(i);
          issue_dq(i - 1);
          pass();
          wgmma_wait<1>();                  // S and dP of tile i
          pin(sa);
          pin(dpa);
          if (!T::kRegA && i == n - 1 && lane == 0) mbar_arrive(q_empty);
          grads(i);
          wgmma_wait<0>();                  // tile i - 1's dQ
          pin(dqa);
          pin(ds);
          if (lane == 0) mbar_arrive(empty((it + i - 1) % ST));
          pack();
        }
        turn();
        issue_dq(n - 1);
        pass();
        wgmma_wait<0>();
        pin(dqa);
        pin(ds);
        if (lane == 0) mbar_arrive(empty((it + n - 1) % ST));
      }
      it += n;
      store_rows<HDP>(dq, dqa, scale, x.b, ia, Sq, H, x.h, hd, t4);
    }
    // the last consumer's first arrival has no turn to match: take it
    if (w == 0) bar_sync(1);
  }
}

template <int HDP>
cudaError_t launch_wg(cudaStream_t stream, const bf16* q, const bf16* k,
                      const bf16* v, const bf16* o, const bf16* dout,
                      bf16* dq, bf16* dk, bf16* dv, const float* lse2,
                      float* fscratch, int* work, int B, int Sq, int Sk,
                      int H, int KVH, int hd, int window, int causal,
                      float scale) {
  using T = Wg<HDP>;
  // prep's grid (query tiles, H, B); the persistent kernels' item counts
  const long long kv_items = static_cast<long long>((Sk + T::BN - 1) / T::BN)
                             * KVH * B;
  const long long q_items = static_cast<long long>((Sq + T::BM - 1) / T::BM)
                            * H * B;
  if (H > 65535 || B > 65535 || kv_items > INT_MAX || q_items > INT_MAX)
    return cudaErrorInvalidConfiguration;
  // the device's context current in this thread before the tensor maps
  // are encoded (autograd runs the backward on a thread of its own, which
  // may have made no CUDA call yet)
  int device, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // dK/dV streams BQ-row Q and dO tiles past BN-key K and V tiles; dQ
  // streams BK-key K and V tiles past BM-row Q and dO tiles
  CUtensorMap tq_s, tdo_s, tk_n, tv_n, tq_m, tdo_m, tk_k, tv_k;
  if (!tensor_map(&tq_s, q, B, Sq, H, hd, T::BQ)
      || !tensor_map(&tdo_s, dout, B, Sq, H, hd, T::BQ)
      || !tensor_map(&tk_n, k, B, Sk, KVH, hd, T::BN)
      || !tensor_map(&tv_n, v, B, Sk, KVH, hd, T::BN)
      || !tensor_map(&tq_m, q, B, Sq, H, hd, T::BM)
      || !tensor_map(&tdo_m, dout, B, Sq, H, hd, T::BM)
      || !tensor_map(&tk_k, k, B, Sk, KVH, hd, T::BK)
      || !tensor_map(&tv_k, v, B, Sk, KVH, hd, T::BK))
    return cudaErrorInvalidValue;
  // persistent: one block per SM (or per item, if fewer).  The SM count,
  // and the shared-memory allowances above 48 KB, are set once per device
  // and template, at its first launch
  static std::atomic<int> sms_of[kMaxDevices];
  if (device < kMaxDevices) sms = sms_of[device].load();
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wg_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kDkdvSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_wg_kernel<HDP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::kDqSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) sms_of[device].store(sms);
  }
  const float c = scale * 1.4426950408889634f;   // scale * log2(e)
  // (lse2, D) per query row, Sq padded to whole dQ items
  const int Sqp = (Sq + T::BM - 1) / T::BM * T::BM;
  float2* rows = reinterpret_cast<float2*>(fscratch);
  flash_bwd_prep_kernel<<<dim3(Sqp / kTile, H, B), kThreads, 0, stream>>>(
      o, dout, lse2, rows, work, Sq, Sqp, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_wg_kernel<HDP>
      <<<static_cast<int>(kv_items < sms ? kv_items : sms), kWgThreads,
         T::kDkdvSmem, stream>>>(tq_s, tdo_s, tk_n, tv_n, rows, dk, dv, work,
                                 B, Sq, Sqp, Sk, H, KVH, hd, window, causal,
                                 scale, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_wg_kernel<HDP>
      <<<static_cast<int>(q_items < sms ? q_items : sms), kWgThreads,
         T::kDqSmem, stream>>>(tq_m, tdo_m, tk_k, tv_k, rows, dq, B, Sq, Sqp,
                               Sk, H, KVH, hd, window, causal, scale, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KVH, hd): bfloat16,
// contiguous on the card, 16-byte aligned.  lse2 (B, H, Sq) float32: the
// forward kernel's row statistics (flash_attention.cu's optional output).
// Scratch: fscratch, B H Sqp 2 float32 with Sqp = Sq rounded up to a
// multiple of 128, 16-byte aligned; work, one int32.  B, Sq, Sk >= 1;
// H % KVH == 0; H <= 65535 and B <= 65535, and fewer than 2^31 work items, else the launch is refused
// (cudaErrorInvalidConfiguration).  window <= 0: no window.  scale:
// hd^-0.5.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, const void* lse2,
                               void* fscratch, void* work, int B, int Sq,
                               int Sk, int H, int KVH, int hd, int window,
                               int causal, float scale, cudaStream_t stream) {
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v),
             *oo = static_cast<const bf16*>(o),
             *dd = static_cast<const bf16*>(dout);
  bf16 *dqq = static_cast<bf16*>(dq), *dkk = static_cast<bf16*>(dk),
       *dvv = static_cast<bf16*>(dv);
  const float* l = static_cast<const float*>(lse2);
  float* fs = static_cast<float*>(fscratch);
  int* wk = static_cast<int*>(work);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16: case 32: case 64:
      err = launch_wg<64>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, fs,
                          wk, B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
    case 120: case 128:
      err = launch_wg<128>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, fs,
                           wk, B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
    case 256:
      err = launch_wg<256>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, fs,
                           wk, B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
  }
  return static_cast<int>(err);
}

// dynamic shared memory of one block of the dK/dV (kernel 0) or dQ
// (kernel 1) launch at head dim hd (0: not built)
int flash_attention_bwd_smem(int hd, int kernel) {
  switch (hd) {
    case 16: case 32: case 64:
      return kernel == 0 ? Wg<64>::kDkdvSmem : Wg<64>::kDqSmem;
    case 120: case 128:
      return kernel == 0 ? Wg<128>::kDkdvSmem : Wg<128>::kDqSmem;
    case 256:
      return kernel == 0 ? Wg<256>::kDkdvSmem : Wg<256>::kDqSmem;
  }
  return 0;
}

}  // extern "C"
