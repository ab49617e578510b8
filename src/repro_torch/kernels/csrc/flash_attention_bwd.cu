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
// Head dims 16, 32, 64 (padded to 64 columns) and 120, 128 (padded to
// 128): wgmma and TMA, the forward's Hopper machinery (hopper.cuh).  Both
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
//  * dQ: an item is 128 query rows of one head and batch element (the
//    forward's items, longest first, a static round robin), 64 rows per
//    consumer; Q and dO load once (at 64 columns into registers, as K and
//    V above), the K and V tiles of the 64-key tiles the rows can see
//    stream through a 3-stage ring.  Per tile: S = Q K^T, dP = dO V^T, P
//    and dS in registers, dQ += dS K with K read MN-major.
// Products per attended pair: 7 (S and dP in both kernels), against the
// bound's 5.  A one-pass form (dQ's part of each step in the dK/dV kernel,
// summed over the key tiles in a fixed order through a float32 buffer in
// global memory) was slower on the card (PERF.md, the flash backward
// row).
//
// Head dim 256: the mma.sync kernels (m16n8k16 from ldmatrix fragments,
// two cp.async stages, 64 x 64 tiles, output in 64-column chunks).  At 256
// columns the dK and dV of 64 keys (2 x 64 x 256 float32) do not fit in a
// warpgroup's registers beside S^T and dP^T, so the wgmma design does not
// carry over; here S and dP are recomputed per 64-column chunk.
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
// mma.sync kernels (padded head dim 256) and the prep kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 64;              // query rows and keys per tile
constexpr int kWarps = 4;              // 16 rows (or keys) of a tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;              // output columns per block
constexpr int kN = kCols / 8;          // n-tiles of 8 over a 64-wide span

template <int HDP>
struct Layout {
  static constexpr int kStride = HDP + 8;       // bf16 per shared row
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kTileBytes = kTileElems * 2;
  // two resident tiles and two stages of two streamed tiles (dK/dV: each
  // stage also holds its 64 rows' lse2 and D)
  static constexpr int kDkdvSmem = 6 * kTileBytes + 2 * 2 * kTile * 4;
  static constexpr int kDqSmem = 6 * kTileBytes;
};

__device__ __forceinline__ bool valid(int i, int j, int Sq, int Sk,
                                      int window, int causal) {
  return i < Sq && j < Sk && (!causal || i >= j)
         && (window <= 0 || i - j < window);
}

// (every (query, key) pair of a 64 x 64 tile valid: no per-entry mask)
__device__ __forceinline__ bool full_tile(int i0, int j0, int Sq, int Sk,
                                          int window, int causal) {
  return i0 + kTile <= Sq && j0 + kTile <= Sk
         && (!causal || i0 >= j0 + kTile - 1)
         && (window <= 0 || i0 + kTile - 1 - j0 < window);
}

// four 8x8 bf16 matrices from shared memory, lanes 8j..8j+7 giving the row
// addresses of matrix j: register j holds matrix j in the mma fragment
// layout (row lane / 4, columns 2 (lane % 4) and + 1); .trans holds it
// transposed (rows 2 (lane % 4) and + 1, column lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// two bf16 (lo at the lower k index) as one 32-bit fragment register
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// d += a b: A 16x16 row-major (4 registers), B 16x8 column-major (2),
// C/D 16x8 float32 (4): lane (g = lane / 4, t = lane % 4) holds
// a: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// b: (2t..2t+1, g), (2t+8..2t+9, g);  d: (g, 2t..2t+1), (g+8, 2t..2t+1).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// cp.async: `bytes` from global `src` into shared `dst` without the
// registers, or zeros when `full` is false (src then is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + kTile) of head `head` of a (B, S, heads, hd) tensor into
// shared rows of kStride bf16, asynchronously (cp.async, 16 bytes a
// thread); zeros past S and past hd (hd % 8 == 0)
template <int HDP>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b,
                          int r0, int S, int heads, int head, int hd) {
  constexpr int kVec = HDP / 8;                    // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    const bool in = r0 + r < S && c < hd;
    cp_async16(dst + r * Layout<HDP>::kStride + c,
               in ? src + ((static_cast<size_t>(b) * S + r0 + r) * heads
                           + head) * hd + c
                  : src,
               in);
  }
}

// acc[n] += A (16 rows of `a` from row r0) . B^T over HDP columns, for
// n-tiles of 8 rows of `bt` (n * 8 + g): the S = Q K^T pattern, both
// operands with the contraction axis contiguous in shared memory.  One
// ldmatrix.x4 gives A's fragment of a k-step, one more the B fragments of
// two n-tiles.
template <int HDP>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[kN][4],
                                              const bf16* a, int r0,
                                              const bf16* bt, int lane) {
  constexpr int S = Layout<HDP>::kStride;
  const int m = lane >> 3, rr = lane & 7;
  const bf16* pa = a + (r0 + (m & 1) * 8 + rr) * S + (m >> 1) * 8;
  const bf16* pb = bt + ((m >> 1) * 8 + rr) * S + (m & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, pa + kk * 16);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, pb + n * 8 * S + kk * 16);
      mma(acc[n], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma(acc[n + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

// acc[n] += A . B[:, c0 + 8n ..], A = x (16 x 64 in accumulator layout,
// rounded to bf16 here), B = the 64 rows of `rows` over columns c0..c0+63:
// the dV += P^T dO pattern, B's fragments of two n-tiles by one transposed
// ldmatrix.x4
template <int HDP>
__device__ __forceinline__ void acc_times_rows(float (&acc)[kN][4],
                                               const float (&x)[kN][4],
                                               const bf16* rows, int c0,
                                               int lane) {
  constexpr int S = Layout<HDP>::kStride;
  const int m = lane >> 3, rr = lane & 7;
  const bf16* base = rows + ((m & 1) * 8 + rr) * S + c0 + (m >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a0 = pack_f2(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_f2(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_f2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_f2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, base + kk * 16 * S + n * 8);
      mma(acc[n], a0, a1, a2, a3, bf[0], bf[1]);
      mma(acc[n + 1], a0, a1, a2, a3, bf[2], bf[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. prep: D per query row
// ---------------------------------------------------------------------------

// D_i = rowsum(dO o): a warp per row, lanes over column pairs, a fixed
// shuffle tree; 64 rows per block.  For the mma.sync kernels into dsum
// (B, H, Sq); for the wgmma kernels into rows (B, H, Sqp) as (lse2_i, D_i)
// pairs beside the forward's lse2, the rows from Sq to Sqp as (+inf, 0)
// (P = 0 there), so a tile of them is one bulk copy.  Also zeroes the
// dK/dV launch's work counter (launched after this one)
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse2,
                      float* __restrict__ dsum, float2* __restrict__ rows,
                      int* __restrict__ work, int Sq, int Sqp, int H,
                      int hd) {
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  if (work != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z) == 0
      && threadIdx.x == 0)
    *work = 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * H + h;   // (b, h) row block
  const int end = rows != nullptr ? Sqp : Sq;
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
      if (lane != 0 || i >= end) continue;
      if (rows == nullptr)
        dsum[row0 * Sq + i] = acc[u];
      else
        rows[row0 * Sqp + i] = i < Sq ? make_float2(lse2[row0 * Sq + i], acc[u])
                                      : make_float2(INFINITY, 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                      int hd, int window, int causal, float scale,
                      float scale_log2) {
  constexpr int E = Layout<HDP>::kTileElems;
  bf16* sk = reinterpret_cast<bf16*>(bwd_smem);
  bf16* sv = sk + E;
  bf16* stage_tiles = sv + E;            // stage st: Q at + 2E st, dO + E
  float* stage_rows = reinterpret_cast<float*>(stage_tiles + 4 * E);
  constexpr int kChunks = HDP / kCols;
  const int j0 = blockIdx.x * kTile, kh = blockIdx.y;
  const int b = blockIdx.z / kChunks, c0 = (blockIdx.z % kChunks) * kCols;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  // the query tiles that can see a key of [j0, j0 + kTile): nq per head,
  // from tile t0; iteration it is head kh G + it / nq, tile t0 + it % nq
  const int qlo = causal ? j0 : 0;
  const int qhi = window > 0 ? min(Sq, j0 + kTile - 1 + window) : Sq;
  const int t0 = qlo / kTile;
  const int nq = qhi > t0 * kTile ? (qhi - t0 * kTile + kTile - 1) / kTile
                                  : 0;
  const int n_it = G * nq;
  // stage it & 1: the Q and dO tiles, then lse2 (threads 0-63) and D
  // (64-127) of the tile's 64 rows, all by cp.async
  auto fetch = [&](int it) {
    const int h = kh * G + it / nq, i0 = (t0 + it % nq) * kTile;
    bf16* tiles = stage_tiles + (it & 1) * 2 * E;
    load_tile<HDP>(tiles, q, b, i0, Sq, H, h, hd);
    load_tile<HDP>(tiles + E, dout, b, i0, Sq, H, h, hd);
    const int r = threadIdx.x % kTile;
    const bool in = i0 + r < Sq;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + i0 + r;
    cp_async4(stage_rows + (it & 1) * 2 * kTile + threadIdx.x,
              threadIdx.x < kTile ? lse2 + (in ? at : 0)
                                  : dsum + (in ? at : 0), in);
  };

  load_tile<HDP>(sk, k, b, j0, Sk, KVH, kh, hd);
  load_tile<HDP>(sv, v, b, j0, Sk, KVH, kh, hd);
  if (n_it > 0) fetch(0);
  cp_async_commit();
  float dk_acc[kN][4] = {}, dv_acc[kN][4] = {};
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) fetch(it + 1);    // the next tiles load meanwhile
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();                     // this stage is in for every thread
    const int i0 = (t0 + it % nq) * kTile;
    const bf16* sq = stage_tiles + (it & 1) * 2 * E;
    const bf16* sdo = sq + E;
    const float* s_lse = stage_rows + (it & 1) * 2 * kTile;
    const float* s_d = s_lse + kTile;
    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float st[kN][4] = {}, dpt[kN][4] = {};
    rows_dot_rows<HDP>(st, sk, r0, sq, lane);
    rows_dot_rows<HDP>(dpt, sv, r0, sdo, lane);
    const bool full = full_tile(i0, j0, Sq, Sk, window, causal);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + r0 + g + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1);            // query in tile
        const float p = full || valid(i0 + c, j, Sq, Sk, window, causal)
                            ? exp2f(st[n][e] * scale_log2 - s_lse[c])
                            : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - s_d[c]);
      }
    acc_times_rows<HDP>(dv_acc, st, sdo, c0, lane);
    acc_times_rows<HDP>(dk_acc, dpt, sq, c0, lane);
    __syncthreads();                     // read before it + 2 overwrites it
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + r0 + g + 8 * half;
      const int d = c0 + n * 8 + 2 * t;      // even; hd even
      if (j >= Sk || d >= hd) continue;
      const size_t at = ((static_cast<size_t>(b) * Sk + j) * KVH + kh) * hd
                        + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[n][2 * half] * scale, dk_acc[n][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
          dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ dsum, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, int hd, int window,
                    int causal, float scale, float scale_log2) {
  constexpr int E = Layout<HDP>::kTileElems;
  bf16* sq = reinterpret_cast<bf16*>(bwd_smem);
  bf16* sdo = sq + E;
  bf16* stage_tiles = sdo + E;           // stage st: K at + 2E st, V + E
  constexpr int kChunks = HDP / kCols;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y;
  const int b = blockIdx.z / kChunks, c0 = (blockIdx.z % kChunks) * kCols;
  const int kh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq;

  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + r0 + g + 8 * half;
    lse_r[half] = i < Sq ? lse2[row0 + i] : INFINITY;
    d_r[half] = i < Sq ? dsum[row0 + i] : 0.f;
  }
  // the key tiles that hold a valid key for these rows: n_it from t0
  const int hi = causal ? min(Sk, q0 + kTile) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = lo / kTile;
  const int n_it = hi > t0 * kTile ? (hi - t0 * kTile + kTile - 1) / kTile
                                   : 0;
  auto fetch = [&](int it) {
    bf16* tiles = stage_tiles + (it & 1) * 2 * E;
    load_tile<HDP>(tiles, k, b, (t0 + it) * kTile, Sk, KVH, kh, hd);
    load_tile<HDP>(tiles + E, v, b, (t0 + it) * kTile, Sk, KVH, kh, hd);
  };

  load_tile<HDP>(sq, q, b, q0, Sq, H, h, hd);
  load_tile<HDP>(sdo, dout, b, q0, Sq, H, h, hd);
  if (n_it > 0) fetch(0);
  cp_async_commit();
  float dq_acc[kN][4] = {};
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) fetch(it + 1);    // the next tiles load meanwhile
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();                     // this stage is in for every thread
    const int j0 = (t0 + it) * kTile;
    const bf16* sk = stage_tiles + (it & 1) * 2 * E;
    const bf16* sv = sk + E;
    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[kN][4] = {}, dp[kN][4] = {};
    rows_dot_rows<HDP>(s, sq, r0, sk, lane);
    rows_dot_rows<HDP>(dp, sdo, r0, sv, lane);
    const bool full = full_tile(q0, j0, Sq, Sk, window, causal);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int i = q0 + r0 + g + 8 * half;
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const float p = full || valid(i, j, Sq, Sk, window, causal)
                            ? exp2f(s[n][e] * scale_log2 - lse_r[half])
                            : 0.f;
        dp[n][e] = p * (dp[n][e] - d_r[half]);
      }
    acc_times_rows<HDP>(dq_acc, dp, sk, c0, lane);
    __syncthreads();                     // read before it + 2 overwrites it
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + r0 + g + 8 * half;
      const int d = c0 + n * 8 + 2 * t;
      if (i >= Sq || d >= hd) continue;
      const size_t at = ((static_cast<size_t>(b) * Sq + i) * H + h) * hd + d;
      *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(
          dq_acc[n][2 * half] * scale, dq_acc[n][2 * half + 1] * scale);
    }
}

template <int HDP>
cudaError_t launch_bwd(cudaStream_t stream, const bf16* q, const bf16* k,
                       const bf16* v, const bf16* o, const bf16* dout,
                       bf16* dq, bf16* dk, bf16* dv, const float* lse2,
                       float* dsum, int B, int Sq, int Sk, int H, int KVH,
                       int hd, int window, int causal, float scale) {
  typedef Layout<HDP> L;
  constexpr int kChunks = HDP / kCols;
  // grid y holds the heads and grid z the (batch, 64-column chunk) pairs
  if (H > 65535 || B > 65535 / kChunks) return cudaErrorInvalidConfiguration;
  const float scale_log2 = scale * 1.4426950408889634f;   // scale * log2(e)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kDqSmem);
  if (err != cudaSuccess) return err;
  const int qt = (Sq + kTile - 1) / kTile, kt = (Sk + kTile - 1) / kTile;
  flash_bwd_prep_kernel<<<dim3(qt, H, B), kThreads, 0, stream>>>(
      o, dout, lse2, dsum, nullptr, nullptr, Sq, Sq, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<HDP><<<dim3(kt, KVH, B * kChunks), kThreads,
                               L::kDkdvSmem, stream>>>(
      q, k, v, dout, lse2, dsum, dk, dv, Sq, Sk, H, KVH, hd, window, causal,
      scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<HDP><<<dim3(qt, H, B * kChunks), kThreads, L::kDqSmem,
                             stream>>>(q, k, v, dout, lse2, dsum, dq, Sq, Sk,
                                       H, KVH, hd, window, causal, scale,
                                       scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 4. dK/dV and dQ on wgmma and TMA (padded head dims 64 and 128)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;        // producer warpgroup + two consumers
// setmaxnreg: 128 x 40 + 256 x 232 <= 65536 registers of the SM
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxDevices = 64;        // launch settings cached per device

template <int HDP>
struct Wg {
  // at 64 columns the resident operands of S and dP (K and V in dK/dV, Q
  // and dO in dQ) are loaded into registers once per item: register A
  // operands halve the shared-memory reads of those products, which at
  // 64-wide tiles with both operands in shared memory take as many bytes
  // a clock as shared memory gives.  At 128 columns the registers are
  // taken by the 64 x 128 accumulators
  static constexpr bool kRegA = HDP == 64;
  // dK/dV: an item is BN keys (64 per consumer warpgroup) of one KV head
  // and batch element; a step streams BQ queries of one query head
  static constexpr int BN = 128, BQ = HDP == 64 ? 64 : 32, ST = 4;
  static constexpr int kKVBytes = BN * HDP * 2;    // the K (or V) tile
  static constexpr int kQBytes = BQ * HDP * 2;     // a stage's Q (or dO)
  static constexpr int kStatBytes = BQ * 8;        // its rows' (lse2, D)
  // K, V | Q stages | dO stages | (lse2, D) rows | mbarriers | item slot,
  // +1024 for the alignment the 128-byte swizzle needs
  static constexpr int kDkdvSmem = 1024 + 2 * kKVBytes + 2 * ST * kQBytes
                                   + ST * kStatBytes + (2 + 2 * ST) * 8 + 16;
  // dQ: an item is BM query rows (64 per consumer) of one query head and
  // batch element; a step streams BK keys of its KV head
  static constexpr int BM = 128, BK = 64, STQ = 3;
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
  const uint32_t bars = rows + ST * T::kStatBytes;
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
      // S = Q K^T and dP = dO V^T of tile i
      auto issue_sdp = [&](int i) {
        const int st = (it + i) % ST;
        issue_rows<HDP, BK>(sa, qw, BM, ks + st * T::kKBytes, qf);
        issue_rows<HDP, BK>(dpa, dow, BM, vs + st * T::kKBytes, dof);
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
      o, dout, lse2, nullptr, rows, work, Sq, Sqp, H, hd);
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
// H % KVH == 0; H <= 65535 and B <= 65535 (hd 256: B * 4 <= 65535), and
// fewer than 2^31 work items, else the launch is refused
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
      err = launch_bwd<256>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, fs,
                            B, Sq, Sk, H, KVH, hd, window, causal, scale);
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
      return kernel == 0 ? Layout<256>::kDkdvSmem : Layout<256>::kDqSmem;
  }
  return 0;
}

}  // extern "C"
