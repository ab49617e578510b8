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
// Design: the FlashAttention-2 split, three launches, no float atomics
// (every sum has a fixed order, so two launches give the same bits, which
// the trainer's bit-exact crash-resume needs):
//  1. prep: one block per (64-row query tile, head, batch): D_i =
//     rowsum(dO o) in float32.  The row log-sum-exp (base 2, of the scaled
//     scores) comes from the forward kernel (flash_attention.cu's optional
//     lse2 output), which the autograd function saves for this kernel.
//  2. dK/dV: one block per (64-key tile, KV head, batch, 64-column chunk).
//     K and V tiles stay in shared memory; the block walks the G query
//     heads and, for each, the query tiles that can see its keys.  Each of
//     4 warps owns 16 keys and computes, on the tensor cores (mma.sync
//     m16n8k16, bf16 in, float32 accumulate), S^T = K Q^T and
//     dP^T = V dO^T for 64 queries, then P^T and dS^T in registers, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//     operands (the accumulator layout of two n-tiles is the A layout of
//     one k-step).  dK and dV stay in registers, 64 columns at a time.
//  3. dQ: one block per (64-row query tile, head, batch, 64-column chunk),
//     walking the key tiles that hold a valid key for its rows: S = Q K^T,
//     dP = dO V^T, P, dS, dQ += dS K.
// P = 2^(s scale log2(e) - lse2) and dS are rounded to bf16 for their
// products (as the forward rounds P for P V); every sum is float32; the
// outputs are bf16.  Head dims
// 16, 32, 64 are padded to 64 columns, 120 and 128 to 128, 256 stays
// (zeros in shared memory: they add +0).  Operand fragments are read from
// padded shared-memory rows with ldmatrix (.trans for the operands read
// across rows), conflict-free.  Tiles load by cp.async (16 bytes a
// thread) in two stages: the next query (dK/dV) or key (dQ) tile loads
// while this one's products run.  wgmma and TMA are later work.
//
// Bound: the tensor cores, 2.5 times the forward's products (S, dP, dV, dK,
// dQ: 5 x 2 hd FLOPs per attended pair) at the bf16 dense rate.  This
// design does 7 products per pair (S and dP twice; for hd > 64 S and dP
// again per 64-column chunk).  Tiles wholly inside the mask skip the
// per-entry mask.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError() after each of its three launches, or
// cudaErrorInvalidValue for a head dim it was not built for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

extern __shared__ __align__(16) unsigned char bwd_smem[];

namespace {

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory, lanes 8j..8j+7 giving the row
// addresses of matrix j: register j holds matrix j in the mma fragment
// layout (row lane / 4, columns 2 (lane % 4) and + 1); .trans holds it
// transposed (rows 2 (lane % 4) and + 1, column lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
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
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
// shuffle tree; 64 rows per block
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      float* __restrict__ dsum, int Sq, int H, int hd) {
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * H + h;   // (b, h) row block
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int i = q0 + r;
    if (i >= Sq) break;
    const size_t base = ((static_cast<size_t>(b) * Sq + i) * H + h) * hd;
    float acc = 0.f;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + base + d));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + base + d));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dsum[row0 * Sq + i] = acc;
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
      o, dout, dsum, Sq, H, hd);
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

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KVH, hd): bfloat16,
// contiguous on the card, 16-byte aligned.  lse2 (B, H, Sq) float32: the
// forward kernel's row statistics (flash_attention.cu's optional output);
// dsum (B, H, Sq) float32 scratch.  B, Sq, Sk >= 1; H % KVH == 0;
// H <= 65535 and B * (padded hd / 64) <= 65535, else the launch is refused
// (cudaErrorInvalidConfiguration).  window <= 0: no window.
// scale: hd^-0.5.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, const void* lse2,
                               void* dsum, int B, int Sq, int Sk, int H,
                               int KVH, int hd, int window, int causal,
                               float scale, cudaStream_t stream) {
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v),
             *oo = static_cast<const bf16*>(o),
             *dd = static_cast<const bf16*>(dout);
  bf16 *dqq = static_cast<bf16*>(dq), *dkk = static_cast<bf16*>(dk),
       *dvv = static_cast<bf16*>(dv);
  const float* l = static_cast<const float*>(lse2);
  float* ds = static_cast<float*>(dsum);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16: case 32: case 64:
      err = launch_bwd<64>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, ds,
                           B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
    case 120: case 128:
      err = launch_bwd<128>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, ds,
                            B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
    case 256:
      err = launch_bwd<256>(stream, qq, kk, vv, oo, dd, dqq, dkk, dvv, l, ds,
                            B, Sq, Sk, H, KVH, hd, window, causal, scale);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
