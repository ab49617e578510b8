// Selective scan of the Mamba-1 block for Hopper (sm_90a), forward and
// backward (the backward's note is before its kernels, below).
// Per (batch b, channel d), with the state h[N] held in registers:
//   h_t = exp(dt_t A[d, :]) * h_{t-1} + (dt_t x_t) B_t
//   y_t = bf16((C_t . h_t + D[d] x_t) * silu(z_t))
// dt, x (bsz, S, d_inner) float32; z (bsz, S, d_inner) bf16, rows evenly
// spaced (the gate half of the input projection, read in place); B, C
// (bsz, S, N) float32; A (d_inner, N), D (d_inner,) float32; y
// (bsz, S, d_inner) bf16.  N is 8 or 16; d_inner even.
//
// Replaces no Pallas kernel.  The JAX package's mamba_block
// (src/repro/models/ssm.py:42-73) materialises decay = exp(dt A) and
// drive = dt x B as (bsz, S, d_inner, N) float32 and runs
// jax.lax.associative_scan over them (:66-70), then the C contraction, the
// D skip and the gate (:71-72).  An eager port of that scan would move
// ~100 GB per layer at falcon-mamba-7b's width; this kernel reads dt, x,
// z, B and C once and writes y once, and fuses the skip and the gate.
//
// Bound: at the model shapes the exponentials (N + 1 per (b, t, d): the
// decays and silu's) and the bytes are about even (falcon-mamba-7b's layer:
// 0.40 GB, 571M exponentials).  The scan is serial in t, so the card is
// filled across channels alone, and falcon's B=1 layer has only 8192 of
// them: a thread per channel is 256 warps for 528 schedulers, each warp
// alone with a ~180-instruction step (the first form; PERF.md row 11).
// Design:
//   * States spread over lanes.  A channel's N states go to L lanes
//     (lane l of the channel holds states l, l + L, ...), L in {1, 2, 4,
//     8, 16} (at most N): the fewest lanes that launch kTargetLanes (14
//     warps an SM of an H100), else N.  The layout depends on (bsz,
//     d_inner, N) only (selective_scan_layout reports it).
//   * The C . h sum leaves the step.  Over a group of G = max(L, 4) steps
//     each lane keeps its partial sums C_t[n] h_t[n] (its states summed
//     pairwise) in G registers; the L lanes of the channel then reduce
//     them transposed, a butterfly reduce-scatter (G/2 + G/4 + ...
//     shuffle-adds over log2 L rounds, the pairs xor L/2 first), after
//     which lane l holds the sums of steps l G/L .. (l + 1) G/L - 1.  That
//     lane alone adds D x, applies silu(z) and writes bf16 y: the gate's
//     exponential and reciprocal run once per (t, d).
//   * Checkpoints for the backward.  The training path's forward (the
//     instance with kCkpt) also writes h after steps 15, 31, ... (each
//     before the last step: a group of steps ends there), from which the
//     backward restarts its 16-step chunks; the serve path's instance is
//     the same code without them.
//   * Staging.  A block is 32 channels x L lanes.  Each tile (32 steps at
//     8 or 16 lanes, the next in flight; 16 steps at fewer lanes, two in
//     flight, so that 7 blocks fit an SM) of the block's dt, x
//     (transposed: a channel's steps contiguous), z and B, C (transposed:
//     a state's steps contiguous) is copied to shared memory by 4-byte
//     cp.async from offsets each thread computes once; a lane reads four
//     steps of dt, x and each of its B, C rows with one 16-byte load.
//     TMA (or a bulk copy) lands tiles in the global layout ([t][d],
//     [t][n]), and the step loop then reads every step's dt, x, B[n] and
//     C[n] apart: four times the shared loads of this loop, whose shared
//     memory traffic is what bounds it.  y goes through a double-buffered
//     shared tile and leaves as bf16 pairs, each warp writing whole
//     64-byte row pieces, one tile behind the compute.
// What holds it back (PERF.md row 11 and its lever measurements): the
// shared memory and shuffle traffic of the step loop (the reduction's
// shuffles, the staging copies, the B, C loads), not the MUFU.
// No atomics, and every sum in a fixed order that depends on the shape
// alone: every launch gives the same bits.  The products and sums of the
// state round one by one (-fmad=false) in the plain version's order
// (decay h + (dt x) B); C . h is summed over a lane's states pairwise,
// then across lanes by the butterfly's tree, then + D x, then times
// silu(z) = z rcp(1 + ex2(-z log2(e))); the exponentials are ex2.approx of
// the argument times log2(e), within a few float32 ulps of expf.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCh = 32;          // channels per block
constexpr int kZRow = kCh + 2;   // bf16 per z / y row (odd words apart)
constexpr int kMaxLanes = 16;
// lanes launched to aim at: 14 warps an SM (3.5 a scheduler) of the
// H100's 132 (PERF.md row 11: falcon-mamba-7b's layer ran fastest at 8
// lanes, 3.9 warps a scheduler, against 16 lanes at 7.8)
constexpr long long kTargetLanes = 14LL * 132 * 32;
constexpr float kLog2e = 1.4426950408889634f;
// steps between the forward's checkpoints, and per chunk of the backward
// (a multiple of every group size kG)
constexpr int kBT = 16;

// one stage: a tile of kT steps: dt, x of the block's channels and the B,
// C rows, transposed (a row kT + 4 floats: 16-byte aligned, and 8 rows
// apart in 16-byte reads hit distinct banks), and the z rows
template <int kN, int kT>
struct Stage {
  float dt[kCh][kT + 4];
  float x[kCh][kT + 4];
  float B[kN][kT + 4];
  float C[kN][kT + 4];
  __nv_bfloat16 z[kT][kZRow];
};

template <int kN, int kL>
struct Layout {
  static constexpr int kLanes = kL;
  static constexpr int kThreads = kCh * kL;
  static constexpr int kNL = kN / kL;          // states per lane
  static constexpr int kG = kL > 4 ? kL : 4;   // steps per reduction group
  static constexpr int kOwn = kG / kL;         // of them ending on a lane
  // 8 or 16 lanes (a few large blocks an SM): 32-step tiles, the next in
  // flight; 1-4 lanes (many small blocks): 16-step tiles, two in flight,
  // so that 7 blocks fit an SM's shared memory
  static constexpr int kTile = kL >= 8 ? 32 : 16;
  static constexpr int kStages = kL >= 8 ? 2 : 3;
  using StageT = Stage<kN, kTile>;
  // the stages and two tiles of y, under the 48 KB a block may take
  // without an opt-in attribute
  static constexpr int kSmem =
      kStages * static_cast<int>(sizeof(StageT))
      + 2 * kTile * kZRow * static_cast<int>(sizeof(__nv_bfloat16));
  // register room for the blocks an SM holds at the shapes that take
  // this lane count: 2 (16 lanes), 3 (8), 7 (shared memory's limit)
  static constexpr int kMinBlocks = kL == 16 ? 2 : kL == 8 ? 3 : 7;
  static_assert(kTile % kG == 0 && kN % kL == 0 && kSmem <= 48 * 1024,
                "layout");
};

int lanes_for(int bsz, int di, int N) {
  const long long channels = static_cast<long long>(bsz) * di;
  for (int L = 1; L < N && L < kMaxLanes; L *= 2)
    if (channels * L >= kTargetLanes) return L;
  return N < kMaxLanes ? N : kMaxLanes;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending committed groups of this thread are in
// flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A thread's share of the copies of every tile, in offsets from the
// tile's first row fixed at the launch.  Thread i takes the elements i,
// i + kThreads, ... of each grid, so its k-th element lies a compile-time
// distance from its first.  dt and x: a warp's 32 elements are 4 steps x
// 8 channels (32-byte row pieces in global memory, 32 distinct banks in
// the transposed rows), warp w taking steps 4 (w % kQ) and channels 8 (w /
// kQ); B and C the same over 4 steps x 8 states; z and y: 2 steps x 16
// channel pairs (64-byte row pieces).  An element past the tile's rows or
// the block's channels is skipped.
template <int kN, int kL>
struct Copier {
  using Lt = Layout<kN, kL>;
  static constexpr int kThreads = Lt::kThreads, kTile = Lt::kTile;
  static constexpr int kQ = kTile / 4;        // 4-step groups of a tile
  static constexpr int kP = kN / 8;           // 8-state groups of B and C
  int t0, c0;              // dt, x: first step, channel
  int bt0, bn0, bc;        // B, C: first step, state; bt0 N + bn0
  int zt0, zc;             // z, y: first step, channel
  long long dx, yo, zo;    // t0 di + c0, zt0 di + zc, zt0 z_ld + zc

  __device__ Copier(int di, long long z_ld) {
    const int lane = threadIdx.x % 32, w0 = threadIdx.x / 32;
    t0 = w0 % kQ * 4 + lane / 8;
    c0 = w0 / kQ * 8 + lane % 8;
    dx = static_cast<long long>(t0) * di + c0;
    bt0 = w0 / kP * 4 + lane / 8;
    bn0 = w0 % kP * 8 + lane % 8;
    bc = bt0 * kN + bn0;
    zt0 = threadIdx.x / (kCh / 2);
    zc = 2 * (threadIdx.x % (kCh / 2));
    yo = static_cast<long long>(zt0) * di + zc;
    zo = zt0 * z_ld + zc;
  }

  // rows (<= kTile) steps of the tile whose first row dt, x, z, B, C
  // point at, into stage s
  __device__ __forceinline__ void stage(
      typename Lt::StageT& s, const float* dt, const float* x,
      const __nv_bfloat16* z, const float* Bm, const float* Cm, int rows,
      int di, int nch, long long z_ld) const {
#pragma unroll
    for (int k = 0; k < kTile / kL; ++k) {
      const int t = t0 + 4 * (k * kL % kQ), c = c0 + 8 * (k * kL / kQ);
      if (t < rows && c < nch) {
        const long long g =
            dx + 4LL * (k * kL % kQ) * di + 8 * (k * kL / kQ);
        cp_async4(&s.dt[c][t], dt + g);
        cp_async4(&s.x[c][t], x + g);
      }
    }
#pragma unroll
    for (int k = 0; k < (kTile * kCh / 2 + kThreads - 1) / kThreads; ++k) {
      const int t = zt0 + k * kThreads / (kCh / 2);
      if (t < rows && zc < nch)                 // nch is even
        cp_async4(&s.z[t][zc],
                  z + zo + static_cast<long long>(k * kThreads / (kCh / 2))
                               * z_ld);
    }
#pragma unroll
    for (int k = 0; k < (kTile * kN + kThreads - 1) / kThreads; ++k) {
      const int t = bt0 + 4 * (k * kL / kP), n = bn0 + 8 * (k * kL % kP);
      if (t < rows) {
        const int g = bc + 4 * (k * kL / kP) * kN + 8 * (k * kL % kP);
        cp_async4(&s.B[n][t], Bm + g);
        cp_async4(&s.C[n][t], Cm + g);
      }
    }
  }

  // rows steps of a tile's y from shared memory to the rows at y
  __device__ __forceinline__ void store(const __nv_bfloat16 (*yt)[kZRow],
                                        __nv_bfloat16* y, int rows, int di,
                                        int nch) const {
#pragma unroll
    for (int k = 0; k < (kTile * kCh / 2 + kThreads - 1) / kThreads; ++k) {
      const int t = zt0 + k * kThreads / (kCh / 2);
      if (t < rows && zc < nch)
        *reinterpret_cast<unsigned*>(
            y + yo + static_cast<long long>(k * kThreads / (kCh / 2)) * di) =
            *reinterpret_cast<const unsigned*>(&yt[t][zc]);
    }
  }
};

// the transposed reduction of the channel's L lanes: p[0, 2 kHalf) are a
// lane's partial sums of 2 kHalf steps; the lanes that differ in bit kM
// swap halves and add, the lane with the bit set keeping the upper half
template <int kHalf, int kM, int kG>
__device__ __forceinline__ void butterfly(float (&p)[kG], int sub) {
  if constexpr (kM > 0) {
    const bool upper = (sub & kM) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? p[i] : p[i + kHalf];
      const float keep = upper ? p[i + kHalf] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, kM);
    }
    butterfly<kHalf / 2, kM / 2, kG>(p, sub);
  }
}

// one group of G steps from step g of the tile: the states, then the sums
// reduced across lanes, then each step's gate and y on the lane holding it
template <int kN, int kL>
__device__ __forceinline__ void scan_group(
    const typename Layout<kN, kL>::StageT& s, __nv_bfloat16 (*yt)[kZRow],
    int g, int c, int sub,
    float (&h)[Layout<kN, kL>::kNL], const float (&a2)[Layout<kN, kL>::kNL],
    float dsk) {
  using Lt = Layout<kN, kL>;
  float p[Lt::kG];
#pragma unroll
  for (int q = 0; q < Lt::kG / 4; ++q) {
    const float4 dt4 = *reinterpret_cast<const float4*>(&s.dt[c][g + 4 * q]);
    const float4 x4 = *reinterpret_cast<const float4*>(&s.x[c][g + 4 * q]);
    const float dtq[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
    const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
    float bq[Lt::kNL][4], cq[Lt::kNL][4];
#pragma unroll
    for (int j = 0; j < Lt::kNL; ++j) {
      const float4 b4 = *reinterpret_cast<const float4*>(
          &s.B[sub + kL * j][g + 4 * q]);
      const float4 c4 = *reinterpret_cast<const float4*>(
          &s.C[sub + kL * j][g + 4 * q]);
      bq[j][0] = b4.x, bq[j][1] = b4.y, bq[j][2] = b4.z, bq[j][3] = b4.w;
      cq[j][0] = c4.x, cq[j][1] = c4.y, cq[j][2] = c4.z, cq[j][3] = c4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dtx = dtq[u] * xq[u];
      float ch[Lt::kNL];
#pragma unroll
      for (int j = 0; j < Lt::kNL; ++j) {
        const float decay = ex2(dtq[u] * a2[j]);
        h[j] = decay * h[j] + dtx * bq[j][u];
        ch[j] = cq[j][u] * h[j];
      }
      // the lane's states summed pairwise: (0 + 1) + (2 + 3), ...
#pragma unroll
      for (int w = 1; w < Lt::kNL; w *= 2)
#pragma unroll
        for (int j = 0; j + w < Lt::kNL; j += 2 * w) ch[j] = ch[j] + ch[j + w];
      p[4 * q + u] = ch[0];
    }
  }
  butterfly<Lt::kG / 2, kL / 2, Lt::kG>(p, sub);
#pragma unroll
  for (int i = 0; i < Lt::kOwn; ++i) {
    const int r = g + sub * Lt::kOwn + i;
    const float xv = s.x[c][r];
    const float zv = __bfloat162float(s.z[r][c]);
    const float gate = zv * rcp(1.0f + ex2(-zv * kLog2e));
    yt[r][c] = __float2bfloat16_rn((p[i] + dsk * xv) * gate);
  }
}

// kCkpt: write the checkpoints (the training path's forward); the serve
// path's instance writes none and is the same code as without them
template <int kN, int kL, bool kCkpt>
__global__ void __launch_bounds__(Layout<kN, kL>::kThreads,
                                  Layout<kN, kL>::kMinBlocks)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ z,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ Dskip,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ ckpt, int S, int di,
                      long long z_ld) {
  using Lt = Layout<kN, kL>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = Lt::kTile, kStages = Lt::kStages;
  auto* stages = reinterpret_cast<typename Lt::StageT*>(smem);
  auto ys = reinterpret_cast<__nv_bfloat16(*)[kTile][kZRow]>(
      smem + kStages * sizeof(typename Lt::StageT));
  const int c = threadIdx.x / kL, sub = threadIdx.x % kL;
  const int d0 = blockIdx.x * kCh;
  const int nch = min(kCh, di - d0);
  // a channel past d_inner computes on a live channel's constants and
  // stale shared memory, and stores nothing
  const int ch = c < nch ? d0 + c : di - 1;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;

  float a2[Lt::kNL], h[Lt::kNL];
#pragma unroll
  for (int j = 0; j < Lt::kNL; ++j) {
    a2[j] = A[static_cast<size_t>(ch) * kN + sub + kL * j] * kLog2e;
    h[j] = 0.0f;
  }
  const float dsk = Dskip[ch];
  // the checkpoints: this lane's state j after step kBT (m + 1) - 1 at
  // ck[m ck_step + kL j], for every m with kBT (m + 1) < S; a channel past
  // d_inner writes none
  const size_t ck_step = static_cast<size_t>(di) * kN;
  float* ck = kCkpt && c < nch
                  ? ckpt + static_cast<size_t>(blockIdx.y) * ((S - 1) / kBT)
                               * ck_step
                        + static_cast<size_t>(d0 + c) * kN + sub
                  : nullptr;

  // the block's first row and channel of each array; tile k's rows start
  // k kTile rows further
  const Copier<kN, kL> cp(di, z_ld);
  const float* dt_t = dt + row0 * di + d0;
  const float* x_t = x + row0 * di + d0;
  const __nv_bfloat16* z_t = z + static_cast<long long>(row0) * z_ld + d0;
  const float* B_t = Bm + row0 * kN;
  const float* C_t = Cm + row0 * kN;
  __nv_bfloat16* y_t = y + row0 * di + d0;
  const size_t tile_rows = static_cast<size_t>(kTile) * di;
  const long long tile_z = kTile * z_ld;
  const int tiles = (S + kTile - 1) / kTile;
  // stage the next tile (k) and step the pointers past it
  auto stage = [&](int k) {
    cp.stage(stages[k % kStages], dt_t, x_t, z_t, B_t, C_t,
             min(kTile, S - k * kTile), di, nch, z_ld);
    dt_t += tile_rows, x_t += tile_rows, z_t += tile_z;
    B_t += kTile * kN, C_t += kTile * kN;
  };
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) stage(k);
    cp_async_commit();               // possibly empty: one group per tile
  }
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();    // this tile's group has landed
    __syncthreads();
    // the stage tile - 1 read is free: every thread passed the barrier
    if (tile + kStages - 1 < tiles) stage(tile + kStages - 1);
    cp_async_commit();
    // the previous tile's y, written before the barrier
    if (tile > 0) {
      cp.store(ys[(tile - 1) & 1], y_t, kTile, di, nch);
      y_t += tile_rows;
    }
    const auto& s = stages[tile % kStages];
    const int rows = min(kTile, S - tile * kTile);
    // whole groups: steps past S (last tile only) compute on stale
    // shared memory after every live step and are not stored
#pragma unroll 1
    for (int g = 0; g < rows; g += Lt::kG) {
      scan_group<kN, kL>(s, ys[tile & 1], g, c, sub, h, a2, dsk);
      if constexpr (kCkpt) {
        const int end = tile * kTile + g + Lt::kG;  // a multiple of kG
        if (ck != nullptr && end % kBT == 0 && end < S)
#pragma unroll
          for (int j = 0; j < Lt::kNL; ++j)
            ck[static_cast<size_t>(end / kBT - 1) * ck_step + kL * j] = h[j];
      }
    }
  }
  __syncthreads();
  cp.store(ys[(tiles - 1) & 1], y_t, S - (tiles - 1) * kTile, di, nch);
}

// f(Layout<kN, lanes>{}) for lanes in {1, 2, 4, 8, 16}, at most kN
template <int kN, typename F>
int with_layout(int lanes, F f) {
  switch (lanes) {
    case 1: return f(Layout<kN, 1>{});
    case 2: return f(Layout<kN, 2>{});
    case 4: return f(Layout<kN, 4>{});
    case 8: return f(Layout<kN, 8>{});
  }
  if constexpr (kN >= 16)
    if (lanes == 16) return f(Layout<kN, 16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kN>
int launch(const float* dt, const float* x, const __nv_bfloat16* z,
           const float* B, const float* C, const float* A, const float* D,
           __nv_bfloat16* y, float* ckpt, int bsz, int S, int di,
           long long z_ld, cudaStream_t stream) {
  return with_layout<kN>(lanes_for(bsz, di, kN), [&](auto lt) {
    using Lt = decltype(lt);
    static_assert(kBT % Lt::kG == 0, "checkpoints end groups");
    const dim3 grid((di + kCh - 1) / kCh, bsz);
    if (ckpt != nullptr)
      selective_scan_kernel<kN, Lt::kLanes, true>
          <<<grid, Lt::kThreads, Lt::kSmem, stream>>>(
              dt, x, z, B, C, A, D, y, ckpt, S, di, z_ld);
    else
      selective_scan_kernel<kN, Lt::kLanes, false>
          <<<grid, Lt::kThreads, Lt::kSmem, stream>>>(
              dt, x, z, B, C, A, D, y, ckpt, S, di, z_ld);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// The backward: the gradients of the scan above for the output gradient dy
// (bf16, the gradient of the bf16 y; the cast taken as the identity).  With
// y_pre = C . h + D x, g = silu(z) and dy_pre = dy g:
//   dz_t = dy_t y_pre_t silu'(z_t)
//   dh_t = dy_pre_t C_t + exp(dt_{t+1} A) dh_{t+1}          (dh_S = 0)
//   ddt_t = sum_n dh_t A exp(dt_t A) h_{t-1} + x_t sum_n dh_t B_t
//   dx_t = D dy_pre_t + dt_t sum_n dh_t B_t
//   dB_t = sum_d dt_t x_t dh_t,   dC_t = sum_d dy_pre_t h_t
//   dA = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1},   dD = sum_{b,t} dy_pre_t x_t
// (ref.selective_scan_bwd_ref; tests hold it to jax.grad of the JAX
// package's scan and to float64 autograd).
//
// Replaces no Pallas kernel: the JAX package takes this gradient by
// jax.grad through mamba_block's associative scan
// (src/repro/models/ssm.py:61-72), jnp.
//
// Bound: the bytes (dt, x, dy, z read, ddt, dx, dz written: 22 per
// (b, t, d); falcon-mamba-7b's layer 0.74 GB, 0.22 ms on an H100) against
// N + 1 exponentials per (b, t, d) (0.14 ms) and 23 N + 10 float32
// operations (0.19 ms).  The work per state and step is about four times
// the forward's: the state recomputed, the reverse recurrence and five
// gradient terms.
// Design:
//   * h_{t-1} in reverse time without inverting the recurrence (dividing
//     by the decay is unstable) and without storing every h (2.1 GB a layer
//     at falcon's width): the forward kernel, asked for checkpoints (the
//     training path's forward), writes h at the end of every 16-step chunk
//     (S / 16 x d_inner x N floats, 134 MB at falcon); each chunk, last
//     first, is recomputed from the checkpoint before it, keeping
//     q_t = decay_t h_{t-1} in registers, and the reverse recurrence runs
//     through it (decay_t recomputed: one exponential more, a register
//     array fewer).  No pass of the backward repeats the forward.
//   * Several contiguous states a lane (four at the model layers: N / 4
//     lanes a channel, 32 channels a block; two where that launches too
//     few warps, chosen by shape as selective_scan_bwd_layout reports): a
//     step's per-channel work (the dt, x and dy silu(z) loads, dt x) is
//     shared by the lane's states, and the lane's B_t, C_t are one 16-byte
//     shared load each.  The sums over a channel's states (y_pre's C . h,
//     ddt's and dx's) leave the recurrences: each lane adds its states'
//     terms for a group of max(L, 4) steps, the channel's lanes reduce
//     them transposed (the forward's butterfly), and each lane finishes the
//     steps it then holds (dz, ddt, dx, dD).
//   * dB and dC (sums over d_inner) through shared memory: every lane
//     stores its states' terms of each step (16-byte stores), and once a
//     chunk the block sums them over its 32 channels in a fixed order into
//     its partial rows; dA and dD (sums over batch and steps) stay in
//     registers and leave as each batch row's partials; a second kernel
//     sums the partials in a fixed order.  No float atomics: every launch
//     gives the same bits.
//   * The state's recompute, the reverse recurrence and the gradient terms
//     are written as fused multiply-adds (__fmaf_rn; the library's
//     -fmad=false leaves them be): about half the instructions of the
//     products and sums rounded one by one.  The checkpoints themselves
//     are the forward's states, rounded as the plain version rounds them.
//   * dt, x and dy silu(z) transposed (a channel's steps contiguous, four
//     a 16-byte load), B, C and the checkpoint as they lie, staged by
//     cp.async one chunk ahead from offsets each thread computes once (the
//     forward's Copier); steps past S and channels past d_inner zero-filled
//     (a zero step leaves h as it is and adds 0 to every gradient).
// What holds it back (PERF.md row 11b, NVIDIA H100 80GB HBM3 at 700 W: the
// scan kernel 1.01 ms at falcon's layer, 4.6x its bound): shared memory
// traffic and issue, no single term.  Without the B, C loads the kernel
// runs 12% faster, without the dB / dC terms' stores 11%, without their
// sums over channels 13%, without the sums across lanes 4%; making the
// exponentials a multiply gains nothing, nor do two states a lane (twice
// the warps) or more registers (the lever trees of scripts/scan_bwd_ab.py).
// ---------------------------------------------------------------------------

// 16 bytes from gmem to smem by cp.async, or 16 zero bytes when !valid
// (nothing is read then)
__device__ __forceinline__ void cp_async16_or0(void* smem, const void* gmem,
                                               bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}

// 4 bytes from gmem to smem by cp.async, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4_or0(void* smem, const void* gmem,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem), "r"(valid ? 4 : 0));
}

// kV (1, 2 or 4) consecutive floats from / to an address aligned to them
template <int kV>
__device__ __forceinline__ void ld_vec(float (&v)[kV], const float* p) {
  if constexpr (kV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (kV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int kV>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (kV == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// one chunk of the backward's inputs: dt, x transposed (a channel's steps
// contiguous, rows kBT + 4 floats: 16-byte aligned, four steps a 16-byte
// load), B, C rows [step][state], the checkpoint before the chunk
// [channel][state] (zeros for the first chunk), z and dy rows
// [step][channel]
template <int kN>
struct __align__(16) BwdStage {
  float dt[kCh][kBT + 4];
  float x[kCh][kBT + 4];
  float B[kBT][kN];
  float C[kBT][kN];
  float h0[kCh][kN];
  __nv_bfloat16 z[kBT][kZRow];
  __nv_bfloat16 dy[kBT][kZRow];
};

// the backward's layout: kNL contiguous states a lane (n0 = sub kNL ..),
// kL = N / kNL lanes a channel, 32 channels a block; the sums over a
// channel's states reduced across its lanes per group of kG steps
template <int kN, int kNL>
struct BwdLt {
  static constexpr int kStates = kNL;
  static constexpr int kL = kN / kNL;           // lanes a channel
  static constexpr int kThreads = kCh * kL;
  static constexpr int kG = kL > 4 ? kL : 4;    // steps a reduction group
  static constexpr int kOwn = kG / kL;          // of them finished on a lane
  // blocks an SM at the shapes that take the layout: registers for three
  // 128-thread blocks (four states a lane), two 256-thread ones (two)
  static constexpr int kMinBlocks = kNL == 4 ? 3 : 2;
  static_assert(kBT % kG == 0 && kBT * kN % kThreads == 0
                && kBT * kN / kThreads <= 2, "layout");
};

// a chunk's working tiles: the block's dC, then dB, terms [step][channel
// state] (a step's row padded by kN floats: the steps one warp of the sum
// reads at once fall on distinct banks), dy silu(z) and dy silu'(z)
// (transposed as dt), and the outputs ddt, dx, dz on their way out
template <int kN>
struct __align__(16) BwdWork {
  static constexpr int kRow = kCh * kN + kN;
  float red[kBT][kRow];
  float dyp[kCh][kBT + 4];
  float gz[kCh][kBT + 4];
  float ddt[kBT][kCh];
  float dx[kBT][kCh];
  __nv_bfloat16 dz[kBT][kCh];
};

template <int kN>
constexpr int bwd_smem() {
  return 2 * static_cast<int>(sizeof(BwdStage<kN>))
         + static_cast<int>(sizeof(BwdWork<kN>));
}

// A thread's share of the backward's copies, in offsets fixed at the
// launch (the forward's Copier, for the backward's tiles): its m-th
// element of each grid lies a compile-time distance from its first.  dt,
// x: tiles of 4 steps x 8 channels a warp (32-byte row pieces in global
// memory, 32 distinct banks in the transposed rows), warp w taking tiles
// kT w .. kT w + kT - 1, tile v at steps 4 (v % 4) and channels 8 (v / 4);
// B, C: the chunk's rows in 16-byte pieces, one a thread (B's, then C's);
// the checkpoint likewise; z, dy and the outputs ddt, dx, dz: pairs of
// channels, 16 pairs a step.  Steps past rows and channels past nch are
// zero-filled (nothing is read) and not stored.
template <int kN, int kThreads>
struct BwdCopier {
  static constexpr int kT = kBT * kCh / kThreads;     // dt, x a thread
  static constexpr int kQ = kN / 4;                   // pieces a B row
  static constexpr int kPairRows = kThreads / (kCh / 2);
  static constexpr int kPairs = kBT / kPairRows;      // pairs a thread
  static_assert(kT >= 2 && kT <= 8 && kThreads >= 2 * kBT * kQ
                && kThreads >= kCh * kQ && kBT % kPairRows == 0,
                "copier");
  int xi, xc;          // dt, x: the first element's step and channel
  int pi, pc;          // pairs: the first pair's step and channel

  __device__ BwdCopier() {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    xi = kT * w % 4 * 4 + lane / 8;
    xc = kT * w / 4 * 8 + lane % 8;
    pi = threadIdx.x / (kCh / 2);
    pc = threadIdx.x % (kCh / 2) * 2;
  }

  // rows (<= kBT) steps from row `row` (b S + t) into stage s by
  // cp.async; h0 is the block's first channel in the checkpoint before
  // the chunk, or null (the first chunk: zeros)
  __device__ __forceinline__ void stage(
      BwdStage<kN>& s, const float* dt, const float* x,
      const __nv_bfloat16* z, const __nv_bfloat16* dy, const float* Bm,
      const float* Cm, const float* h0, size_t row, int rows, int di,
      int d0, int nch, long long z_ld) const {
    const float* dt_c = dt + row * di + d0;
    const float* x_c = x + row * di + d0;
#pragma unroll
    for (int m = 0; m < kT; ++m) {
      const int i = xi + 4 * (m % 4), c = xc + 8 * (m / 4);
      const bool ok = i < rows && c < nch;
      const int g = ok ? i * di + c : 0;
      cp_async4_or0(&s.dt[c][i], dt_c + g, ok);
      cp_async4_or0(&s.x[c][i], x_c + g, ok);
    }
    const int t = threadIdx.x;
    if (t < 2 * kBT * kQ) {
      const int r = t % (kBT * kQ), i = r / kQ, n = 4 * (r % kQ);
      const bool ok = i < rows;
      const float* src = (t < kBT * kQ ? Bm : Cm) + row * kN;
      cp_async16_or0(t < kBT * kQ ? &s.B[i][n] : &s.C[i][n],
                     src + (ok ? i * kN + n : 0), ok);
    }
    if (t < kCh * kQ) {
      const int c = t / kQ, n = 4 * (t % kQ);
      const bool ok = h0 != nullptr && c < nch;
      cp_async16_or0(&s.h0[c][n], ok ? h0 + c * kN + n : Bm, ok);
    }
    const __nv_bfloat16* z_c = z + static_cast<long long>(row) * z_ld + d0;
    const __nv_bfloat16* dy_c = dy + row * di + d0;
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int i = pi + m * kPairRows;
      const bool ok = i < rows && pc < nch;       // nch is even
      cp_async4_or0(&s.z[i][pc], z_c + (ok ? i * z_ld + pc : 0), ok);
      cp_async4_or0(&s.dy[i][pc], dy_c + (ok ? i * di + pc : 0), ok);
    }
  }

  // the chunk's ddt, dx and dz (rows steps from row `row`) from the work
  // tiles to global memory, a pair of channels a store
  __device__ __forceinline__ void store(const BwdWork<kN>& w, float* ddt,
                                        float* dx, __nv_bfloat16* dz,
                                        size_t row, int rows, int di,
                                        int d0, int nch) const {
    const size_t o_c = row * di + d0;
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int i = pi + m * kPairRows;
      if (i < rows && pc < nch) {
        const size_t o = o_c + static_cast<size_t>(i) * di + pc;
        *reinterpret_cast<float2*>(ddt + o) =
            *reinterpret_cast<const float2*>(&w.ddt[i][pc]);
        *reinterpret_cast<float2*>(dx + o) =
            *reinterpret_cast<const float2*>(&w.dx[i][pc]);
        *reinterpret_cast<__nv_bfloat162*>(dz + o) =
            *reinterpret_cast<const __nv_bfloat162*>(&w.dz[i][pc]);
      }
    }
  }
};

// out[i kN + n] = the sum over the block's channels c of red[i][c kN + n]
// for the chunk's first rows steps: each thread sums kV states of one
// step, the channels in four interleaved partial sums added pairwise (a
// fixed order)
template <int kN, int kThreads>
__device__ __forceinline__ void red_rows(
    const float (*red)[BwdWork<kN>::kRow], float* out, int rows) {
  constexpr int kV = kBT * kN / kThreads;       // 1 or 2
  constexpr int kPer = kN / kV;                 // threads a step
  const int i = threadIdx.x / kPer, n = threadIdx.x % kPer * kV;
  if (i >= rows) return;
  float acc[4][kV];
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    float v[kV];
    ld_vec<kV>(v, &red[i][c * kN + n]);
#pragma unroll
    for (int u = 0; u < kV; ++u)
      acc[c % 4][u] = c < 4 ? v[u] : acc[c % 4][u] + v[u];
  }
  float sum[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u)
    sum[u] = (acc[0][u] + acc[1][u]) + (acc[2][u] + acc[3][u]);
  st_vec<kV>(out + i * kN + n, sum);
}

// One block: 32 channels of one batch row, kL lanes a channel, kNL states
// a lane.  The chunks of kBT steps, last first: from the checkpoint before
// the chunk (staged with its inputs) the chunk's states are recomputed,
// q_t = decay_t h_{t-1} kept in registers, y_pre's sums reduced and dz
// finished per group; the chunk's dC terms are summed over the block's
// channels into this block's partial row; then the reverse recurrence of
// dh runs through the chunk (decay_t recomputed), ddt's and dx's sums are
// reduced and finished per group, and the dB terms are summed as the dC
// ones.  dA and dD leave as this batch row's partials in part_ad.
// selective_scan_bwd_reduce_kernel sums both partials in order.
template <int kN, int kNL>
__global__ void __launch_bounds__(BwdLt<kN, kNL>::kThreads,
                                  BwdLt<kN, kNL>::kMinBlocks)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ z,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ Dskip,
                          const __nv_bfloat16* __restrict__ dy,
                          const float* __restrict__ ckpt,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          __nv_bfloat16* __restrict__ dz,
                          float* __restrict__ part_bc,
                          float* __restrict__ part_ad, int bsz, int S,
                          int di, long long z_ld) {
  using Lt = BwdLt<kN, kNL>;
  using Wk = BwdWork<kN>;
  constexpr int kL = Lt::kL, kThreads = Lt::kThreads, kG = Lt::kG;
  constexpr int kOwn = Lt::kOwn;
  constexpr int kWC = 32 / kL;                  // channels a warp
  extern __shared__ __align__(16) unsigned char smem[];
  auto* stages = reinterpret_cast<BwdStage<kN>*>(smem);
  Wk& w = *reinterpret_cast<Wk*>(smem + 2 * sizeof(BwdStage<kN>));
  const int c = threadIdx.x / kL, sub = threadIdx.x % kL, n0 = sub * kNL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kCh;
  const int nch = min(kCh, di - d0);
  const int b = blockIdx.y;
  // a channel past d_inner reads zeros (its constants a live channel's),
  // adds 0 to dB and dC, and stores nothing
  const bool live = c < nch;
  const int ch = live ? d0 + c : di - 1;
  const size_t row0 = static_cast<size_t>(b) * S;
  float a[kNL], a2[kNL];
#pragma unroll
  for (int j = 0; j < kNL; ++j) {
    a[j] = A[static_cast<size_t>(ch) * kN + n0 + j];
    a2[j] = a[j] * kLog2e;
  }
  const float dsk = Dskip[ch];
  const int chunks = (S + kBT - 1) / kBT;
  // checkpoint k of this batch row at ck + k ck_step, from channel d0
  const size_t ck_step = static_cast<size_t>(di) * kN;
  const float* ck = ckpt + static_cast<size_t>(b) * (chunks - 1) * ck_step
                    + static_cast<size_t>(d0) * kN;
  // this block's partial rows for batch row b: dB, then dC
  float* p_dB = part_bc
                + (static_cast<size_t>(blockIdx.x) * 2 * bsz + b) * S * kN;
  float* p_dC = p_dB + static_cast<size_t>(bsz) * S * kN;
  const BwdCopier<kN, kThreads> cp;
  auto stage = [&](int k) {
    cp.stage(stages[k & 1], dt, x, z, dy, Bm, Cm,
             k > 0 ? ck + static_cast<size_t>(k - 1) * ck_step : nullptr,
             row0 + static_cast<size_t>(k) * kBT, min(kBT, S - k * kBT), di,
             d0, nch, z_ld);
  };

  float dh[kNL] = {}, dnext[kNL] = {}, dA[kNL] = {};
  float dD = 0.0f;
  stage(chunks - 1);
  cp_async_commit();
  for (int k = chunks - 1; k >= 0; --k) {
    const int rows = min(kBT, S - k * kBT);
    if (k > 0) stage(k - 1);
    cp_async_commit();                 // possibly empty: one group a chunk
    cp_async_wait<1>();                // chunk k has landed
    __syncthreads();
    const BwdStage<kN>& s = stages[k & 1];
    // the gate of this warp's channels: dy silu(z) and dy silu'(z), with
    // sigma(z) = rcp(1 + ex2(-z log2(e))) as the forward's
#pragma unroll
    for (int m = 0; m < kBT * kWC / 32; ++m) {
      const int e = lane + 32 * m;
      const int i = e / kWC, cc = warp * kWC + e % kWC;
      const float zv = __bfloat162float(s.z[i][cc]);
      const float dyv = __bfloat162float(s.dy[i][cc]);
      const float sg = rcp(1.0f + ex2(-zv * kLog2e));
      w.dyp[cc][i] = dyv * (zv * sg);
      w.gz[cc][i] = dyv * (sg * __fmaf_rn(zv, 1.0f - sg, 1.0f));
    }
    __syncwarp();

    // forward through the chunk: q_t = decay_t h_{t-1}, h_t; this lane's
    // terms of C_t . h_t; the dC terms to red; per group, y_pre summed
    // across the channel's lanes, dz and dD of the steps this lane holds
    float h[kNL], q[kBT][kNL];
    ld_vec<kNL>(h, &s.h0[c][n0]);
#pragma unroll
    for (int g0 = 0; g0 < kBT; g0 += kG) {
      float p[kG];
#pragma unroll
      for (int g = g0; g < g0 + kG; g += 4) {
        float dtq[4], xq[4], yq[4];
        ld_vec<4>(dtq, &s.dt[c][g]);
        ld_vec<4>(xq, &s.x[c][g]);
        ld_vec<4>(yq, &w.dyp[c][g]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = g + u;
          float bv[kNL], cv[kNL], dc[kNL];
          ld_vec<kNL>(bv, &s.B[i][n0]);
          ld_vec<kNL>(cv, &s.C[i][n0]);
          const float dtx = dtq[u] * xq[u];
          float yp = 0.0f;
#pragma unroll
          for (int j = 0; j < kNL; ++j) {
            q[i][j] = ex2(dtq[u] * a2[j]) * h[j];
            h[j] = __fmaf_rn(dtx, bv[j], q[i][j]);
            yp = j == 0 ? cv[j] * h[j] : __fmaf_rn(cv[j], h[j], yp);
            dc[j] = yq[u] * h[j];
          }
          p[i - g0] = yp;
          st_vec<kNL>(&w.red[i][c * kN + n0], dc);
        }
      }
      butterfly<kG / 2, kL / 2, kG>(p, sub);
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int i = g0 + sub * kOwn + o;
        const float xv = s.x[c][i];
        w.dz[i][c] = __float2bfloat16_rn(__fmaf_rn(dsk, xv, p[o])
                                         * w.gz[c][i]);
        dD = __fmaf_rn(w.dyp[c][i], xv, dD);
      }
    }
    __syncthreads();                   // the chunk's dC terms are in red
    red_rows<kN, kThreads>(w.red, p_dC + static_cast<size_t>(k) * kBT * kN,
                           rows);
    __syncthreads();                   // red is free for the dB terms

    // backward through the chunk: dh_t = dy_pre_t C_t + decay_{t+1}
    // dh_{t+1}; dA; this lane's terms of ddt's and dx's sums; the dB terms
    // to red; per group, the sums across the channel's lanes, then ddt and
    // dx of the steps this lane holds
#pragma unroll
    for (int g0 = kBT - kG; g0 >= 0; g0 -= kG) {
      float p1[kG], p2[kG];
#pragma unroll
      for (int g = g0 + kG - 4; g >= g0; g -= 4) {
        float dtq[4], xq[4], yq[4];
        ld_vec<4>(dtq, &s.dt[c][g]);
        ld_vec<4>(xq, &s.x[c][g]);
        ld_vec<4>(yq, &w.dyp[c][g]);
#pragma unroll
        for (int u = 3; u >= 0; --u) {
          const int i = g + u;
          float bv[kNL], cv[kNL], db[kNL];
          ld_vec<kNL>(bv, &s.B[i][n0]);
          ld_vec<kNL>(cv, &s.C[i][n0]);
          const float dtx = dtq[u] * xq[u];
          float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
          for (int j = 0; j < kNL; ++j) {
            dh[j] = __fmaf_rn(yq[u], cv[j], dnext[j] * dh[j]);
            dnext[j] = ex2(dtq[u] * a2[j]);    // decay_t, recomputed
            const float r = dh[j] * q[i][j];
            dA[j] = __fmaf_rn(dtq[u], r, dA[j]);
            t1 = j == 0 ? a[j] * r : __fmaf_rn(a[j], r, t1);
            t2 = j == 0 ? dh[j] * bv[j] : __fmaf_rn(dh[j], bv[j], t2);
            db[j] = dtx * dh[j];
          }
          p1[i - g0] = t1;
          p2[i - g0] = t2;
          st_vec<kNL>(&w.red[i][c * kN + n0], db);
        }
      }
      butterfly<kG / 2, kL / 2, kG>(p1, sub);
      butterfly<kG / 2, kL / 2, kG>(p2, sub);
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int i = g0 + sub * kOwn + o;
        w.ddt[i][c] = __fmaf_rn(s.x[c][i], p2[o], p1[o]);
        w.dx[i][c] = __fmaf_rn(s.dt[c][i], p2[o], dsk * w.dyp[c][i]);
      }
    }
    __syncthreads();                   // the dB terms, ddt, dx and dz
    red_rows<kN, kThreads>(w.red, p_dB + static_cast<size_t>(k) * kBT * kN,
                           rows);
    cp.store(w, ddt, dx, dz, row0 + static_cast<size_t>(k) * kBT, rows, di,
             d0, nch);
  }
  // dD: this lane's steps, then across the channel's lanes (a butterfly)
#pragma unroll
  for (int m = kL / 2; m > 0; m /= 2)
    dD = dD + __shfl_xor_sync(0xffffffffu, dD, m);
  if (live) {
    float* ad = part_ad + static_cast<size_t>(b) * di * (kN + 1);
#pragma unroll
    for (int j = 0; j < kNL; ++j)
      ad[static_cast<size_t>(ch) * kN + n0 + j] = dA[j];
    if (sub == 0) ad[static_cast<size_t>(di) * kN + ch] = dD;
  }
}

// out[i] = part[i] + part[M + i] + ... + part[(K - 1) M + i], in that
// order: the blocks' (or batch rows') partial sums, the same bits on every
// launch
__global__ void __launch_bounds__(256)
selective_scan_bwd_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int K,
                                 long long M) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < M;
       i += 256LL * gridDim.x) {
    float acc = part[i];
    for (int k = 1; k < K; ++k) acc = acc + part[k * M + i];
    out[i] = acc;
  }
}

int reduce_grid(long long M) {
  const long long blocks = (M + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

// lanes launched to aim at with four states a lane: 7 warps an SM of the
// H100's 132 (falcon-mamba-7b's layer launches 7.8 at four states a lane;
// hymba-1.5b's B=1 layer, 3.0, takes two)
constexpr long long kBwdTargetLanes = 7LL * 132 * 32;

int bwd_states_for(int bsz, int di, int N) {
  return static_cast<long long>(bsz) * di * (N / 4) >= kBwdTargetLanes ? 4
                                                                       : 2;
}

// f(BwdLt<kN, states>{}) for states 4 or 2
template <int kN, typename F>
int with_bwd_layout(int states, F f) {
  if (states == 4) return f(BwdLt<kN, 4>{});
  if (states == 2) return f(BwdLt<kN, 2>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kN>
int launch_bwd(const float* dt, const float* x, const __nv_bfloat16* z,
               const float* B, const float* C, const float* A,
               const float* D, const __nv_bfloat16* dy, const float* ckpt,
               float* ddt, float* dx, __nv_bfloat16* dz, float* dBC,
               float* dAD, float* part_bc, float* part_ad, int bsz, int S,
               int di, long long z_ld, cudaStream_t stream) {
  constexpr int kSmem = bwd_smem<kN>();
  return with_bwd_layout<kN>(bwd_states_for(bsz, di, kN), [&](auto lt) {
    using Lt = decltype(lt);
    auto* kernel = selective_scan_bwd_kernel<kN, Lt::kStates>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (di + kCh - 1) / kCh;
    kernel<<<dim3(blocks, bsz), Lt::kThreads, kSmem, stream>>>(
        dt, x, z, B, C, A, D, dy, ckpt, ddt, dx, dz, part_bc, part_ad, bsz,
        S, di, z_ld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long m_bc = 2LL * bsz * S * kN;
    const long long m_ad = static_cast<long long>(di) * (kN + 1);
    selective_scan_bwd_reduce_kernel<<<reduce_grid(m_bc), 256, 0, stream>>>(
        part_bc, dBC, blocks, m_bc);
    selective_scan_bwd_reduce_kernel<<<reduce_grid(m_ad), 256, 0, stream>>>(
        part_ad, dAD, bsz, m_ad);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// dt, x (bsz, S, di) float32 contiguous; z bf16 with row (b, t) at
// z + (b S + t) z_ld, 4-byte aligned, z_ld even; B, C (bsz, S, N) float32
// contiguous; A (di, N), D (di,) float32; y (bsz, S, di) bf16; ckpt null,
// or (bsz, ceil(S / 16) - 1, di, N) float32 for the states after steps 15,
// 31, ... (the backward's checkpoints).  All on the card; N in {8, 16};
// bsz, S, di >= 1, di even, bsz <= 65535.
int selective_scan_launch(const float* dt, const float* x, const void* z,
                          const float* B, const float* C, const float* A,
                          const float* D, void* y, float* ckpt, int bsz,
                          int S, int di, int N, long long z_ld,
                          cudaStream_t stream) {
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (di % 2 || z_ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 16)
    return launch<16>(dt, x, zb, B, C, A, D, yb, ckpt, bsz, S, di, z_ld,
                      stream);
  if (N == 8)
    return launch<8>(dt, x, zb, B, C, A, D, yb, ckpt, bsz, S, di, z_ld,
                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the layout selective_scan_launch takes at (bsz, S, di, N): out = {lanes
// per channel, channels per block, threads per block, steps per tile};
// cudaErrorInvalidValue for an N it is not built for
int selective_scan_layout(int bsz, int S, int di, int N, int* out) {
  (void)S;
  const auto describe = [out](auto lt) {
    using Lt = decltype(lt);
    out[0] = Lt::kLanes;
    out[1] = kCh;
    out[2] = Lt::kThreads;
    out[3] = Lt::kTile;
    return 0;
  };
  if (N == 16) return with_layout<16>(lanes_for(bsz, di, N), describe);
  if (N == 8) return with_layout<8>(lanes_for(bsz, di, N), describe);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of selective_scan_launch's scan for the output gradient dy
// (bsz, S, di) bf16 contiguous, inputs as there, B and C 16-byte aligned,
// and ckpt the checkpoints that selective_scan_launch wrote for them
// (16-byte aligned).  Writes ddt, dx (bsz, S, di) float32, dz (bsz, S, di)
// bf16, dBC (2, bsz, S, N) float32 (dB then dC) and dAD (di N + di)
// float32 (dA (di, N) then dD); scratch: part_bc (ceil(di / 32), 2, bsz,
// S, N) and part_ad (bsz, di N + di) float32.  Three launches on the
// stream: the scan's, then the two ordered sums of the partials.
int selective_scan_bwd_launch(const float* dt, const float* x, const void* z,
                              const float* B, const float* C, const float* A,
                              const float* D, const void* dy,
                              const float* ckpt, float* ddt, float* dx,
                              void* dz, float* dBC, float* dAD,
                              float* part_bc, float* part_ad, int bsz, int S,
                              int di, int N, long long z_ld,
                              cudaStream_t stream) {
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  auto* dzb = static_cast<__nv_bfloat16*>(dz);
  if (di % 2 || z_ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 16)
    return launch_bwd<16>(dt, x, zb, B, C, A, D, dyb, ckpt, ddt, dx, dzb,
                          dBC, dAD, part_bc, part_ad, bsz, S, di, z_ld,
                          stream);
  if (N == 8)
    return launch_bwd<8>(dt, x, zb, B, C, A, D, dyb, ckpt, ddt, dx, dzb,
                         dBC, dAD, part_bc, part_ad, bsz, S, di, z_ld,
                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the layout selective_scan_bwd_launch takes at (bsz, S, di, N): out =
// {lanes per channel, channels per block, threads per block, steps per
// chunk, chunks, channel blocks, dynamic shared memory bytes}
int selective_scan_bwd_layout(int bsz, int S, int di, int N, int* out) {
  const auto describe = [&](auto lt) {
    using Lt = decltype(lt);
    out[0] = Lt::kL;
    out[1] = kCh;
    out[2] = Lt::kThreads;
    out[3] = kBT;
    out[4] = (S + kBT - 1) / kBT;
    out[5] = (di + kCh - 1) / kCh;
    out[6] = bwd_smem<Lt::kL * Lt::kStates>();
    return 0;
  };
  if (N == 16) return with_bwd_layout<16>(bwd_states_for(bsz, di, N),
                                          describe);
  if (N == 8) return with_bwd_layout<8>(bwd_states_for(bsz, di, N),
                                        describe);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
