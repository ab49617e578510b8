// Selective scan of the Mamba-1 block for Hopper (sm_90a), forward only.
// Per (batch b, channel d), with the state h[N] held in registers:
//   h_t = exp(dt_t A[d, :]) * h_{t-1} + (dt_t x_t) B_t
//   y_t = bf16((C_t . h_t + D[d] x_t) * silu(z_t))
// dt, x (bsz, S, d_inner) float32; z (bsz, S, d_inner) bf16, rows evenly
// spaced (the gate half of the input projection, read in place); B, C
// (bsz, S, N) float32; A (d_inner, N), D (d_inner,) float32; y
// (bsz, S, d_inner) bf16.  N is 8 or 16 (one instance each); d_inner even.
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
// 0.40 GB, 571M exponentials).  Design, simple first: a thread per (b, d)
// steps through t, its N states and the N constants A[d, :] log2(e) in
// registers; 64 channels of one b per block.  The inputs of a tile of
// kTile steps -- each thread's dt, x, z and the block's B_t, C_t -- are
// copied to shared memory by cp.async, the next tile's copies in flight
// while the current tile computes (two stages), so the step loop waits on
// no global load and stays rolled: at one or two warps per SM (falcon's
// 8192 channels are 256 warps) a first form that held eight steps of
// inputs in registers, its loop unrolled (tens of KB of code), ran twice
// as long.  What holds this form back: a scheduler has one warp
// (falcon) or two (hymba), and no other warp covers the latencies of a
// step's ~180 instructions (PERF.md row 11).  No
// cross-thread arithmetic and no atomics: every launch gives the same
// bits.  The products and sums of the state round one by one
// (-fmad=false) in the plain version's order (decay h + (dt x) B); C . h
// is summed in four interleaved partial sums (n mod 4), then + D x, then
// times silu(z) (__expf and __fdividef); the exponentials are ex2.approx
// of the argument times log2(e), within a few float32 ulps of expf.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;   // channels of one batch row per block
constexpr int kTile = 32;      // time steps staged per shared-memory stage
constexpr float kLog2e = 1.4426950408889634f;

// one stage: the tile's dt, x, z of the block's channels and its B, C rows
template <int kN>
struct Stage {
  float dt[kTile][kThreads];
  float x[kTile][kThreads];
  float B[kTile][kN];
  float C[kTile][kN];
  __nv_bfloat16 z[kTile][kThreads];
};

template <int kN>
constexpr int smem_bytes() { return 2 * static_cast<int>(sizeof(Stage<kN>)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// rows (<= kTile) steps from row r0 = b S + t: thread i copies channel
// d0 + i of dt and x (i < nch), thread i < nch / 2 the bf16 pair
// (d0 + 2i, d0 + 2i + 1) of z, and the block copies the B and C rows in
// 16-byte pieces
template <int kN>
__device__ __forceinline__ void stage_tile(
    Stage<kN>& s, const float* __restrict__ dt, const float* __restrict__ x,
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ Bm,
    const float* __restrict__ Cm, size_t r0, int rows, int di, int d0,
    int nch, long long z_ld) {
  const int i = threadIdx.x;
  if (i < nch) {
    for (int r = 0; r < rows; ++r) {
      const size_t g = (r0 + r) * di + d0 + i;
      cp_async4(&s.dt[r][i], dt + g);
      cp_async4(&s.x[r][i], x + g);
    }
  }
  if (2 * i < nch) {
    for (int r = 0; r < rows; ++r)
      cp_async4(&s.z[r][2 * i], z + (r0 + r) * z_ld + d0 + 2 * i);
  }
  const int chunks = rows * (kN / 4);
  const float* gB = Bm + r0 * kN;
  const float* gC = Cm + r0 * kN;
  for (int c = i; c < 2 * chunks; c += kThreads) {
    if (c < chunks)
      cp_async16(&s.B[0][0] + 4 * c, gB + 4 * c);
    else
      cp_async16(&s.C[0][0] + 4 * (c - chunks), gC + 4 * (c - chunks));
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ z,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ Dskip,
                      __nv_bfloat16* __restrict__ y, int S, int di,
                      long long z_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<kN>* stages = reinterpret_cast<Stage<kN>*>(smem);
  const int i = threadIdx.x;
  const int d0 = blockIdx.x * kThreads;
  const int nch = min(kThreads, di - d0);
  const bool live = i < nch;
  const int ch = live ? d0 + i : di - 1;   // a lane past d_inner stores nothing
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;

  float a2[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[static_cast<size_t>(ch) * kN + n] * kLog2e;
    h[n] = 0.0f;
  }
  const float dsk = Dskip[ch];

  const int tiles = (S + kTile - 1) / kTile;
  stage_tile<kN>(stages[0], dt, x, z, Bm, Cm, row0, min(kTile, S), di, d0,
                 nch, z_ld);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int t_tile = tile * kTile;
    // the other stage was last read by tile - 1, which every thread has
    // finished (the barrier closing the previous iteration)
    if (tile + 1 < tiles)
      stage_tile<kN>(stages[(tile + 1) & 1], dt, x, z, Bm, Cm,
                     row0 + t_tile + kTile, min(kTile, S - t_tile - kTile),
                     di, d0, nch, z_ld);
    cp_async_commit();               // possibly empty: one group per tile
    cp_async_wait_one();             // this tile's group has landed
    __syncthreads();
    const Stage<kN>& s = stages[tile & 1];
    const int rows = min(kTile, S - t_tile);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const float dtv = s.dt[r][i];
      const float xv = s.x[r][i];
      const float zv = __bfloat162float(s.z[r][i]);
      const float dtx = dtv * xv;
      const float4* B4 = reinterpret_cast<const float4*>(s.B[r]);
      const float4* C4 = reinterpret_cast<const float4*>(s.C[r]);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 b4 = B4[q], c4 = C4[q];
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          const float decay = ex2(dtv * a2[n]);
          h[n] = decay * h[n] + dtx * bq[j];
          part[j] = part[j] + cq[j] * h[n];
        }
      }
      const float ch_sum = (part[0] + part[1]) + (part[2] + part[3]);
      const float gate = __fdividef(zv, 1.0f + __expf(-zv));
      const float out = (ch_sum + dsk * xv) * gate;
      if (live)
        y[(row0 + t_tile + r) * di + d0 + i] = __float2bfloat16_rn(out);
    }
    __syncthreads();                 // done with this stage before refill
  }
}

template <int kN>
int launch(const float* dt, const float* x, const __nv_bfloat16* z,
           const float* B, const float* C, const float* A, const float* D,
           __nv_bfloat16* y, int bsz, int S, int di, long long z_ld,
           cudaStream_t stream) {
  const int smem = smem_bytes<kN>();
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  selective_scan_kernel<kN><<<grid, kThreads, smem, stream>>>(
      dt, x, z, B, C, A, D, y, S, di, z_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dt, x (bsz, S, di) float32 contiguous; z bf16 with row (b, t) at
// z + (b S + t) z_ld, 4-byte aligned, z_ld even; B, C (bsz, S, N) float32
// contiguous, 16-byte aligned; A (di, N), D (di,) float32; y (bsz, S, di)
// bf16.  All on the card; N in {8, 16}; bsz, S, di >= 1, di even,
// bsz <= 65535.
int selective_scan_launch(const float* dt, const float* x, const void* z,
                          const float* B, const float* C, const float* A,
                          const float* D, void* y, int bsz, int S, int di,
                          int N, long long z_ld, cudaStream_t stream) {
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (di % 2 || z_ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 16)
    return launch<16>(dt, x, zb, B, C, A, D, yb, bsz, S, di, z_ld, stream);
  if (N == 8)
    return launch<8>(dt, x, zb, B, C, A, D, yb, bsz, S, di, z_ld, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
