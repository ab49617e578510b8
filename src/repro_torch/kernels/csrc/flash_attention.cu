// Online-softmax (flash) attention for Hopper (sm_90a): causal or
// bidirectional, sliding window, grouped-query heads, ragged lengths.
//
//   out[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / G, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) * scale  (G = H / KVH)
//
// over the keys j with j < Sk, (causal) i >= j and (window > 0)
// i - j < window; positions count from 0 in both q and k (top-left
// aligned, also when Sq != Sk).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel) and its wrapper (src/repro/kernels/ops.py,
// flash_attention).  The TPU version pads Sq and Sk to 128-tiles and
// repeats every KV head G times in its wrapper, then walks a (B*H, Sq/128,
// Sk/128) grid with the running max / normaliser / accumulator in VMEM
// scratch.  Here the layout is read as it is: q (B, Sq, H, hd) and k, v
// (B, Sk, KVH, hd), each head a contiguous hd-vector, KV head h / G indexed
// in the kernel (no repeat), ragged edges masked by bounds (no padding;
// rows and keys past the end are zero in shared memory and never stored).
// One block per (64-row query tile, head, batch) loops over its key tiles;
// the sequential kv grid axis of the TPU kernel becomes that loop, with the
// running statistics in registers.  Tiles wholly above the causal diagonal
// or wholly outside the window are skipped; a row with at least one valid
// key gets the same result as without the skip.
//
// The arithmetic follows _kernel: scores in float32, scaled after the dot;
// masked scores set to -1e30 (not -inf: a row whose first tiles are all
// masked keeps m = -1e30 and p = exp(0) = 1 for them, which corr =
// exp(-1e30 - m_new) = 0 wipes when the first valid key arrives);
// p = exp(s - m) cast to the input type before the PV product, which sums
// in float32; out = acc / max(l, 1e-30) in the input type.  One choice the
// TPU kernel leaves to its padding: a row with no valid key at all (e.g.
// Sk <= i - window) is written as zeros here, as in
// ref.flash_attention_ref.
//
// Two kernels:
//  * bf16 (the model's type): tensor cores through mma.sync m16n8k16
//    (bf16 x bf16 -> f32), Q, K and V tiles in shared memory read with
//    ldmatrix (rows padded by 16 bytes, so the eight row addresses of one
//    ldmatrix hit 32 distinct banks), S and P in registers.  Each of the
//    four warps owns 16 query rows: S = Q K^T lands in the mma accumulator
//    layout, whose pairs of 8-key tiles are the A-operand layout of P V
//    after packing to bf16, so P never touches shared memory.
//  * float32 (the tests' type): one thread per query row, q in shared
//    memory (rows padded by one word), K and V tiles broadcast from shared
//    memory, the dot products and PV sums in float32 on the FP32 units.
// -fmad=false is global (the sampling kernels need it for bit parity);
// this kernel is held to a tolerance, not to bits: its products are
// tensor-core fragments (bf16) or separate multiply and add (float32), and
// it uses no explicit fmaf.  No float atomics: the summation order is fixed
// and two launches give the same bits.
//
// Bound, at the full-width prefill (B=8, Sq=Sk=2048, H=32, KVH=4, hd=64,
// causal): 4*hd FLOPs per unmasked (i, j) pair, ~1.4e11 FLOPs against
// ~0.15 GB of q, k, v and out, so the tensor-core rate bounds it
// (chip_smoke.py computes the bound of each run).  This first version
// loads each K/V tile synchronously (no cp.async / TMA pipeline, no wgmma):
// latency is hidden only by the several blocks resident on an SM.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim it was not
// built for (16, 32, 64, 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

extern __shared__ __align__(16) unsigned char flash_smem[];

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows per block (both kernels)
constexpr int kBK = 64;          // keys per tile, bf16 kernel
constexpr int kBKF = 16;         // keys per tile, float32 kernel
constexpr int kWarps = kBQ / 16; // bf16 kernel: 16 query rows per warp

// [*t0, *t1): the key tiles that hold a valid key for some row of
// [q0, q0 + rows).  Empty when no row has one.
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sk,
                                          int window, int causal, int bk,
                                          int* t0, int* t1) {
  const int hi = causal ? min(Sk, q0 + rows) : Sk;   // keys < hi
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *t0 = lo / bk;
  *t1 = hi > lo ? (hi + bk - 1) / bk : *t0;
}

__device__ __forceinline__ bool valid_key(int i, int j, int Sk, int window,
                                          int causal) {
  return j < Sk && (!causal || i >= j) && (window <= 0 || i - j < window);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a (rows, stride) bf16 head slice into a (64, LD)
// shared tile, 16 bytes per thread and step; rows >= n are zero
template <int HD, int LD, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int r0, int n) {
  constexpr int kChunks = HD / 8;      // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                  int KVH, int window, int causal, float scale) {
  constexpr int LD = HD + 8;           // padded row, in elements
  constexpr int kThreads = kWarps * 32;
  constexpr int NT = kBK / 8;          // 8-key score tiles per warp
  constexpr int DT = HD / 8;           // 8-dim output tiles per warp
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* ks = qs + kBQ * LD;
  __nv_bfloat16* vs = ks + kBK * LD;

  // causal: the longest rows (last query tiles) start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KVH);
  const int q0 = qt * kBQ, rows = min(kBQ, Sq - q0);
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kstride = static_cast<size_t>(KVH) * HD;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * qstride
                            + static_cast<size_t>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * kstride
                            + static_cast<size_t>(kh) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * kstride
                            + static_cast<size_t>(kh) * HD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma groupID, thread in group
  const int wrow = warp * 16;              // the warp's first row in tile

  load_tile<HD, LD, kThreads>(qs, qb, qstride, q0, Sq);
  __syncthreads();
  uint32_t qf[HD / 16][4];                 // A fragments of the warp's Q
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qf[kk], qs + (wrow + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};         // rows g and g + 8
  float l[2] = {0.0f, 0.0f};               // this thread's partial sums

  int t0, t1;
  key_tiles(q0, rows, Sk, window, causal, kBK, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the last tile is consumed
    load_tile<HD, LD, kThreads>(ks, kb, kstride, k0, Sk);
    load_tile<HD, LD, kThreads>(vs, vb, kstride, k0, Sk);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LD
                        + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask, and the tile's row maxima
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0)
                      || (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int i = q0 + wrow + g + (e / 2) * 8;
          const int j = k0 + n * 8 + 2 * t4 + (e % 2);
          if (!valid_key(i, j, Sk, window, causal)) x = kNegInf;
        }
        s[n][e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // P = exp(S - m) in bf16 as the A operand; O += P V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[hf][e] = expf(s[2 * kk + hf][e] - m[e / 2]);
          l[e / 2] += p[hf][e];
        }
      const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                             pack_bf16(p[0][2], p[0][3]),
                             pack_bf16(p[1][0], p[1][1]),
                             pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                              + dn * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dn], a, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
  }

  // the four threads of a row hold its partial normalisers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + wrow + g + r * 8;
    if (i >= Sq) continue;
    // a row that saw no valid key is written as zeros
    const bool none = m[r] == kNegInf;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + static_cast<size_t>(b) * Sq * qstride
                         + i * qstride + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          none ? 0.0f : o[n][2 * r] / den,
          none ? 0.0f : o[n][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t4) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FP32 units, one thread per query row
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kBQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Sk, int H, int KVH, int window, int causal,
                 float scale) {
  constexpr int QLD = HD + 1;          // padded: row r starts in bank r
  float* qs = reinterpret_cast<float*>(flash_smem);
  float* ks = qs + kBQ * QLD;
  float* vs = ks + kBKF * HD;
  // each thread's scores of the tile, [key][row] (conflict-free); kept
  // here rather than in a register array so the key loops need not be
  // unrolled (a fully unrolled 16 x 128 body took ptxas ~35 s)
  float* ss = vs + kBKF * HD;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KVH);
  const int q0 = qt * kBQ, rows = min(kBQ, Sq - q0);
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kstride = static_cast<size_t>(KVH) * HD;
  const float* qb = q + static_cast<size_t>(b) * Sq * qstride
                    + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * Sk * kstride
                    + static_cast<size_t>(kh) * HD;
  const float* vb = v + static_cast<size_t>(b) * Sk * kstride
                    + static_cast<size_t>(kh) * HD;

  for (int c = threadIdx.x; c < kBQ * HD; c += kBQ) {
    const int r = c / HD, d = c % HD;
    qs[r * QLD + d] = r < rows ? qb[(q0 + r) * qstride + d] : 0.0f;
  }
  const int row = threadIdx.x, i = q0 + row;
  const float* qr = qs + row * QLD;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = kNegInf, l = 0.0f;

  int t0, t1;
  key_tiles(q0, rows, Sk, window, causal, kBKF, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBKF;
    __syncthreads();                       // q stored / last tile consumed
    for (int c = threadIdx.x; c < kBKF * HD; c += kBQ) {
      const int r = c / HD, d = c % HD;
      const bool in = k0 + r < Sk;
      ks[c] = in ? kb[(k0 + r) * kstride + d] : 0.0f;
      vs[c] = in ? vb[(k0 + r) * kstride + d] : 0.0f;
    }
    __syncthreads();
    float mt = kNegInf;
#pragma unroll 1
    for (int j = 0; j < kBKF; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qr[d] * ks[j * HD + d];
      const float sj =
          valid_key(i, k0 + j, Sk, window, causal) ? dot * scale : kNegInf;
      ss[j * kBQ + row] = sj;
      mt = fmaxf(mt, sj);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll 1
    for (int j = 0; j < kBKF; ++j) {
      const float p = expf(ss[j * kBQ + row] - m_new);
      psum += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += p * vs[j * HD + d];
    }
    l = l * corr + psum;
    m = m_new;
  }
  if (i >= Sq) return;
  const bool none = m == kNegInf;       // no valid key: zeros
  const float den = fmaxf(l, 1e-30f);
  float* dst = out + static_cast<size_t>(b) * Sq * qstride + i * qstride
               + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = none ? 0.0f : acc[d] / den;
}

template <int HD>
cudaError_t launch_bf16(dim3 grid, cudaStream_t stream, const void* q,
                        const void* k, const void* v, void* out, int Sq,
                        int Sk, int H, int KVH, int window, int causal,
                        float scale) {
  const size_t smem = (kBQ + 2 * kBK) * (HD + 8) * sizeof(__nv_bfloat16);
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KVH, window, causal,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(dim3 grid, cudaStream_t stream, const void* q,
                       const void* k, const void* v, void* out, int Sq,
                       int Sk, int H, int KVH, int window, int causal,
                       float scale) {
  const size_t smem =
      (kBQ * (HD + 1) + 2 * kBKF * HD + kBKF * kBQ) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_f32_kernel<HD><<<grid, kBQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KVH,
      window, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), out (B, Sq, H, hd), all
// contiguous on the card, 16-byte aligned, of one type: bfloat16 when
// is_bf16, else float32.  B, Sq, Sk >= 1; H % KVH == 0; B <= 65535,
// H <= 65535.  window <= 0: no window.  scale: hd^-0.5 as float32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int KVH,
                           int hd, int window, int causal, int is_bf16,
                           float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
#define FLASH_CASE(HD)                                                      \
  case HD:                                                                  \
    return static_cast<int>(                                                \
        is_bf16 ? launch_bf16<HD>(grid, stream, q, k, v, out, Sq, Sk, H,    \
                                  KVH, window, causal, scale)               \
                : launch_f32<HD>(grid, stream, q, k, v, out, Sq, Sk, H,     \
                                 KVH, window, causal, scale));
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // extern "C"
