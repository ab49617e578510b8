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
// A work item (query tile, head, batch) loops over its key tiles; the
// sequential kv grid axis of the TPU kernel becomes that loop, with the
// running statistics in registers.  Tiles wholly above the causal diagonal
// or wholly outside the window are skipped; a row with at least one valid
// key gets the same result as without the skip.  Causal work lists start
// with the longest query tiles.
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
//  * bf16 (the model's type), one template per padded head dim HDP in
//    {64, 128, 256} (hd 16, 32, 64 -> 64; 120, 128 -> 128; 256 -> 256),
//    each in two instances: without and with the row log-sum-exp output
//    (training's), so the serve path runs the code it ran before.
//    Persistent: one block per SM walks the work items blockIdx.x,
//    + gridDim.x, ...; the longest-first order balances the blocks' shares
//    to within one item, and the next item's Q and first K/V tiles load
//    while the last one's softmax and stores run.  A block is three
//    warpgroups: warpgroup 0 is the producer (one thread issues every copy;
//    setmaxnreg drops it to 40 registers), warpgroups 1 and 2 are consumers
//    of 64 query rows each (128 rows per item; 232 registers).
//    - Loads: TMA (cp.async.bulk.tensor) through 4-D tensor maps (hd,
//      heads, S, B) with 128-byte swizzle, in 64-column boxes; Q once per
//      item, K and V tiles of BK keys (128; 64 at HDP 256) into rings of
//      ST stages (3; 2 at HDP 256), each with a full and an empty
//      mbarrier.  The maps' zero fill gives the ragged edges: rows past Sq
//      or Sk of a batch element and columns past hd arrive as zeros.
//    - Products: wgmma.  S = Q K^T is m64nBKk16 with both operands K-major
//      in shared memory; O += P V is m64nHDPk16 with P in registers (the
//      f32 accumulator layout of S, packed to bf16 pairs, is the A
//      register-fragment layout) and V read MN-major (transpose bit).
//    - Softmax overlaps the tensor cores, two ways: each consumer issues
//      the next tile's Q K^T and this tile's P V back to back, waits for
//      Q K^T only (wait_group 1) and runs the softmax while P V is in
//      flight; and the two consumers take turns to issue (named barriers,
//      ping-pong), so one's softmax runs beside the other's products.
//      Exponentials are ex2 of scores pre-scaled by scale * log2(e) (one
//      FFMA per score on interior tiles); only the tiles that cross the
//      diagonal, the window edge or Sk are masked.
//    - Epilogue: normalise in registers, store the rows < Sq and columns
//      < hd directly (bf16 pairs); optionally each row's log-sum-exp for
//      the backward kernel (flash_attention_bwd.cu), which leaves the
//      output's arithmetic as it is.
//  * float32 (the tests' type; hd 16, 32, 64, 128): one thread per query
//    row, q in shared memory (rows padded by one word), K and V tiles
//    broadcast from shared memory, the dot products and PV sums in float32
//    on the FP32 units.
// Built with the sampling kernels' flags, -fmad=false included: the bf16
// form writes each of its fused multiply-adds as an explicit fmaf, which
// the flag leaves alone.  No float atomics: the summation order is fixed
// and two launches give the same bits.
//
// Bound, three terms; the largest binds (chip_smoke.py computes each run's):
//  * tensor cores: 4*hd FLOPs per attended (i, j) pair at the bf16 peak;
//  * exponentials: one ex2 per attended pair on the MUFU units, 16 per
//    clock per SM (132 SMs); at hd=64 this equals the tensor-core term,
//    which is why the softmax has to overlap the products;
//  * bytes: q, k, v read once, out written once, over the HBM rate (far
//    below the other two at the prefill shapes).
// At B=8, Sq=Sk=2048, H=32, KVH=4, hd=64, causal: 1.375e11 FLOPs and
// 5.37e8 exponentials, ~0.14 ms each.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim it was not
// built for (bf16: 16, 32, 64, 120, 128, 256; float32: 16, 32, 64, 128) or
// a tensor map cuTensorMapEncodeTiled refuses.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

extern __shared__ __align__(16) unsigned char flash_smem[];

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows per block, float32 kernel
constexpr int kBKF = 16;         // keys per tile, float32 kernel
constexpr int kMaxDevices = 64;  // bf16 launch settings cached per device

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
// bf16: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;    // consumer warpgroups of 64 query rows
constexpr int kBM = 64 * kConsumers;                  // rows per work item
constexpr int kThreads16 = 128 * (kConsumers + 1);    // + the producer
// setmaxnreg: 128 x 40 + 256 x 232 <= 65536 registers of the SM
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// the tiles of one padded head dim: BK keys per tile, ST stages
template <int HDP>
struct Tiles {
  static constexpr int BK = HDP == 256 ? 64 : 128;
  static constexpr int ST = HDP == 256 ? 2 : 3;
  static constexpr int kQBytes = kBM * HDP * 2;
  static constexpr int kKVBytes = BK * HDP * 2;      // one K or V tile
  // Q, then the K ring, then the V ring, then the mbarriers; +1024 for
  // the alignment the 128-byte swizzle needs
  static constexpr int kSmem = 1024 + kQBytes + 2 * ST * kKVBytes
                               + (2 + 4 * ST) * 8;
};


// S = Q K^T for the warpgroup's 64 rows x BK keys.  Q and K tiles are
// HDP / 64 column chunks of 128-byte swizzled rows; a k16 step moves 32
// bytes inside a chunk.  Issued and committed, not waited for.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<HDP>::BK / 2],
                                         uint32_t q, uint32_t k) {
  constexpr int BK = Tiles<HDP>::BK;
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    Wgmma<BK>::ss(s,
                  desc_sw128(q + (kk / 4) * kBM * kRowBytes + col, 16, 1024),
                  desc_sw128(k + (kk / 4) * BK * kRowBytes + col, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
  pin(s);
}

// O += P V: P (64 x BK) in registers, V (BK keys x HDP) MN-major: the
// stride between 8-key groups is one swizzle atom (1024 bytes), between
// 64-column chunks one chunk (BK rows); a k16 step is 16 keys
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         uint32_t (&p)[Tiles<HDP>::BK / 4],
                                         uint32_t v) {
  constexpr int BK = Tiles<HDP>::BK;
  pin(o);
  pin(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<HDP>::rs(o, &p[4 * kk],
                   desc_sw128(v + kk * 16 * kRowBytes, BK * kRowBytes, 1024));
  wgmma_commit();
  pin(o);
}

// One tile's online softmax for this thread's rows ia and ia + 8.  s holds
// raw scores in the accumulator layout (s[4j + e]: row ia + 8 (e / 2), key
// k0 + 8j + 2 t4 + e % 2) and leaves as p = 2^(s c - m) in float32; m is
// the running max of the scaled scores, corr the factor for what came
// before.  Edge tiles are scaled and masked first (-1e30), so the same
// FFMA serves both kinds with cs = 1 there.
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    float c, bool edge, int ia, int k0, int t4, int Sk, int window,
    int causal) {
  float cs = c;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ia + (e / 2) * 8, key = k0 + 8 * j + 2 * t4 + e % 2;
        s[4 * j + e] =
            valid_key(i, key, Sk, window, causal) ? s[4 * j + e] * c : kNegInf;
      }
    cs = 1.0f;
  }
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e / 2][j % 2] = fmaxf(mx[e / 2][j % 2], s[4 * j + e]);
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * cs);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg[r] = -m_new;
  }
  float sum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], cs, neg[e / 2]));
      s[4 * j + e] = p;
      sum[e / 2][j % 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], corr[r], sum[r][0] + sum[r][1]);
}

// work item w of a persistent block: (query tile, head, batch), query
// tiles slowest and heads fastest (the G heads of one KV head are
// neighbours in time, so their K/V tiles are read from L2); causal grids
// take the longest query tiles first, which balances the blocks' static
// round-robin shares to within one item
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item(int w, int nq, int H, int B,
                                     int causal) {
  const int tile = w / (H * B), hb = w % (H * B);
  return {(causal ? nq - 1 - tile : tile) * kBM, hb % H, hb / H};
}

// kLse: also write each row's log-sum-exp (a separate instance, so the
// serve path's kernel is the one without it)
template <int HDP, bool kLse>
__global__ void __launch_bounds__(kThreads16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse2, int B, int Sq, int Sk, int H,
                  int KVH, int hd, int window, int causal, float c) {
  using T = Tiles<HDP>;
  constexpr int BK = T::BK, ST = T::ST;
  // shared memory: Q | K stages | V stages | barriers, 1024-aligned
  const uint32_t base = (smem_addr(flash_smem) + 1023) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks = qs + T::kQBytes;
  const uint32_t vs = ks + ST * T::kKVBytes;
  const uint32_t bars = vs + ST * T::kKVBytes;
  // q_full, q_empty, then per stage: k_full, v_full, k_empty, v_empty
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto bar = [&](int kind, int st) { return bars + 8 * (2 + kind * ST + st); };

  // this block's work items: w = blockIdx.x, + gridDim.x, ... < W; the
  // K/V tiles of all of them form one stream through the rings
  const int nq = (Sq + kBM - 1) / kBM, W = nq * B * H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);   // one arrival per consumer warp
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 1);
      mbar_init(bar(2, st), 4 * kConsumers);
      mbar_init(bar(3, st), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy, in the consumers' order
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                       // K (and V) tiles issued so far
      for (int j = 0, w = blockIdx.x; w < W; ++j, w += gridDim.x) {
        const Item x = item(w, nq, H, B, causal);
        const int kh = x.h / (H / KVH);
        int t0, t1;
        key_tiles(x.q0, min(kBM, Sq - x.q0), Sk, window, causal, BK, &t0,
                  &t1);
        const int n = t1 - t0;
        mbar_wait(q_empty, (j & 1) ^ 1);          // the last Q is read
        mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int ch = 0; ch < HDP / 64; ++ch)
          tma_load(qs + ch * kBM * kRowBytes, &tq, q_full, ch * 64, x.h,
                   x.q0, x.b);
        // K_0, then K_i and V_{i-1} for i = 1 .. n-1, then V_{n-1}
        for (int i = 0; i <= n; ++i) {
#pragma unroll
          for (int kind = 0; kind < 2; ++kind) {
            const int tile = kind == 0 ? i : i - 1;
            if (tile < 0 || tile >= n) continue;
            const int st = (it + tile) % ST, ph = ((it + tile) / ST) & 1;
            mbar_wait(bar(2 + kind, st), ph ^ 1);   // the stage is free
            mbar_expect_tx(bar(kind, st), T::kKVBytes);
            const uint32_t dst = (kind == 0 ? ks : vs) + st * T::kKVBytes;
            const CUtensorMap* map = kind == 0 ? &tk : &tv;
#pragma unroll
            for (int ch = 0; ch < HDP / 64; ++ch)
              tma_load(dst + ch * BK * kRowBytes, map, bar(kind, st),
                       ch * 64, kh, (t0 + tile) * BK, x.b);
          }
        }
        it += n;
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;   // accumulator row group, pair
    const uint32_t qw = qs + 64 * w * kRowBytes;
    float o[HDP / 2], s[BK / 2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) s[x] = 0.0f;
#pragma unroll
    for (int x = 0; x < BK / 4; ++x) p[x] = 0u;

    auto release = [&](uint32_t b_) {
      if (lane == 0) mbar_arrive(b_);
    };
    // consumer w issues its products after the other one (ping-pong over
    // named barriers 1 and 2), so one warpgroup's softmax runs beside the
    // other's products
    auto turn = [&]() { bar_sync(1 + w); };
    auto pass = [&]() { bar_arrive(1 + (w + 1) % kConsumers); };
    if (w == kConsumers - 1) bar_arrive(1);   // consumer 0 goes first

    int it = 0;                               // K (and V) tiles consumed
    for (int j = 0, wk = blockIdx.x; wk < W; ++j, wk += gridDim.x) {
      const Item x = item(wk, nq, H, B, causal);
      int t0, t1;
      key_tiles(x.q0, min(kBM, Sq - x.q0), Sk, window, causal, BK, &t0,
                &t1);
      const int n = t1 - t0;
      const int r0 = x.q0 + 64 * w;           // the warpgroup's first row
      const int ia = r0 + 16 * wi + g;        // this thread's rows ia, ia + 8
#pragma unroll
      for (int y = 0; y < HDP / 2; ++y) o[y] = 0.0f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
      float corr[2] = {1.0f, 1.0f};

      // does tile t hold a masked (row, key) pair for these rows?
      auto edge = [&](int t) {
        const int k0 = t * BK;
        return k0 + BK > Sk || (causal && k0 + BK - 1 > r0)
               || (window > 0 && r0 + 63 - k0 >= window);
      };
      auto softmax = [&](int t) {
        online_softmax<BK>(s, m, l, corr, c, edge(t), ia, t * BK, t4, Sk,
                           window, causal);
      };
      auto to_bf16 = [&]() {
#pragma unroll
        for (int y = 0; y < BK / 4; ++y)
          p[y] = pack_bf16(s[2 * y], s[2 * y + 1]);
      };
      auto rescale = [&]() {
#pragma unroll
        for (int y = 0; y < HDP / 8; ++y) {
          o[4 * y] *= corr[0];
          o[4 * y + 1] *= corr[0];
          o[4 * y + 2] *= corr[1];
          o[4 * y + 3] *= corr[1];
        }
      };
      auto stage = [&](int i) { return (it + i) % ST; };
      auto phase = [&](int i) { return ((it + i) / ST) & 1; };

      mbar_wait(q_full, j & 1);
      if (n == 0) release(q_empty);
      if (n > 0) {
        mbar_wait(bar(0, stage(0)), phase(0));
        turn();
        issue_qk<HDP>(s, qw, ks + stage(0) * T::kKVBytes);
        pass();
        wgmma_wait<0>();
        pin(s);
        release(bar(2, stage(0)));
        if (n == 1) release(q_empty);         // Q's last product is done
        softmax(t0);
        to_bf16();
        for (int i = 1; i < n; ++i) {
          const int st = stage(i), pst = stage(i - 1);
          mbar_wait(bar(0, st), phase(i));
          turn();
          issue_qk<HDP>(s, qw, ks + st * T::kKVBytes);     // S_i = Q K_i^T
          rescale();
          mbar_wait(bar(1, pst), phase(i - 1));
          issue_pv<HDP>(o, p, vs + pst * T::kKVBytes);     // O += P_{i-1} V
          pass();
          wgmma_wait<1>();                                 // S_i is ready
          pin(s);
          release(bar(2, st));
          if (i == n - 1) release(q_empty);
          softmax(t0 + i);                                 // while P V runs
          wgmma_wait<0>();
          pin(o);
          pin(p);
          release(bar(3, pst));
          to_bf16();
        }
        const int st = stage(n - 1);
        rescale();
        mbar_wait(bar(1, st), phase(n - 1));
        turn();
        issue_pv<HDP>(o, p, vs + st * T::kKVBytes);
        pass();
        wgmma_wait<0>();
        pin(o);
        release(bar(3, st));
      }
      it += n;

      // the four threads of a row hold its partial normalisers
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const size_t stride = static_cast<size_t>(H) * hd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ia + r * 8;
        if (i >= Sq) continue;
        // a row that saw no valid key is written as zeros
        const bool none = m[r] == kNegInf;
        const float inv = 1.0f / fmaxf(l[r], 1e-30f);
        // the row's log-sum-exp of the scaled scores, base 2, for the
        // backward kernel (+inf: no valid key); outside the output's
        // arithmetic, which is the same with or without it
        if (kLse && t4 == 0)
          lse2[(static_cast<size_t>(x.b) * H + x.h) * Sq + i] =
              none ? INFINITY : m[r] + log2f(l[r]);
        __nv_bfloat16* dst = out
                             + (static_cast<size_t>(x.b) * Sq + i) * stride
                             + static_cast<size_t>(x.h) * hd;
#pragma unroll
        for (int y = 0; y < HDP / 8; ++y) {
          const int col = 8 * y + 2 * t4;
          if (col >= hd) continue;
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(none ? 0.0f : o[4 * y + 2 * r] * inv,
                                    none ? 0.0f : o[4 * y + 2 * r + 1] * inv);
        }
      }
    }
    // the last consumer's first arrival has no turn to match: take it
    if (w == 0) bar_sync(1);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int HDP, bool kLse>
cudaError_t launch_bf16_as(cudaStream_t stream, const void* q, const void* k,
                           const void* v, void* out, float* lse2, int B,
                           int Sq, int Sk, int H, int KVH, int hd, int window,
                           int causal, float scale) {
  using T = Tiles<HDP>;
  // the device's context current in this thread before the tensor maps
  // are encoded (a thread that has made no CUDA call yet has none, and the
  // encode then fails)
  int device, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, H, hd, kBM)
      || !tensor_map(&tk, k, B, Sk, KVH, hd, T::BK)
      || !tensor_map(&tv, v, B, Sk, KVH, hd, T::BK))
    return cudaErrorInvalidValue;
  // persistent: one block per SM (or per work item, if fewer).  The SM
  // count, and the shared-memory allowance a block above 48 KB needs, are
  // set once per device and template, at its first launch
  static std::atomic<int> sms_of[kMaxDevices];
  if (device < kMaxDevices) sms = sms_of[device].load();
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_bf16_kernel<HDP, kLse>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) sms_of[device].store(sms);
  }
  const long long items =
      static_cast<long long>((Sq + kBM - 1) / kBM) * B * H;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_bf16_kernel<HDP, kLse><<<grid, kThreads16, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse2, B, Sq, Sk, H, KVH,
      hd, window, causal, scale * 1.4426950408889634f);   // scale * log2(e)
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bf16(cudaStream_t stream, const void* q, const void* k,
                        const void* v, void* out, float* lse2, int B, int Sq,
                        int Sk, int H, int KVH, int hd, int window,
                        int causal, float scale) {
  return lse2 == nullptr
             ? launch_bf16_as<HDP, false>(stream, q, k, v, out, lse2, B, Sq,
                                          Sk, H, KVH, hd, window, causal,
                                          scale)
             : launch_bf16_as<HDP, true>(stream, q, k, v, out, lse2, B, Sq,
                                         Sk, H, KVH, hd, window, causal,
                                         scale);
}

template <int HD>
cudaError_t launch_f32(cudaStream_t stream, const void* q, const void* k,
                       const void* v, void* out, int B, int Sq, int Sk,
                       int H, int KVH, int window, int causal, float scale) {
  const size_t smem =
      (kBQ * (HD + 1) + 2 * kBKF * HD + kBKF * kBQ) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
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
// is_bf16, else float32.  B, Sq, Sk >= 1; H % KVH == 0; float32:
// B <= 65535, H <= 65535; bf16: ceil(Sq / 128) * B * H < 2^31.  window <= 0:
// no window.  scale: hd^-0.5 as float32.  lse2: null, or (bf16 only) a
// (B, H, Sq) float32 output of each row's log-sum-exp of the scaled scores
// in base 2 (+inf for a row with no valid key), which the backward kernel
// (flash_attention_bwd.cu) takes instead of recomputing it.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse2, int B, int Sq, int Sk,
                           int H, int KVH, int hd, int window, int causal,
                           int is_bf16, float scale, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    switch (hd) {
      case 16: case 32: case 64:
        err = launch_bf16<64>(stream, q, k, v, out,
                              static_cast<float*>(lse2), B, Sq, Sk, H, KVH, hd,
                              window, causal, scale);
        break;
      case 120: case 128:
        err = launch_bf16<128>(stream, q, k, v, out,
                              static_cast<float*>(lse2), B, Sq, Sk, H, KVH, hd,
                               window, causal, scale);
        break;
      case 256:
        err = launch_bf16<256>(stream, q, k, v, out,
                              static_cast<float*>(lse2), B, Sq, Sk, H, KVH, hd,
                               window, causal, scale);
        break;
    }
    return static_cast<int>(err);
  }
  switch (hd) {
#define FLASH_F32(HD)                                                       \
  case HD:                                                                  \
    err = launch_f32<HD>(stream, q, k, v, out, B, Sq, Sk, H, KVH, window,   \
                         causal, scale);                                    \
    break;
    FLASH_F32(16)
    FLASH_F32(32)
    FLASH_F32(64)
    FLASH_F32(128)
#undef FLASH_F32
  }
  return static_cast<int>(err);
}

// dynamic shared memory of one bf16 block for head dim hd (0: not built)
int flash_attention_bf16_smem(int hd) {
  switch (hd) {
    case 16: case 32: case 64: return Tiles<64>::kSmem;
    case 120: case 128: return Tiles<128>::kSmem;
    case 256: return Tiles<256>::kSmem;
  }
  return 0;
}

}  // extern "C"
