// Local Minibatch Gibbs (Algorithm 3) for Hopper (sm_90a): S sequential
// sub-steps per chain in one launch, every draw made in-kernel by Philox.
//
// Replaces bucket_energy_pallas (src/repro/kernels/minibatch_energy.py:54)
// on the local path of src/repro/core/samplers.py:161 (make_local_gibbs_step,
// which the JAX engine scans S times with one bucket-energy call each).  Per
// chain and sub-step s at site i:
//   1. Floyd's algorithm draws B distinct k from {0 .. n-2}: at step t, with
//      r = n-1-B+t, k = umulhi(bits_t, r+1) from lane t of stream 0 (raw
//      32-bit words), inserted unless already drawn, then r is inserted;
//   2. j_t = k_t + (k_t >= i) skips the site;
//   3. eps_u = scale * sum_t W[i, j_t] 1[x[j_t] = u], bucket u summed over
//      t = 0 .. B-1 in order (the plain version's order, so the two are
//      bit-equal);
//   4. x_i <- argmax_u eps_u + gumbel_u (first maximum), Gumbels from
//      stream 1.
// Semantics and the Philox layout are those of ../ref.py
// (local_gibbs_sweep_ref) and ../philox.py (LOCAL_GIBBS_STREAMS).
//
// A sub-step depends on the chain's state only through the B values
// x[j_t], and only through their buckets (a value outside [0, D) adds to
// none).  So one block of warps runs each chain as a pipeline in which
// producer warps finish every sub-step ahead and one consumer warp only
// checks it.  A ring of R slots holds the sub-steps in flight: per slot the
// records (j_t | b_t << 16, w_t), the Gumbels and (i | value << 16), with
// three mbarriers (drawn, full, empty).
//   * Drawing warps take sub-steps in turn: wait until the consumer has
//     released the slot, draw the Philox words (computed during the
//     previous sub-step's gathers), run Floyd's rounds, gather
//     w_t = W[i, j_t], convert the Gumbels, store the records, arrive on
//     drawn.
//   * Summing warps take sub-steps in turn: wait for drawn and for the
//     consumer to release sub-step s - lead, read the bucket b_t of each
//     x[j_t] from the shared x row as it stands, sum each bucket over t in
//     draw order with __fadd_rn and take the first-maximum argmax, exactly
//     as the plain version does, store the value, arrive on full.
//   * The consumer (warp 0) takes the sub-steps in windows of up to four:
//     one pass compares every record's b_t with the bucket of x[j_t] in the
//     state before the window, and every j_t with the sites the window's
//     earlier sub-steps write.  A sub-step with no difference and no such
//     site stores its value (the window's values go out in one store where
//     no record needs another: the producer's sums were the sums at this
//     point of the chain, bit for bit); the others are checked again in
//     order against the state as it then stands, and recomputed with the
//     same code where a bucket changed.  Either way x_i is the plain
//     version's, whatever the timing: every launch gives the same bits.
//     The window's slots are released together.
// The summing warps' reads of x race with the consumer's writes; the check
// makes that harmless.  The lead trades the state's age (recomputes)
// against the consumer waiting for sums.  Where the plan allows no lead
// (a short ring, B > 128), every producer draws and sums its own
// sub-steps, ungated.
//
// Floyd's steps depend on each other, but only through the subset drawn so
// far, so a producer warp resolves 32 of them at once against its own
// bitmap of the n-1 candidate sites: lane t collides iff k_t was drawn in
// an earlier round (bitmap), or a lower lane drew the same k
// (__match_any_sync), or k_t is the r of a lower lane t' (k_t - r_0 = t')
// that collided itself.  The last is a pointer chain to lower lanes,
// resolved by at most five rounds of pointer jumping over shuffles.  The
// result is the sequential algorithm's, step for step.
//
// Bound: the byte bound (4 bytes per distinct W entry read, 8*C*n of x,
// 4*C*S of sites) is far below what the S dependent sub-steps allow.  Two
// blocks share an SM (C = 256 at potts-64x64), 32 warps in all: the
// consumer's window check (a few dependent shared-memory loads, votes and
// compares a record) and the summing warps' latency after the gate set
// the pace, both slowed by the issue slots the other warps take.
//
// Plain C interface (loaded with ctypes); the launch returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;                  // warp 0 consumes, 1.. produce
constexpr int kMaxProducers = kWarps - 1;
constexpr int kMaxThreads = 32 * kWarps;
// 32-lane Floyd rounds whose W gathers are in flight together
constexpr int kRounds = 4;
// ring slots: how many sub-steps ahead of the consumer a producer may start
constexpr int kDepth = 32;
// the consumer checks up to kWindow sub-steps at once, about
// kWindowRecords records in all
constexpr int kWindow = 4;
constexpr int kWindowRecords = 128;
// a producer sums sub-step s once the consumer has released s - lead,
// lead about kLeadRecords / B sub-steps, at most kLead
constexpr int kLead = 8;
constexpr int kLeadRecords = 512;
// at most about kProducerRecords / B producer warps: wide subsets
// recompute more as more sub-steps are in flight
constexpr int kProducerRecords = 1024;
constexpr uint32_t kSubStream = 0, kGumbelStream = 1;

// One round of Floyd's algorithm: lanes t = t0 + lane < B take their raw
// word from rec[t].y, draw their k and, where later rounds follow (B > 32),
// insert their pick into the bitmap.  Returns the pick in [0, n-1) on a
// valid lane, -1 on the others.  Called by the whole warp; the caller
// synchronises the warp before the bitmap is read again.
__device__ __forceinline__ int floyd_round(uint32_t* bitmap, const int2* rec,
                                           int t0, int B, int m) {
  const int lane = threadIdx.x & 31;
  const int t = t0 + lane;
  const bool valid = t < B;
  const int r0 = m - B + t0;             // r of lane 0
  const int r = r0 + lane;
  // 0xffffffff equals no valid lane's draw
  const uint32_t k =
      valid ? __umulhi(static_cast<uint32_t>(rec[t].y),
                       static_cast<uint32_t>(r) + 1u)
            : 0xffffffffu;
  // drawn in an earlier round (none in the first)
  bool hit = t0 > 0 && valid && ((bitmap[k >> 5] >> (k & 31)) & 1u);
  const unsigned same = __match_any_sync(kFull, k);
  hit = hit || (same & ((1u << lane) - 1u)) != 0u;  // a lower lane's k
  // k == r of lower lane d: drawn iff lane d collided (rare: skip the
  // jumps when no lane points anywhere)
  const int d = valid ? static_cast<int>(k) - r0 : -1;
  int p = (d >= 0 && d < lane) ? d : -1;
  if (__any_sync(kFull, p >= 0)) {
#pragma unroll
    for (int jump = 0; jump < 5; ++jump) {
      const int src = p >= 0 ? p : lane;
      const bool hit_p = __shfl_sync(kFull, hit, src);
      const int p_p = __shfl_sync(kFull, p, src);
      if (p >= 0) {
        hit = hit || hit_p;
        p = p_p;
      }
    }
  }
  if (!valid) return -1;
  const int pick = hit ? r : static_cast<int>(k);
  if (B > 32) atomicOr(&bitmap[pick >> 5], 1u << (pick & 31));
  return pick;
}

// The bucket of a state value: itself in [0, D), D (no bucket) outside.
__device__ __forceinline__ uint32_t bucket(int v, int D) {
  return (v >= 0 && v < D) ? static_cast<uint32_t>(v)
                           : static_cast<uint32_t>(D);
}

// ints of one slot: B records (j | b << 16, w bits), D Gumbels and the head
// (i | value << 16); even, so the next slot's records stay 8-byte aligned
__host__ __device__ __forceinline__ size_t slot_ints(int B, int D) {
  const size_t v = 2 * static_cast<size_t>(B) + static_cast<size_t>(D) + 1;
  return v + (v & 1);
}

// ints between the mbarriers and the slots: the x row and the producers'
// bitmaps (used where B > 32)
__host__ __device__ __forceinline__ size_t fixed_ints(int n, int P) {
  const size_t v = static_cast<size_t>(n) +
                   static_cast<size_t>(P) * ((n + 30) / 32);
  return v + (v & 1);
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int B, int D,
                                                      int P, int R) {
  return 24 * static_cast<size_t>(R) +
         sizeof(int) * (fixed_ints(n, P) + R * slot_ints(B, D));
}

struct Slot {
  int2* rec;       // (B,): (j | b << 16, w bits); first the subset's words
  float* gumbel;   // (D,): first the Gumbel stream's words
  int* head;       // i | value << 16
};

__device__ __forceinline__ Slot slot_at(int* base, int k, int B, int D) {
  int* p = base + k * slot_ints(B, D);
  Slot sl;
  sl.rec = reinterpret_cast<int2*>(p);
  sl.gumbel = reinterpret_cast<float*>(p + 2 * static_cast<size_t>(B));
  sl.head = p + 2 * static_cast<size_t>(B) + D;
  return sl;
}

// The sub-step's value from its records: lane u0 + lane sums bucket u over
// t in order (a zero where the record's bucket differs: +0 leaves any sum
// as it is) and keeps the first maximum of its buckets, then the warp
// takes the first maximum over lanes.  Called by the whole warp after the
// records are written; every lane gets the value.
__device__ __forceinline__ int bucket_argmax(const int2* rec,
                                             const float* gumbel, int B,
                                             int D, float scale) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  int best_u = INT_MAX;
  for (int u0 = 0; u0 < D; u0 += 32) {
    const uint32_t u = static_cast<uint32_t>(u0 + lane);
    float a = 0.f;
#pragma unroll 16
    for (int t = 0; t < B; ++t) {
      const int2 e = rec[t];
      a = __fadd_rn(a, (static_cast<uint32_t>(e.x) >> 16) == u
                           ? __int_as_float(e.y) : 0.f);
    }
    if (u < static_cast<uint32_t>(D)) {
      const float sc = __fadd_rn(__fmul_rn(scale, a), gumbel[u]);
      if (best_u == INT_MAX || sc > best) {
        best = sc;
        best_u = static_cast<int>(u);
      }
    }
  }
  if (D <= 32) {
    // lane = bucket: the largest score as an order-preserving int key
    // (+0 for -0, which compares equal), then the lowest lane holding it
    const int b = __float_as_int(__fadd_rn(best, 0.f));
    const int key = lane < D ? (b >= 0 ? b : b ^ 0x7fffffff) : INT_MIN;
    const int top = __reduce_max_sync(kFull, key);
    return __ffs(__ballot_sync(kFull, key == top)) - 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int ou = __shfl_xor_sync(kFull, best_u, off);
    if (ou != INT_MAX &&
        (best_u == INT_MAX || ob > best || (ob == best && ou < best_u))) {
      best = ob;
      best_u = ou;
    }
  }
  return best_u;
}

struct Ring {
  uint64_t* full;   // (R,): the producer's slot is written
  uint64_t* empty;  // (R,): the consumer is done with the slot
  uint64_t* drawn;  // (R,): a drawing warp's records are in (split roles)
  int* slots;
  int R;            // >= P, or >= S: no waiter is two phases ahead
};

// The four raw words of Philox call `call` of sub-step s: the subset
// stream's calls first, then the Gumbel stream's.
__device__ __forceinline__ uint4 substep_words(uint32_t seed, int c, int s,
                                               int call, int subset_calls) {
  const bool sub = call < subset_calls;
  return philox::words4(seed, sub ? kSubStream : kGumbelStream, c, s,
                        sub ? call : call - subset_calls);
}

// A sub-step in a producer's hands: its slot, its site and, for the group
// of 32 * kRounds records being drawn, the picks and the gathered weights.
struct Draw {
  Slot sl;
  int k;                 // the slot
  int i;                 // the site
  int pick[kRounds];     // k of Floyd's algorithm, or -1
  float w[kRounds];
};

// Producer warp q of P.  A sub-step is finished ahead into slot s % R in
// three steps: draw (wait for the slot, the Philox words, Floyd's rounds,
// the W gathers issued), land (the Gumbels, the records (j, w) stored) and
// sum (the buckets of x[j_t] as the state stands, the sums, the argmax,
// the slot handed over).  With `lead` > 0, warps 0 .. summers-1 sum
// sub-steps q, q + summers, ..., each once its records are in and the
// consumer has released sub-step s - lead, and the others draw and land
// theirs in turn; otherwise warp q does all three for sub-steps q, q + P,
// ....  Where a sub-step's Philox calls fit the lanes (B + D <= 128 or
// so), lane l computes call l of the warp's next sub-step while this one's
// gathers are in flight.
__device__ __forceinline__ void produce(const Ring& ring, const int* xs,
                                        uint32_t* bitmap, int n,
                                        const float* __restrict__ W,
                                        const int* __restrict__ i_sites,
                                        uint32_t seed, int c, int q, int P,
                                        int S, int B, int D, float scale,
                                        int lead, int summers) {
  const int lane = threadIdx.x & 31;
  const int m = n - 1;
  const volatile int* xv = xs;
  const int subset_calls = (B + 3) >> 2;
  const int calls = subset_calls + ((D + 3) >> 2);
  const bool ahead = calls <= 32;
  uint4 next = make_uint4(0u, 0u, 0u, 0u);

  // group g0's Floyd rounds and W gathers (issued); at g0 = 0 first the
  // slot, the site and the words, and after the gathers the words of the
  // warp's next sub-step
  const auto draw = [&](int s, int g0, int stride, Draw& d) {
    if (g0 == 0) {
      d.k = s % ring.R;
      if (s >= ring.R)  // the consumer has released sub-step s - R's slot
        hopper::mbar_wait(hopper::smem_addr(ring.empty + d.k),
                          ((s / ring.R) - 1) & 1);
      d.sl = slot_at(ring.slots, d.k, B, D);
      d.i = __ldg(i_sites + static_cast<long long>(c) * S + s);
      // the raw words into the slot: the subset's into rec[t].y, the
      // Gumbels' into gumbel[u]
      const auto store = [&](int call, uint4 w4) {
        const uint32_t word[4] = {w4.x, w4.y, w4.z, w4.w};
        const bool sub = call < subset_calls;
        const int t0 = 4 * (sub ? call : call - subset_calls);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (sub && t0 + e < B)
            d.sl.rec[t0 + e].y = static_cast<int>(word[e]);
          if (!sub && t0 + e < D)
            d.sl.gumbel[t0 + e] = __uint_as_float(word[e]);
        }
      };
      if (ahead) {
        if (lane < calls) store(lane, next);
      } else {
        for (int call = lane; call < calls; call += 32)
          store(call, substep_words(seed, c, s, call, subset_calls));
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      d.pick[r] = -1;
      if (g0 + 32 * r < B) {
        d.pick[r] = floyd_round(bitmap, d.sl.rec, g0 + 32 * r, B, m);
        __syncwarp();
      }
    }
    const float* wrow = W + static_cast<long long>(d.i) * n;
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (d.pick[r] >= 0)
        d.w[r] = __ldg(wrow + d.pick[r] + (d.pick[r] >= d.i));
    if (g0 == 0 && ahead && s + stride < S && lane < calls) {
      next = substep_words(seed, c, s + stride, lane, subset_calls);
      // computed here, while the gathers are in flight
      asm volatile("" : "+r"(next.x), "+r"(next.y), "+r"(next.z),
                   "+r"(next.w) :: "memory");
    }
  };

  // the Gumbels (at g0 = 0) and group g0's records (j, w)
  const auto land = [&](int g0, Draw& d) {
    if (g0 == 0)
      for (int u = lane; u < D; u += 32)
        d.sl.gumbel[u] = philox::gumbel(
            philox::to_uniform(__float_as_uint(d.sl.gumbel[u])));
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (d.pick[r] >= 0)
        d.sl.rec[g0 + 32 * r + lane] = make_int2(
            d.pick[r] + (d.pick[r] >= d.i), __float_as_int(d.w[r]));
    if (B > 32 && g0 + 32 * kRounds >= B) {   // the bitmap cleared for the
                                              // warp's next draw
      if (g0 == 0) {
#pragma unroll
        for (int r = 0; r < kRounds; ++r)
          if (d.pick[r] >= 0) bitmap[d.pick[r] >> 5] = 0u;
      } else {
        __syncwarp();
        for (int t = lane; t < B; t += 32) {
          const int j = d.sl.rec[t].x;
          bitmap[(j - (j > d.i)) >> 5] = 0u;
        }
      }
    }
  };

  // the buckets of x[j_t] as the state stands (the consumer checks them),
  // the sums and the argmax; the slot handed over
  const auto sum = [&](const Draw& d) {
    for (int t = lane; t < B; t += 32) {
      const int j = d.sl.rec[t].x;
      d.sl.rec[t].x = j | static_cast<int>(bucket(xv[j], D) << 16);
    }
    __syncwarp();
    const int v = bucket_argmax(d.sl.rec, d.sl.gumbel, B, D, scale);
    if (lane == 0) *d.sl.head = d.i | (v << 16);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(hopper::smem_addr(ring.full + d.k));
  };

  if (lead > 0) {   // B <= 32 * kRounds: one group; warps 0 .. summers-1
                    // sum, the others draw
    Draw d;
    if (q >= summers) {
      const int stride = P - summers;
      const int q0 = q - summers;
      if (ahead && q0 < S && lane < calls)
        next = substep_words(seed, c, q0, lane, subset_calls);
      for (int s = q0; s < S; s += stride) {
        draw(s, 0, stride, d);
        land(0, d);
        if (lane == 0) *d.sl.head = d.i;
        __syncwarp();
        if (lane == 0)
          hopper::mbar_arrive(hopper::smem_addr(ring.drawn + d.k));
      }
    } else {
      for (int s = q; s < S; s += summers) {
        d.k = s % ring.R;
        d.sl = slot_at(ring.slots, d.k, B, D);
        hopper::mbar_wait(hopper::smem_addr(ring.drawn + d.k),
                          (s / ring.R) & 1);
        if (s >= lead)  // the consumer is at most `lead` sub-steps behind
          hopper::mbar_wait(
              hopper::smem_addr(ring.empty + (s - lead) % ring.R),
              ((s - lead) / ring.R) & 1);
        d.i = *d.sl.head;
        sum(d);
      }
    }
  } else {
    if (ahead && q < S && lane < calls)
      next = substep_words(seed, c, q, lane, subset_calls);
    for (int s = q; s < S; s += P) {
      Draw d;
      for (int g0 = 0; g0 < B; g0 += 32 * kRounds) {
        draw(s, g0, P, d);
        land(g0, d);
      }
      sum(d);
    }
  }
}

// A lane's records of a slot against the state: false if a bucket differs
// from the record's, which then takes the current bucket.
__device__ __forceinline__ bool rescan(const Slot& sl, const int* xs, int B,
                                       int D) {
  bool same = true;
  for (int t0 = threadIdx.x & 31; t0 < B; t0 += 4 * 32) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + 32 * u;
      const uint32_t e = static_cast<uint32_t>(sl.rec[t < B ? t : 0].x);
      const uint32_t j = e & 0xffffu;
      const uint32_t b = bucket(xs[j], D);
      if (t < B && b != e >> 16) {
        same = false;
        sl.rec[t].x = static_cast<int>(j | b << 16);
      }
    }
  }
  return __all_sync(kFull, same);
}

// The consumer warp: sub-steps 0 .. S-1 in order, in windows of up to
// `window` sub-steps.  One pass checks every record of the window against
// the state before the window (lane by lane over (sub-step, t) pairs) and
// each record's site against the sites the window's earlier sub-steps
// write.  Then, in order, a sub-step with neither a changed bucket nor such
// a site takes its stored value; the others are checked again against the
// state as it then stands, and recomputed where a bucket changed.  The
// window's slots are released together.  Returns the number of sub-steps
// it recomputed.
__device__ __forceinline__ int consume(const Ring& ring, int* xs, int S,
                                       int B, int D, float scale,
                                       int window) {
  const int lane = threadIdx.x & 31;
  const int stride = static_cast<int>(slot_ints(B, D));
  // B <= 32: `per` sub-steps a pass over the lanes
  const int per = B <= 32 ? 32 / B : 1;
  const int lane_g = B <= 32 ? lane / B : 0, lane_t = B <= 32 ? lane % B : 0;
  int recomputed = 0;
  int k0 = 0;              // the window's first slot
  uint32_t parity = 0u;    // the parity of slot k0's fill
  for (int s0 = 0; s0 < S; s0 += window) {
    const int w = S - s0 < window ? S - s0 : window;
    // lane g < w: sub-step s0 + g's slot and head
    int kg = k0 + (lane < w ? lane : 0);
    const uint32_t pg = parity ^ (kg >= ring.R ? 1u : 0u);
    kg -= kg >= ring.R ? ring.R : 0;
    uint32_t head = 0u;
    if (lane < w) {
      hopper::mbar_wait(hopper::smem_addr(ring.full + kg), pg);
      head = static_cast<uint32_t>(*slot_at(ring.slots, kg, B, D).head);
    }
    __syncwarp();
    int site[kWindow];
#pragma unroll
    for (int g = 0; g < kWindow; ++g)
      site[g] = static_cast<int>(__shfl_sync(kFull, head, g) & 0xffffu);
    // every (sub-step, t) pair of the window; loads clamped to a live
    // record, so that a lane's loads go out together
    uint32_t stale = 0u, hit = 0u;
    const auto check = [&](int g, int t, bool live) {
      const int gc = live ? g : 0;
      const int kq = k0 + gc - (k0 + gc >= ring.R ? ring.R : 0);
      const uint32_t e = static_cast<uint32_t>(
          ring.slots[kq * stride + 2 * (live ? t : 0)]);
      const int j = static_cast<int>(e & 0xffffu);
      const uint32_t b = bucket(xs[j], D);    // loaded whether live or not
      if (live && b != e >> 16) stale |= 1u << g;
#pragma unroll
      for (int g2 = 0; g2 < kWindow - 1; ++g2)
        if (live && g2 < g && j == site[g2]) hit |= 1u << g;
    };
    if (B <= 32) {      // lane: sub-step p * per + lane / B, record lane % B
#pragma unroll
      for (int p = 0; p < kWindow; ++p) {
        const int g = p * per + lane_g;
        check(g, lane_t, lane_g < per && g < w);
      }
    } else {
      for (int g = 0; g < w; ++g)
        for (int t0 = lane; t0 < B; t0 += 4 * 32) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            check(g, t0 + 32 * u, t0 + 32 * u < B);
        }
    }
    const uint32_t redo = __reduce_or_sync(kFull, stale | hit);
    if (redo == 0u) {
      // no record of the window reads a site the window writes: lane g
      // stores its value, unless a later sub-step writes the same site
      bool last = lane < w;
#pragma unroll
      for (int g2 = 1; g2 < kWindow; ++g2)
        if (g2 > lane && g2 < w &&
            site[g2] == static_cast<int>(head & 0xffffu))
          last = false;
      if (last) xs[head & 0xffffu] = static_cast<int>(head >> 16);
    }
    for (int g = 0; g < w && redo != 0u; ++g) {
      const int kq = k0 + g - (k0 + g >= ring.R ? ring.R : 0);
      const uint32_t hd = __shfl_sync(kFull, head, g);
      int v = static_cast<int>(hd >> 16);
      if ((redo >> g) & 1u) {   // against the state as it now stands
        const Slot sl = slot_at(ring.slots, kq, B, D);
        __syncwarp();
        if (!rescan(sl, xs, B, D)) {
          __syncwarp();
          v = bucket_argmax(sl.rec, sl.gumbel, B, D, scale);
          ++recomputed;
        }
      }
      if (lane == 0) xs[hd & 0xffffu] = v;
    }
    __syncwarp();
    if (lane < w) hopper::mbar_arrive(hopper::smem_addr(ring.empty + kg));
    k0 += w;
    if (k0 >= ring.R) {
      k0 -= ring.R;
      parity ^= 1u;
    }
  }
  return recomputed;
}

__global__ void __launch_bounds__(kMaxThreads, 2)
local_gibbs_sweep_kernel(const int* __restrict__ x_in,
                         const float* __restrict__ W,
                         const int* __restrict__ i_sites,
                         const int* __restrict__ seed_ptr,
                         int* __restrict__ x_out,
                         int* __restrict__ recomputed, int n, int S, int B,
                         int D, float scale, int R, int window, int lead,
                         int summers) {
  extern __shared__ __align__(16) int smem[];
  const int P = blockDim.x / 32 - 1;
  const int words = (n + 30) / 32;
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + R;
  ring.drawn = ring.empty + R;
  ring.R = R;
  int* xs = smem + 6 * R;                                     // n
  uint32_t* bitmaps = reinterpret_cast<uint32_t*>(xs + n);    // P * words
  ring.slots = xs + fixed_ints(n, P);                         // R slots
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const long long row = static_cast<long long>(c) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x_in[row + j];
  if (B > 32)
    for (int k = threadIdx.x; k < P * words; k += blockDim.x) bitmaps[k] = 0u;
  if (threadIdx.x == 0) {
    for (int k = 0; k < R; ++k) {
      hopper::mbar_init(hopper::smem_addr(ring.full + k), 1);
      hopper::mbar_init(hopper::smem_addr(ring.empty + k), 1);
      hopper::mbar_init(hopper::smem_addr(ring.drawn + k), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    const int count = consume(ring, xs, S, B, D, scale, window);
    if (recomputed != nullptr && threadIdx.x == 0) recomputed[c] = count;
  } else {
    produce(ring, xs, bitmaps + (warp - 1) * words, n, W, i_sites,
            static_cast<uint32_t>(__ldg(seed_ptr)), c, warp - 1, P, S, B, D,
            scale, lead, summers);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) x_out[row + j] = xs[j];
}

// Opt-in shared memory one block may use on the current device (cached).
int smem_allowance() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}

struct Plan {
  int P;          // producer warps
  int R;          // ring slots
  int window;     // sub-steps the consumer checks at once
  int lead;       // how far ahead of the consumer a producer sums (0: no
                  // gate, every producer draws and sums its own sub-steps)
  int summers;    // with lead > 0: the producers that sum (the others draw)
  size_t bytes;   // shared memory
};

// The launch's plan at (n, S, B, D): the deepest ring (at most kDepth
// slots, at most S) that fits the device's shared memory with the most
// producer warps it allows (at most R, so no wait is two phases ahead).
// The consumer's window is about kWindowRecords records, the producers'
// lead about kLeadRecords and their number at most about
// kProducerRecords: wide subsets go stale sooner.  Where the lead is at
// least the window (the sub-step a gate waits for lies in an earlier
// window) and below R, and a sub-step's records fit one group, about two
// fifths of the producers sum and the others draw; otherwise each draws
// and sums its own sub-steps, ungated.  False when not even one producer
// and one slot fit.
bool plan(int n, int S, int B, int D, Plan* out) {
  // j, i and the value travel in 16 bits (any n and D that fit shared
  // memory fit them)
  if (n > 65536 || D > 65535) return false;
  const size_t allowance = static_cast<size_t>(smem_allowance());
  const int depth = S < kDepth ? (S > 0 ? S : 1) : kDepth;
  const auto clamp = [](int v, int lo, int hi) {
    return v < lo ? lo : v > hi ? hi : v;
  };
  const int window = clamp(kWindowRecords / B, 1, kWindow);
  const int lead = clamp(kLeadRecords / B, window, kLead);
  const int producers = clamp(kProducerRecords / B, 1, kMaxProducers);
  for (int r = depth; r >= 1; --r) {
    for (int p = r < producers ? r : producers; p >= 1; --p) {
      Plan pl;
      pl.R = r;
      pl.P = p;
      pl.window = window < r ? window : r;
      pl.lead = lead < r ? lead : 0;
      if (B > 32 * kRounds || p < 2 || pl.lead < pl.window) pl.lead = 0;
      pl.summers = pl.lead > 0 ? clamp((2 * p + 2) / 5, 1, p - 1) : 0;
      pl.bytes = smem_bytes(n, B, D, p, r);
      if (pl.bytes <= allowance) {
        *out = pl;
        return true;
      }
    }
  }
  return false;
}

}  // namespace

extern "C" {

// The plan of local_gibbs_sweep_launch at (n, S, B, D): out = {producer
// warps, ring slots, the consumer's window, the producers' lead (0: none),
// the summing producers, shared-memory bytes}; returns 0, or
// cudaErrorInvalidValue when no plan fits.
int local_gibbs_sweep_plan(int n, int S, int B, int D, int* out) {
  Plan pl;
  if (!plan(n, S, B, D, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = pl.P;
  out[1] = pl.R;
  out[2] = pl.window;
  out[3] = pl.lead;
  out[4] = pl.summers;
  out[5] = static_cast<int>(pl.bytes);
  return 0;
}

// x (C, n) int32, W (n, n) float32, i_sites (C, S) int32, seed (1,) int32,
// x_out (C, n) int32, recomputed (C,) int32 or null, all contiguous on the
// card.  C >= 1, n >= 2, 1 <= B <= n - 1, D >= 1; sites in [0, n).
// recomputed[c]: the sub-steps of chain c the consumer recomputed (it
// depends on timing; the states do not).  cudaErrorInvalidValue when one
// producer and one slot do not fit.
int local_gibbs_sweep_launch(const int* x, const float* W, const int* i_sites,
                             const int* seed, int* x_out, int* recomputed,
                             int C, int n, int S, int B, int D, float scale,
                             cudaStream_t stream) {
  Plan pl;
  if (!plan(n, S, B, D, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_gibbs_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  local_gibbs_sweep_kernel<<<C, 32 * (pl.P + 1), pl.bytes, stream>>>(
      x, W, i_sites, seed, x_out, recomputed, n, S, B, D, scale, pl.R,
      pl.window, pl.lead, pl.summers);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
