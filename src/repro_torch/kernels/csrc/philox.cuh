// Philox4x32-10 and the uniform / Gumbel / log-uniform conversions of the
// in-kernel-RNG sweeps (Salmon et al., SC'11; Random123's reference rounds).
//
// Written out rather than taken from curand_kernel.h: curand_init(seed,
// subsequence, offset) fixes its own counter layout, and the plain PyTorch
// version (../philox.py) must reproduce these bits exactly.  Layout:
//   key  = (seed, stream)        ctr = (lane / 4, s, c, 0)
//   bits = word (lane % 4) of philox4x32_10(ctr, key)
//   u    = float(bits >> 8) * 2^-24                  exact, in [0, 1)
// (the local sweep's subset stream uses the raw words: bits()).
// One call gives the words of four consecutive lanes 4q..4q+3: the
// MIN-Gibbs and DoubleMIN pair draws take all four (uniforms4(), one call
// per stream per quad of lanes); a body that reads one lane at a time
// (uniform(), bits()) uses one word of its call.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // key increments

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Raw 32-bit words of lanes 4q..4q+3 of stream `stream` at sub-step s of
// chain row c.
__device__ __forceinline__ uint4 words4(uint32_t seed, uint32_t stream,
                                        int c, int s, int q) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(s),
                 static_cast<uint32_t>(c), 0u),
      seed, stream);
}

// Raw 32-bit word of lane `lane` of stream `stream` at sub-step s of chain
// row c.
__device__ __forceinline__ uint32_t bits(uint32_t seed, uint32_t stream,
                                         int c, int s, int lane) {
  const uint4 w = words4(seed, stream, c, s, lane >> 2);
  const int q = lane & 3;
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}

__device__ __forceinline__ float to_uniform(uint32_t word) {
  return __fmul_rn(__uint2float_rn(word >> 8), 5.9604644775390625e-08f);
}

// Uniform of lane `lane` of stream `stream` at sub-step s of chain row c.
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t stream,
                                         int c, int s, int lane) {
  return to_uniform(bits(seed, stream, c, s, lane));
}

// Uniforms of lanes 4q..4q+3: one call.
__device__ __forceinline__ float4 uniforms4(uint32_t seed, uint32_t stream,
                                            int c, int s, int q) {
  const uint4 w = words4(seed, stream, c, s, q);
  return make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z),
                     to_uniform(w.w));
}

// 1e-20 rounded from double, as the plain version's Python scalar is
__device__ __forceinline__ float tiny() { return static_cast<float>(1e-20); }

// -log(-log(u + 1e-20) + 1e-20)
__device__ __forceinline__ float gumbel(float u) {
  const float t = logf(__fadd_rn(u, tiny()));
  return -logf(__fadd_rn(-t, tiny()));
}

// log(u + 1e-20)
__device__ __forceinline__ float log_uniform(float u) {
  return logf(__fadd_rn(u, tiny()));
}

}  // namespace philox
