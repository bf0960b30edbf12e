// Random numbers and warp reductions shared by the port's CUDA kernels.
//
// Counterparts of zhusuan_tpu/ops/_pallas_utils.py::uniform_from_bits and
// split_boxmuller_normal. A TPU kernel draws from the TPU's hardware PRNG; a
// CUDA kernel has none, so this is Philox4x32-10 (Salmon et al., SC'11)
// written by hand, with the same bits as the plain torch version in
// zhusuan_tpu_torch/ops/_random.py. The counter is (iteration, chain, group,
// stream); the stream ids are listed there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zs {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;

// Stream ids (counter word 3) of the kernels that draw whole [rows, cols]
// arrays of their own; ops/_random.py lists every stream.
constexpr uint32_t kStreamAdviNoise = 0x300u;      // ADVI particles per step
constexpr uint32_t kStreamRandomNormal = 0x400u;   // random.cu, normals
constexpr uint32_t kStreamRandomUniform = 0x401u;  // random.cu, uniforms

struct U4 {
  uint32_t x, y, z, w;
};

// Philox4x32-10, counter (c0, c1, c2, c3), key (k0, k1).
__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return U4{c0, c1, c2, c3};
}

__device__ __forceinline__ uint32_t word(const U4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// uint32 bits -> float in [0, 1): mantissa fill with exponent 0, minus 1.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Box-Muller using both outputs.
__device__ __forceinline__ void boxmuller(uint32_t b1, uint32_t b2, float* n0,
                                          float* n1) {
  const float u1 = fmaxf(uniform_from_bits(b1), 1e-7f);
  const float u2 = uniform_from_bits(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  const float theta = kTwoPi * u2;
  float s, c;  // one range reduction for both; the bits of sinf and cosf
  sincosf(theta, &s, &c);
  *n0 = r * c;
  *n1 = r * s;
}

// The 4 standard normals of columns 4g .. 4g+3 of row `row`.
__device__ __forceinline__ void normals4(uint32_t t, uint32_t row, uint32_t g,
                                         uint32_t stream, uint32_t k0,
                                         uint32_t k1, float* n) {
  const U4 b = philox4x32_10(t, row, g, stream, k0, k1);
  boxmuller(b.x, b.y, &n[0], &n[1]);
  boxmuller(b.z, b.w, &n[2], &n[3]);
}

// Sum over the 32 lanes; every lane gets the same bits (each butterfly step
// adds the same two numbers on both lanes, and addition commutes).
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace zs
