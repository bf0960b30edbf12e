// The built-in densities that the port's HMC-family kernels evaluate
// (device side of zhusuan_tpu_torch/ops/densities.py).
//
// A Pallas kernel traces the user's density into its body; a CUDA kernel
// cannot, so each built-in is a struct that loads its parameters from the
// two pointers the wrapper passes and gives, for the K = E / 4 groups of 4
// elements that lane `lane` of a warp owns (element e = 4 k + i is column
// 4 (32 k + lane) + i):
//   grad(x, g)   the gradient of log p at the row x (every lane's g);
//   log_prob(x)  log p of the whole row (the same value on every lane).
// Columns at or past `dim` are padding: their gradient is 0, so a padded
// position and momentum that start at 0 stay 0.
//
// Each expression is written in the order of the plain torch version's
// arithmetic, so that under -fmad=false a trajectory agrees with the plain
// version bit for bit. The equicorrelated density's row sums are
// accumulated in double, which is exact for float32 rows of these widths,
// and rounded to float once, as the plain version does: the order of the
// warp butterflies, which differs from torch's, then does not matter.

#pragma once

#include <cuda_runtime.h>

#include "philox.cuh"

namespace zs {

enum DensityId { kDiagonalGaussian = 0, kEquicorrelatedGaussian = 1 };

// log p(x) = sum_j -0.5 (x_j - loc_j)^2 inv_var_j; grad = -(x - loc) inv_var.
// p0 = loc [dim], p1 = inv_var [dim].
template <int K>
struct DiagonalGaussian {
  static constexpr int E = 4 * K;
  float mu[E], w[E];

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane, int dim) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      mu[e] = j < dim ? p0[j] : 0.0f;
      w[e] = j < dim ? p1[j] : 0.0f;
    }
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
#pragma unroll
    for (int e = 0; e < E; ++e) g[e] = -(x[e] - mu[e]) * w[e];
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    float lp = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float z = x[e] - mu[e];
      lp += -0.5f * z * z * w[e];
    }
    return warp_sum(lp);
  }
};

// log p(z) = -0.5 (a sum(z^2) - b s^2), s = sum(z), evaluated centred as
// -0.5 (a sum((z - s/d)^2) + c s^2) with c = a/d - b: both terms are >= 0,
// so float32 loses nothing to cancellation (ops/densities.py says why).
// grad = -(a (z - s/d) + c s). p0 = (a, c, 1/d); p1 unused. One warp sum of z
// (in double) per gradient evaluation, two dependent ones per log-density.
template <int K>
struct EquicorrelatedGaussian {
  static constexpr int E = 4 * K;
  float a, c, inv_d;
  bool on[E];

  __device__ __forceinline__ void load(const float* p0, const float*,
                                       int lane, int dim) {
    a = p0[0];
    c = p0[1];
    inv_d = p0[2];
#pragma unroll
    for (int e = 0; e < E; ++e) on[e] = 4 * (32 * (e / 4) + lane) + e % 4 < dim;
  }

  __device__ __forceinline__ float row_sum(const float (&x)[E]) const {
    double s = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) s += static_cast<double>(x[e]);
    return static_cast<float>(warp_sum(s));
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
    const float s = row_sum(x);
    const float m = s * inv_d;
    const float cs = c * s;
#pragma unroll
    for (int e = 0; e < E; ++e) g[e] = on[e] ? -(a * (x[e] - m) + cs) : 0.0f;
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    const float s = row_sum(x);
    const float m = s * inv_d;
    double rr = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float r = on[e] ? x[e] - m : 0.0f;
      rr += static_cast<double>(r * r);
    }
    return -0.5f * (a * static_cast<float>(warp_sum(rr)) + c * s * s);
  }
};

}  // namespace zs
