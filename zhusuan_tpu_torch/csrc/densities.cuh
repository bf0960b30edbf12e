// The built-in densities that the port's kernels evaluate (device side of
// zhusuan_tpu_torch/ops/densities.py).
//
// A Pallas kernel traces the user's density into its body; a CUDA kernel
// cannot, so each built-in is a struct that loads its parameters from the
// two pointers the wrapper passes and gives, for the K = E / 4 groups of 4
// elements that lane `lane` of a warp owns (element e = 4 k + i is column
// 4 (32 k + lane) + i):
//   grad(x, g)   the gradient of log p at the row x (every lane's g);
//   log_prob(x)  log p of the whole row (the same value on every lane);
//   value_and_grad(x, g)  both at once, for the ADVI trainer (advi_step.cu):
//                the arithmetic of the plain version's value_and_grad, with
//                log p's row sum accumulated in double and rounded once.
//                value_and_grad<true> is the same for a row that ONE lane
//                holds whole (dim <= 4, the struct loaded as lane 0 with
//                K = 1): no sum leaves the lane, so every lane of a warp can
//                evaluate a row of its own.
// Toy2D (dim 2) has value_and_grad<true> only: the ADVI trainer alone takes it.
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

enum DensityId {
  kDiagonalGaussian = 0,
  kEquicorrelatedGaussian = 1,
  kToy2D = 2
};

// A lane's partial sum of a row: summed over the warp that shares the row,
// or the row's sum already when this lane holds the whole row.
template <bool kWholeRow>
__device__ __forceinline__ double row_total(double v) {
  return kWholeRow ? v : warp_sum(v);
}

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

  template <bool kWholeRow = false>
  __device__ __forceinline__ float value_and_grad(const float (&x)[E],
                                                  float (&g)[E]) const {
    double lp = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float z = x[e] - mu[e];
      g[e] = -z * w[e];
      lp += static_cast<double>(-0.5f * (z * z) * w[e]);
    }
    return static_cast<float>(row_total<kWholeRow>(lp));
  }
};

// log p(z) = -0.5 (a sum(z^2) - b s^2), s = sum(z), evaluated centred as
// -0.5 (a sum((z - s/d)^2) + c s^2) with c = a/d - b: both terms are >= 0,
// so float32 loses nothing to cancellation (ops/densities.py says why).
// grad = -(a (z - s/d) + c s). p0 = (a, c, 1/d); p1 unused. One warp sum of z
// (in double) per gradient evaluation, two dependent ones per log-density.
// A lane adds its elements in two interleaved sums (even and odd e) before
// the butterfly: the sums of float32 rows of these widths are exact in
// double, so the order does not change them, and the two chains halve the
// dependent adds.
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

  template <bool kWholeRow = false>
  __device__ __forceinline__ float row_sum(const float (&x)[E]) const {
    double s0 = 0.0, s1 = 0.0;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      s0 += static_cast<double>(x[e]);
      s1 += static_cast<double>(x[e + 1]);
    }
    return static_cast<float>(row_total<kWholeRow>(s0 + s1));
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

  template <bool kWholeRow = false>
  __device__ __forceinline__ float value_and_grad(const float (&x)[E],
                                                  float (&g)[E]) const {
    const float s = row_sum<kWholeRow>(x);
    const float m = s * inv_d;
    const float cs = c * s;
    double rr = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float r = on[e] ? x[e] - m : 0.0f;
      g[e] = on[e] ? -(a * r + cs) : 0.0f;
      rr += static_cast<double>(r * r);
    }
    return -0.5f *
           (a * static_cast<float>(row_total<kWholeRow>(rr)) + cs * s);
  }
};

// The funnel-like posterior of examples/toy_examples/toy2d_intractable.py
// over one latent z = [z1, z2] (dim 2: a lane holds the whole row in its
// elements 0 and 1): log p = log N(z2; 0, scale) + log N(z1; 0, exp(z2)),
//   d/dz1 = -z1 exp(-2 z2),  d/dz2 = -z2 / scale^2 + z1^2 exp(-2 z2) - 1.
// p0 = (-log(2 pi) - log(scale), 0.5 / scale^2, 1 / scale^2); p1 unused.
// No overflow guard: exp(-2 z2) is inf for z2 far below 0, as in the plain
// version, and the non-finite pattern is the same on both sides.
template <int K>
struct Toy2D {
  static constexpr int E = 4 * K;
  float c0, half_inv_var, inv_var;

  __device__ __forceinline__ void load(const float* p0, const float*, int,
                                       int) {
    c0 = p0[0];
    half_inv_var = p0[1];
    inv_var = p0[2];
  }

  template <bool kWholeRow>
  __device__ __forceinline__ float value_and_grad(const float (&x)[E],
                                                  float (&g)[E]) const {
    static_assert(kWholeRow && K == 1, "Toy2D: a lane holds the whole row");
    const float z1 = x[0], z2 = x[1];
    const float z1p = z1 * expf(-2.0f * z2);
    const float quad = z1 * z1p;
    g[0] = -z1p;
    g[1] = (-(z2 * inv_var) + quad) - 1.0f;
    g[2] = 0.0f;
    g[3] = 0.0f;
    return ((c0 - half_inv_var * (z2 * z2)) - z2) - 0.5f * quad;
  }
};

// The tempered bridge log f = (1 - beta) log p0 + beta log p1 between two
// built-ins over one row (annealed SMC's rejuvenation target; K1 alone takes
// it). beta is read from a device scalar, so a ladder of temperatures never
// waits on the host. In the plain version's order: w0 = 1 - beta, then
// w0 lp0 + beta lp1 and, element by element, w0 g0 + beta g1. Padding
// columns have g0 = g1 = 0, so their gradient stays 0.
template <int K, template <int> class D0, template <int> class D1>
struct Tempered {
  static constexpr int E = 4 * K;
  D0<K> prior;
  D1<K> target;
  float beta, w0;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       const float* t0, const float* t1,
                                       const float* b, int lane, int dim) {
    prior.load(p0, p1, lane, dim);
    target.load(t0, t1, lane, dim);
    beta = *b;
    w0 = 1.0f - beta;
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
    float g1[E];
    prior.grad(x, g);
    target.grad(x, g1);
#pragma unroll
    for (int e = 0; e < E; ++e) g[e] = w0 * g[e] + beta * g1[e];
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    return w0 * prior.log_prob(x) + beta * target.log_prob(x);
  }
};

}  // namespace zs
