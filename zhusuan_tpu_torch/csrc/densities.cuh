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
  kToy2D = 2,
  kEightSchools = 3,
  kEightSchoolsCentred = 4,
  kOrderedLogisticRegression = 5,
  kWeibullAFT = 6,
  kCovarianceEstimation = 7,
  kWhitened = 8,
  kNealFunnel = 9,
  kNeuTra = 10,
  kGaussianLinearRegression = 11,
  kPoissonChangepoint = 12
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

// ---------------------------------------------------------------------------
// Built-ins over several latents, with data (NUTS only; ops/densities.py's
// LatentDictDensity classes). A chain's row of dim <= 16 elements lies on the
// first lanes of its group of L lanes, 4 elements a lane (lane r holds flat
// elements 4 r .. 4 r + 3; csrc/nuts_step.cu launches them at K = 1). Every
// lane of the group:
//   1. gathers the whole row by shuffles (the parameters are few);
//   2. scores the data rows i = r, r + L, ... and adds each row's log-density
//      and its terms of each parameter's gradient into double partial sums,
//      in the flat order of the row (acc[0] is log p, acc[1 + j] element j);
//      the lane that owns element j adds its prior and Jacobian terms;
//   3. sums the partials over the group in one butterfly of log2 L shuffles
//      of doubles, so every lane holds the totals, rounds each to float once
//      and applies the chain rule of the bijectors in float;
//   4. keeps the gradient of the elements it owns.
// The sums of float32 terms are exact in double at these sizes, so the order
// of addition (rows over lanes, then the butterfly) does not change the
// float32 results: the plain version (ops/densities.py) sums in torch's order
// in double and rounds once, and each element's arithmetic is written in the
// plain version's order. value_and_grad returns log p on every lane of the
// group and the lane's 4 gradient elements (0 past the row).
// p0 is the data table (float32 rows), p1 the float32 constants.

__device__ __forceinline__ float softplus_k(float u) {
  return fmaxf(u, 0.0f) + log1pf(expf(-fabsf(u)));
}

__device__ __forceinline__ float log_sigmoid_k(float u) {
  return -(fmaxf(-u, 0.0f) + log1pf(expf(-fabsf(u))));
}

__device__ __forceinline__ float sigmoid_k(float u) {
  return 1.0f / (1.0f + expf(-u));
}

// The row's flat elements 0 .. kMax - 1 on every lane of the group of L.
template <int L, int kMax>
__device__ __forceinline__ void gather_row(const float (&x)[4],
                                           float (&P)[kMax]) {
#pragma unroll
  for (int j = 0; j < kMax; ++j)
    P[j] = __shfl_sync(0xffffffffu, x[j & 3], j >> 2, L);
}

template <int L, int N>
__device__ __forceinline__ void group_sums_double(double (&v)[N]) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < N; ++s) v[s] += __shfl_xor_sync(0xffffffffu, v[s], off);
  }
}

// Lane r's 4 elements of the flat gradient G.
template <int kMax>
__device__ __forceinline__ void own_elements(const float (&G)[kMax], int r,
                                             float (&g)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) g[e] = 0.0f;
#pragma unroll
  for (int j = 0; j < kMax; ++j)
    if ((j >> 2) == r) g[j & 3] = G[j];
}

// The eight-schools posterior in its unconstrained space (EightSchoolsLogJoint):
// elements mu, tau (softplus-unconstrained), then theta_tilde (non-centred,
// theta = mu + scale theta_tilde) or theta (centred), J <= 14 of them. Data
// rows are the schools: (y_j, 1 / sigma_j). Constants: log(2/pi) - log 5,
// 1/5, 1/100.
template <int L, bool kCentred>
struct EightSchools {
  static constexpr bool kCarried = true;
  static constexpr int kMax = 16;
  const float* tab;
  int n, r;
  float c_hc, s_inv, m_inv;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane, int n_rows) {
    tab = p0;
    n = n_rows;
    r = lane;
    c_hc = p1[0];
    s_inv = p1[1];
    m_inv = p1[2];
  }

  __device__ __forceinline__ float value_and_grad(const float (&x)[4],
                                                  float (&g)[4]) const {
    float P[kMax];
    gather_row<L>(x, P);
    const float mu = P[0], u = P[1];
    const float tau = softplus_k(u);
    const float sg = sigmoid_k(u), sgm = sigmoid_k(-u);
    const float itau = 1.0f / tau, ltau = logf(tau);
    double acc[1 + kMax];
#pragma unroll
    for (int s = 0; s <= kMax; ++s) acc[s] = 0.0;
#pragma unroll
    for (int j = 0; j < kMax - 2; ++j) {
      if (j < n && (j & (L - 1)) == r) {  // school j on its lane
        const float yv = tab[2 * j], is = tab[2 * j + 1];
        const float t = P[2 + j];
        if (kCentred) {
          const float a = (t - mu) * itau;
          const float z = (yv - t) * is;
          const float rr = z * is;
          acc[0] += static_cast<double>((-0.5f * (a * a) - ltau) + (-0.5f * (z * z)));
          const float ait = a * itau;
          acc[1] += static_cast<double>(ait);
          acc[2] += static_cast<double>((a * a) * itau - itau);
          acc[3 + j] += static_cast<double>(rr - ait);
        } else {
          const float theta = mu + tau * t;
          const float z = (yv - theta) * is;
          const float rr = z * is;
          acc[0] += static_cast<double>(-0.5f * (z * z));
          acc[1] += static_cast<double>(rr);
          acc[2] += static_cast<double>(rr) * static_cast<double>(t);
          acc[3 + j] += static_cast<double>(tau * rr);
        }
      }
      if (!kCentred && j < n && ((2 + j) >> 2) == r) {  // theta_tilde's prior
        const float t = P[2 + j];
        acc[0] += static_cast<double>(-0.5f * (t * t));
        acc[3 + j] += static_cast<double>(-t);
      }
    }
    if (r == 0) {  // mu and tau's lane: their priors and tau's Jacobian
      const float t5 = tau * s_inv;
      const float mu_s = mu * m_inv;
      acc[0] += static_cast<double>(-0.5f * (mu_s * mu_s));
      acc[0] += static_cast<double>(c_hc - log1pf(t5 * t5));
      acc[0] += static_cast<double>(log_sigmoid_k(u));
      acc[1] += static_cast<double>(-(mu_s * m_inv));
      acc[2] += static_cast<double>(-(2.0f * (t5 * s_inv)) / (1.0f + t5 * t5));
    }
    group_sums_double<L>(acc);
    float G[kMax];
    G[0] = static_cast<float>(acc[1]);
    G[1] = static_cast<float>(acc[2]) * sg + sgm;
#pragma unroll
    for (int j = 0; j < kMax - 2; ++j) G[2 + j] = j < n ? static_cast<float>(acc[3 + j]) : 0.0f;
    own_elements(G, r, g);
    return static_cast<float>(acc[0]);
  }
};

// Ordinal (cumulative-logit) regression in its unconstrained space
// (OrderedLogisticRegressionLogJoint): elements beta [p], then u [K - 1] with
// the Ordered cutpoints c_0 = u_0, c_k = c_{k-1} + exp(u_k); p <= 4,
// K - 1 <= 8, p + K - 1 <= 12. Data rows (x_i [p], y_i). Constants p, K - 1,
// finfo(float32).max / 2 (the padding of the outer cutpoints).
template <int L>
struct OrderedLogisticRegression {
  static constexpr bool kCarried = true;
  static constexpr int kMax = 12, kMaxP = 4;
  const float* tab;
  int n, r, p, nc;
  float big;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane, int n_rows) {
    tab = p0;
    n = n_rows;
    r = lane;
    p = static_cast<int>(p1[0]);
    nc = static_cast<int>(p1[1]);
    big = p1[2];
  }

  __device__ __forceinline__ float value_and_grad(const float (&x)[4],
                                                  float (&g)[4]) const {
    float P[kMax], cf[kMax];
    gather_row<L>(x, P);
    float run = 0.0f;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {  // the cutpoints, at their flat index
      const float v = j == p ? P[j] : run + expf(P[j]);
      const bool cut = j >= p && j < p + nc;
      cf[j] = cut ? v : 0.0f;
      run = cut ? v : run;
    }
    double acc[1 + kMax];
#pragma unroll
    for (int s = 0; s <= kMax; ++s) acc[s] = 0.0;
    const int stride = p + 1;
    for (int i = r; i < n; i += L) {
      const float* row = tab + static_cast<size_t>(i) * stride;
      float xr[kMaxP];
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) xr[j] = j < p ? row[j] : 0.0f;
      float eta = P[0] * xr[0];
#pragma unroll
      for (int j = 1; j < kMaxP; ++j)
        if (j < p) eta = eta + P[j] * xr[j];
      const int y = static_cast<int>(row[p]);
      float hi = big, lo = -big;
#pragma unroll
      for (int j = 0; j < kMax; ++j) {
        const int k = j - p;
        if (j >= p && k < nc) {
          hi = k == y ? cf[j] : hi;
          lo = k == y - 1 ? cf[j] : lo;
        }
      }
      const float a = hi - eta, b = lo - eta;
      const float d = b - a;
      const float lp_row = (log_sigmoid_k(a) + log_sigmoid_k(-b)) +
                           logf(-expm1f(fminf(d, -1e-12f)));
      const float inv_em = d < -1e-12f ? 1.0f / expm1f(a - b) : 0.0f;
      const float s_na = 1.0f / (1.0f + expf(a));
      const float s_b = 1.0f / (1.0f + expf(-b));
      const float ga = s_na + inv_em, gb = -s_b - inv_em, geta = s_b - s_na;
      acc[0] += static_cast<double>(lp_row);
#pragma unroll
      for (int j = 0; j < kMaxP; ++j)
        if (j < p) acc[1 + j] += static_cast<double>(xr[j]) * static_cast<double>(geta);
#pragma unroll
      for (int j = 0; j < kMax; ++j) {
        const int k = j - p;
        if (j >= p && k < nc) {
          if (k == y) acc[1 + j] += static_cast<double>(ga);
          if (k + 1 == y) acc[1 + j] += static_cast<double>(gb);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMax; ++j) {  // priors and the Jacobian, on j's lane
      if ((j >> 2) != r) continue;
      if (j < p) {
        acc[0] += static_cast<double>(-0.5f * (P[j] * P[j]));
        acc[1 + j] += static_cast<double>(-P[j]);
      } else if (j < p + nc) {
        const float ch = cf[j] * 0.5f;
        acc[0] += static_cast<double>(-0.5f * (ch * ch));
        acc[1 + j] += static_cast<double>(-(ch * 0.5f));
        if (j > p) acc[0] += static_cast<double>(P[j]);
      }
    }
    group_sums_double<L>(acc);
    // Through the Ordered bijector: d/du_k = exp(u_k) sum_{m >= k} g_c_m + 1
    // for k >= 1, and the whole sum for k = 0.
    float G[kMax], tail = 0.0f;
#pragma unroll
    for (int j = kMax - 1; j >= 0; --j) {
      const float gc = static_cast<float>(acc[1 + j]);
      if (j < p) {
        G[j] = gc;
      } else if (j < p + nc) {
        tail = j == p + nc - 1 ? gc : gc + tail;
        G[j] = j == p ? tail : expf(P[j]) * tail + 1.0f;
      } else {
        G[j] = 0.0f;
      }
    }
    own_elements(G, r, g);
    return static_cast<float>(acc[0]);
  }
};

// Weibull AFT survival regression in its unconstrained space
// (WeibullAFTLogJoint): elements beta [p], then u (the shape softplus(u));
// p <= 8. Data rows (x_i [p], log s_i, event_i), s_i the event time or the
// censor time. Constant p.
template <int L>
struct WeibullAFT {
  static constexpr bool kCarried = true;
  static constexpr int kMax = 9, kMaxP = 8;
  const float* tab;
  int n, r, p;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane, int n_rows) {
    tab = p0;
    n = n_rows;
    r = lane;
    p = static_cast<int>(p1[0]);
  }

  __device__ __forceinline__ float value_and_grad(const float (&x)[4],
                                                  float (&g)[4]) const {
    float P[kMax];
    gather_row<L>(x, P);
    float u = 0.0f;
#pragma unroll
    for (int j = 0; j < kMax; ++j) u = j == p ? P[j] : u;
    const float k = softplus_k(u);
    const float sg = sigmoid_k(u), sgm = sigmoid_k(-u);
    const float logk = logf(k), ik = 1.0f / k, km1 = k - 1.0f;
    double acc[1 + kMax];
#pragma unroll
    for (int s = 0; s <= kMax; ++s) acc[s] = 0.0;
    const int stride = p + 2;
    for (int i = r; i < n; i += L) {
      const float* row = tab + static_cast<size_t>(i) * stride;
      float xr[kMaxP];
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) xr[j] = j < p ? row[j] : 0.0f;
      float eta = P[0] * xr[0];
#pragma unroll
      for (int j = 1; j < kMaxP; ++j)
        if (j < p) eta = eta + P[j] * xr[j];
      const float ls = row[p], ev = row[p + 1];
      const bool event = ev > 0.5f;
      const float z = ls - eta;
      const float e = expf(k * z);
      const float lp_row = event ? ((logk - eta) + (k - 1.0f) * z) - e : -e;
      const float rr = k * (e - ev);
      const float dk = (event ? ik + z : 0.0f) - z * e;
      acc[0] += static_cast<double>(lp_row);
#pragma unroll
      for (int j = 0; j < kMaxP; ++j)
        if (j < p) acc[1 + j] += static_cast<double>(xr[j]) * static_cast<double>(rr);
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (j == p) acc[1 + j] += static_cast<double>(dk);
    }
#pragma unroll
    for (int j = 0; j < kMax; ++j) {  // priors and the Jacobian, on j's lane
      if ((j >> 2) != r) continue;
      if (j < p) {
        acc[0] += static_cast<double>(-0.5f * (P[j] * P[j]));
        acc[1 + j] += static_cast<double>(-P[j]);
      } else if (j == p) {
        acc[0] += static_cast<double>(-0.5f * (km1 * km1));
        acc[0] += static_cast<double>(log_sigmoid_k(u));
        acc[1 + j] += static_cast<double>(-km1);
      }
    }
    group_sums_double<L>(acc);
    float G[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const float gj = static_cast<float>(acc[1 + j]);
      G[j] = j < p ? gj : j == p ? gj * sg + sgm : 0.0f;
    }
    own_elements(G, r, g);
    return static_cast<float>(acc[0]);
  }
};

// The covariance posterior of examples/hierarchical/covariance_estimation.py
// in its unconstrained space (CovarianceEstimationLogJoint): elements
// y [K(K-1)/2] (the partial correlations z = tanh(y), row-major in the strict
// lower triangle; L is CorrelationCholesky's factor), then u [K] (the scales
// s = softplus(u)); 2 <= K <= 5. One data row: the scatter matrix S (K x K,
// float32). Constants K, n, C, then a_j - n/2 for j < K - 1. In closed form:
//   log p = sum_a (-s_a^2/2 + log sigmoid(u_a) - n log s_a) - tr(W M W^T)/2
//           + sum_{i>j} (a_j - n/2) log(1 - z_ij^2) + C,
// W = L^-1, M = diag(1/s) S diag(1/s). Every lane of the chain's group
// evaluates the whole density (it does not depend on the data size), in the
// plain version's order: each sum accumulated in double left to right and
// rounded once. Where a z rounds to +-1 or a diagonal entry of L underflows
// to 0 the closure is not finite: log p is -inf and the gradient 0.
template <int L>
struct CovarianceEstimation {
  static constexpr bool kCarried = true;
  static constexpr int kMax = 16, kMaxK = 5, kMaxPairs = 10;
  const float* tab;
  int k, m;
  float n, c0;
  float coef[kMaxK - 1];
  int r;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane, int) {
    tab = p0;
    r = lane;
    k = static_cast<int>(p1[0]);
    m = k * (k - 1) / 2;
    n = p1[1];
    c0 = p1[2];
#pragma unroll
    for (int j = 0; j < kMaxK - 1; ++j) coef[j] = j < k - 1 ? p1[3 + j] : 0.0f;
  }

  __device__ __forceinline__ float value_and_grad(const float (&x)[4],
                                                  float (&g)[4]) const {
    float P[kMax];
    gather_row<L>(x, P);
    float u[kMaxK];
#pragma unroll
    for (int a = 0; a < kMaxK; ++a) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < kMax; ++j) v = j == m + a ? P[j] : v;
      u[a] = v;
    }
    float sp[kMaxK], isp[kMaxK];
#pragma unroll
    for (int a = 0; a < kMaxK; ++a) {
      sp[a] = softplus_k(u[a]);
      isp[a] = 1.0f / sp[a];
    }
    // Pair e = i (i - 1) / 2 + j of row i > column j.
    float z[kMaxPairs], lz[kMaxPairs], om[kMaxPairs];
#pragma unroll
    for (int e = 0; e < kMaxPairs; ++e) {
      z[e] = tanhf(P[e]);
      const float zz = z[e] * z[e];
      lz[e] = log1pf(-zz);
      om[e] = 1.0f - zz;
    }
    float R[kMaxK][kMaxK], Lm[kMaxK][kMaxK];
    bool bad = false;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const int e = i * (i - 1) / 2 + j;
        R[i][j] = expf(0.5f * p);
        Lm[i][j] = z[e] * R[i][j];
        p = p + lz[e];
        if (i < k) bad = bad || !(lz[e] > -INFINITY);
      }
      R[i][i] = expf(0.5f * p);
      Lm[i][i] = R[i][i];
      if (i < k) bad = bad || !(Lm[i][i] > 0.0f);
    }
    float W[kMaxK][kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      W[i][i] = 1.0f / Lm[i][i];
#pragma unroll
      for (int j = 0; j < i; ++j) {
        double acc = static_cast<double>(Lm[i][j]) * static_cast<double>(W[j][j]);
#pragma unroll
        for (int q = j + 1; q < i; ++q)
          acc = acc + static_cast<double>(Lm[i][q]) * static_cast<double>(W[q][j]);
        W[i][j] = -static_cast<float>(acc) * W[i][i];
      }
    }
    float M[kMaxK][kMaxK];
#pragma unroll
    for (int a = 0; a < kMaxK; ++a) {
#pragma unroll
      for (int b = a; b < kMaxK; ++b) {
        const float v = (a < k && b < k) ? (tab[a * k + b] * isp[a]) * isp[b] : 0.0f;
        M[a][b] = v;
        M[b][a] = v;
      }
    }
    float T[kMaxK][kMaxK];  // W M
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
#pragma unroll
      for (int b = 0; b < kMaxK; ++b) {
        double acc = static_cast<double>(W[i][0]) * static_cast<double>(M[0][b]);
#pragma unroll
        for (int q = 1; q <= i; ++q)
          acc = acc + static_cast<double>(W[i][q]) * static_cast<double>(M[q][b]);
        T[i][b] = static_cast<float>(acc);
      }
    }
    float V[kMaxK][kMaxK];  // W M W^T
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        double acc = static_cast<double>(T[i][0]) * static_cast<double>(W[j][0]);
#pragma unroll
        for (int q = 1; q <= j; ++q)
          acc = acc + static_cast<double>(T[i][q]) * static_cast<double>(W[j][q]);
        V[i][j] = static_cast<float>(acc);
      }
    }
    double quad = 0.0;
    bool first = true;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
#pragma unroll
      for (int q = 0; q <= i; ++q) {
        if (i >= k) continue;
        const double t = static_cast<double>(T[i][q]) * static_cast<double>(W[i][q]);
        quad = first ? t : quad + t;
        first = false;
      }
    }
    const double nd = static_cast<double>(n);
    double lp = 0.0;
#pragma unroll
    for (int a = 0; a < kMaxK; ++a) {
      if (a >= k) continue;
      const double t = static_cast<double>(-0.5f * (sp[a] * sp[a]));
      lp = a == 0 ? t : lp + t;
      lp = lp + static_cast<double>(log_sigmoid_k(u[a]));
      lp = lp - nd * static_cast<double>(logf(sp[a]));
    }
    lp = lp - 0.5 * quad;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j)
        if (i < k) lp = lp + static_cast<double>(coef[j]) * static_cast<double>(lz[i * (i - 1) / 2 + j]);
    }
    lp = lp + static_cast<double>(c0);
    float G[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j) G[j] = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxK; ++a) {  // the scales, through Softplus
      double h = static_cast<double>(W[a][a]) * static_cast<double>(T[a][a]);
#pragma unroll
      for (int q = a + 1; q < kMaxK; ++q)
        if (q < k) h = h + static_cast<double>(W[q][a]) * static_cast<double>(T[q][a]);
      double acc = -static_cast<double>(sp[a]) - nd * static_cast<double>(isp[a]);
      acc = acc + static_cast<double>(isp[a]) * h;
      const float gu = static_cast<float>(acc) * sigmoid_k(u[a]) + sigmoid_k(-u[a]);
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (a < k && j == m + a) G[j] = gu;
    }
    // G_ij = (W^T V)_ij in double, then the partial correlations.
    double Gd[kMaxK][kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        double acc = static_cast<double>(W[i][i]) * static_cast<double>(V[i][j]);
#pragma unroll
        for (int q = i + 1; q < kMaxK; ++q)
          if (q < k) acc = acc + static_cast<double>(W[q][i]) * static_cast<double>(V[q][j]);
        Gd[i][j] = acc;
      }
    }
#pragma unroll
    for (int i = 1; i < kMaxK; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const int e = i * (i - 1) / 2 + j;
        double acc = (static_cast<double>(om[e]) * Gd[i][j]) * static_cast<double>(R[i][j]);
        double s_acc = Gd[i][j + 1] * static_cast<double>(Lm[i][j + 1]);
#pragma unroll
        for (int q = j + 2; q <= i; ++q) s_acc = s_acc + Gd[i][q] * static_cast<double>(Lm[i][q]);
        const double zd = static_cast<double>(z[e]);
        acc = acc - zd * s_acc;
        acc = acc - (2.0 * static_cast<double>(coef[j])) * zd;
        if (i < k) G[e] = static_cast<float>(acc);
      }
    }
    if (bad) {
#pragma unroll
      for (int j = 0; j < kMax; ++j) G[j] = 0.0f;
    }
    own_elements(G, r, g);
    return bad ? -INFINITY : static_cast<float>(lp);
  }
};

// ---------------------------------------------------------------------------
// Built-ins of the HMC transition's kernel alone (K1: csrc/hmc_step.cu's
// zs_fused_builtin_hmc_step), in K1's layout: lane `lane` of the chain's warp
// holds the K groups of 4 elements of densities above, and grad / log_prob
// are called by every lane of the warp. Each sum is taken in the order of
// the plain version (ops/densities.py):
//   - a product of a matrix and a vector adds its products pairwise over the
//     columns, ((0 + 1) + (2 + 3)) + ..., zero columns skipped past `dim`
//     (the plain version pads with zeros to a power of two: the same sums);
//   - a sum over the 32 lanes of a warp is warp_sum's butterfly (halves
//     first), as the plain version's _butterfly_sum;
//   - a sum over a row's elements or the data rows is accumulated in double
//     and rounded once, exact for float32 terms of these sizes.
// K = 1 for every one but the funnel: the row lies on lanes 0 .. 31 at 4
// elements a lane (element i of lane l is column 4 l + i).

// Neal's funnel over z = [v, x_1 .. x_{dim-1}]:
//   log p = -0.5 (v s^-1)^2 + sum_i (-0.5 (x_i e^{-v/2})^2 - v/2),
//   d/dx_i = -(x_i e^{-v/2}) e^{-v/2},
//   d/dv = -(v s^-1) s^-1 + sum_i (0.5 (x_i e^{-v/2})^2 - 0.5).
// p0 = (1 / s); p1 unused.
template <int K>
struct NealFunnel {
  static constexpr int E = 4 * K;
  float inv_s;
  int lane, dim;

  __device__ __forceinline__ void load(const float* p0, const float*,
                                       int lane_, int dim_) {
    inv_s = p0[0];
    lane = lane_;
    dim = dim_;
  }

  template <bool kGrad>
  __device__ __forceinline__ float eval(const float (&x)[E],
                                        float (&g)[E]) const {
    const float v = __shfl_sync(0xffffffffu, x[0], 0);
    const float h = 0.5f * v;
    const float ev = expf(-h);
    double lp = 0.0, gv = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      g[e] = 0.0f;
      if (j >= 1 && j < dim) {
        const float r = x[e] * ev;
        const float rr = r * r;
        lp += static_cast<double>(-0.5f * rr - h);
        if (kGrad) {
          gv += static_cast<double>(0.5f * rr - 0.5f);
          g[e] = -(r * ev);
        }
      }
    }
    const float w = v * inv_s;
    const float value =
        static_cast<float>(warp_sum(lp) + static_cast<double>(-0.5f * (w * w)));
    if (kGrad) {
      const float g_v = static_cast<float>(
          warp_sum(gv) + static_cast<double>(-(w * inv_s)));
      if (lane == 0) g[0] = g_v;
    }
    return value;
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
    eval<true>(x, g);
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    float g[E];
    return eval<false>(x, g);
  }

  template <bool kWholeRow = false>
  __device__ __forceinline__ float value_and_grad(const float (&x)[E],
                                                  float (&g)[E]) const {
    static_assert(!kWholeRow, "NealFunnel: a warp holds the row");
    return eval<true>(x, g);
  }
};

// The sum over k in [k0, k0 + N) of m[k * step] * v[k], pairwise; a part
// that lies at or past `dim` is 0 (uniform across the warp).
template <int N>
__device__ __forceinline__ float pairwise_dot(const float* m, int step,
                                              const float* v, int k0,
                                              int dim) {
  if (k0 >= dim) return 0.0f;
  if constexpr (N == 1) {
    return m[k0 * step] * v[k0];
  } else {
    return pairwise_dot<N / 2>(m, step, v, k0, dim) +
           pairwise_dot<N / 2>(m, step, v, k0 + N / 2, dim);
  }
}

// log p_base(L y), gradient L^T grad p_base(L y) (WhitenedLogJoint), dim <=
// 128. L is staged once a block in shared memory, rows of stride dim | 1 (odd:
// the 32 rows or columns a step reads fall in 32 banks); a warp's row goes
// through two rows of 128 floats of its own: lane l forms elements l + 32 r
// of L y (a row of L each) or of L^T g (a column each), all lanes reading the
// vector by broadcast. The base is a built-in of K1 (p0, p1 its parameters);
// its value is its value_and_grad's (row sums in double), as the plain
// version's.
template <int K, template <int> class Base>
struct Whitened {
  static_assert(K == 1, "Whitened: dim <= 128");
  static constexpr int E = 4;
  static constexpr int kMaxDim = 128;
  Base<K> base;
  const float* chol;  // shared [dim][stride]
  float* vin;         // this warp's [128]
  float* vout;        // this warp's [128]
  int lane, dim, stride;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       const float* chol_s, float* warp_buf,
                                       int lane_, int dim_) {
    base.load(p0, p1, lane_, dim_);
    chol = chol_s;
    vin = warp_buf;
    vout = warp_buf + kMaxDim;
    lane = lane_;
    dim = dim_;
    stride = dim_ | 1;
  }

  template <bool kTranspose>
  __device__ __forceinline__ void apply(const float (&in)[E],
                                        float (&out)[E]) const {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      if (j < dim) vin[j] = in[i];
    }
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < kMaxDim / 32; ++r) {
      const int j = lane + 32 * r;
      if (j < dim)
        vout[j] = kTranspose
                      ? pairwise_dot<kMaxDim>(chol + j, stride, vin, 0, dim)
                      : pairwise_dot<kMaxDim>(chol + j * stride, 1, vin, 0, dim);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      out[i] = j < dim ? vout[j] : 0.0f;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void grad(const float (&y)[E],
                                       float (&g)[E]) const {
    float x[E], gx[E];
    apply<false>(y, x);
    base.grad(x, gx);
    apply<true>(gx, g);
  }

  __device__ __forceinline__ float log_prob(const float (&y)[E]) const {
    float x[E], gx[E];
    apply<false>(y, x);
    return base.template value_and_grad<false>(x, gx);
  }
};

// A built-in pulled back through a RealNVP affine-coupling flow
// (NeuTraLogJoint): log p_base(f(y)) + log|det J_f(y)|, dim <= 32, the hidden
// width padded to 32 (lane u is hidden unit u). The couplings are staged once
// a block in shared memory, packed as the plain version packs them: for each
// coupling, W1 [n_in][32], b1 [32], W2^T [2 n_out][32], b2 [2 n_out]. A warp
// keeps its row (zrow), its gradient (grow) and each coupling's input (hist)
// in shared memory of its own. Forward, coupling f: pre_u = (c W1)_u + b1_u on
// lane u, shift_o and raw_o by butterfly sums over the units, then lane o <
// n_out moves a_o to a_o e^{ls_o} + shift_o, ls_o = 2 tanh(raw_o / 2), and
// adds ls_o to its log-det. Backward, written out (the net recomputed from
// hist, to the same bits): d/da = g e^ls, d/dls = (g a) e^ls + 1, d/draw =
// d/dls (1 - t^2), (d/dh)_u added over the outputs in order, the
// conditioning half's gradient plus a butterfly sum over the units.
template <int K, template <int> class Base>
struct NeuTra {
  static_assert(K == 1, "NeuTra: dim <= 32");
  static constexpr int E = 4;
  static constexpr int kMaxIn = 16, kMaxOut = 16;
  Base<K> base;
  const float* w;  // shared: the packed couplings
  float* zrow;     // this warp's [32]
  float* grow;     // this warp's [32]
  float* hist;     // this warp's [n_flows][32]
  int lane, dim, d1, n_flows;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       const float* w_s, float* warp_buf,
                                       int n_flows_, int lane_, int dim_) {
    base.load(p0, p1, lane_, dim_);
    w = w_s;
    zrow = warp_buf;
    grow = warp_buf + 32;
    hist = warp_buf + 64;
    lane = lane_;
    dim = dim_;
    d1 = dim_ / 2;
    n_flows = n_flows_;
  }

  // Coupling f's weights and halves: conditioning from c0, active from a0.
  __device__ __forceinline__ void layout(int f, const float*& w1,
                                         const float*& b1, const float*& w2t,
                                         const float*& b2, int& n_in,
                                         int& n_out, int& c0, int& a0) const {
    const int d2 = dim - d1;
    const int size_even = d1 * 32 + 32 + 2 * d2 * 32 + 2 * d2;
    const int size_odd = d2 * 32 + 32 + 2 * d1 * 32 + 2 * d1;
    const bool even = (f & 1) == 0;
    n_in = even ? d1 : d2;
    n_out = even ? d2 : d1;
    c0 = even ? 0 : d1;
    a0 = even ? d1 : 0;
    w1 = w + (f / 2) * (size_even + size_odd) + (even ? 0 : size_even);
    b1 = w1 + n_in * 32;
    w2t = b1 + 32;
    b2 = w2t + 2 * n_out * 32;
  }

  __device__ __forceinline__ void net(const float* c, const float* w1,
                                      const float* b1, const float* w2t,
                                      const float* b2, int n_in, int n_out,
                                      float& pre, float (&shift)[kMaxOut],
                                      float (&raw)[kMaxOut]) const {
    float acc = c[0] * w1[lane];
#pragma unroll
    for (int a = 1; a < kMaxIn; ++a)
      if (a < n_in) acc = acc + c[a] * w1[a * 32 + lane];
    pre = acc + b1[lane];
    const float h = pre > 0.0f ? pre : 0.0f;
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < n_out) {
        shift[o] = warp_sum(h * w2t[o * 32 + lane]) + b2[o];
        raw[o] = warp_sum(h * w2t[(n_out + o) * 32 + lane]) + b2[n_out + o];
      }
    }
  }

  // f(y) into x and the log-det (every lane), each coupling's input saved.
  __device__ __forceinline__ void forward(const float (&y)[E], float (&x)[E],
                                          double& logdet) const {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      if (j < dim) zrow[j] = y[i];
    }
    __syncwarp();
    double ld = 0.0;
    for (int f = 0; f < n_flows; ++f) {
      const float *w1, *b1, *w2t, *b2;
      int n_in, n_out, c0, a0;
      layout(f, w1, b1, w2t, b2, n_in, n_out, c0, a0);
      if (lane < dim) hist[f * 32 + lane] = zrow[lane];
      float pre, shift[kMaxOut], raw[kMaxOut];
      net(zrow + c0, w1, b1, w2t, b2, n_in, n_out, pre, shift, raw);
      float my_shift = 0.0f, my_raw = 0.0f;
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < n_out && lane == o) {
          my_shift = shift[o];
          my_raw = raw[o];
        }
      }
      __syncwarp();
      if (lane < n_out) {
        const float t = tanhf(my_raw * 0.5f);
        const float ls = 2.0f * t;
        const float e = expf(ls);
        const float a = zrow[a0 + lane];
        zrow[a0 + lane] = a * e + my_shift;
        ld += static_cast<double>(ls);
      }
      __syncwarp();
    }
    logdet = warp_sum(ld);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      x[i] = j < dim ? zrow[j] : 0.0f;
    }
    __syncwarp();
  }

  __device__ __forceinline__ float log_prob(const float (&y)[E]) const {
    float x[E], g[E];
    double logdet;
    forward(y, x, logdet);
    const float v = base.template value_and_grad<false>(x, g);
    return static_cast<float>(static_cast<double>(v) + logdet);
  }

  __device__ __forceinline__ void grad(const float (&y)[E],
                                       float (&g)[E]) const {
    float x[E], gx[E];
    double logdet;
    forward(y, x, logdet);
    base.grad(x, gx);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      if (j < dim) grow[j] = gx[i];
    }
    __syncwarp();
    for (int f = n_flows - 1; f >= 0; --f) {
      const float *w1, *b1, *w2t, *b2;
      int n_in, n_out, c0, a0;
      layout(f, w1, b1, w2t, b2, n_in, n_out, c0, a0);
      const float* hz = hist + f * 32;
      float pre, shift[kMaxOut], raw[kMaxOut];
      net(hz + c0, w1, b1, w2t, b2, n_in, n_out, pre, shift, raw);
      float gs[kMaxOut], gr[kMaxOut];
      float my_ga = 0.0f;
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        gs[o] = 0.0f;
        gr[o] = 0.0f;
        if (o < n_out) {
          const float gn = grow[a0 + o];
          const float a = hz[a0 + o];
          const float t = tanhf(raw[o] * 0.5f);
          const float e = expf(2.0f * t);
          const float g_ls = (gn * a) * e + 1.0f;
          gs[o] = gn;
          gr[o] = g_ls * (1.0f - t * t);
          if (lane == o) my_ga = gn * e;
        }
      }
      float gh = gs[0] * w2t[lane];
#pragma unroll
      for (int o = 1; o < kMaxOut; ++o)
        if (o < n_out) gh = gh + gs[o] * w2t[o * 32 + lane];
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o)
        if (o < n_out) gh = gh + gr[o] * w2t[(n_out + o) * 32 + lane];
      const float gp = pre > 0.0f ? gh : 0.0f;
      float my_gc = 0.0f;
#pragma unroll
      for (int a = 0; a < kMaxIn; ++a) {
        if (a < n_in) {
          const float s = warp_sum(gp * w1[a * 32 + lane]);
          if (lane == a) my_gc = grow[c0 + a] + s;
        }
      }
      __syncwarp();
      if (lane < n_in) grow[c0 + lane] = my_gc;
      if (lane < n_out) grow[a0 + lane] = my_ga;
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = 4 * lane + i;
      g[i] = j < dim ? grow[j] : 0.0f;
    }
    __syncwarp();
  }
};

// The Bayesian linear regression of examples/model_comparison/loo_compare.py
// (GaussianLinearRegressionLogJoint) over w [dim <= 8], normalising constants
// included: rows i = lane, lane + 32, ... of the table (x_i [dim], y_i), z_i =
// (y_i - x_i^T w) / noise, log p = sum_i -z_i^2 / 2 + sum_j -(w_j/prior)^2 / 2
// + C, d/dw_j = sum_i x_ij z_i / noise - w_j / prior^2. p0 the table, p1 the
// constants (dim, 1 / noise, 1 / prior, C).
template <int K>
struct GaussianLinearRegression {
  static_assert(K == 1, "GaussianLinearRegression: dim <= 8");
  static constexpr int E = 4, kMax = 8;
  const float* tab;
  int n, d, lane;
  float inv_n, inv_p, c0;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int lane_, int n_rows) {
    tab = p0;
    n = n_rows;
    lane = lane_;
    d = static_cast<int>(p1[0]);
    inv_n = p1[1];
    inv_p = p1[2];
    c0 = p1[3];
  }

  template <bool kGrad>
  __device__ __forceinline__ float eval(const float (&x)[E],
                                        float (&g)[E]) const {
    float P[kMax];
    gather_row<32>(x, P);
    double acc[1 + kMax];
#pragma unroll
    for (int s = 0; s <= kMax; ++s) acc[s] = 0.0;
    const int stride = d + 1;
    for (int i = lane; i < n; i += 32) {
      const float* row = tab + static_cast<size_t>(i) * stride;
      float eta = P[0] * row[0];
#pragma unroll
      for (int j = 1; j < kMax; ++j)
        if (j < d) eta = eta + P[j] * row[j];
      const float z = (row[d] - eta) * inv_n;
      acc[0] += static_cast<double>(-0.5f * (z * z));
      if (kGrad) {
        const float r = z * inv_n;
#pragma unroll
        for (int j = 0; j < kMax; ++j)
          if (j < d)
            acc[1 + j] += static_cast<double>(row[j]) * static_cast<double>(r);
      }
    }
#pragma unroll
    for (int j = 0; j < kMax; ++j) {  // the prior, on j's lane
      if ((j >> 2) == lane && j < d) {
        const float ws = P[j] * inv_p;
        acc[0] += static_cast<double>(-0.5f * (ws * ws));
        acc[1 + j] += static_cast<double>(-(ws * inv_p));
      }
    }
    if (lane == 0) acc[0] += static_cast<double>(c0);
    if (!kGrad) return static_cast<float>(warp_sum(acc[0]));
    group_sums_double<32>(acc);
    float G[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j)
      G[j] = j < d ? static_cast<float>(acc[1 + j]) : 0.0f;
    own_elements(G, lane, g);
    return static_cast<float>(acc[0]);
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
    eval<true>(x, g);
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    float g[E];
    return eval<false>(x, g);
  }
};

// The change-point posterior of examples/state_space/changepoint.py
// (PoissonChangepointLogJoint) over log_lam [2], the change point tau read
// for the chain (its [n_chains, 1] observation): rows t = lane, lane + 32,
// ... of the counts y_t, lr_t = log_lam_0 for t < tau else log_lam_1,
//   log p = sum_t (y_t lr_t - e^{lr_t}) + sum_k -(log_lam_k / prior)^2 / 2,
//   d/dlog_lam_k = sum_{t on k's side} (y_t - e^{lr_t})
//                  - (log_lam_k / prior) / prior.
// p0 the counts, p1 the constants (T, 1 / prior).
template <int K>
struct PoissonChangepoint {
  static_assert(K == 1, "PoissonChangepoint: dim 2");
  static constexpr int E = 4;
  const float* tab;
  int n, lane;
  float inv_p, tau;

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       const float* chain_row, int lane_,
                                       int n_rows) {
    tab = p0;
    n = n_rows;
    lane = lane_;
    inv_p = p1[1];
    tau = chain_row[0];
  }

  template <bool kGrad>
  __device__ __forceinline__ float eval(const float (&x)[E],
                                        float (&g)[E]) const {
    const float l0 = __shfl_sync(0xffffffffu, x[0], 0);
    const float l1 = __shfl_sync(0xffffffffu, x[1], 0);
    const float e0 = expf(l0), e1 = expf(l1);
    double lp = 0.0, g0 = 0.0, g1 = 0.0;
    for (int t = lane; t < n; t += 32) {
      const float y = tab[t];
      const bool before = static_cast<float>(t) < tau;
      const float lr = before ? l0 : l1;
      const float e = before ? e0 : e1;
      lp += static_cast<double>(y * lr - e);
      if (kGrad) {
        const double dr = static_cast<double>(y - e);
        if (before) {
          g0 += dr;
        } else {
          g1 += dr;
        }
      }
    }
    const float lh0 = l0 * inv_p, lh1 = l1 * inv_p;
    if (lane == 0) {
      lp += static_cast<double>(-0.5f * (lh0 * lh0));
      lp += static_cast<double>(-0.5f * (lh1 * lh1));
    }
    const float value = static_cast<float>(warp_sum(lp));
    if (kGrad) {
      const float gl0 = static_cast<float>(
          warp_sum(g0) + static_cast<double>(-(lh0 * inv_p)));
      const float gl1 = static_cast<float>(
          warp_sum(g1) + static_cast<double>(-(lh1 * inv_p)));
#pragma unroll
      for (int e = 0; e < E; ++e) g[e] = 0.0f;
      if (lane == 0) {
        g[0] = gl0;
        g[1] = gl1;
      }
    }
    return value;
  }

  __device__ __forceinline__ void grad(const float (&x)[E],
                                       float (&g)[E]) const {
    eval<true>(x, g);
  }

  __device__ __forceinline__ float log_prob(const float (&x)[E]) const {
    float g[E];
    return eval<false>(x, g);
  }
};

}  // namespace zs
