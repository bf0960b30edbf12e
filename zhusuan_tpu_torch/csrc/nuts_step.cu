// Fused NUTS transition for Hopper (sm_90a): one warp per chain, one whole
// tree per warp, every depth from 1 to 12.
//
// Replaces both Pallas TPU kernels of zhusuan_tpu/ops/nuts_step.py:
// fused_nuts_transition (the pallas_call at ops/nuts_step.py:331, the tree
// fully unrolled for depth <= 6) and fused_nuts_transition_looped (the
// pallas_call at ops/nuts_step.py:641, depths 7-12). Computes, per chain, what
// they compute (and what mcmc/nuts.py::NUTS._transition_one computes): the
// momentum draw, every leaf's leapfrog step, the per-level U-turn checks
// against a stack of checkpoints (slot popcount(i >> 1) for an even leaf i;
// an odd leaf checks the top trailing_ones(i) slots), progressive
// multinomial selection inside a subtree and biased progressive selection at
// each merge, the full-tree U-turn check after a merge, and the divergence
// rule (NaN energy, or H - H0 > max_delta_energy).
//
// The density is the built-in diagonal Gaussian
//   log p(x) = sum_j -0.5 * (x_j - loc_j)^2 * inv_var_j,
//   grad     = -(x - loc) * inv_var,
// read through pointers. Its gradient is a function of x alone, so the
// kernel recomputes it where the JAX package carries it (the edges' g).
//
// Layout and what bounds it on an H100. Lane l of a warp owns the groups of 4
// contiguous elements g = l + 32 k (k < K), so one Philox call gives the 4
// momentum normals its lane needs. The moving edge (q, p), the momentum sums
// of the tree and of the subtree, and inv_mass, loc, inv_var stay in
// registers. Each warp's slice of dynamic shared memory holds the rows that
// are written once and read later: both edges (q, p), the tree's and the
// subtree's proposal, and the two checkpoint stacks of max_tree_depth - 1
// rows each. A lane touches only its own elements of a row (16-byte
// accesses, no bank conflicts), so the rows need no synchronisation. Every
// decision is warp-uniform: the row sums are butterfly reductions whose
// result is the same on every lane, and every lane draws the same uniforms.
// Each leaf costs one gradient, two row sums, and at an odd leaf two more per
// checked slot: five dependent __shfl_xor_sync each, so the kernel is bound
// by shuffle latency per leaf, not by device memory (it reads q once and
// writes q' once). Each warp stops when its own tree stops; a Pallas kernel
// runs every chain of a block to the end of its slowest chain.
//
// Arithmetic: built with -fmad=false, and the elementwise expressions are
// written in the order of the plain torch version
// (zhusuan_tpu_torch/mcmc/nuts.py::nuts_transition), so both compute the same
// leapfrog trajectory bit for bit; the row sums differ from torch's only in
// their order of addition.
//
// Built as a shared library with a plain C interface (nvcc, loaded through
// ctypes); zs_fused_nuts_transition returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using zs::normals4;
using zs::philox4x32_10;
using zs::U4;
using zs::uniform_from_bits;
using zs::warp_sum;
using zs::word;

// Counter word 3 of each stream (zhusuan_tpu_torch/ops/_random.py).
constexpr uint32_t kStreamMomentum = 1u;
constexpr uint32_t kStreamDirection = 0x100u;
constexpr uint32_t kStreamLeaf = 0x101u;
constexpr uint32_t kStreamMerge = 0x102u;
constexpr int kMaxDepth = 12;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSharedBytes = 232448;  // what one block may use on sm_90

// torch.logaddexp: two equal infinities give themselves (so -inf with -inf
// is -inf, where max + log1p(exp(-|a - b|)) would give NaN).
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Two sums over the warp at once (independent butterflies interleave).
__device__ __forceinline__ void warp_sum2(float* a, float* b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    *a += __shfl_xor_sync(0xffffffffu, *a, off);
    *b += __shfl_xor_sync(0xffffffffu, *b, off);
  }
}

// The uniform of column j of a [n_chains, n_cols] draw: injected, or word
// j % 4 of the Philox counter (t, chain, j / 4, stream).
struct Uniforms {
  const float* injected;
  int n_cols;
  uint32_t stream;

  __device__ __forceinline__ float at(int j, uint32_t t, uint32_t chain,
                                      uint32_t k0, uint32_t k1) const {
    if (injected != nullptr)
      return injected[static_cast<size_t>(chain) * n_cols + j];
    const U4 b = philox4x32_10(t, chain, static_cast<uint32_t>(j >> 2),
                               stream, k0, k1);
    return uniform_from_bits(word(b, j & 3));
  }
};

template <int K>
struct Rows {
  static constexpr int kFloats = 128 * K;  // one row: 32 lanes x K groups x 4
  float* base;

  __device__ __forceinline__ float* row(int r) const { return base + r * kFloats; }

  __device__ __forceinline__ void store(int r, const float* v, int lane) const {
    float4* dst = reinterpret_cast<float4*>(row(r));
#pragma unroll
    for (int k = 0; k < K; ++k)
      dst[k * 32 + lane] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }

  __device__ __forceinline__ void load(int r, float* v, int lane) const {
    const float4* src = reinterpret_cast<const float4*>(row(r));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 x = src[k * 32 + lane];
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }

  __device__ __forceinline__ void copy(int dst, int src, int lane) const {
    float4* d = reinterpret_cast<float4*>(row(dst));
    const float4* s = reinterpret_cast<const float4*>(row(src));
#pragma unroll
    for (int k = 0; k < K; ++k) d[k * 32 + lane] = s[k * 32 + lane];
  }
};

// Shared rows of one warp: the edges, the proposals, then n_slots rows of
// checkpointed momenta and n_slots rows of the subtree momentum sums before
// each checkpoint.
constexpr int kRowQL = 0, kRowPL = 1, kRowQR = 2, kRowPR = 3, kRowProp = 4,
              kRowSubProp = 5, kRowCkpt = 6;

__host__ __device__ constexpr int checkpoint_slots(int depth) {
  return depth > 1 ? depth - 1 : 1;  // popcount(i >> 1) < D - 1 for i < 2^(D-1)
}

__host__ __device__ constexpr int rows_per_warp(int depth) {
  return kRowCkpt + 2 * checkpoint_slots(depth);
}

// K = groups of 4 elements per lane; the kernel covers dim <= 128 * K.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_nuts_kernel(const float* __restrict__ q, const float* __restrict__ inv_mass,
                  const float* __restrict__ loc, const float* __restrict__ inv_var,
                  const float* __restrict__ step_size, const float* __restrict__ eps_in,
                  const float* __restrict__ u_dir, const float* __restrict__ u_leaf,
                  const float* __restrict__ u_merge, int n_chains, int dim,
                  int max_depth, float max_delta_energy, uint32_t key0,
                  uint32_t key1, uint32_t t, float* __restrict__ out_q,
                  float* __restrict__ out_lp, float* __restrict__ out_h,
                  float* __restrict__ out_acc, int* __restrict__ out_depth,
                  int* __restrict__ out_n_leap, uint8_t* __restrict__ out_turning,
                  uint8_t* __restrict__ out_divergent) {
  constexpr int E = 4 * K;
  extern __shared__ float4 shared[];
  const int lane = threadIdx.x & 31;
  const int warp_in_block = threadIdx.x >> 5;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp_in_block;
  if (warp >= n_chains) return;  // whole warps exit together
  const uint32_t chain = static_cast<uint32_t>(warp);
  const size_t row0 = static_cast<size_t>(warp) * dim;
  const int n_slots = checkpoint_slots(max_depth);
  const Rows<K> rows{reinterpret_cast<float*>(shared) +
                     static_cast<size_t>(warp_in_block) * rows_per_warp(max_depth) *
                         Rows<K>::kFloats};
  const int row_ckpt_p = kRowCkpt;
  const int row_ckpt_psum = kRowCkpt + n_slots;
  const Uniforms dirs{u_dir, max_depth, kStreamDirection};
  const Uniforms leaves{u_leaf, (1 << max_depth) - 1, kStreamLeaf};
  const Uniforms merges{u_merge, max_depth, kStreamMerge};
  const float ss = *step_size;
  const float neg_inf = -INFINITY;

  // Registers: the moving edge (x, p), the tree's and the subtree's
  // momentum sums, and the per-element constants. Padding elements are 0
  // everywhere, so they add nothing to any sum.
  float x[E], p[E], psum[E], spsum[E], im[E], mu[E], w[E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = k * 32 + lane;
    float nrm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g * 4 < dim) {
      if (eps_in != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = g * 4 + i;
          nrm[i] = j < dim ? eps_in[row0 + j] : 0.0f;
        }
      } else {
        normals4(t, chain, static_cast<uint32_t>(g), kStreamMomentum, key0, key1, nrm);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = k * 4 + i;
      const int j = g * 4 + i;
      const bool ok = j < dim;
      im[e] = ok ? inv_mass[j] : 0.0f;
      mu[e] = ok ? loc[j] : 0.0f;
      w[e] = ok ? inv_var[j] : 0.0f;
      x[e] = ok ? q[row0 + j] : 0.0f;
      p[e] = ok ? nrm[i] / sqrtf(im[e]) : 0.0f;  // p0 = eps / sqrt(inv_mass)
      psum[e] = p[e];
    }
  }
  rows.store(kRowQL, x, lane);
  rows.store(kRowQR, x, lane);
  rows.store(kRowProp, x, lane);
  rows.store(kRowPL, p, lane);
  rows.store(kRowPR, p, lane);

  // log p(x) and the kinetic energy sum (p * p) * inv_mass, over the warp.
  auto energies = [&](float* lp, float* kin) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float z = x[e] - mu[e];
      a += (-0.5f * (z * z)) * w[e];
      b += (p[e] * p[e]) * im[e];
    }
    warp_sum2(&a, &b);
    *lp = a;
    *kin = b;
  };
  // sum(sub * (a * inv_mass)) and sum(sub * (b * inv_mass)) over the warp.
  auto dots = [&](const float* sub, const float* a, const float* b, float* da,
                  float* db) {
    float s = 0.0f, r = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s += sub[e] * (a[e] * im[e]);
      r += sub[e] * (b[e] * im[e]);
    }
    warp_sum2(&s, &r);
    *da = s;
    *db = r;
  };

  float lp0, kin0;
  energies(&lp0, &kin0);
  const float h0 = -lp0 + 0.5f * kin0;
  float lp_prop = lp0, h_prop = h0, logw = -h0, sum_alpha = 0.0f;
  int depth = 0, n_leap = 0;
  bool turning = false, diverging = false;

  for (int k = 0; k < max_depth; ++k) {
    const bool right = dirs.at(k, t, chain, key0, key1) < 0.5f;
    const float eps = right ? ss : -ss;
    const float half_eps = 0.5f * eps;
    rows.load(right ? kRowQR : kRowQL, x, lane);
    rows.load(right ? kRowPR : kRowPL, p, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) spsum[e] = 0.0f;
    float s_logw = neg_inf, slp_prop = 0.0f, sh_prop = 0.0f;
    bool s_turn = false, s_div = false;
    const int first_leaf = (1 << k) - 1;

    for (int i = 0; i < (1 << k); ++i) {
      // One leapfrog step; grad = -(x - loc) * inv_var at either end.
#pragma unroll
      for (int e = 0; e < E; ++e) {
        p[e] = p[e] + half_eps * (-(x[e] - mu[e]) * w[e]);
        x[e] = x[e] + (eps * p[e]) * im[e];
        p[e] = p[e] + half_eps * (-(x[e] - mu[e]) * w[e]);
      }
      float lp, kin;
      energies(&lp, &kin);
      const float h = -lp + 0.5f * kin;
      const float delta = h - h0;
      const bool div = isnan(delta) || delta > max_delta_energy;
      // min(1, exp(-delta)), NaN -> 0; fminf alone would drop a NaN.
      const float alpha = isnan(delta) ? 0.0f : fminf(expf(-delta), 1.0f);

      // Progressive multinomial selection within the subtree.
      const float wl = div ? neg_inf : -h;
      const float s_logw_new = logaddexp(s_logw, wl);
      if (logf(leaves.at(first_leaf + i, t, chain, key0, key1)) < wl - s_logw_new) {
        rows.store(kRowSubProp, x, lane);
        slp_prop = lp;
        sh_prop = h;
      }
      s_logw = s_logw_new;

      // Iterative U-turn bookkeeping.
      const int slot = __popc(i >> 1);
      if ((i & 1) == 0) {
        if (!div) {  // checkpoint (momentum, subtree psum before it)
          rows.store(row_ckpt_p + slot, p, lane);
          rows.store(row_ckpt_psum + slot, spsum, lane);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) spsum[e] = spsum[e] + p[e];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) spsum[e] = spsum[e] + p[e];
        if (!div) {
          const int ones = __popc(((i + 1) & -(i + 1)) - 1);
          for (int s = slot - ones + 1; s <= slot && !s_turn; ++s) {
            float ck_p[E], sub[E];
            rows.load(row_ckpt_psum + s, sub, lane);
#pragma unroll
            for (int e = 0; e < E; ++e) sub[e] = spsum[e] - sub[e];
            rows.load(row_ckpt_p + s, ck_p, lane);
            float d_ck, d_new;
            dots(sub, ck_p, p, &d_ck, &d_new);
            s_turn = d_ck <= 0.0f || d_new <= 0.0f;
          }
        }
      }
      s_div = div;
      sum_alpha += alpha;
      ++n_leap;
      if (s_turn || s_div) break;
    }

    // Doubling merge: biased progressive selection toward the new subtree,
    // then the full-tree U-turn check, only when the subtree is valid.
    ++depth;
    const bool stop = s_turn || s_div;
    bool merged_turn = false;
    if (!stop) {
      if (logf(merges.at(k, t, chain, key0, key1)) < s_logw - logw) {
        rows.copy(kRowProp, kRowSubProp, lane);
        lp_prop = slp_prop;
        h_prop = sh_prop;
      }
      logw = logaddexp(logw, s_logw);
#pragma unroll
      for (int e = 0; e < E; ++e) psum[e] = psum[e] + spsum[e];
      rows.store(right ? kRowQR : kRowQL, x, lane);
      rows.store(right ? kRowPR : kRowPL, p, lane);
      float p_l[E], p_r[E];
      rows.load(kRowPL, p_l, lane);
      rows.load(kRowPR, p_r, lane);
      float d_l, d_r;
      dots(psum, p_l, p_r, &d_l, &d_r);
      merged_turn = d_l <= 0.0f || d_r <= 0.0f;
    }
    turning = stop ? s_turn : merged_turn;
    diverging = s_div;
    if (stop || merged_turn) break;
  }

  // The tree's proposal.
  rows.load(kRowProp, x, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (k * 32 + lane) * 4 + i;
      if (j < dim) out_q[row0 + j] = x[k * 4 + i];
    }
  }
  if (lane == 0) {
    out_lp[chain] = lp_prop;
    out_h[chain] = h_prop;
    out_acc[chain] = sum_alpha / fmaxf(static_cast<float>(n_leap), 1.0f);
    out_depth[chain] = depth;
    out_n_leap[chain] = n_leap;
    out_turning[chain] = turning ? 1 : 0;
    out_divergent[chain] = diverging ? 1 : 0;
  }
}

template <int K>
int launch(const float* q, const float* inv_mass, const float* loc,
           const float* inv_var, const float* step_size, const float* eps,
           const float* u_dir, const float* u_leaf, const float* u_merge,
           int n_chains, int dim, int max_depth, float max_delta_energy,
           uint32_t key0, uint32_t key1, uint32_t t, float* out_q, float* out_lp,
           float* out_h, float* out_acc, int* out_depth, int* out_n_leap,
           uint8_t* out_turning, uint8_t* out_divergent, cudaStream_t stream) {
  const size_t per_warp =
      static_cast<size_t>(rows_per_warp(max_depth)) * Rows<K>::kFloats * sizeof(float);
  const size_t bytes = per_warp * kWarpsPerBlock;
  if (bytes > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_nuts_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(n_chains) + kWarpsPerBlock - 1) /
                           kWarpsPerBlock;
  fused_nuts_kernel<K><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, bytes, stream>>>(
      q, inv_mass, loc, inv_var, step_size, eps, u_dir, u_leaf, u_merge, n_chains, dim,
      max_depth, max_delta_energy, key0, key1, t, out_q, out_lp, out_h, out_acc,
      out_depth, out_n_leap, out_turning, out_divergent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Plain C entry point. Pointers are device pointers; q, inv_mass [dim], loc,
// inv_var, step_size [1] and the noise are float32. eps [n, dim], u_dir
// [n, D], u_leaf [n, 2^D - 1] and u_merge [n, D] are all null (the kernel
// then draws them from Philox keyed by (key0, key1) with counter (t, chain,
// group, stream)) or all given. Outputs: out_q [n, dim], out_lp, out_h,
// out_acc [n] float32, out_depth, out_n_leap [n] int32, out_turning,
// out_divergent [n] one byte each. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int zs_fused_nuts_transition(
    const void* q, const void* inv_mass, const void* loc, const void* inv_var,
    const void* step_size, const void* eps, const void* u_dir, const void* u_leaf,
    const void* u_merge, int n_chains, int dim, int max_depth,
    float max_delta_energy, uint32_t key0, uint32_t key1, uint32_t t, void* out_q,
    void* out_lp, void* out_h, void* out_acc, void* out_depth, void* out_n_leap,
    void* out_turning, void* out_divergent, void* stream) {
  const int groups = (dim + 3) / 4;
  const int k = groups <= 32 ? 1 : groups <= 64 ? 2 : groups <= 128 ? 4 : 0;
  const bool noise_ok = (eps == nullptr && u_dir == nullptr && u_leaf == nullptr &&
                         u_merge == nullptr) ||
                        (eps != nullptr && u_dir != nullptr && u_leaf != nullptr &&
                         u_merge != nullptr);
  if (k == 0 || n_chains < 1 || dim < 1 || max_depth < 1 || max_depth > kMaxDepth ||
      !noise_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZS_LAUNCH(KK)                                                                  \
  return launch<KK>(f(q), f(inv_mass), f(loc), f(inv_var), f(step_size), f(eps),      \
                    f(u_dir), f(u_leaf), f(u_merge), n_chains, dim, max_depth,         \
                    max_delta_energy, key0, key1, t, static_cast<float*>(out_q),       \
                    static_cast<float*>(out_lp), static_cast<float*>(out_h),           \
                    static_cast<float*>(out_acc), static_cast<int*>(out_depth),        \
                    static_cast<int*>(out_n_leap), static_cast<uint8_t*>(out_turning), \
                    static_cast<uint8_t*>(out_divergent), s)
  switch (k) {
    case 1: ZS_LAUNCH(1);
    case 2: ZS_LAUNCH(2);
    default: ZS_LAUNCH(4);
  }
#undef ZS_LAUNCH
}
