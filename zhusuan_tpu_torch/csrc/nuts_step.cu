// Fused NUTS transition for Hopper (sm_90a): a chain on a group of L lanes
// (L = 8 up to 128 dims, 16 up to 256, 32 up to 512; 32 / L chains a warp,
// one warp a block), one whole tree per chain, every depth from 1 to 12.
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
// The density is a built-in (ops/nuts_step.py::DENSITIES), read through
// pointers. The diagonal Gaussian
//   log p(x) = sum_j -0.5 * (x_j - loc_j)^2 * inv_var_j,
//   grad     = -(x - loc) * inv_var
// has a gradient that is a function of x alone, so its body recomputes it
// where the JAX package carries it (the edges' g). The built-ins over several
// latents with data (csrc/densities.cuh: EightSchools, OrderedLogisticRegression,
// WeibullAFT) sweep their data rows for each evaluation, so their body
// carries the gradient as the JAX package does: the moving edge's in
// registers, the far edge's in a shared row beside its (q, p), and one
// evaluation of log p and its gradient a leaf. The body is one template over
// the density (`Diagonal` or a data built-in); `if constexpr` keeps the
// carried paths out of the diagonal instantiation.
//
// What bounds it on an H100: per leaf a chain does ~20 flops an element and
// reads and writes nothing of device memory, so the kernel is bound by the
// instructions a chain issues per leaf and by their dependent latency. The
// layout cuts both:
// - Lane r of a chain's group owns the groups of 4 contiguous elements
//   g = r + L k (k < K), so one Philox call gives the 4 momentum normals it
//   needs, and a row sum is a butterfly of log2 L shuffles. The chain's
//   scalar work (selection, energies, logaddexp) is issued once for 32 / L
//   chains. Chains of a warp step their leaves together; a chain whose tree
//   has stopped is predicated off, and the warp runs while any of its chains
//   does.
// - The leaf uniforms are drawn ahead of use: lane r computes the Philox
//   group (t, chain, g0 + r, stream) and its logf for the next 4 L leaves,
//   and a leaf reads its log-uniform with one shuffle. The direction and
//   merge uniforms of every depth (3 groups each) are drawn once, at the
//   tree's start. The counters and words are those of the plain Philox
//   (ops/_random.py), so the bits are the same.
// - An odd leaf reduces its two energy sums and the two dots of every slot
//   it checks in one interleaved butterfly; s_turn is the OR over the slots.
// - Rows written once and read later live in memory, `groups` float4s each
//   (the row's width rounded up to 16 bytes, not a padded warp width): the
//   far edge (q, p) and the tree's proposal in shared memory, and the two
//   checkpoint stacks of max_tree_depth - 1 rows each either in shared
//   memory or, when the wrapper passes a scratch buffer, in global memory
//   that stays in L2, through one generic pointer (measured faster than
//   global-only loads for the global stacks). The moving edge, the momentum
//   sums and the subtree's proposal stay in registers. A lane touches only
//   its own elements of a row, so rows need no synchronisation.
// Residency per SM at d = 100 (groups = 25, L = 8, 4 chains a block): the
// stacks in shared memory take 13 / 17 / 21 rows of 400 B a chain at depths
// 6 / 8 / 10, 20.8 / 27.2 / 33.6 KB a block, so 10 / 8 / 6 blocks = 40 / 32 /
// 24 chains fit (5280 / 4224 / 3168 on 132 SMs); in global memory, 4.8 KB a
// block, and the registers bind (ptxas: ~250 a thread at L = 8, so 8 warps
// = 32 chains an SM, 4224 on the card).
// L follows from dim (`dispatch`; ops/nuts_step.py::nuts_lanes mirrors it);
// where the stacks live is chosen by ops/nuts_step.py::nuts_layout.
//
// Arithmetic: built with -fmad=false, and the elementwise expressions are
// written in the order of the plain torch version
// (zhusuan_tpu_torch/mcmc/nuts.py::nuts_transition), so both compute the same
// leapfrog trajectory bit for bit. The row sums (energies, U-turn dots)
// differ from torch's in their order of addition and in fusing each product
// into its sum (fmaf), so a near-tie may go the other way.
//
// Built as a shared library with a plain C interface (nvcc, loaded through
// ctypes); zs_fused_nuts_transition returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "densities.cuh"
#include "philox.cuh"

namespace {

using zs::normals4;
using zs::philox4x32_10;
using zs::U4;
using zs::uniform_from_bits;

// Counter word 3 of each stream (zhusuan_tpu_torch/ops/_random.py).
constexpr uint32_t kStreamMomentum = 1u;
constexpr uint32_t kStreamDirection = 0x100u;
constexpr uint32_t kStreamLeaf = 0x101u;
constexpr uint32_t kStreamMerge = 0x102u;
constexpr int kMaxDepth = 12;
constexpr int kMaxSlots = kMaxDepth - 1;
constexpr int kParts = 2 + 2 * kMaxSlots;  // an odd leaf's sums
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDim = 512;

#ifdef ZS_NUTS_CLOCKS
// A measurement build (scripts/profile_hmc_nuts.py --clocks): lane 0 of
// block 0 adds the cycles of each part of its tree into zs_clocks (0 the
// whole kernel, 1 the leaves, 2 their uniforms, 3 the leapfrog, 4 the
// lane's sums, 5 the butterfly, 6 the decisions, 7 the merges).
__device__ long long zs_clocks[8];
#define ZS_CLOCK(var) const long long var = clock64()
#define ZS_ADD(i, a, b) \
  if (blockIdx.x == 0 && threadIdx.x == 0) zs_clocks[i] += (b) - (a)
#else
#define ZS_CLOCK(var)
#define ZS_ADD(i, a, b)
#endif

// torch.logaddexp: two equal infinities give themselves (so -inf with -inf
// is -inf, where max + log1p(exp(-|a - b|)) would give NaN).
// Computed whole and selected, not branched around: a branch on a chain's
// value is a reconvergence barrier in the leaf.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float sum = fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  return isinf(a) && a == b ? a : sum;
}

// The first N of v summed over each group of L lanes, in one butterfly (the
// N sums of a level are independent, so their shuffles overlap). Every lane
// of a group gets the same bits.
template <int L, int N, int M>
__device__ __forceinline__ void group_sums(float (&v)[M]) {
  static_assert(N <= M, "group_sums: N <= M");
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < N; ++s) v[s] += __shfl_xor_sync(kFull, v[s], off);
  }
}

// A leaf's sums: its two energies and the two dots of each of the `ones`
// slots it checks. A switch on the count (the same on every lane), so that
// each case's shuffles are straight-line code: a shuffle under a branch the
// compiler cannot prove uniform costs a reconvergence barrier each.
template <int L>
__device__ __forceinline__ void leaf_sums(float (&v)[kParts], int ones) {
  switch (ones) {
    case 0: group_sums<L, 2>(v); break;
    case 1: group_sums<L, 4>(v); break;
    case 2: group_sums<L, 6>(v); break;
    case 3: group_sums<L, 8>(v); break;
    case 4: group_sums<L, 10>(v); break;
    case 5: group_sums<L, 12>(v); break;
    case 6: group_sums<L, 14>(v); break;
    case 7: group_sums<L, 16>(v); break;
    case 8: group_sums<L, 18>(v); break;
    case 9: group_sums<L, 20>(v); break;
    case 10: group_sums<L, 22>(v); break;
    default: group_sums<L, kParts>(v); break;
  }
}

// Word w of a lane's 4 values (w the same on every lane).
__device__ __forceinline__ float pick(const float (&u)[4], int w) {
  return w == 0 ? u[0] : w == 1 ? u[1] : w == 2 ? u[2] : u[3];
}

// Columns 4 grp .. 4 grp + 3 of a chain's row of a [n_chains, n_cols]
// uniform draw: injected, or the words of the Philox counter (t, chain, grp,
// stream). Columns past the row give 0.5 (never read).
__device__ __forceinline__ void draw4(const float* injected, int n_cols,
                                      uint32_t stream, uint32_t t,
                                      uint32_t chain, int grp, uint32_t k0,
                                      uint32_t k1, float (&u)[4]) {
  if (injected != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * grp + i;
      u[i] = j < n_cols ? injected[static_cast<size_t>(chain) * n_cols + j] : 0.5f;
    }
  } else {
    const U4 b = philox4x32_10(t, chain, static_cast<uint32_t>(grp), stream, k0, k1);
    u[0] = uniform_from_bits(b.x);
    u[1] = uniform_from_bits(b.y);
    u[2] = uniform_from_bits(b.z);
    u[3] = uniform_from_bits(b.w);
  }
}

// A chain's rows of `groups` float4s each, in shared or global memory; lane
// r of the chain's group touches only its groups r + L k below `groups`.
template <int L, int K>
struct Rows {
  float4* base;
  int groups, r;

  __device__ __forceinline__ void store(int i, const float (&v)[4 * K]) const {
    float4* dst = base + static_cast<size_t>(i) * groups;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int g = r + L * k;
      if (g < groups)
        dst[g] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }

  // The 4 elements of the lane's k-th group of row i.
  __device__ __forceinline__ void load_group(int i, int k, float (&v)[4]) const {
    const int g = r + L * k;
    const float4 x = g < groups ? base[static_cast<size_t>(i) * groups + g]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }

  __device__ __forceinline__ void load(int i, float (&v)[4 * K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float u[4];
      load_group(i, k, u);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * k + j] = u[j];
    }
  }
};

__host__ __device__ constexpr int checkpoint_slots(int depth) {
  return depth > 1 ? depth - 1 : 1;  // popcount(i >> 1) < D - 1 for i < 2^(D-1)
}

// Shared rows of a chain: the far edge (q, p) and the tree's proposal (and
// the far edge's gradient for a carried density), then, unless the stacks are
// in global memory, n_slots rows of checkpointed momenta and n_slots rows of
// the subtree momentum sums before each checkpoint.
constexpr int kRowFarQ = 0, kRowFarP = 1, kRowProp = 2, kRowFarG = 3;

__host__ __device__ constexpr int fixed_rows(bool carried) { return carried ? 4 : 3; }

__host__ __device__ constexpr int shared_rows(int depth, bool stacks_in_shared,
                                              bool carried) {
  return fixed_rows(carried) + (stacks_in_shared ? 2 * checkpoint_slots(depth) : 0);
}

// The diagonal Gaussian's tag: its body reads a.loc and a.inv_var itself.
// The data built-ins of csrc/densities.cuh have kCarried = true: the body
// carries their gradient.
struct Diagonal {
  static constexpr bool kCarried = false;
};

struct Args {
  const float* q;          // [c, d]
  const float* inv_mass;   // [d]
  const float* loc;        // [d]  (diagonal Gaussian)
  const float* inv_var;    // [d]  (diagonal Gaussian)
  const float* dens_data;  // the data table of a carried density
  const float* dens_consts;  // its constants
  int n_rows;              // its data rows
  const float* step_size;  // [1]
  const float* eps;        // [c, d] injected normals, or null
  const float* u_dir;      // [c, D], or null
  const float* u_leaf;     // [c, 2^D - 1], or null
  const float* u_merge;    // [c, D], or null
  float4* stacks;          // [n_chains + 3, 2 n_slots, groups] float4, or null
  int n_chains, dim, max_depth;
  float max_delta_energy;
  uint32_t key0, key1, t;
  float* out_q;
  float* out_lp;
  float* out_h;
  float* out_acc;
  int* out_depth;
  int* out_n_leap;
  uint8_t* out_turning;
  uint8_t* out_divergent;
};

// L = lanes a chain; K = groups of 4 elements a lane (dim <= 4 L K); Dens
// the density (Diagonal, or a data built-in at K = 1).
template <int L, int K, class Dens>
__global__ void __launch_bounds__(32) fused_nuts_kernel(const Args a) {
  constexpr int E = 4 * K;
  constexpr bool kCarried = Dens::kCarried;
  static_assert(!kCarried || K == 1, "a carried density takes K = 1");
  constexpr int kChains = 32 / L;  // a block is one warp
  extern __shared__ float4 shared[];
  ZS_CLOCK(c_start);
  const int lane = threadIdx.x;
  const int r = lane & (L - 1);
  const int local = lane / L;
  const long long slot_chain = static_cast<long long>(blockIdx.x) * kChains + local;
  // The spare chains of a ragged last warp shadow the last chain: they run
  // on its inputs (every lane must reach the shuffles) and write nothing.
  const bool valid = slot_chain < a.n_chains;
  const uint32_t chain = static_cast<uint32_t>(valid ? slot_chain : a.n_chains - 1);
  const int dim = a.dim;
  const int groups = (dim + 3) / 4;
  const int max_depth = a.max_depth;
  const size_t row0 = static_cast<size_t>(chain) * dim;
  const int n_slots = checkpoint_slots(max_depth);
  const bool stacks_in_shared = a.stacks == nullptr;
  float4* mine = shared + static_cast<size_t>(local) *
                              shared_rows(max_depth, stacks_in_shared, kCarried) *
                              groups;
  const Rows<L, K> fixed{mine, groups, r};
  const Rows<L, K> stack{
      stacks_in_shared
          ? mine + fixed_rows(kCarried) * groups
          : a.stacks + static_cast<size_t>(slot_chain) * 2 * n_slots * groups,
      groups, r};
  const int row_ckpt_psum = n_slots;  // stack rows: momenta, then sums
  const uint32_t k0 = a.key0, k1 = a.key1, t = a.t;
  const float ss = *a.step_size;
  const float neg_inf = -INFINITY;

  // Registers: the moving edge (x, p, and g for a carried density), the
  // tree's and the subtree's momentum sums, the subtree's proposal, and the
  // per-element constants. Padding elements are 0 everywhere, so they add
  // nothing to any sum.
  float x[E], p[E], psum[E], spsum[E], sprop[E], im[E], mu[E], w[E], g[E];
  Dens dens;
  if constexpr (kCarried) dens.load(a.dens_data, a.dens_consts, r, a.n_rows);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int grp = r + L * k;
    float nrm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (grp < groups) {
      if (a.eps != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = grp * 4 + i;
          nrm[i] = j < dim ? a.eps[row0 + j] : 0.0f;
        }
      } else {
        normals4(t, chain, static_cast<uint32_t>(grp), kStreamMomentum, k0, k1, nrm);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = k * 4 + i;
      const int j = grp * 4 + i;
      const bool ok = grp < groups && j < dim;
      im[e] = ok ? a.inv_mass[j] : 0.0f;
      if constexpr (!kCarried) {
        mu[e] = ok ? a.loc[j] : 0.0f;
        w[e] = ok ? a.inv_var[j] : 0.0f;
      }
      x[e] = ok ? a.q[row0 + j] : 0.0f;
      p[e] = ok ? nrm[i] / sqrtf(im[e]) : 0.0f;  // p0 = eps / sqrt(inv_mass)
      psum[e] = p[e];
    }
  }
  // The log-density and gradient at the start (a carried density).
  float lp_start = 0.0f;
  if constexpr (kCarried) lp_start = dens.value_and_grad(x, g);
  // The registers hold the right edge, the far rows the left one.
  fixed.store(kRowFarQ, x);
  fixed.store(kRowFarP, p);
  fixed.store(kRowProp, x);
  if constexpr (kCarried) fixed.store(kRowFarG, g);
  bool far_is_right = false;

  // The direction uniforms (lanes 0-2 of a group: groups 0-2 of the row) and
  // the merge log-uniforms (lanes 3-5) of every depth.
  float dm[4];
  {
    const bool dir_lane = r < 3;
    draw4(dir_lane ? a.u_dir : a.u_merge, max_depth,
          dir_lane ? kStreamDirection : kStreamMerge, t, chain,
          dir_lane ? r : r - 3, k0, k1, dm);
    if (!dir_lane) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dm[i] = logf(dm[i]);
    }
  }
  const int n_leaf_cols = (1 << max_depth) - 1;

  // A lane's parts of sum((x - loc)^2 * inv_var) = -2 log p(x) and of the
  // kinetic energy sum((p * p) * inv_mass): each product fused into its sum
  // (fmaf), two sums a part to halve the dependent adds. The -0.5 of log p
  // is applied to the total (a power of 2: exact).
  // A carried density has its log p from value_and_grad: quad is 0.
  auto energy_parts = [&](float* quad, float* kin) {
    float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      if constexpr (!kCarried) {
        const float z0 = x[e] - mu[e], z1 = x[e + 1] - mu[e + 1];
        s0 = __fmaf_rn(z0 * z0, w[e], s0);
        s1 = __fmaf_rn(z1 * z1, w[e + 1], s1);
      }
      b0 = __fmaf_rn(p[e] * p[e], im[e], b0);
      b1 = __fmaf_rn(p[e + 1] * p[e + 1], im[e + 1], b1);
    }
    *quad = s0 + s1;
    *kin = b0 + b1;
  };

  float part0[2];
  energy_parts(&part0[0], &part0[1]);
  group_sums<L, 2>(part0);
  const float lp0 = kCarried ? lp_start : -0.5f * part0[0];
  const float h0 = -lp0 + 0.5f * part0[1];
  float lp_prop = lp0, h_prop = h0, logw = -h0, sum_alpha = 0.0f;
  int depth = 0, n_leap = 0;
  bool turning = false, diverging = false, live = valid;

  for (int k = 0; k < max_depth; ++k) {
    if (!__any_sync(kFull, live)) break;
    const bool right = __shfl_sync(kFull, pick(dm, k & 3), k >> 2, L) < 0.5f;
    const float log_u_merge = __shfl_sync(kFull, pick(dm, k & 3), 3 + (k >> 2), L);
    const float eps = right ? ss : -ss;
    const float half_eps = 0.5f * eps;
    if (live && right == far_is_right) {  // extend the far edge: swap it in
      float fq[E], fp[E];
      fixed.load(kRowFarQ, fq);
      fixed.load(kRowFarP, fp);
      fixed.store(kRowFarQ, x);
      fixed.store(kRowFarP, p);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = fq[e];
        p[e] = fp[e];
      }
      if constexpr (kCarried) {
        float fg[E];
        fixed.load(kRowFarG, fg);
        fixed.store(kRowFarG, g);
#pragma unroll
        for (int e = 0; e < E; ++e) g[e] = fg[e];
      }
      far_is_right = !right;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) spsum[e] = 0.0f;
    float s_logw = neg_inf, slp_prop = 0.0f, sh_prop = 0.0f;
    bool s_turn = false, s_div = false, run = live;
    const int first_leaf = (1 << k) - 1;
    int g0 = 0;
    float lu[4];  // log-uniforms of leaves 4 (g0 + r) .. 4 (g0 + r) + 3

    for (int i = 0; i < (1 << k); ++i) {
      if (!__any_sync(kFull, run)) break;
      ZS_CLOCK(c_leaf);
      const int j = first_leaf + i;
      if (i == 0 || (j >> 2) >= g0 + L) {
        g0 = j >> 2;
        draw4(a.u_leaf, n_leaf_cols, kStreamLeaf, t, chain, g0 + r, k0, k1, lu);
#pragma unroll
        for (int v = 0; v < 4; ++v) lu[v] = logf(lu[v]);
      }
      const float log_u = __shfl_sync(kFull, pick(lu, j & 3), (j >> 2) - g0, L);
      ZS_CLOCK(c_uniform);

      // One leapfrog step: for the diagonal Gaussian grad = -(x - loc) *
      // inv_var at either end; a carried density evaluates log p and its
      // gradient once, at the new x.
      float lp_leaf = 0.0f;
      if constexpr (kCarried) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          p[e] = p[e] + half_eps * g[e];
          x[e] = x[e] + (eps * p[e]) * im[e];
        }
        lp_leaf = dens.value_and_grad(x, g);
#pragma unroll
        for (int e = 0; e < E; ++e) p[e] = p[e] + half_eps * g[e];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          p[e] = p[e] + half_eps * (-(x[e] - mu[e]) * w[e]);
          x[e] = x[e] + (eps * p[e]) * im[e];
          p[e] = p[e] + half_eps * (-(x[e] - mu[e]) * w[e]);
        }
      }
      ZS_CLOCK(c_leapfrog);

      // The energies and, at an odd leaf, sum(sub * (ckpt_p * inv_mass))
      // and sum(sub * (p * inv_mass)) for each checked slot, where sub is
      // the momentum sum since the checkpoint: one butterfly for all.
      const bool odd = (i & 1) != 0;
      const int slot = __popc(i >> 1);
      int ones = 0;
      float part[kParts];
      energy_parts(&part[0], &part[1]);
      if (odd) {
#pragma unroll
        for (int e = 0; e < E; ++e) spsum[e] = spsum[e] + p[e];
        ones = __popc(((i + 1) & -(i + 1)) - 1);
        float pim[E];
#pragma unroll
        for (int e = 0; e < E; ++e) pim[e] = p[e] * im[e];
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          if (s < ones) {
            const int row = slot - ones + 1 + s;
            float da0 = 0.0f, da1 = 0.0f, db0 = 0.0f, db1 = 0.0f;
            // One group of 4 at a time: a slot's two rows never sit whole in
            // registers.
#pragma unroll
            for (int k = 0; k < K; ++k) {
              float ck[4], sub[4];
              stack.load_group(row_ckpt_psum + row, k, sub);
              stack.load_group(row, k, ck);
#pragma unroll
              for (int i = 0; i < 4; i += 2) {
                const int e = 4 * k + i;
                const float s0 = spsum[e] - sub[i], s1 = spsum[e + 1] - sub[i + 1];
                da0 = __fmaf_rn(s0, ck[i] * im[e], da0);
                da1 = __fmaf_rn(s1, ck[i + 1] * im[e + 1], da1);
                db0 = __fmaf_rn(s0, pim[e], db0);
                db1 = __fmaf_rn(s1, pim[e + 1], db1);
              }
            }
            part[2 + 2 * s] = da0 + da1;
            part[3 + 2 * s] = db0 + db1;
          }
        }
      }
      ZS_CLOCK(c_sums);
      leaf_sums<L>(part, ones);
      ZS_CLOCK(c_butterfly);
      const float lp = kCarried ? lp_leaf : -0.5f * part[0];
      const float h = -lp + 0.5f * part[1];
      const float delta = h - h0;
      const bool div = isnan(delta) || delta > a.max_delta_energy;
      // min(1, exp(-delta)), NaN -> 0; fminf alone would drop a NaN.
      const float alpha = isnan(delta) ? 0.0f : fminf(expf(-delta), 1.0f);
      // Progressive multinomial selection within the subtree.
      const float wl = div ? neg_inf : -h;
      const float s_logw_new = logaddexp(s_logw, wl);

      if (run) {
        if (log_u < wl - s_logw_new) {
#pragma unroll
          for (int e = 0; e < E; ++e) sprop[e] = x[e];
          slp_prop = lp;
          sh_prop = h;
        }
        s_logw = s_logw_new;
        // Iterative U-turn bookkeeping.
        if (!odd) {
          if (!div) {  // checkpoint (momentum, subtree psum before it)
            stack.store(slot, p);
            stack.store(row_ckpt_psum + slot, spsum);
          }
        } else if (!div) {
          bool turn = false;
#pragma unroll
          for (int s = 0; s < kMaxSlots; ++s)
            if (s < ones) turn = turn || part[2 + 2 * s] <= 0.0f || part[3 + 2 * s] <= 0.0f;
          s_turn = turn;
        }
        s_div = div;
        sum_alpha += alpha;
        ++n_leap;
        if (s_turn || s_div) run = false;
      }
      if (!odd) {
#pragma unroll
        for (int e = 0; e < E; ++e) spsum[e] = spsum[e] + p[e];
      }
      ZS_CLOCK(c_end);
      ZS_ADD(1, c_leaf, c_end);
      ZS_ADD(2, c_leaf, c_uniform);
      ZS_ADD(3, c_uniform, c_leapfrog);
      ZS_ADD(4, c_leapfrog, c_sums);
      ZS_ADD(5, c_sums, c_butterfly);
      ZS_ADD(6, c_butterfly, c_end);
    }
    ZS_CLOCK(c_merge);

    // Doubling merge: biased progressive selection toward the new subtree,
    // then the full-tree U-turn check, only when the subtree is valid. The
    // check's sums are taken on every lane (the shuffles need all of them).
    float fp[E], tot[E], part[2] = {0.0f, 0.0f};
    fixed.load(kRowFarP, fp);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      tot[e] = psum[e] + spsum[e];
      part[0] = __fmaf_rn(tot[e], fp[e] * im[e], part[0]);
      part[1] = __fmaf_rn(tot[e], p[e] * im[e], part[1]);
    }
    group_sums<L, 2>(part);
    if (live) {
      ++depth;
      const bool stop = s_turn || s_div;
      bool merged_turn = false;
      if (!stop) {
        if (log_u_merge < s_logw - logw) {
          fixed.store(kRowProp, sprop);
          lp_prop = slp_prop;
          h_prop = sh_prop;
        }
        logw = logaddexp(logw, s_logw);
#pragma unroll
        for (int e = 0; e < E; ++e) psum[e] = tot[e];
        merged_turn = part[0] <= 0.0f || part[1] <= 0.0f;
      }
      turning = stop ? s_turn : merged_turn;
      diverging = s_div;
      if (stop || merged_turn) live = false;
    }
    ZS_CLOCK(c_merged);
    ZS_ADD(7, c_merge, c_merged);
  }
  ZS_CLOCK(c_done);
  ZS_ADD(0, c_start, c_done);

  if (!valid) return;
  fixed.load(kRowProp, x);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (r + L * k) * 4 + i;
      if (j < dim) a.out_q[row0 + j] = x[k * 4 + i];
    }
  }
  if (r == 0) {
    a.out_lp[chain] = lp_prop;
    a.out_h[chain] = h_prop;
    a.out_acc[chain] = sum_alpha / fmaxf(static_cast<float>(n_leap), 1.0f);
    a.out_depth[chain] = depth;
    a.out_n_leap[chain] = n_leap;
    a.out_turning[chain] = turning ? 1 : 0;
    a.out_divergent[chain] = diverging ? 1 : 0;
  }
}

// The dynamic shared memory a launch asks for is checked by
// cudaFuncSetAttribute against the device's per-block limit (the wrapper's
// layout rule keeps under it).
template <int L, int K, class Dens = Diagonal>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kChains = 32 / L;
  const size_t bytes = static_cast<size_t>(kChains) *
                       shared_rows(a.max_depth, a.stacks == nullptr, Dens::kCarried) *
                       ((a.dim + 3) / 4) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(fused_nuts_kernel<L, K, Dens>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(a.n_chains) + kChains - 1) / kChains;
  fused_nuts_kernel<L, K, Dens><<<static_cast<unsigned>(blocks), 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The layout at a.dim: the narrowest of 8, 16 and 32 lanes whose lanes hold
// the row in at most 4 groups of 4 elements each (8 lanes beat 16 and 32 at
// 100 dims), and the fewest groups a lane. A measurement build fixes the
// width with -DZS_NUTS_LANES=L (scripts/profile_hmc_nuts.py times 16 and 32
// lanes at 100 dims so).
int dispatch(const Args& a, cudaStream_t stream) {
  const int groups = (a.dim + 3) / 4;
#ifdef ZS_NUTS_LANES
  constexpr int L = ZS_NUTS_LANES;
  if (groups <= L) return launch<L, 1>(a, stream);
  if (groups <= 2 * L) return launch<L, 2>(a, stream);
  if (groups <= 4 * L) return launch<L, 4>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
#else
  if (groups <= 8) return launch<8, 1>(a, stream);
  if (groups <= 16) return launch<8, 2>(a, stream);
  if (groups <= 32) return launch<8, 4>(a, stream);
  if (groups <= 64) return launch<16, 4>(a, stream);
  return launch<32, 4>(a, stream);
#endif
}

template <int L>
using EightSchoolsNonCentred = zs::EightSchools<L, false>;
template <int L>
using EightSchoolsCentred = zs::EightSchools<L, true>;

// A carried density: one group of 4 elements a lane (its rows have at most
// 16 elements, on lanes 0-3), and the lanes of a chain split the data rows:
// 8 lanes a chain up to kRowsFor32 rows, 32 above (the butterfly's two more
// levels cost less than the rows they take off each lane). A measurement
// build fixes the width with -DZS_NUTS_DATA_LANES=L.
constexpr int kRowsFor32 = 32;

template <template <int> class D>
int launch_data(const Args& a, cudaStream_t stream) {
  if (a.dim > D<8>::kMax) return static_cast<int>(cudaErrorInvalidValue);
#ifdef ZS_NUTS_DATA_LANES
  return launch<ZS_NUTS_DATA_LANES, 1, D<ZS_NUTS_DATA_LANES>>(a, stream);
#else
  if (a.n_rows > kRowsFor32) return launch<32, 1, D<32>>(a, stream);
  return launch<8, 1, D<8>>(a, stream);
#endif
}

int dispatch_carried(int density, const Args& a, cudaStream_t stream) {
  switch (density) {
    case zs::kEightSchools:
      return launch_data<EightSchoolsNonCentred>(a, stream);
    case zs::kEightSchoolsCentred:
      return launch_data<EightSchoolsCentred>(a, stream);
    case zs::kOrderedLogisticRegression:
      return launch_data<zs::OrderedLogisticRegression>(a, stream);
    case zs::kWeibullAFT:
      return launch_data<zs::WeibullAFT>(a, stream);
    case zs::kCovarianceEstimation:
      return launch_data<zs::CovarianceEstimation>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef ZS_NUTS_CLOCKS
// Copies zs_clocks into host_out (8 int64) and zeroes it.
extern "C" int zs_nuts_clocks(void* host_out) {
  cudaError_t err = cudaMemcpyFromSymbol(host_out, zs_clocks, sizeof(zs_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(zs_clocks, zero, sizeof(zero)));
}
#endif

namespace {

bool noise_ok(const void* eps, const void* u_dir, const void* u_leaf,
              const void* u_merge) {
  return (eps == nullptr && u_dir == nullptr && u_leaf == nullptr && u_merge == nullptr) ||
         (eps != nullptr && u_dir != nullptr && u_leaf != nullptr && u_merge != nullptr);
}

Args make_args(const void* q, const void* inv_mass, const void* step_size,
               const void* eps, const void* u_dir, const void* u_leaf,
               const void* u_merge, int n_chains, int dim, int max_depth,
               float max_delta_energy, uint32_t key0, uint32_t key1, uint32_t t,
               void* stacks, void* out_q, void* out_lp, void* out_h, void* out_acc,
               void* out_depth, void* out_n_leap, void* out_turning,
               void* out_divergent) {
  const auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  Args a{};
  a.q = f(q);
  a.inv_mass = f(inv_mass);
  a.step_size = f(step_size);
  a.eps = f(eps);
  a.u_dir = f(u_dir);
  a.u_leaf = f(u_leaf);
  a.u_merge = f(u_merge);
  a.stacks = static_cast<float4*>(stacks);
  a.n_chains = n_chains;
  a.dim = dim;
  a.max_depth = max_depth;
  a.max_delta_energy = max_delta_energy;
  a.key0 = key0;
  a.key1 = key1;
  a.t = t;
  a.out_q = static_cast<float*>(out_q);
  a.out_lp = static_cast<float*>(out_lp);
  a.out_h = static_cast<float*>(out_h);
  a.out_acc = static_cast<float*>(out_acc);
  a.out_depth = static_cast<int*>(out_depth);
  a.out_n_leap = static_cast<int*>(out_n_leap);
  a.out_turning = static_cast<uint8_t*>(out_turning);
  a.out_divergent = static_cast<uint8_t*>(out_divergent);
  return a;
}

}  // namespace

// Plain C entry point of the diagonal Gaussian. Pointers are device pointers;
// q, inv_mass [dim], loc, inv_var, step_size [1] and the noise are float32.
// eps [n, dim], u_dir [n, D], u_leaf [n, 2^D - 1] and u_merge [n, D] are all
// null (the kernel then draws them from Philox keyed by (key0, key1) with
// counter (t, chain, group, stream)) or all given. dim <= 512. stacks is null
// (the checkpoint stacks in shared memory) or a float32 scratch buffer of
// (n + 3) * 2 * max(D - 1, 1) * ceil(dim / 4) * 4 elements, 16-byte aligned.
// Outputs: out_q [n, dim], out_lp, out_h, out_acc [n] float32, out_depth,
// out_n_leap [n] int32, out_turning, out_divergent [n] one byte each.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int zs_fused_nuts_transition(
    const void* q, const void* inv_mass, const void* loc, const void* inv_var,
    const void* step_size, const void* eps, const void* u_dir, const void* u_leaf,
    const void* u_merge, int n_chains, int dim, int max_depth,
    float max_delta_energy, uint32_t key0, uint32_t key1, uint32_t t, void* stacks,
    void* out_q, void* out_lp, void* out_h, void* out_acc, void* out_depth,
    void* out_n_leap, void* out_turning, void* out_divergent, void* stream) {
  if (n_chains < 1 || dim < 1 || dim > kMaxDim || max_depth < 1 ||
      max_depth > kMaxDepth || !noise_ok(eps, u_dir, u_leaf, u_merge))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, inv_mass, step_size, eps, u_dir, u_leaf, u_merge, n_chains,
                     dim, max_depth, max_delta_energy, key0, key1, t, stacks, out_q,
                     out_lp, out_h, out_acc, out_depth, out_n_leap, out_turning,
                     out_divergent);
  a.loc = static_cast<const float*>(loc);
  a.inv_var = static_cast<const float*>(inv_var);
  return dispatch(a, static_cast<cudaStream_t>(stream));
}

// The same transition on a built-in density over several latents with data
// (density: zs::DensityId 3-7, csrc/densities.cuh): data is its float32 table
// of n_rows rows, consts its float32 constants, dim <= 16; the stacks' scratch
// buffer as above. The rest as zs_fused_nuts_transition.
extern "C" int zs_fused_nuts_transition_data(
    int density, const void* data, const void* consts, int n_rows, const void* q,
    const void* inv_mass, const void* step_size, const void* eps, const void* u_dir,
    const void* u_leaf, const void* u_merge, int n_chains, int dim, int max_depth,
    float max_delta_energy, uint32_t key0, uint32_t key1, uint32_t t, void* stacks,
    void* out_q, void* out_lp, void* out_h, void* out_acc, void* out_depth,
    void* out_n_leap, void* out_turning, void* out_divergent, void* stream) {
  if (n_chains < 1 || dim < 1 || max_depth < 1 || max_depth > kMaxDepth ||
      n_rows < 1 || data == nullptr || consts == nullptr ||
      !noise_ok(eps, u_dir, u_leaf, u_merge))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, inv_mass, step_size, eps, u_dir, u_leaf, u_merge, n_chains,
                     dim, max_depth, max_delta_energy, key0, key1, t, stacks, out_q,
                     out_lp, out_h, out_acc, out_depth, out_n_leap, out_turning,
                     out_divergent);
  a.dens_data = static_cast<const float*>(data);
  a.dens_consts = static_cast<const float*>(consts);
  a.n_rows = n_rows;
  return dispatch_carried(density, a, static_cast<cudaStream_t>(stream));
}
