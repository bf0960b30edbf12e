// Whole-fit mean-field ADVI trainer for Hopper (sm_90a): every Adam step of a
// mean-field SGVB fit in one launch of one thread block.
//
// Replaces the Pallas TPU kernel zhusuan_tpu/ops/advi_step.py::
// fused_meanfield_advi (pallas_call at :270). Per step t, for the Gaussian
// q = N(loc, exp(log_scale)^2) over [dim]:
//   eps [n, dim] standard normals;  sigma = exp(log_scale);
//   z = loc + sigma eps;  F(z) and dF/dz per particle row (a built-in density
//   of densities.cuh);
//   g_loc = -mean(dF/dz);  g_ls = -mean(dF/dz (sigma eps)) - 1   (the exact
//   pathwise gradients of the sgvb loss: the Gaussian entropy term's total
//   derivative is (0, 1));
//   loss_t = -mean F - 0.5 mean|eps|^2 - dim 0.5 log(2 pi) - sum(log_scale);
//   Adam on both vectors: m/v moments, bias corrections c1 = 1 - b1^(t+1),
//   c2 = 1 - b2^(t+1), p -= lr_t (m / c1) / (sqrt(v / c2) + eps_adam).
// Outputs: loc [dim], log_scale [dim], losses [n_steps].
//
// The Pallas kernel makes the step loop its sequential grid and keeps the
// parameters and moments in VMEM scratch between grid steps. Blocks of a CUDA
// grid run in no order and share nothing, so here the step loop is a loop
// inside ONE block: loc, log_scale and the four Adam moments live in shared
// memory for the whole fit, and nothing but one loss per step is written to
// device memory before the end. Two layouts, by width:
//   dim > 4 (advi_kernel): a warp owns a particle row (rows strided over the
//     block's warps; lane l holds the groups of 4 columns l + 32 k, the
//     layout of the sampler kernels, so densities.cuh serves as it is and
//     one Philox call gives a lane's 4 normals). Each lane sums its columns'
//     gradient terms over its rows in double; the warps' partial sums meet
//     in shared memory and thread j adds column j's in warp order, then
//     updates parameter j.
//   dim <= 4 (advi_rows_kernel; the toy2d recipe's 500 x 2): a row is one
//     Philox group, so a LANE owns a row (rows strided over the block's
//     threads) and evaluates the density by itself (value_and_grad<true>).
//     With a warp per row 31 lanes of 32 idle and the step is bound by
//     instruction issue: 500 rows x ~400 instructions over 4 schedulers,
//     27.8 us per step on an H100, against 16 warps' worth here. Each lane
//     sums its rows' terms in double, a warp butterfly and warp 0's
//     butterfly over the 32 warps' partial sums give the totals, and lanes
//     0 .. dim-1 of warp 0 update the parameters.
// Two __syncthreads per step either way.
//
// The Pallas kernel evaluates an arbitrary traced density and schedule. A
// CUDA kernel cannot: the density is one of the built-ins (by id), and the
// host evaluates the schedule and the bias corrections into the
// [n_steps, 3] table (lr_t, c1, c2) that both this kernel and its plain
// version read.
//
// Noise: Philox4x32-10 with counter (step, particle row, group, 0x300)
// unless the caller injects [n_steps, n, dim] normals. Both Box-Muller
// outputs fall into one row, so the particle count need not be even (the TPU
// kernel fills row halves and needs it).
//
// What bounds it on an H100: by the formula, operations (per step about 60
// per particle-element, over the float32 peak: nanoseconds). The real floor
// is latency: n_steps dependent steps on one SM, each a few rows of Philox,
// Box-Muller and density per warp (per lane at dim <= 4), two barriers and
// the sums across warps.
//
// Built with -fmad=false; every float expression is written in the order of
// the plain torch version (ops/advi_step.py::fused_meanfield_advi_reference)
// and every mean over particles is accumulated in double and rounded once on
// both sides, so the two agree bit for bit while the double sums are exact.
//
// A shared library with a plain C interface; the entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "densities.cuh"
#include "philox.cuh"

namespace {

using zs::warp_sum;

struct Args {
  const float* dens0;  // density parameters (densities.cuh)
  const float* dens1;
  const float* loc0;   // [dim]
  const float* ls0;    // [dim]
  const float* table;  // [n_steps, 3]: lr_t, 1 - b1^(t+1), 1 - b2^(t+1)
  const float* noise;  // [n_steps, n_particles, dim] injected normals or null
  int n_steps, n_particles, dim;
  float b1, one_minus_b1, b2, one_minus_b2, adam_eps;
  float loss_const;    // dim * 0.5 log(2 pi), rounded to float on the host
  uint32_t key0, key1;
  float* out_loc;      // [dim]
  float* out_ls;       // [dim]
  float* out_losses;   // [n_steps]
};

// Warps per block: 32, or 16 at K = 4 so that the partial sums of 512
// columns fit shared memory.
template <int K>
struct Block {
  static constexpr int kWarps = K == 4 ? 16 : 32;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWidth = 128 * K;  // padded columns
  static constexpr size_t kSharedBytes =
      sizeof(double) * (2 * kWarps * kWidth + 2 * kWarps) +
      sizeof(float) * 6 * kWidth;
};

__device__ __forceinline__ float adam(float p, float g, float* m_ref,
                                      float* v_ref, const Args& a, float lr,
                                      float c1, float c2) {
  const float m = a.b1 * *m_ref + a.one_minus_b1 * g;
  const float v = a.b2 * *v_ref + (a.one_minus_b2 * g) * g;
  *m_ref = m;
  *v_ref = v;
  return p - (lr * (m / c1)) / (sqrtf(v / c2) + a.adam_eps);
}

// K = groups of 4 columns per lane; the kernel covers dim <= 128 * K.
template <int K, template <int> class Density>
__global__ void __launch_bounds__(Block<K>::kThreads, 1)
    advi_kernel(const Args a) {
  constexpr int E = 4 * K;
  constexpr int W = Block<K>::kWarps;
  constexpr int DP = Block<K>::kWidth;
  extern __shared__ double shared[];
  double* red_g = shared;            // [W][DP] per-warp sums of dF/dz
  double* red_gs = red_g + W * DP;   // [W][DP] of dF/dz (sigma eps)
  double* red_f = red_gs + W * DP;   // [W] of F
  double* red_e = red_f + W;         // [W] of |eps|^2
  float* loc = reinterpret_cast<float*>(red_e + W);  // [DP] each
  float* ls = loc + DP;
  float* m_l = ls + DP;
  float* v_l = m_l + DP;
  float* m_s = v_l + DP;
  float* v_s = m_s + DP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dim = a.dim;
  const int n = a.n_particles;
  const double inv_n = 1.0 / static_cast<double>(n);

  for (int j = tid; j < DP; j += Block<K>::kThreads) {
    loc[j] = j < dim ? a.loc0[j] : 0.0f;
    ls[j] = j < dim ? a.ls0[j] : 0.0f;
    m_l[j] = 0.0f;
    v_l[j] = 0.0f;
    m_s[j] = 0.0f;
    v_s[j] = 0.0f;
  }
  Density<K> dens;
  dens.load(a.dens0, a.dens1, lane, dim);
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    // This lane's columns of the current parameters (padding: loc 0,
    // sigma 1 against eps 0).
    float mu[E], sigma[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      mu[e] = loc[j];
      sigma[e] = expf(ls[j]);
    }
    // sum(log_scale) of the loss, before this step's update (warp 0).
    float sum_ls = 0.0f;
    if (warp == 0) {
      double s = 0.0;
      for (int j = lane; j < dim; j += 32) s += static_cast<double>(ls[j]);
      sum_ls = static_cast<float>(warp_sum(s));
    }

    double acc_g[E], acc_gs[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc_g[e] = 0.0;
      acc_gs[e] = 0.0;
    }
    double acc_f = 0.0, acc_e = 0.0;
    for (int row = warp; row < n; row += W) {
      float se[E], z[E], g[E];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int grp = k * 32 + lane;
        float nz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (grp * 4 < dim) {
          if (a.noise != nullptr) {
            const size_t base =
                (static_cast<size_t>(t) * n + row) * static_cast<size_t>(dim);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = grp * 4 + i;
              if (j < dim) nz[i] = a.noise[base + j];
            }
          } else {
            zs::normals4(static_cast<uint32_t>(t), static_cast<uint32_t>(row),
                         static_cast<uint32_t>(grp), zs::kStreamAdviNoise,
                         a.key0, a.key1, nz);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = k * 4 + i;
          const float eps = grp * 4 + i < dim ? nz[i] : 0.0f;
          se[e] = sigma[e] * eps;
          z[e] = mu[e] + se[e];
          acc_e += static_cast<double>(eps * eps);
        }
      }
      const float f = dens.value_and_grad(z, g);
      acc_f += static_cast<double>(f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc_g[e] += static_cast<double>(g[e]);
        acc_gs[e] += static_cast<double>(g[e] * se[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      red_g[warp * DP + j] = acc_g[e];
      red_gs[warp * DP + j] = acc_gs[e];
    }
    acc_e = warp_sum(acc_e);
    if (lane == 0) {
      red_f[warp] = acc_f;  // F is the same on every lane
      red_e[warp] = acc_e;
    }
    __syncthreads();

    const float lr = a.table[3 * t];
    const float c1 = a.table[3 * t + 1];
    const float c2 = a.table[3 * t + 2];
    if (tid < dim) {
      double s_g = 0.0, s_gs = 0.0;
#pragma unroll 8
      for (int w = 0; w < W; ++w) {
        s_g += red_g[w * DP + tid];
        s_gs += red_gs[w * DP + tid];
      }
      const float mean_g = static_cast<float>(s_g * inv_n);
      const float mean_gs = static_cast<float>(s_gs * inv_n);
      const float g_loc = -mean_g;
      const float g_ls = -mean_gs - 1.0f;
      loc[tid] = adam(loc[tid], g_loc, &m_l[tid], &v_l[tid], a, lr, c1, c2);
      ls[tid] = adam(ls[tid], g_ls, &m_s[tid], &v_s[tid], a, lr, c1, c2);
    }
    if (tid == 0) {
      double s_f = 0.0, s_e = 0.0;
      for (int w = 0; w < W; ++w) {
        s_f += red_f[w];
        s_e += red_e[w];
      }
      const float mean_f = static_cast<float>(s_f * inv_n);
      const float mean_e2 = static_cast<float>(s_e * inv_n);
      a.out_losses[t] =
          ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;
    }
    __syncthreads();
  }
  if (tid < dim) {
    a.out_loc[tid] = loc[tid];
    a.out_ls[tid] = ls[tid];
  }
}

// dim <= 4: a lane per particle row (see the top of the file).
template <template <int> class Density>
__global__ void __launch_bounds__(1024, 1) advi_rows_kernel(const Args a) {
  constexpr int E = 4;
  constexpr int W = 32;                // warps
  constexpr int Q = 2 * E + 2;         // sums: g[E], g sigma eps [E], F, eps^2
  __shared__ double red[Q][W];
  __shared__ float loc[E], ls[E], m_l[E], v_l[E], m_s[E], v_s[E];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dim = a.dim;
  const int n = a.n_particles;
  const double inv_n = 1.0 / static_cast<double>(n);

  if (tid < E) {
    loc[tid] = tid < dim ? a.loc0[tid] : 0.0f;
    ls[tid] = tid < dim ? a.ls0[tid] : 0.0f;
    m_l[tid] = 0.0f;
    v_l[tid] = 0.0f;
    m_s[tid] = 0.0f;
    v_s[tid] = 0.0f;
  }
  Density<1> dens;
  dens.load(a.dens0, a.dens1, 0, dim);  // every lane: columns 0 .. 3
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    float mu[E], sigma[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mu[e] = loc[e];
      sigma[e] = expf(ls[e]);  // padding: sigma 1 against eps 0
    }
    double acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0;
    for (int row = tid; row < n; row += 32 * W) {
      float nz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a.noise != nullptr) {
        const size_t base =
            (static_cast<size_t>(t) * n + row) * static_cast<size_t>(dim);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < dim) nz[i] = a.noise[base + i];
      } else {
        zs::normals4(static_cast<uint32_t>(t), static_cast<uint32_t>(row), 0u,
                     zs::kStreamAdviNoise, a.key0, a.key1, nz);
      }
      float se[E], z[E], g[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float eps = e < dim ? nz[e] : 0.0f;
        se[e] = sigma[e] * eps;
        z[e] = mu[e] + se[e];
        acc[2 * E + 1] += static_cast<double>(eps * eps);
      }
      const float f = dens.template value_and_grad<true>(z, g);
      acc[2 * E] += static_cast<double>(f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[e] += static_cast<double>(g[e]);
        acc[E + e] += static_cast<double>(g[e] * se[e]);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const double v = warp_sum(acc[q]);
      if (lane == 0) red[q][warp] = v;
    }
    __syncthreads();

    if (warp == 0) {
      double tot[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) tot[q] = warp_sum(red[q][lane]);
      // sum(log_scale) of the loss, before this step's update.
      double s = 0.0;
      for (int j = 0; j < dim; ++j) s += static_cast<double>(ls[j]);
      const float sum_ls = static_cast<float>(s);
      __syncwarp();
      const float lr = a.table[3 * t];
      const float c1 = a.table[3 * t + 1];
      const float c2 = a.table[3 * t + 2];
      if (lane < dim) {
        double s_g = 0.0, s_gs = 0.0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e == lane) {
            s_g = tot[e];
            s_gs = tot[E + e];
          }
        }
        const float mean_g = static_cast<float>(s_g * inv_n);
        const float mean_gs = static_cast<float>(s_gs * inv_n);
        const float g_loc = -mean_g;
        const float g_ls = -mean_gs - 1.0f;
        loc[lane] =
            adam(loc[lane], g_loc, &m_l[lane], &v_l[lane], a, lr, c1, c2);
        ls[lane] = adam(ls[lane], g_ls, &m_s[lane], &v_s[lane], a, lr, c1, c2);
      }
      if (lane == 0) {
        const float mean_f = static_cast<float>(tot[2 * E] * inv_n);
        const float mean_e2 = static_cast<float>(tot[2 * E + 1] * inv_n);
        a.out_losses[t] =
            ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;
      }
    }
    __syncthreads();
  }
  if (tid < dim) {
    a.out_loc[tid] = loc[tid];
    a.out_ls[tid] = ls[tid];
  }
}

constexpr int kMaxDevices = 64;

template <int K, template <int> class Density>
int launch(const Args& a, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a launch is refused unless the
  // function's limit is raised first: once per device and instantiation, on
  // its first launch there.
  static std::atomic<bool> limit_set[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limit_set[device].load(std::memory_order_acquire)) {
    rc = cudaFuncSetAttribute(
        advi_kernel<K, Density>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Block<K>::kSharedBytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    limit_set[device].store(true, std::memory_order_release);
  }
  advi_kernel<K, Density>
      <<<1, Block<K>::kThreads, Block<K>::kSharedBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <template <int> class Density>
int launch_rows(const Args& a, cudaStream_t stream) {
  advi_rows_kernel<Density><<<1, 1024, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <template <int> class Density>
int dispatch_k(const Args& a, cudaStream_t stream) {
  const int groups = (a.dim + 3) / 4;
  if (groups == 1) return launch_rows<Density>(a, stream);
  if (groups <= 32) return launch<1, Density>(a, stream);
  if (groups <= 64) return launch<2, Density>(a, stream);
  if (groups <= 128) return launch<4, Density>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const float* f(const void* ptr) { return static_cast<const float*>(ptr); }

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pointers are device pointers to float32 arrays. density is a DensityId of
// densities.cuh with its parameter arrays dens0, dens1. table is
// [n_steps, 3] (lr_t, 1 - b1^(t+1), 1 - b2^(t+1)). noise may be null: the
// kernel then draws from Philox keyed by (key0, key1). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int zs_fused_meanfield_advi(
    int density, const void* dens0, const void* dens1, const void* loc0,
    const void* ls0, const void* table, const void* noise, int n_steps,
    int n_particles, int dim, float b1, float one_minus_b1, float b2,
    float one_minus_b2, float adam_eps, float loss_const, uint32_t key0,
    uint32_t key1, void* out_loc, void* out_ls, void* out_losses,
    void* stream) {
  if (n_steps < 1 || n_particles < 1 || dim < 1 || dens0 == nullptr ||
      loc0 == nullptr || ls0 == nullptr || table == nullptr ||
      out_loc == nullptr || out_ls == nullptr || out_losses == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.dens0 = f(dens0);
  a.dens1 = f(dens1);
  a.loc0 = f(loc0);
  a.ls0 = f(ls0);
  a.table = f(table);
  a.noise = f(noise);
  a.n_steps = n_steps;
  a.n_particles = n_particles;
  a.dim = dim;
  a.b1 = b1;
  a.one_minus_b1 = one_minus_b1;
  a.b2 = b2;
  a.one_minus_b2 = one_minus_b2;
  a.adam_eps = adam_eps;
  a.loss_const = loss_const;
  a.key0 = key0;
  a.key1 = key1;
  a.out_loc = static_cast<float*>(out_loc);
  a.out_ls = static_cast<float*>(out_ls);
  a.out_losses = static_cast<float*>(out_losses);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (density) {
    case zs::kDiagonalGaussian:
      if (dens1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_k<zs::DiagonalGaussian>(a, s);
    case zs::kEquicorrelatedGaussian:
      return dispatch_k<zs::EquicorrelatedGaussian>(a, s);
    case zs::kToy2D:
      if (dim != 2) return static_cast<int>(cudaErrorInvalidValue);
      return launch_rows<zs::Toy2D>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
