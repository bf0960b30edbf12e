// Stochastic-gradient MCMC kernels for Hopper (sm_90a): one warp per chain,
// one body, four modes.
//
// Replaces four Pallas TPU kernels of zhusuan_tpu/ops, each an entry point
// below and an instantiation of one templated body (`sgmcmc_kernel`):
//   zs_fused_sgld_step   ops/sgld_step.py::fused_sgld_step (pallas_call at
//                        :86): q' = q + 0.5 lr g(q) + sqrt(lr) eps;
//   zs_fused_psgld_step  ops/psgld_step.py::fused_psgld_step (:102): the
//                        RMSprop accumulator rms' = decay rms + (1-decay) g^2,
//                        G = 1/(epsilon + sqrt(rms')), then
//                        q' = q + 0.5 lr G g + sqrt(lr G) eps;
//   zs_fused_sghmc_step  ops/sghmc_step.py::fused_sghmc_step (:117): the first-
//                        or second-order SGHMC integrator with friction alpha
//                        and noise sqrt(max(2 (alpha - beta) lr, 0)) eps, and
//                        the per-chain sum of v'^2;
//   zs_fused_sgnht_step  ops/sgnht_step.py::fused_sgnht_step (:124): SGNHT with
//                        a per-coordinate thermostat, first or second order.
// eps is drawn in the kernel (counter-based Philox4x32-10, mantissa uniforms,
// Box-Muller using both outputs) unless the caller injects it. The gradient
// is that of one of the built-in densities of densities.cuh (a CUDA kernel
// cannot trace a user closure the way a Pallas kernel does), chosen by id.
//
// Momentum resampling (SGHMC, SGNHT: every n_iter_resample_v iterations) is
// decided on the host from the iteration counter, outside the kernel, as in
// the JAX package. When the host says this iteration resamples, the kernel
// takes v = sqrt(lr) N(0, 1) from its own Philox stream in place of the
// carried v before the integrator, in the same pass over the state.
//
// What bounds it on an H100: per chain-iteration each mode reads its state
// (q; q, rms; q, v; q, v, alpha) once and writes it once, and does a few tens
// of operations per element (Philox and Box-Muller for each draw, the
// gradient, the update), so at the main path's 32768 x 100 float32 the bound
// is device-memory bandwidth: 26 to 79 MB at 3.35 TB/s, 8 to 24 us. This
// first version keeps the HMC kernels' layout: lane l of a warp owns the
// groups of 4 contiguous elements g = l + 32 k (k < K), so one Philox call
// yields exactly the 4 normals its lane needs, and a row sum (the
// equicorrelated density's gradient, SGHMC's sum of v'^2) is a warp shuffle
// sum. Loads are 4-byte and the row is not staged through shared memory.
//
// SGLD on the diagonal density at dim % 4 == 0 (the main path's 32768 x 100)
// takes a second body, `sgld_flat_kernel`: the update is elementwise there
// (no row sum), so no warp is needed. [chains, dim] is a flat array of
// groups of 4 elements, one thread a group in a grid-stride loop, every
// load and store 16 bytes (q, the injected eps, q'; the density's loc and
// inv_var as float4), no lane on padding. Flat group i is (chain, grp) =
// (i / (dim / 4), i % (dim / 4)) and draws from the same Philox counter
// (t, chain, grp, 0x200), so q' is bit for bit the warp body's. The
// equicorrelated density, other widths and the PSGLD, SGHMC and SGNHT
// modes keep the warp-per-chain body (ops/sgld_step.py::sgld_layout).
//
// Built with -fmad=false (ops/_build.py), and every expression is written in
// the order of the plain torch version's elementwise ops
// (zhusuan_tpu_torch/mcmc/sgmcmc.py::*_transition), so that each product and
// sum rounds as there: on the same normals the kernel and its plain version
// agree bit for bit on the diagonal density.
//
// A shared library with a plain C interface (nvcc, loaded through ctypes);
// each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "densities.cuh"
#include "philox.cuh"

namespace {

using zs::warp_sum;

constexpr uint32_t kStreamNoise = 0x200u;     // counter word 3 of eps
constexpr uint32_t kStreamResample = 0x201u;  // of a resampled momentum

enum Mode { kSgld = 0, kPsgld = 1, kSghmc = 2, kSgnht = 3 };

// Every pointer a mode may use; a mode ignores the others (null).
struct Args {
  const float* q;       // [c, d]
  const float* v;       // [c, d] momentum (SGHMC, SGNHT)
  const float* aux;     // [c, d] rms (PSGLD) or alpha (SGNHT)
  const float* dens0;   // density parameters (densities.cuh)
  const float* dens1;
  const float* lr_dev;  // [1] learning rate on the device, or null
  float lr_host;        // the learning rate when lr_dev is null
  const float* eps;     // [c, d] injected integrator normals, or null
  const float* eps_v;   // [c, d] injected resample normals, or null
  int n_chains, dim;
  uint32_t key0, key1, t;
  int second_order;     // SGHMC, SGNHT
  int resample;         // SGHMC, SGNHT: replace v by sqrt(lr) N(0, 1)
  // Mode constants, rounded to float on the host:
  //   PSGLD: decay, 1 - decay, epsilon;
  //   SGHMC: 2 (alpha - beta), 1 - alpha, exp(-alpha / 2);
  //   SGNHT: 2 a, tune_rate, 0.5 tune_rate.
  float c0, c1, c2;
  float* out_q;         // [c, d]
  float* out_v;         // [c, d] (SGHMC, SGNHT)
  float* out_aux;       // [c, d] rms' (PSGLD) or alpha' (SGNHT)
  float* out_vsq;       // [c] sum_d v'^2 (SGHMC)
};

// The 4 normals of columns 4 grp .. 4 grp + 3 of row `chain`: injected, or
// drawn from Philox stream `stream`.
__device__ __forceinline__ void draw4(const float* injected, size_t row,
                                      int grp, int dim, const Args& a,
                                      uint32_t chain, uint32_t stream,
                                      float (&n)[4]) {
  if (injected != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = grp * 4 + i;
      n[i] = j < dim ? injected[row + j] : 0.0f;
    }
  } else {
    zs::normals4(a.t, chain, static_cast<uint32_t>(grp), stream, a.key0,
                 a.key1, n);
  }
}

// K = groups of 4 elements per lane; the kernel covers dim <= 128 * K.
template <int K, template <int> class Density, int M>
__global__ void __launch_bounds__(256) sgmcmc_kernel(const Args a) {
  constexpr int E = 4 * K;
  constexpr bool kHasV = M == kSghmc || M == kSgnht;
  constexpr bool kHasAux = M == kPsgld || M == kSgnht;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= a.n_chains) return;  // whole warps exit together
  const uint32_t chain = static_cast<uint32_t>(warp);
  const int dim = a.dim;
  const size_t row = static_cast<size_t>(warp) * dim;
  const float lr = a.lr_dev != nullptr ? *a.lr_dev : a.lr_host;
  const float sq = sqrtf(lr);

  Density<K> dens;
  dens.load(a.dens0, a.dens1, lane, dim);
  // x: position; v: momentum (after a resample); aux: rms or alpha;
  // nz: the integrator's standard normals (0 on padding columns).
  float x[E], v[E], aux[E], nz[E], g[E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int grp = k * 32 + lane;
    float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float nv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (grp * 4 < dim) {
      draw4(a.eps, row, grp, dim, a, chain, kStreamNoise, n);
      if (kHasV && a.resample)
        draw4(a.eps_v, row, grp, dim, a, chain, kStreamResample, nv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = k * 4 + i;
      const int j = grp * 4 + i;
      const bool ok = j < dim;
      x[e] = ok ? a.q[row + j] : 0.0f;
      nz[e] = ok ? n[i] : 0.0f;
      v[e] = 0.0f;
      aux[e] = 0.0f;
      if (kHasV && ok) v[e] = a.resample ? sq * nv[i] : a.v[row + j];
      if (kHasAux && ok) aux[e] = a.aux[row + j];
    }
  }

  float nq[E], nv[E], naux[E];
  if (M == kSgld) {
    // q + (0.5 lr) g + sqrt(lr) eps
    const float half_lr = 0.5f * lr;
    dens.grad(x, g);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float drift = x[e] + half_lr * g[e];
      nq[e] = drift + sq * nz[e];
    }
  } else if (M == kPsgld) {
    const float half_lr = 0.5f * lr;
    dens.grad(x, g);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float gg = g[e] * g[e];
      const float r = a.c0 * aux[e] + a.c1 * gg;
      const float precond = 1.0f / (a.c2 + sqrtf(r));
      const float step = (half_lr * precond) * g[e];
      const float noise = sqrtf(lr * precond) * nz[e];
      nq[e] = (x[e] + step) + noise;
      naux[e] = r;
    }
  } else if (M == kSghmc) {
    const float noise_sd = sqrtf(fmaxf(a.c0 * lr, 0.0f));
    if (!a.second_order) {
      dens.grad(x, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float noise = noise_sd * nz[e];
        nv[e] = (a.c1 * v[e] + lr * g[e]) + noise;
        nq[e] = x[e] + nv[e];
      }
    } else {
      const float dh = a.c2;
      float x1[E];
#pragma unroll
      for (int e = 0; e < E; ++e) x1[e] = x[e] + 0.5f * v[e];
      dens.grad(x1, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float noise = noise_sd * nz[e];
        nv[e] = dh * ((dh * v[e] + lr * g[e]) + noise);
        nq[e] = x1[e] + 0.5f * nv[e];
      }
    }
  } else {  // kSgnht, per-coordinate thermostat
    const float noise_sd = sqrtf(a.c0 * lr);
    const float tune = a.c1, half_tune = a.c2;
    if (!a.second_order) {
      dens.grad(x, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float noise = noise_sd * nz[e];
        nv[e] = ((1.0f - aux[e]) * v[e] + lr * g[e]) + noise;
        nq[e] = x[e] + nv[e];
        naux[e] = aux[e] + tune * (nv[e] * nv[e] - lr);
      }
    } else {
      float x1[E], dh[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x1[e] = x[e] + 0.5f * v[e];
        aux[e] = aux[e] + half_tune * (v[e] * v[e] - lr);  // alpha1
        dh[e] = expf(-0.5f * aux[e]);
      }
      dens.grad(x1, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float noise = noise_sd * nz[e];
        nv[e] = dh[e] * ((dh[e] * v[e] + lr * g[e]) + noise);
        nq[e] = x1[e] + 0.5f * nv[e];
        naux[e] = aux[e] + half_tune * (nv[e] * nv[e] - lr);
      }
    }
  }

  double vsq = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = 4 * (32 * (e / 4) + lane) + e % 4;
    if (j < dim) {
      a.out_q[row + j] = nq[e];
      if (kHasV) a.out_v[row + j] = nv[e];
      if (kHasAux) a.out_aux[row + j] = naux[e];
      // In double, which is exact for these widths, as the plain version
      // sums: the order of the warp butterflies then does not matter.
      if (M == kSghmc) vsq += static_cast<double>(nv[e] * nv[e]);
    }
  }
  if (M == kSghmc) {
    vsq = warp_sum(vsq);
    if (lane == 0) a.out_vsq[chain] = static_cast<float>(vsq);
  }
}

// SGLD, diagonal density, dim % 4 == 0: thread i of the grid-stride loop
// updates flat group i of [chains, dim / 4] (see the top of the file).
template <typename Index, bool kInjected>
__global__ void __launch_bounds__(256)
    sgld_flat_kernel(const Args a, Index n_groups, uint32_t row_groups) {
  const float lr = a.lr_dev != nullptr ? *a.lr_dev : a.lr_host;
  const float sq = sqrtf(lr);
  const float half_lr = 0.5f * lr;
  const float4* q4 = reinterpret_cast<const float4*>(a.q);
  const float4* mu4 = reinterpret_cast<const float4*>(a.dens0);
  const float4* w4 = reinterpret_cast<const float4*>(a.dens1);
  const float4* eps4 = reinterpret_cast<const float4*>(a.eps);
  float4* out4 = reinterpret_cast<float4*>(a.out_q);
  const Index step = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_groups; i += step) {
    const Index chain = i / row_groups;
    const uint32_t grp = static_cast<uint32_t>(i - chain * row_groups);
    const float4 x = q4[i];
    const float4 mu = __ldg(mu4 + grp);
    const float4 w = __ldg(w4 + grp);
    float nz[4];
    if (kInjected) {
      const float4 e = eps4[i];
      nz[0] = e.x;
      nz[1] = e.y;
      nz[2] = e.z;
      nz[3] = e.w;
    } else {
      zs::normals4(a.t, static_cast<uint32_t>(chain), grp, kStreamNoise,
                   a.key0, a.key1, nz);
    }
    // The warp body's SGLD arithmetic: g = -(x - mu) w, then
    // q + (0.5 lr) g + sqrt(lr) eps.
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ms[4] = {mu.x, mu.y, mu.z, mu.w};
    const float ws[4] = {w.x, w.y, w.z, w.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float g = -(xs[e] - ms[e]) * ws[e];
      const float drift = xs[e] + half_lr * g;
      o[e] = drift + sq * nz[e];
    }
    out4[i] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

constexpr int kMaxDevices = 64;

// The grid is as many blocks as the card holds at once (SMs x resident
// blocks an SM, read once per device and instantiation), so no block waits
// for a second wave; each thread loops over its groups.
template <typename Index, bool kInjected>
int launch_flat(const Args& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  static std::atomic<int> resident[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int count = resident[device].load(std::memory_order_relaxed);
  if (count == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sgld_flat_kernel<Index, kInjected>, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    count = sms * (per_sm > 0 ? per_sm : 1);
    resident[device].store(count, std::memory_order_relaxed);
  }
  const uint32_t row_groups = static_cast<uint32_t>(a.dim / 4);
  const Index n_groups = static_cast<Index>(a.n_chains) * row_groups;
  const unsigned long long wanted =
      (static_cast<unsigned long long>(n_groups) + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      wanted < static_cast<unsigned long long>(count) ? wanted : count);
  sgld_flat_kernel<Index, kInjected>
      <<<blocks, kThreads, 0, stream>>>(a, n_groups, row_groups);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_flat(int density, const Args& a, void* stream) {
  if (a.n_chains < 1 || a.dim < 4 || a.dim % 4 != 0 ||
      density != zs::kDiagonalGaussian || a.dens0 == nullptr ||
      a.dens1 == nullptr || a.q == nullptr || a.out_q == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long groups =
      static_cast<unsigned long long>(a.n_chains) * (a.dim / 4);
  const bool injected = a.eps != nullptr;
  if (groups <= 0xFFFFFFFFull - 0xFFFFFFull) {  // i + step stays below 2^32
    return injected ? launch_flat<uint32_t, true>(a, s)
                    : launch_flat<uint32_t, false>(a, s);
  }
  return injected ? launch_flat<unsigned long long, true>(a, s)
                  : launch_flat<unsigned long long, false>(a, s);
}

template <int K, template <int> class Density, int M>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 chains per block
  const long long blocks =
      (static_cast<long long>(a.n_chains) * 32 + kThreads - 1) / kThreads;
  sgmcmc_kernel<K, Density, M>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
}

template <template <int> class Density, int M>
int dispatch_k(const Args& a, cudaStream_t stream) {
  const int groups = (a.dim + 3) / 4;
  if (groups <= 32) {
    launch<1, Density, M>(a, stream);
  } else if (groups <= 64) {
    launch<2, Density, M>(a, stream);
  } else if (groups <= 128) {
    launch<4, Density, M>(a, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int dispatch(int density, const Args& a, void* stream) {
  if (a.n_chains < 1 || a.dim < 1 || a.dens0 == nullptr || a.q == nullptr ||
      a.out_q == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (density) {
    case zs::kDiagonalGaussian:
      if (a.dens1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_k<zs::DiagonalGaussian, M>(a, s);
    case zs::kEquicorrelatedGaussian:
      return dispatch_k<zs::EquicorrelatedGaussian, M>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const float* f(const void* ptr) { return static_cast<const float*>(ptr); }
float* o(void* ptr) { return static_cast<float*>(ptr); }

Args common(const void* q, const void* dens0, const void* dens1,
            const void* lr_dev, float lr_host, const void* eps, int n_chains,
            int dim, uint32_t key0, uint32_t key1, uint32_t t, void* out_q) {
  Args a{};
  a.q = f(q);
  a.dens0 = f(dens0);
  a.dens1 = f(dens1);
  a.lr_dev = f(lr_dev);
  a.lr_host = lr_host;
  a.eps = f(eps);
  a.n_chains = n_chains;
  a.dim = dim;
  a.key0 = key0;
  a.key1 = key1;
  a.t = t;
  a.out_q = o(out_q);
  return a;
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pointers are device pointers to float32 arrays. density is a DensityId of
// densities.cuh with its parameter arrays dens0, dens1. The learning rate is
// *lr_dev when lr_dev is not null, else lr_host. eps (and eps_v) may be
// null: the kernel then draws them from Philox keyed by (key0, key1) with
// counter (t, chain, group, stream). Each returns the CUDA error code of the
// launch (0 on success).
//
// SGLD: flat != 0 takes the flat body (ops/sgld_step.py::sgld_layout): the
// diagonal density at dim % 4 == 0, with q, eps, out_q and the density's
// arrays 16-byte aligned; anything else is refused.
extern "C" int zs_fused_sgld_step(const void* q, int density,
                                  const void* dens0, const void* dens1,
                                  const void* lr_dev, float lr_host,
                                  const void* eps, int n_chains, int dim,
                                  uint32_t key0, uint32_t key1, uint32_t t,
                                  int flat, void* out_q, void* stream) {
  const Args a = common(q, dens0, dens1, lr_dev, lr_host, eps, n_chains, dim,
                        key0, key1, t, out_q);
  if (flat) return dispatch_flat(density, a, stream);
  return dispatch<kSgld>(density, a, stream);
}

extern "C" int zs_fused_psgld_step(const void* q, const void* rms, int density,
                                   const void* dens0, const void* dens1,
                                   const void* lr_dev, float lr_host,
                                   float decay, float one_minus_decay,
                                   float epsilon, const void* eps,
                                   int n_chains, int dim, uint32_t key0,
                                   uint32_t key1, uint32_t t, void* out_q,
                                   void* out_rms, void* stream) {
  Args a = common(q, dens0, dens1, lr_dev, lr_host, eps, n_chains, dim, key0,
                  key1, t, out_q);
  if (rms == nullptr || out_rms == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.aux = f(rms);
  a.c0 = decay;
  a.c1 = one_minus_decay;
  a.c2 = epsilon;
  a.out_aux = o(out_rms);
  return dispatch<kPsgld>(density, a, stream);
}

// two_alpha_minus_beta = 2 (alpha - beta), decay_half = exp(-alpha / 2).
// With resample != 0, v is not read: the kernel draws sqrt(lr) N(0, 1)
// (eps_v when injected) in its place.
extern "C" int zs_fused_sghmc_step(
    const void* q, const void* v, int density, const void* dens0,
    const void* dens1, const void* lr_dev, float lr_host,
    float two_alpha_minus_beta, float one_minus_alpha, float decay_half,
    int second_order, int resample, const void* eps, const void* eps_v,
    int n_chains, int dim, uint32_t key0, uint32_t key1, uint32_t t,
    void* out_q, void* out_v, void* out_vsq, void* stream) {
  Args a = common(q, dens0, dens1, lr_dev, lr_host, eps, n_chains, dim, key0,
                  key1, t, out_q);
  if ((!resample && v == nullptr) || out_v == nullptr || out_vsq == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.v = f(v);
  a.eps_v = f(eps_v);
  a.second_order = second_order;
  a.resample = resample;
  a.c0 = two_alpha_minus_beta;
  a.c1 = one_minus_alpha;
  a.c2 = decay_half;
  a.out_v = o(out_v);
  a.out_vsq = o(out_vsq);
  return dispatch<kSghmc>(density, a, stream);
}

// two_a = 2 variance_extra; alpha is the per-coordinate thermostat [c, d].
extern "C" int zs_fused_sgnht_step(
    const void* q, const void* v, const void* alpha, int density,
    const void* dens0, const void* dens1, const void* lr_dev, float lr_host,
    float two_a, float tune_rate, float half_tune_rate, int second_order,
    int resample, const void* eps, const void* eps_v, int n_chains, int dim,
    uint32_t key0, uint32_t key1, uint32_t t, void* out_q, void* out_v,
    void* out_alpha, void* stream) {
  Args a = common(q, dens0, dens1, lr_dev, lr_host, eps, n_chains, dim, key0,
                  key1, t, out_q);
  if ((!resample && v == nullptr) || alpha == nullptr || out_v == nullptr ||
      out_alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.v = f(v);
  a.aux = f(alpha);
  a.eps_v = f(eps_v);
  a.second_order = second_order;
  a.resample = resample;
  a.c0 = two_a;
  a.c1 = tune_rate;
  a.c2 = half_tune_rate;
  a.out_v = o(out_v);
  a.out_aux = o(out_alpha);
  return dispatch<kSgnht>(density, a, stream);
}
