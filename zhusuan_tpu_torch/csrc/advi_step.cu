// Whole-fit mean-field ADVI trainer for Hopper (sm_90a): every Adam step of a
// mean-field SGVB fit in one launch, spread over one thread-block cluster.
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
// parameters and moments in VMEM scratch between grid steps. Here the step
// loop is a loop inside the kernel, and the particle rows of a step are
// split over the C blocks (1-16) of ONE cluster on neighbouring SMs
// (ops/advi_step.py::advi_layout chooses C and the warps a block, W, by
// measurement). Every block keeps a replica of the parameters and the four
// Adam moments and updates it from the same totals, summed in the same
// fixed order, so the replicas stay identical with no broadcast. A step:
//   1. each block evaluates its rows and sums, in double, its share of
//      sum_rows dF/dz and dF/dz (sigma eps) per column, F and |eps|^2;
//   2. it pushes those partial sums into its slot of EVERY block's shared
//      memory (distributed shared memory) by st.async, double-buffered by
//      the parity of t. Each store counts down the bytes the receiver's
//      transaction barrier (an mbarrier, one per buffer) expects for the
//      step, so a block waits for its own inputs alone: no cluster
//      barrier, no release fence on the stores. The slots of step t + 2
//      are written only after the writer has received every block's step
//      t + 1, which each block sends after reading step t's;
//   3. while its stores are in flight, each lane draws step t + 1's Philox
//      normals and reads the next row of the schedule table, neither of
//      which takes part in the chain of dependent steps; then it waits;
//   4. every block sums the C (or C W) partials in one fixed order and runs
//      Adam on its replica. Block 0 writes the loss, and the parameters at
//      the end.
// A cluster of one block (the rule's choice while one block holds the rows)
// writes its own slots and takes the block barrier, then draws the noise.
// The first design waited on the cluster barrier, split (arrive.release,
// the noise, wait.acquire): a step took 1.62-1.67 us at toy2d's cluster
// layouts against 1.32 with the transaction barriers (PERF_APPENDIX.md).
// Two layouts, by width:
//   dim <= 4 (advi_lanes_kernel<D>, D = dim; the toy2d recipe's 500 x 2):
//     a LANE owns a particle row (a row is one Philox group) and evaluates
//     the density by itself (value_and_grad<true>). Each lane sums its
//     rows' 2 D + 2 live quantities; a transposed reduce-scatter butterfly
//     (each level exchanges half the values still held: 9 double shuffles
//     at D = 2 where a butterfly per quantity took 30) leaves each quantity
//     on 32 / QP lanes, and those lanes push it, each warp a partial of its
//     own. Every lane keeps the parameters in registers; lane j < 2 D runs
//     the Adam update of parameter j (loc, then log_scale) and the others
//     take it by a shuffle: no shared replica, no block barrier.
//   dim > 4 (advi_warps_kernel<K>): a WARP owns a particle row; lane l holds
//     the groups of 4 columns l + 32 k (k < K), the layout of the sampler
//     kernels, so densities.cuh serves as it is and one Philox call gives a
//     lane's 4 normals. The block's warps meet in shared memory; thread j
//     sums column j over them (one block barrier), pushes it, and after the
//     wait sums the C blocks' partials of column j and updates loc_j and
//     log_scale_j of the block's replica (a second block barrier).
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
// is latency: n_steps dependent steps, each the density of a few rows, a
// warp's butterflies, the exchange and an Adam update. The design puts the
// rows on up to 16 SMs so that a step is one row (or a few) a lane or warp,
// takes the noise off the chain, and makes the exchange one push and one
// wait a step.
//
// Built with -fmad=false; every float expression is written in the order of
// the plain torch version (ops/advi_step.py::fused_meanfield_advi_reference)
// and every mean over particles is accumulated in double and rounded once on
// both sides, so the two agree bit for bit while the double sums are exact.
//
// With -DZS_ADVI_CLOCKS, thread 0 of block 0 adds the cycles (clock64) of
// each part of its steps to a device array that zs_advi_clocks reads: the
// parts are listed at kClockParts.
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

constexpr int kMaxCluster = 16;     // non-portable above 8
constexpr int kMaxWarps = 16;       // warps a block
// The H100's shared memory for a block (232,448 bytes), less the two
// static transaction barriers: the most a launch may ask for.
constexpr int kSharedMax = 232448 - 16;

struct Args {
  const float* dens0;  // density parameters (densities.cuh)
  const float* dens1;
  const float* loc0;   // [dim]
  const float* ls0;    // [dim]
  const float* table;  // [n_steps, 3]: lr_t, 1 - b1^(t+1), 1 - b2^(t+1)
  const float* noise;  // [n_steps, n_particles, dim] injected normals or null
  int n_steps, n_particles, dim;
  int cluster, warps;  // the layout: blocks of the cluster, warps a block
  float b1, one_minus_b1, b2, one_minus_b2, adam_eps;
  float loss_const;    // dim * 0.5 log(2 pi), rounded to float on the host
  uint32_t key0, key1;
  float* out_loc;      // [dim]
  float* out_ls;       // [dim]
  float* out_losses;   // [n_steps]
};

#ifdef ZS_ADVI_CLOCKS
// noise (drawn while the stores fly), density (the rows), reduce (the
// warp's butterflies and, at dim > 4, the block's), exchange (the push, and
// the wait after the noise), adam (the partials' sums, Adam, the block
// barrier at dim > 4), steps. Every thread keeps the sums in
// registers (a stamp is a clock read and an add); thread 0 of block 0
// writes its own at the end.
constexpr int kClockParts = 6;
__device__ unsigned long long g_clocks[kClockParts];
#define ZS_CLOCK_START                      \
  long long zs_clock_last = clock64();      \
  unsigned long long zs_clock_sum[kClockParts] = {}
#define ZS_STAMP(part)                                                  \
  do {                                                                  \
    const long long zs_now = clock64();                                 \
    zs_clock_sum[part] +=                                               \
        static_cast<unsigned long long>(zs_now - zs_clock_last);        \
    zs_clock_last = zs_now;                                             \
  } while (0)
#define ZS_COUNT_STEP zs_clock_sum[5] += 1
#define ZS_CLOCK_FLUSH                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0)                              \
    for (int zs_i = 0; zs_i < kClockParts; ++zs_i)                      \
      g_clocks[zs_i] += zs_clock_sum[zs_i]
#else
#define ZS_CLOCK_START
#define ZS_STAMP(part)
#define ZS_COUNT_STEP
#define ZS_CLOCK_FLUSH
#define ZS_COUNT_STEP
#endif

__device__ __forceinline__ float adam(float p, float g, float* m_ref,
                                      float* v_ref, const Args& a, float lr,
                                      float c1, float c2) {
  const float m = a.b1 * *m_ref + a.one_minus_b1 * g;
  const float v = a.b2 * *v_ref + (a.one_minus_b2 * g) * g;
  *m_ref = m;
  *v_ref = v;
  return p - (lr * (m / c1)) / (sqrtf(v / c2) + a.adam_eps);
}

__device__ __forceinline__ float loss_of(const Args& a, double s_f,
                                         double s_e, double inv_n,
                                         float sum_ls) {
  const float mean_f = static_cast<float>(s_f * inv_n);
  const float mean_e2 = static_cast<float>(s_e * inv_n);
  return ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;
}

// The 4 normals of columns 4 grp .. 4 grp + 3 of particle row `row` at step
// t (0 past dim): injected, or Philox.
__device__ __forceinline__ void draw4(const Args& a, int t, int row, int grp,
                                      float (&nz)[4]) {
  if (a.noise != nullptr) {
    const size_t base = (static_cast<size_t>(t) * a.n_particles + row) *
                        static_cast<size_t>(a.dim);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = grp * 4 + i;
      nz[i] = j < a.dim ? a.noise[base + j] : 0.0f;
    }
  } else {
    zs::normals4(static_cast<uint32_t>(t), static_cast<uint32_t>(row),
                 static_cast<uint32_t>(grp), zs::kStreamAdviNoise, a.key0,
                 a.key1, nz);
  }
}

// The cluster barrier (a block barrier when the cluster is one block): once
// after the transaction barriers are set up, and once before the blocks
// leave.
__device__ __forceinline__ void cluster_sync(int clusters) {
  if (clusters > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// The exchange. A block's partial sums go into every block's slot by
// st.async, whose arrival counts down the bytes the receiver's transaction
// barrier (an mbarrier of its shared memory, one per buffer) expects for
// the step; a block waits on its own barrier alone. The parity of t picks
// the buffer, and a buffer's barrier completes one phase every two steps.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t remote_u32(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    // A lost store must fail the launch, never hang the card.
    if (spin > (1ll << 24)) __trap();
  }
}
__device__ __forceinline__ void st_async_f64(uint32_t dst, double v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "d"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_v2f64(uint32_t dst, double x,
                                               double y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "d"(x), "d"(y), "r"(bar)
      : "memory");
}
// Thread 0 sets up both buffers' barriers; then a cluster barrier so that
// every block's are ready before any remote store.
__device__ __forceinline__ void mbar_setup(uint64_t* bars, uint32_t bytes,
                                           int clusters) {
  if (clusters > 1 && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bars[0], bytes);
    mbar_expect(&bars[1], bytes);
  }
}

// ---------------------------------------------------------------------- //
// dim <= 4: a lane per particle row
// ---------------------------------------------------------------------- //
// Quantities a lane sums: g[D], g sigma eps [D], F, |eps|^2, padded to QP.
template <int D>
struct Lanes {
  static constexpr int Q = 2 * D + 2;
  static constexpr int S = Q <= 4 ? 2 : Q <= 8 ? 3 : 4;  // log2 QP
  static constexpr int QP = 1 << S;
  static constexpr int G = 32 >> S;  // lanes that hold one quantity
  static constexpr int RP = 4;       // rows a lane draws ahead
};

// The transposed reduce-scatter: v[QP] on every lane in, the warp's total of
// quantity lane >> (5 - S) out (the same bits on the G lanes that hold it).
// Level s exchanges half of the values still held over lane bit 4 - s.
template <int S>
__device__ __forceinline__ double reduce_scatter(double (&v)[1 << S],
                                                 int lane) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int half = (1 << S) >> (s + 1);
    const int mask = 16 >> s;
    const bool upper = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const double send = upper ? v[i] : v[i + half];
      const double keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
  }
  double r = v[0];
#pragma unroll
  for (int mask = 16 >> S; mask > 0; mask >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, mask);
  return r;
}

template <int D, template <int> class Density>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    advi_lanes_kernel(const Args a) {
  using L = Lanes<D>;
  constexpr int Q = L::Q, S = L::S, QP = L::QP, G = L::G, RP = L::RP;
  extern __shared__ double slots[];  // [2][C W][QP]
  __shared__ uint64_t bars[2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int C = a.cluster;
  const int P = C * a.warps;  // partials: one a warp
  const int rank = blockIdx.x;
  const int producer = rank * a.warps + warp;
  const int stride = 32 * P;  // rows between a lane's rows
  const int row0 = 32 * producer + lane;
  const int n = a.n_particles;
  const double inv_n = 1.0 / static_cast<double>(n);
  const int q = lane >> (5 - S);  // the quantity this lane pushes
  const int gi = lane & (G - 1);

  // Every lane holds the parameters; lane j < D owns loc_j, lane D + j
  // owns log_scale_j (the parameter `own` and its moments).
  float loc[D], ls[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    loc[j] = a.loc0[j];
    ls[j] = a.ls0[j];
  }
  const int pj = lane < 2 * D ? lane : 0;
  float own = pj < D ? a.loc0[pj] : a.ls0[pj - D], m_own = 0.0f,
        v_own = 0.0f;
  Density<1> dens;
  dens.load(a.dens0, a.dens1, 0, a.dim);  // every lane: columns 0 .. 3
  float nz[RP][4];
#pragma unroll
  for (int k = 0; k < RP; ++k)
    if (row0 + k * stride < n) draw4(a, 0, row0 + k * stride, 0, nz[k]);
  // This step's row of the schedule table; the next one is read in the
  // barrier's shadow, off the chain of dependent steps.
  float lr = a.table[0], c1 = a.table[1], c2 = a.table[2];
  const uint32_t step_bytes = 8u * static_cast<uint32_t>(P * Q);
  mbar_setup(bars, step_bytes, C);
  // Every block has started before any writes into its shared memory.
  cluster_sync(C);
  ZS_CLOCK_START;

  for (int t = 0; t < a.n_steps; ++t) {
    float mu[4], sigma[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mu[e] = e < D ? loc[e] : 0.0f;
      sigma[e] = e < D ? expf(ls[e]) : 1.0f;  // padding: eps 0
    }
    double acc[QP];
#pragma unroll
    for (int i = 0; i < QP; ++i) acc[i] = 0.0;
    auto row_terms = [&](const float (&e4)[4]) {
      float se[4], z[4], g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float eps = e < D ? e4[e] : 0.0f;
        se[e] = sigma[e] * eps;
        z[e] = mu[e] + se[e];
        if (e < D) acc[2 * D + 1] += static_cast<double>(eps * eps);
      }
      const float f = dens.template value_and_grad<true>(z, g);
      acc[2 * D] += static_cast<double>(f);
#pragma unroll
      for (int e = 0; e < D; ++e) {
        acc[e] += static_cast<double>(g[e]);
        acc[D + e] += static_cast<double>(g[e] * se[e]);
      }
    };
#pragma unroll
    for (int k = 0; k < RP; ++k)
      if (row0 + k * stride < n) row_terms(nz[k]);
    for (int row = row0 + RP * stride; row < n; row += stride) {
      float e4[4];
      draw4(a, t, row, 0, e4);
      row_terms(e4);
    }
    ZS_STAMP(1);

    const double part = reduce_scatter<S>(acc, lane);
    ZS_STAMP(2);
    const int par = t & 1;
    if (q < Q) {
      double* dst = slots + (par * P + producer) * QP + q;
      if (C > 1) {
        for (int b = gi; b < C; b += G)
          st_async_f64(remote_u32(smem_u32(dst), b), part,
                       remote_u32(smem_u32(&bars[par]), b));
      } else if (gi == 0) {
        *dst = part;
      }
    }
    if (C == 1) __syncthreads();
    ZS_STAMP(3);
    const int tn = t + 1 < a.n_steps ? t + 1 : t;
    const float lr_next = a.table[3 * tn], c1_next = a.table[3 * tn + 1],
                c2_next = a.table[3 * tn + 2];
    if (t + 1 < a.n_steps) {
#pragma unroll
      for (int k = 0; k < RP; ++k)
        if (row0 + k * stride < n) draw4(a, t + 1, row0 + k * stride, 0, nz[k]);
    }
    ZS_STAMP(0);
    if (C > 1) {
      mbar_wait(&bars[par], (t >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(&bars[par], step_bytes);
    }
    ZS_STAMP(3);

    // Quantity q's total over the P partials: lane gi of its group adds
    // partials gi, gi + G, ... in order, then a butterfly over the group.
    double tot = 0.0;
    if (q < Q) {
      const double* col = slots + par * P * QP + q;
      for (int p = gi; p < P; p += G) tot += col[p * QP];
    }
#pragma unroll
    for (int mask = G >> 1; mask > 0; mask >>= 1)
      tot += __shfl_xor_sync(0xffffffffu, tot, mask);
    // Quantity pj is the gradient sum of the lane's own parameter.
    const double s_own = __shfl_sync(0xffffffffu, tot, pj * G);
    const double s_f = __shfl_sync(0xffffffffu, tot, 2 * D * G);
    const double s_e = __shfl_sync(0xffffffffu, tot, (2 * D + 1) * G);
    // sum(log_scale) of the loss, before this step's update.
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < D; ++j) s += static_cast<double>(ls[j]);
    const float sum_ls = static_cast<float>(s);
    const float mean_own = static_cast<float>(s_own * inv_n);
    const float g_own = pj < D ? -mean_own : -mean_own - 1.0f;
    own = adam(own, g_own, &m_own, &v_own, a, lr, c1, c2);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      loc[j] = __shfl_sync(0xffffffffu, own, j);
      ls[j] = __shfl_sync(0xffffffffu, own, D + j);
    }
    if (rank == 0 && threadIdx.x == 0)
      a.out_losses[t] = loss_of(a, s_f, s_e, inv_n, sum_ls);
    lr = lr_next;
    c1 = c1_next;
    c2 = c2_next;
    ZS_STAMP(4);
    ZS_COUNT_STEP;
  }
  ZS_CLOCK_FLUSH;
  if (C > 1) cluster_sync(C);  // no block leaves with a store in flight
  if (rank == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      a.out_loc[j] = loc[j];
      a.out_ls[j] = ls[j];
    }
  }
}

// ---------------------------------------------------------------------- //
// dim > 4: a warp per particle row
// ---------------------------------------------------------------------- //
template <int K>
struct Warps {
  static constexpr int E = 4 * K;
  static constexpr int DP = 128 * K;  // padded columns
  static constexpr int RP = 4 / K;    // rows a warp draws ahead
};

// Doubles a row of partials holds: (sum g, sum g sigma eps) per column, then
// (sum F, sum |eps|^2).
__host__ __device__ constexpr int warps_pitch(int dim) { return 2 * (dim + 1); }

__host__ __device__ constexpr size_t warps_shared_bytes(int dim, int clusters,
                                                        int warps, int dp) {
  return sizeof(double) * warps_pitch(dim) * (2 * clusters + warps) +
         sizeof(float) * 6 * dp;
}

template <int K, template <int> class Density>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    advi_warps_kernel(const Args a) {
  constexpr int E = Warps<K>::E, DP = Warps<K>::DP, RP = Warps<K>::RP;
  extern __shared__ double shared[];
  __shared__ uint64_t bars[2];
  const int C = a.cluster, W = a.warps;
  const int dim = a.dim;
  const int pitch = warps_pitch(dim);
  double* slots = shared;               // [2][C][pitch]
  double* red = slots + 2 * C * pitch;  // [W][pitch]
  float* loc = reinterpret_cast<float*>(red + W * pitch);  // [DP] each
  float* ls = loc + DP;
  float* m_l = ls + DP;
  float* v_l = m_l + DP;
  float* m_s = v_l + DP;
  float* v_s = m_s + DP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = 32 * W;
  const int rank = blockIdx.x;
  const int stride = C * W;  // rows between a warp's rows
  const int row0 = rank * W + warp;
  const int n = a.n_particles;
  const double inv_n = 1.0 / static_cast<double>(n);

  for (int j = tid; j < DP; j += threads) {
    loc[j] = j < dim ? a.loc0[j] : 0.0f;
    ls[j] = j < dim ? a.ls0[j] : 0.0f;
    m_l[j] = v_l[j] = m_s[j] = v_s[j] = 0.0f;
  }
  Density<K> dens;
  dens.load(a.dens0, a.dens1, lane, dim);
  float nz[RP][E];
  auto draw_row = [&](int t, int row, float (&out)[E]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int grp = k * 32 + lane;
      float n4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (grp * 4 < dim) draw4(a, t, row, grp, n4);
#pragma unroll
      for (int i = 0; i < 4; ++i) out[4 * k + i] = n4[i];
    }
  };
#pragma unroll
  for (int r = 0; r < RP; ++r)
    if (row0 + r * stride < n) draw_row(0, row0 + r * stride, nz[r]);
  float lr = a.table[0], c1 = a.table[1], c2 = a.table[2];
  const uint32_t step_bytes = 8u * static_cast<uint32_t>(C * pitch);
  mbar_setup(bars, step_bytes, C);
  cluster_sync(C);  // also orders the replica's first writes
  ZS_CLOCK_START;

  for (int t = 0; t < a.n_steps; ++t) {
    float mu[E], sigma[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      mu[e] = loc[j];
      sigma[e] = expf(ls[j]);  // padding: loc 0, sigma 1 against eps 0
    }
    // sum(log_scale) of the loss, before this step's update: warp 0 of
    // block 0, whose lane 0 writes the loss. (In the barrier's shadow it
    // would race with the threads already past the wait, and a double
    // buffer for it measured slower.)
    float sum_ls = 0.0f;
    if (rank == 0 && warp == 0) {
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
    auto row_terms = [&](const float (&eps_row)[E]) {
      float se[E], z[E], g[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = 4 * (32 * (e / 4) + lane) + e % 4;
        const float eps = j < dim ? eps_row[e] : 0.0f;
        se[e] = sigma[e] * eps;
        z[e] = mu[e] + se[e];
        acc_e += static_cast<double>(eps * eps);
      }
      const float f = dens.value_and_grad(z, g);
      acc_f += static_cast<double>(f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc_g[e] += static_cast<double>(g[e]);
        acc_gs[e] += static_cast<double>(g[e] * se[e]);
      }
    };
#pragma unroll
    for (int r = 0; r < RP; ++r)
      if (row0 + r * stride < n) row_terms(nz[r]);
    for (int row = row0 + RP * stride; row < n; row += stride) {
      float eps_row[E];
      draw_row(t, row, eps_row);
      row_terms(eps_row);
    }
    ZS_STAMP(1);

    // The block's partials: the warps meet in `red`, thread j sums column j
    // (j = dim: F and |eps|^2).
    double* mine = red + warp * pitch;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 4 * (32 * (e / 4) + lane) + e % 4;
      if (j < dim)
        *reinterpret_cast<double2*>(mine + 2 * j) =
            make_double2(acc_g[e], acc_gs[e]);
    }
    acc_e = warp_sum(acc_e);
    if (lane == 0)  // F is the same on every lane
      *reinterpret_cast<double2*>(mine + 2 * dim) =
          make_double2(acc_f, acc_e);
    __syncthreads();
    ZS_STAMP(2);
    const int par = t & 1;
    for (int j = tid; j <= dim; j += threads) {
      double x = 0.0, y = 0.0;
      for (int w = 0; w < W; ++w) {
        const double2 v = *reinterpret_cast<const double2*>(red + w * pitch +
                                                             2 * j);
        x += v.x;
        y += v.y;
      }
      double* slot = slots + (par * C + rank) * pitch + 2 * j;
      if (C > 1) {
        for (int b = 0; b < C; ++b)
          st_async_v2f64(remote_u32(smem_u32(slot), b), x, y,
                         remote_u32(smem_u32(&bars[par]), b));
      } else {
        *reinterpret_cast<double2*>(slot) = make_double2(x, y);
      }
    }
    if (C == 1) __syncthreads();
    ZS_STAMP(3);
    const int tn = t + 1 < a.n_steps ? t + 1 : t;
    const float lr_next = a.table[3 * tn], c1_next = a.table[3 * tn + 1],
                c2_next = a.table[3 * tn + 2];
    if (t + 1 < a.n_steps) {
#pragma unroll
      for (int r = 0; r < RP; ++r)
        if (row0 + r * stride < n) draw_row(t + 1, row0 + r * stride, nz[r]);
    }
    ZS_STAMP(0);
    if (C > 1) {
      mbar_wait(&bars[par], (t >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(&bars[par], step_bytes);
    }
    ZS_STAMP(3);

    // Thread j: the C partials of column j, then Adam on loc_j and
    // log_scale_j; thread 0 of block 0 also the loss (item dim).
    const double* part = slots + par * C * pitch;
    for (int j = tid; j < dim; j += threads) {
      double x = 0.0, y = 0.0;
      for (int b = 0; b < C; ++b) {
        const double2 v =
            *reinterpret_cast<const double2*>(part + b * pitch + 2 * j);
        x += v.x;
        y += v.y;
      }
      const float g_loc = -static_cast<float>(x * inv_n);
      const float g_ls = -static_cast<float>(y * inv_n) - 1.0f;
      loc[j] = adam(loc[j], g_loc, &m_l[j], &v_l[j], a, lr, c1, c2);
      ls[j] = adam(ls[j], g_ls, &m_s[j], &v_s[j], a, lr, c1, c2);
    }
    if (rank == 0 && tid == 0) {
      double x = 0.0, y = 0.0;
      for (int b = 0; b < C; ++b) {
        const double2 v =
            *reinterpret_cast<const double2*>(part + b * pitch + 2 * dim);
        x += v.x;
        y += v.y;
      }
      a.out_losses[t] = loss_of(a, x, y, inv_n, sum_ls);
    }
    lr = lr_next;
    c1 = c1_next;
    c2 = c2_next;
    __syncthreads();
    ZS_STAMP(4);
    ZS_COUNT_STEP;
  }
  ZS_CLOCK_FLUSH;
  if (C > 1) cluster_sync(C);
  if (rank == 0) {
    for (int j = tid; j < dim; j += threads) {
      a.out_loc[j] = loc[j];
      a.out_ls[j] = ls[j];
    }
  }
}

// ---------------------------------------------------------------------- //
// Launch
// ---------------------------------------------------------------------- //
constexpr int kMaxDevices = 64;

size_t lanes_shared_bytes(int qp, int clusters, int warps) {
  return sizeof(double) * 2 * clusters * warps * qp;
}

// One launch of `kernel`: a cluster of a.cluster blocks of 32 a.warps
// threads. The function's limits (dynamic shared memory past 48 KB, a
// cluster past 8 blocks) are raised once per device on its first launch
// there; `limits_set` is the instantiation's own flag array.
int launch_cluster(void (*kernel)(const Args), std::atomic<bool>* limits_set,
                   const Args& a, size_t shared_bytes, cudaStream_t stream) {
  if (shared_bytes > static_cast<size_t>(kSharedMax))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limits_set[device].load(std::memory_order_acquire)) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSharedMax);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    limits_set[device].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.cluster);
  config.blockDim = dim3(32 * a.warps);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = a.cluster > 1 ? 1 : 0;
  rc = cudaLaunchKernelEx(&config, kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <int D, template <int> class Density>
int launch_lanes(const Args& a, cudaStream_t stream) {
  static std::atomic<bool> limits_set[kMaxDevices];
  return launch_cluster(
      advi_lanes_kernel<D, Density>, limits_set, a,
      lanes_shared_bytes(Lanes<D>::QP, a.cluster, a.warps), stream);
}

template <int K, template <int> class Density>
int launch_warps(const Args& a, cudaStream_t stream) {
  static std::atomic<bool> limits_set[kMaxDevices];
  return launch_cluster(
      advi_warps_kernel<K, Density>, limits_set, a,
      warps_shared_bytes(a.dim, a.cluster, a.warps, Warps<K>::DP), stream);
}

template <template <int> class Density>
int dispatch(const Args& a, cudaStream_t stream) {
  switch (a.dim) {
    case 1: return launch_lanes<1, Density>(a, stream);
    case 2: return launch_lanes<2, Density>(a, stream);
    case 3: return launch_lanes<3, Density>(a, stream);
    case 4: return launch_lanes<4, Density>(a, stream);
    default: break;
  }
  const int groups = (a.dim + 3) / 4;
  if (groups <= 32) return launch_warps<1, Density>(a, stream);
  if (groups <= 64) return launch_warps<2, Density>(a, stream);
  if (groups <= 128) return launch_warps<4, Density>(a, stream);
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
// kernel then draws from Philox keyed by (key0, key1). cluster (1-16) and
// warps (1-16) are the layout (ops/advi_step.py::advi_layout); a layout
// whose shared memory does not fit, or a cluster the card cannot schedule,
// is refused. Returns the CUDA error code of the launch (0 on success).
extern "C" int zs_fused_meanfield_advi(
    int density, const void* dens0, const void* dens1, const void* loc0,
    const void* ls0, const void* table, const void* noise, int n_steps,
    int n_particles, int dim, int cluster, int warps, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float adam_eps,
    float loss_const, uint32_t key0, uint32_t key1, void* out_loc,
    void* out_ls, void* out_losses, void* stream) {
  if (n_steps < 1 || n_particles < 1 || dim < 1 || dens0 == nullptr ||
      loc0 == nullptr || ls0 == nullptr || table == nullptr ||
      out_loc == nullptr || out_ls == nullptr || out_losses == nullptr ||
      cluster < 1 || cluster > kMaxCluster || warps < 1 ||
      warps > kMaxWarps)
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
  a.cluster = cluster;
  a.warps = warps;
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
      return dispatch<zs::DiagonalGaussian>(a, s);
    case zs::kEquicorrelatedGaussian:
      return dispatch<zs::EquicorrelatedGaussian>(a, s);
    case zs::kToy2D:
      if (dim != 2) return static_cast<int>(cudaErrorInvalidValue);
      return launch_lanes<2, zs::Toy2D>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef ZS_ADVI_CLOCKS
// Copies the cycle sums of the parts (kClockParts) into host array `out`
// and zeroes them. Returns the CUDA error code.
extern "C" int zs_advi_clocks(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long zero[kClockParts] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero)));
}
#endif
