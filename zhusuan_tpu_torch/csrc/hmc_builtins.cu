// K1 on the built-ins it alone evaluates (ops/hmc_step.py::
// BUILTIN_DENSITIES, float32 q): the whitened Gaussians of dense
// preconditioning, Neal's funnel, a Gaussian or the funnel pulled back
// through a NeuTra coupling flow, and two built-ins with data, one of which
// reads a value of its chain (the change point a Gibbs sweep holds). They
// are the closures those paths hand HMC, which the Pallas kernel
// zhusuan_tpu/ops/hmc_step.py::fused_hmc_step (pallas_call at :206) traces
// into its body on a TPU; a CUDA kernel cannot trace a closure, so each is a
// struct of csrc/densities.cuh. The transition is csrc/hmc_step.cu's K1, the
// same body (csrc/hmc_family.cuh) in step mode; this source holds only these
// instantiations, so that they build beside hmc_step.cu's.
//
// What bounds it on an H100: the densities' own work. The whitened density
// forms L y and L^T g, 2 d^2 multiply-adds a gradient, a lane a row (or a
// column) of L staged once a block in shared memory, its pairwise trees
// re-reading L and the vector there; NeuTra runs each coupling's net a
// hidden unit a lane, a butterfly of 5 shuffles for every output and every
// conditioning input, forward and backward, a long chain of dependent
// shuffles; the funnel and the data built-ins are a few operations an
// element or a data row. At the examples' 32-512 chains a launch fills few
// of the 132 SMs: latency, not bandwidth, bounds them.
//
// A shared library with a plain C interface (nvcc, loaded through ctypes);
// the entry returns cudaGetLastError() after its launch.

#include "hmc_family.cuh"

namespace {

template <template <int> class B>
struct WhitenedOf {
  template <int K>
  using type = zs::Whitened<K, B>;
};

template <template <int> class B>
struct NeuTraOf {
  template <int K>
  using type = zs::NeuTra<K, B>;
};

// K1 on a built-in of its own (float32 q): density and, for the composite
// ones, base are DensityIds of densities.cuh (a Gaussian base; or the funnel,
// under NeuTra).
template <template <template <int> class> class Of, bool kFunnel>
int dispatch_base(int base, const Args& a, cudaStream_t s) {
  if (base == zs::kDiagonalGaussian && a.dens1 != nullptr)
    return launch<1, float, Of<zs::DiagonalGaussian>::template type, kStep>(
        a, s);
  if (base == zs::kEquicorrelatedGaussian)
    return launch<1, float, Of<zs::EquicorrelatedGaussian>::template type,
                  kStep>(a, s);
  if constexpr (kFunnel) {
    if (base == zs::kNealFunnel)
      return launch<1, float, Of<zs::NealFunnel>::template type, kStep>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_builtin(int density, int base, const Args& a, void* stream) {
  if (a.n_chains < 1 || a.dim < 1 || a.n_host < 0 || a.dens0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (density) {
    case zs::kWhitened:
      if (a.dim > 128 || a.aux0 == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_base<WhitenedOf, false>(base, a, s);
    case zs::kNealFunnel:
      return dispatch_k<float, zs::NealFunnel, kStep>(a, s);
    case zs::kNeuTra:
      if (a.dim > 32 || a.aux0 == nullptr || a.aux1 == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_base<NeuTraOf, true>(base, a, s);
    case zs::kGaussianLinearRegression:
      if (a.dim > 8 || a.dens1 == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<1, float, zs::GaussianLinearRegression, kStep>(a, s);
    case zs::kPoissonChangepoint:
      if (a.dim != 2 || a.dens1 == nullptr || a.chain_vals == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<1, float, zs::PoissonChangepoint, kStep>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// zs_fused_hmc_step on a built-in that K1 alone evaluates (float32 q):
// density a DensityId of densities.cuh with its parameter arrays dens0, dens1
// (a composite built-in's base, by id `base`, reads them; aux0, aux1 its
// factor or flow), n_rows the rows of a data built-in's table, chain_vals
// the [n_chains, chain_stride] values a built-in reads for each chain (the
// change point; re-pointed at every launch), smem_block and smem_warp the
// floats of dynamic shared memory a block and a warp. The same outputs.
extern "C" int zs_fused_builtin_hmc_step(
    const void* q, const void* mass, int density, int base, const void* dens0,
    const void* dens1, const void* aux0, const void* aux1,
    const void* chain_vals, int chain_stride, int n_rows, int smem_block,
    int smem_warp, const void* step_size, const void* eps, const void* u_mh,
    int n_chains, int dim, int n_leapfrogs, uint32_t key0, uint32_t key1,
    uint32_t t, void* out_q, void* out_p, void* out_acc, void* out_old_lp,
    void* out_new_lp, void* out_old_h, void* out_new_h, void* stream) {
  Args a{};
  a.q = q;
  a.mass = f(mass);
  a.dens0 = f(dens0);
  a.dens1 = f(dens1);
  a.aux0 = f(aux0);
  a.aux1 = f(aux1);
  a.chain_vals = f(chain_vals);
  a.chain_stride = chain_stride;
  a.n_rows = n_rows;
  a.smem_block = smem_block;
  a.smem_warp = smem_warp;
  a.step_size = f(step_size);
  a.n_host = n_leapfrogs;
  a.eps = f(eps);
  a.u_mh = f(u_mh);
  a.n_chains = n_chains;
  a.dim = dim;
  a.key0 = key0;
  a.key1 = key1;
  a.t = t;
  a.out_q = out_q;
  a.out_p = o(out_p);
  a.out_acc = o(out_acc);
  a.out_old_lp = o(out_old_lp);
  a.out_new_lp = o(out_new_lp);
  a.out_old_h = o(out_old_h);
  a.out_new_h = o(out_new_h);
  return dispatch_builtin(density, base, a, stream);
}
