// Cholesky factor and its inverse of one small SPD matrix, for Hopper
// (sm_90a): one thread block per matrix.
//
// Replaces the Pallas TPU kernel zhusuan_tpu/ops/linalg.py::_chol_inv_kernel
// (pallas_call at :110, entry cholesky_inverse :134-153): for one [n, n]
// float32 symmetric positive-definite A, n <= 512, L lower-triangular with
// zeros above (A = L L^T) and L^{-1} lower-triangular with zeros above, in
// one launch. The sparse-GP step (SVGP's inducing Gram matrix, n = 100) calls
// it once per training step, and everything downstream whitens by matmuls.
//
// Algorithm: right-looking Cholesky, column j = 0..n-1, that applies the same
// elementary column operations to X = I, so X ends as L^{-1}:
//   d = sqrt(M[j][j]);  l_i = M[i][j] / d (i > j);  r_c = X[j][c] / d (c <= j)
//   M[i][k] -= l_i l_k   for j < k <= i   (trailing Schur complement, lower
//                                          triangle only)
//   X[i][c] -= l_i r_c   for c <= j < i   (forward substitution of L X = I)
//   column j of L is (d, l_{j+1}, ...), row j of X becomes r.
// M and X share ONE lower-triangular working matrix W: before step j, the
// columns c < j of W hold X and the columns k >= j hold M (X's columns
// c >= j are still those of I, and M's columns < j are no longer read).
// With v = (r_0 .. r_j, l_{j+1} .. l_{n-1}), step j is then the rank-1
// update W[i][e] -= v_i v_e of every row i > j over its entries e <= i
// (W[i][j] becomes -v_i v_j: X[i][j] was 0), and W ends as L^{-1}; L is
// written out one column per step. Row i has i + 1 entries, so a warp per
// row keeps its lanes busy, and the loads of one lane are independent.
// Unlike the TPU kernel, which rewrites the whole n x n matrix three times
// per column with masks (VMEM is large, dynamic indexing is not), each step
// touches only the entries it changes.
//
// What bounds it on an H100: the work is about n^3/3 multiply-subtracts
// (0.67 MFLOP at n = 100), a few ns at 67 TFLOP/s, and it moves 3 n^2
// floats. The real floor is the n dependent column steps: each ends in a
// __syncthreads, two per column here (v is staged into shared memory, then
// every row below the column is updated).
//
// Memory: for n <= kSharedMaxN (338) W lives in dynamic shared memory as a
// packed lower triangle (row i at offset i (i + 1) / 2), beside v:
// n (n + 1) / 2 + n floats = 230,516 bytes at n = 338, under the 232,448
// bytes a block may have (40 KB at n = 100); at n = 339 they would not fit.
// Above that (the lower triangle of a 512 x 512 matrix is 513 KB), W lives
// in the output L^{-1} itself, row-major in device memory (1 MB at n = 512,
// resident in the 50 MB L2), under the same single-block loop: slower per
// entry, same arithmetic.
//
// Non-SPD input: no clamp. When any pivot M[j][j] is <= 0 or not finite, the
// kernel writes L = NaN on and below the diagonal (0 above) and L^{-1} = NaN
// everywhere, the pattern of the JAX package's reference path (Cholesky, then
// a triangular solve), with no host sync. The TPU kernel clamps the pivot at
// 1e-30 and returns finite garbage instead.
//
// Built with -fmad=false (ops/_build.py): every product and difference rounds
// on its own, as the JAX kernel's unfused elementwise ops do.
//
// A shared library with a plain C interface (nvcc, loaded through ctypes); the
// entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 512;
constexpr int kSharedMaxN = 338;
constexpr int kSharedBytesMax =
    (kSharedMaxN * (kSharedMaxN + 1) / 2 + kSharedMaxN) * sizeof(float);
constexpr int kMaxDevices = 64;
// Whether chol_inv_kernel<true>'s shared-memory limit is raised, per device.
// Two threads may both raise it; setting it twice is harmless.
std::atomic<bool> g_shared_limit_set[kMaxDevices];

// kShared: W packed in shared memory (n <= kSharedMaxN), else row-major in
// linv_out. Shared memory always holds v.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    chol_inv_kernel(const float* __restrict__ a, int n,
                    float* __restrict__ l_out, float* __restrict__ linv_out) {
  extern __shared__ float smem[];
  float* v = smem;  // [n]
  float* W = kShared ? smem + n : linv_out;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nn = n * n;
  auto row = [&](int i) -> float* {
    return kShared ? W + i * (i + 1) / 2 : W + i * n;
  };

  // W = lower triangle of A. L's upper triangle is 0.
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, k = idx - (idx / n) * n;
    if (k <= i) {
      row(i)[k] = a[idx];
    } else {
      l_out[idx] = 0.0f;
    }
  }
  __syncthreads();

  bool ok = true;  // every thread reads the same pivots, so this is uniform
  for (int j = 0; j < n; ++j) {
    const float p = row(j)[j];
    ok = ok && p > 0.0f && isfinite(p);
    const float d = sqrtf(p);
    const float* wj = row(j);
    for (int e = tid; e < n; e += kThreads) {
      v[e] = e < j ? wj[e] / d : (e == j ? 1.0f / d : row(e)[j] / d);
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      float* wi = row(i);
      const float vi = v[i];
      // Four entries per lane at a time, all loaded before any is stored:
      // the compiler cannot tell that W and v do not overlap, so it would
      // not move a load above the previous store by itself.
      int e = lane;
      for (; e + 96 <= i; e += 128) {
        float w[4], u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[q] = wi[e + 32 * q];
          u[q] = v[e + 32 * q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wi[e + 32 * q] = e + 32 * q == j ? -(vi * u[q]) : w[q] - vi * u[q];
        }
      }
      for (; e <= i; e += 32) {
        wi[e] = e == j ? -(vi * v[e]) : wi[e] - vi * v[e];
      }
    }
    // Row j of W becomes row j of L^{-1}; column j of L is (d, v_{j+1}..).
    float* wjw = row(j);
    for (int e = tid; e <= j; e += kThreads) wjw[e] = v[e];
    for (int i = j + tid; i < n; i += kThreads) {
      l_out[i * n + j] = i == j ? d : v[i];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, k = idx - (idx / n) * n;
    if (!ok) {
      if (k <= i) l_out[idx] = NAN;
      linv_out[idx] = NAN;
    } else if (k > i) {
      linv_out[idx] = 0.0f;
    } else if (kShared) {
      linv_out[idx] = row(i)[k];
    }
  }
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, l, linv: device pointers to contiguous row-major [n, n] float32 arrays
// (a is read only; l and linv are written; none may overlap). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int zs_cholesky_inverse(const void* a, int n, void* l, void* linv,
                                   void* stream) {
  if (a == nullptr || l == nullptr || linv == nullptr || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* lf = static_cast<float*>(l);
  float* xf = static_cast<float*>(linv);
  if (n <= kSharedMaxN) {
    // Above 48 KB of dynamic shared memory a launch is refused unless the
    // function's limit is raised first: once per device, on its first launch
    // there (a training loop calls this every step).
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!g_shared_limit_set[device].load(std::memory_order_acquire)) {
      e = cudaFuncSetAttribute(chol_inv_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytesMax);
      if (e != cudaSuccess) return static_cast<int>(e);
      g_shared_limit_set[device].store(true, std::memory_order_release);
    }
    const size_t bytes =
        (static_cast<size_t>(n) * (n + 1) / 2 + n) * sizeof(float);
    chol_inv_kernel<true><<<1, kThreads, bytes, s>>>(af, n, lf, xf);
  } else {
    chol_inv_kernel<false><<<1, kThreads, n * sizeof(float), s>>>(af, n, lf,
                                                                  xf);
  }
  return static_cast<int>(cudaGetLastError());
}
