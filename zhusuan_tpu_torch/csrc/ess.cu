// Effective sample size of every column of [n, cols] draws, for Hopper
// (sm_90a), in one pass over the draws.
//
// Replaces no TPU kernel: the JAX package computes ESS with numpy on the
// host. It replaces, on the card, the batched FFT path of
// diagnostics.py::ess_batch_device (a cast, a mean, a zero-padded rfft of
// length 2^ceil(log2(2n - 1)), a product, an irfft and a dozen elementwise
// passes over [n, cols] temporaries), which read and wrote the draws' size
// some twenty times. The estimator is the same (diagnostics.py, header):
// with mu the column mean, acov(t) = sum_i (x_i - mu)(x_{i+t} - mu) / (n - t),
// rho_t = 1 - (acov(0) n / (n - 1) - acov(t)) / acov(0), summed from t = 0
// up to the first negative rho (a non-finite rho counts as -1), and
// ess = n / (1 + 2 sum rho); a column whose acov(0) is not positive (a
// frozen column, or one holding a NaN or an infinity) gets 0. rho_t is
// computed as acov(t) / acov(0) - 1 / (n - 1), the same value, without the
// cancellation of var - acov(t) in float32.
//
// What bounds it on an H100: one read of the draws (bytes over 3.35 TB/s;
// 3.28 GB of bfloat16 draws at [500, 3.28 M] is 0.98 ms) and a write of
// cols floats, when the lags each column needs are few: the arithmetic is
// n (cutoff + 1) multiply-adds a column, n^2 / 2 at worst (a random walk).
//
// Design. A block owns a tile of kTile contiguous columns: it stages all n
// rows of them (any row stride: a view is read in place) in shared memory
// as float32 (coalesced row loads, 16-byte
// for float32 and 8-byte for 16-bit types where the widths allow, widened
// on the way in), with kGroup zero rows below the last so that a lag that
// runs past the column reads zeros, and a row stride of kTile + 1 floats so
// that lanes walking down a column, or along a row, hit distinct banks.
//   1. Mean: the block's warps split the rows, a lane a column; partial
//      sums meet in shared memory; each lane then centres its rows.
//   2. Lags 0..kGroup-1 for every column at once: a lane a column, each
//      warp over its rows, with the next kGroup values of the column in a
//      ring of registers (one shared load feeds kGroup multiply-adds).
//   3. A lane a column sums the warps' partials, forms rho and finds the
//      first negative one. A column cut off there is written out; the
//      rest ("survivors", the slowly mixing ones) are listed.
//   4. Survivors, a warp each, taken from a shared counter: kGroup lags at
//      a time, each lane over a contiguous run of rows with a ring as in
//      step 2 (two shared loads a kGroup multiply-adds), the kGroup sums
//      reduced across the warp by a transposing butterfly (9 shuffles) that
//      leaves each lane one lag's sum; the lanes form their rho at once, a
//      ballot finds the first negative one (or n), where the lag loop stops
//      for the whole warp, and 3 shuffles sum the rho before it.
// A warp a survivor keeps one column's long lag loop from holding 31
// others that stopped, as a lane a column would; a lane a column keeps the
// short columns (nearly all, on a well-mixing sampler) at a load per
// kGroup multiply-adds. Blocks are independent; three (n = 500) to four
// (n = 300) fit an SM, so one block's loads overlap another's arithmetic.
// Measured on an H100 at [500, 3.28 M] bfloat16 HMC draws (95% of columns
// past lag 7, cutoffs 31 lags on average): 8.6 ms, 2.7 ms of it the load
// and lags 0-7; at [300, 3.28 M] float32 NUTS draws (cutoffs ~1): 1.9 ms,
// 1.6x the bytes bound. Sixteen warps a block were slower (9.8 ms).
//
// Sums are float32 after the mean is taken out, accumulated in another
// order than the FFT's: the kernel is held to the float64 estimator by
// tolerance, and built with FMA contraction on (ops/_build.py).
// A shared library with a plain C interface; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;         // columns a block
constexpr int kStride = kTile + 1;  // floats a staged row
constexpr int kGroup = 8;         // lags a pass
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
constexpr int kSharedMax = 232448;  // a block's dynamic shared memory

enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// Four consecutive elements of a 16-byte (float) or 8-byte (16-bit) load.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using Raw = float4;
  __device__ static void split(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void split(const Raw& r, float* v) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xFFFF0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xFFFF0000u);
  }
};
template <>
struct Quad<__half> {
  using Raw = uint2;
  __device__ static void split(const Raw& r, float* v) {
    v[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(r.x)));
    v[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(r.x >> 16)));
    v[2] = __half2float(__ushort_as_half(static_cast<unsigned short>(r.y)));
    v[3] = __half2float(__ushort_as_half(static_cast<unsigned short>(r.y >> 16)));
  }
};

// Floats of shared memory a block takes beside its tile: the warps'
// partial sums (kGroup a lane), each column's running sum of rho and
// acov(0), and the survivors' list (ints, float-sized). With tile_floats,
// the rule ops/ess.py::ess_layout writes again to route by on the host;
// launch_as refuses a layout past kSharedMax all the same.
__host__ __device__ constexpr int side_floats(int warps) {
  return warps * kGroup * kTile + 3 * kTile + 2;
}

__host__ __device__ constexpr long long tile_floats(int n) {
  return static_cast<long long>(n + kGroup) * kStride;
}

// Stage rows 0..n-1 of columns c0..c0+width-1 into tile (row stride
// kStride), zero elsewhere, and the kGroup rows below.
template <typename T, bool kVector>
__device__ void stage(const T* __restrict__ x, long long ld, int n,
                      long long c0, int width, float* tile) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  if (kVector) {
    // kTile / 4 loads a row; width is a multiple of 4.
    constexpr int kQuads = kTile / 4;
    constexpr int kBatch = 4;
    const int q = tid % kQuads;
    const int rows_a_pass = threads / kQuads;
    const bool live = 4 * q < width;
    using Raw = typename Quad<T>::Raw;
    for (int r = tid / kQuads; r < n; r += kBatch * rows_a_pass) {
      Raw raw[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int row = r + b * rows_a_pass;
        if (live && row < n)
          raw[b] = *reinterpret_cast<const Raw*>(
              x + static_cast<long long>(row) * ld + c0 + 4 * q);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int row = r + b * rows_a_pass;
        if (row >= n) break;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (live) Quad<T>::split(raw[b], v);
#pragma unroll
        for (int k = 0; k < 4; ++k) tile[row * kStride + 4 * q + k] = v[k];
      }
    }
  } else {
    const int k = tid % kTile;
    const int rows_a_pass = threads / kTile;
    for (int row = tid / kTile; row < n; row += rows_a_pass)
      tile[row * kStride + k] =
          k < width ? widen(x[static_cast<long long>(row) * ld + c0 + k])
                    : 0.0f;
  }
  for (int e = tid; e < kGroup * kStride; e += threads)
    tile[n * kStride + e] = 0.0f;
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ess_kernel(const T* __restrict__ x, int n, long long cols, long long ld,
               float* __restrict__ out) {
  extern __shared__ float shared[];
  const int warps = blockDim.x / 32;
  float* tile = shared;
  float* partial = tile + tile_floats(n);           // [warps][kGroup][kTile]
  float* col_sum = partial + warps * kGroup * kTile;  // [kTile]
  float* col_var = col_sum + kTile;                   // [kTile]
  int* survivors = reinterpret_cast<int*>(col_var + kTile);  // [kTile]
  int* counts = survivors + kTile;  // survivors, next to take

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int width = static_cast<int>(cols - c0 < kTile ? cols - c0 : kTile);
  stage<T, kVector>(x, ld, n, c0, width, tile);
  __syncthreads();

  // 1. The mean, then the column centred in place.
  const int chunk = (n + warps - 1) / warps;
  const int r0 = min(n, warp * chunk);
  const int r1 = min(n, r0 + chunk);
  float* column = tile + lane;
  float s = 0.0f;
  for (int i = r0; i < r1; ++i) s += column[i * kStride];
  partial[warp * kTile + lane] = s;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < warps; ++w) total += partial[w * kTile + lane];
  const float mean = total / static_cast<float>(n);
  for (int i = r0; i < r1; ++i) column[i * kStride] -= mean;
  __syncthreads();

  // 2. Lags 0..kGroup-1 over this warp's rows: ring[(u + j) % kGroup]
  // holds column[i + u + j] at step u of a round.
  float acc[kGroup];
  float ring[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    acc[j] = 0.0f;
    ring[j] = column[(r0 + j) * kStride];  // rows past n are zeros
  }
  int i = r0;
  for (; i + kGroup <= r1; i += kGroup) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float a = ring[u];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] += a * ring[(u + j) % kGroup];
      ring[u] = column[(i + u + kGroup) * kStride];
    }
  }
  for (; i < r1; ++i) {
    const float a = ring[0];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] += a * ring[j];
#pragma unroll
    for (int j = 0; j + 1 < kGroup; ++j) ring[j] = ring[j + 1];
    ring[kGroup - 1] = column[(i + kGroup) * kStride];
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    partial[(warp * kGroup + j) * kTile + lane] = acc[j];
  __syncthreads();

  const float inv_nm1 = 1.0f / static_cast<float>(n - 1);
  // 3. A lane a column: rho for lags 0..kGroup-1 and the first negative.
  if (warp == 0) {
    float acov[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float sum = 0.0f;
      for (int w = 0; w < warps; ++w)
        sum += partial[(w * kGroup + j) * kTile + lane];
      acov[j] = sum / static_cast<float>(n - j);
    }
    const float var_plus = acov[0];
    float rho_sum = 0.0f;
    bool done = !(var_plus > 0.0f);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (done) break;
      if (j >= n) {
        done = true;
        break;
      }
      float rho = acov[j] / var_plus - inv_nm1;
      if (!isfinite(rho)) rho = -1.0f;
      if (rho < 0.0f) {
        done = true;
        break;
      }
      rho_sum += rho;
    }
    if (n <= kGroup) done = true;
    const bool mine = lane < width;
    if (done && mine)
      out[c0 + lane] = var_plus > 0.0f
                           ? static_cast<float>(n) / (1.0f + 2.0f * rho_sum)
                           : 0.0f;
    const unsigned alive = __ballot_sync(kFull, !done && mine);
    if (!done && mine)
      survivors[__popc(alive & ((1u << lane) - 1u))] = lane;
    col_sum[lane] = rho_sum;
    col_var[lane] = var_plus;
    if (lane == 0) {
      counts[0] = __popc(alive);
      counts[1] = 0;
    }
  }
  __syncthreads();

  // 4. The survivors, a warp each.
  const int n_survivors = counts[0];
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&counts[1], 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n_survivors) break;
    const int c = survivors[k];
    const float* col = tile + c;
    const float var_plus = col_var[c];
    float rho_sum = col_sum[c];
    for (int t0 = kGroup; t0 < n; t0 += kGroup) {
      // Lane l takes rows [l len, (l + 1) len) of the n - t0 that lag t0
      // pairs, len odd so that the lanes' rows fall in distinct banks,
      // with the next kGroup values at lag t0 in a ring (as in step 2).
      const int len = ((n - t0 + 31) / 32) | 1;
      const int lo = lane * len;
      const int hi = min(n - t0, lo + len);
      float part[kGroup];
      float ring[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        part[j] = 0.0f;
        ring[j] = lo < hi ? col[(lo + t0 + j) * kStride] : 0.0f;
      }
      int r = lo;
      for (; r + kGroup <= hi; r += kGroup) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float a = col[(r + u) * kStride];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            part[j] += a * ring[(u + j) % kGroup];
          ring[u] = col[(r + u + t0 + kGroup) * kStride];  // past n: zeros
        }
      }
      for (; r < hi; ++r) {
        const float a = col[r * kStride];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) part[j] += a * ring[j];
#pragma unroll
        for (int j = 0; j + 1 < kGroup; ++j) ring[j] = ring[j + 1];
        ring[kGroup - 1] = col[(r + t0 + kGroup) * kStride];
      }
      // Transposing butterfly: after offsets 16, 8 and 4 a lane holds
      // one lag's sum over 8 lanes, lag (lane >> 2) & 7; 2 and 1 finish it.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool upper = lane & 16;
        const float send = upper ? part[j] : part[j + 4];
        const float keep = upper ? part[j + 4] : part[j];
        part[j] = keep + __shfl_xor_sync(kFull, send, 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool upper = lane & 8;
        const float send = upper ? part[j] : part[j + 2];
        const float keep = upper ? part[j + 2] : part[j];
        part[j] = keep + __shfl_xor_sync(kFull, send, 8);
      }
      {
        const bool upper = lane & 4;
        const float send = upper ? part[0] : part[1];
        const float keep = upper ? part[1] : part[0];
        part[0] = keep + __shfl_xor_sync(kFull, send, 4);
      }
      part[0] += __shfl_xor_sync(kFull, part[0], 2);
      part[0] += __shfl_xor_sync(kFull, part[0], 1);
      // Each lane forms its lag's rho; the lags stop at the first negative
      // one (or at n), and the rho before it are summed over the lags, the
      // same in every lane.
      const int t = t0 + ((lane >> 2) & 7);
      float rho = -1.0f;
      if (t < n) {
        rho = part[0] / static_cast<float>(n - t) / var_plus - inv_nm1;
        if (!isfinite(rho)) rho = -1.0f;
      }
      const unsigned stops =
          __ballot_sync(kFull, t >= n || rho < 0.0f) & 0x11111111u;
      const int first =
          stops ? (__ffs(static_cast<int>(stops)) - 1) >> 2 : kGroup;
      float add = ((lane >> 2) & 7) < first ? rho : 0.0f;
      add += __shfl_xor_sync(kFull, add, 4);
      add += __shfl_xor_sync(kFull, add, 8);
      add += __shfl_xor_sync(kFull, add, 16);
      rho_sum += add;
      if (stops) break;
    }
    if (lane == 0)
      out[c0 + c] = static_cast<float>(n) / (1.0f + 2.0f * rho_sum);
  }
}

template <typename T, bool kVector>
int launch_as(const void* x, int n, long long cols, long long ld, int warps,
              void* out, cudaStream_t stream) {
  static bool limits_set[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limits_set[device]) {  // racing first launches set the same values
    rc = cudaFuncSetAttribute(ess_kernel<T, kVector>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSharedMax);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(ess_kernel<T, kVector>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    limits_set[device] = true;
  }
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(tile_floats(n) + side_floats(warps));
  if (bytes > static_cast<size_t>(kSharedMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (cols + kTile - 1) / kTile;
  ess_kernel<T, kVector><<<static_cast<unsigned>(blocks), 32 * warps, bytes,
                           stream>>>(static_cast<const T*>(x), n, cols, ld,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, int n, long long cols, long long ld, int warps,
             void* out, cudaStream_t stream) {
  // Vector loads where every row's quads are aligned: the row stride and
  // the row length multiples of 4 elements and the base on the load's
  // width.
  const uintptr_t align = sizeof(typename Quad<T>::Raw);
  if (cols % 4 == 0 && ld % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % align == 0)
    return launch_as<T, true>(x, n, cols, ld, warps, out, stream);
  return launch_as<T, false>(x, n, cols, ld, warps, out, stream);
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: a device pointer to [n, cols] draws of dtype (0 float32, 1 bfloat16,
// 2 float16), row i at x + i ld, its columns contiguous; out: [cols]
// float32. warps (1-8) is the layout (ops/ess.py::ess_layout); n >= 2, and
// the staged tile has to fit a block's shared memory. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int zs_fused_ess(const void* x, int n, long long cols,
                            long long ld, int dtype, int warps, void* out,
                            void* stream) {
  if (x == nullptr || out == nullptr || n < 2 || cols < 1 || ld < 0 ||
      warps < 1 || warps > kMaxWarps ||
      (cols + kTile - 1) / kTile > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch<float>(x, n, cols, ld, warps, out, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(x, n, cols, ld, warps, out, s);
    case kFloat16: return dispatch<__half>(x, n, cols, ld, warps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
