// Standalone samplers for Hopper (sm_90a): [rows, cols] float32 standard
// normals or uniforms in [0, 1) in one pass.
//
// Replaces two Pallas TPU kernels of zhusuan_tpu/ops/random.py:
//   zs_gpu_normal   tpu_normal (pallas_call at :83): PRNG bits -> mantissa
//                   uniforms -> Box-Muller (u1 clamped at 1e-7);
//   zs_gpu_uniform  tpu_uniform (:117): PRNG bits -> mantissa uniforms.
// The TPU kernels read the chip's hardware PRNG, seeded per ~1 MB block of
// rows (key + block index), and a block with an odd row count keeps only the
// cosine output. Both are artefacts of the TPU's block grid: here the bits
// come from counter-based Philox4x32-10 (philox.cuh), the counter is
// (0, row, group of 4 columns, stream), so an element's value depends only on
// the key and its own (row, column), and both Box-Muller outputs are always
// used. The plain torch versions (ops/_random.py::philox_normal and
// philox_uniform_rows) give the same bits.
//
// What bounds it on an H100: nothing is read and each element is written
// once, so the bound is the output's bytes over the device-memory rate
// (4 MB at 3.35 TB/s, 1.25 us at 1024 x 1024); the ~50 operations per normal
// (ten Philox rounds per 4, log, sqrt, sin or cos per 2) come to 0.8 us at
// the float32 peak, below it. One thread owns one group of 4 columns of one
// row, so one Philox call gives exactly its 4 outputs; stores are 4-byte
// (cols need not be a multiple of 4): reaching the bound is later work.
//
// Built with -fmad=false like the other sources (ops/_build.py); a shared
// library with a plain C interface, each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

template <bool kNormal>
__global__ void __launch_bounds__(256)
    random_kernel(float* out, long long rows, int cols, int groups,
                  uint32_t key0, uint32_t key1) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * groups) return;
  const long long row = idx / groups;
  const int g = static_cast<int>(idx - row * groups);
  float v[4];
  if (kNormal) {
    zs::normals4(0u, static_cast<uint32_t>(row), static_cast<uint32_t>(g),
                 zs::kStreamRandomNormal, key0, key1, v);
  } else {
    const zs::U4 b = zs::philox4x32_10(0u, static_cast<uint32_t>(row),
                                       static_cast<uint32_t>(g),
                                       zs::kStreamRandomUniform, key0, key1);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = zs::uniform_from_bits(zs::word(b, i));
  }
  float* dst = out + row * cols + 4 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * g + i < cols) dst[i] = v[i];
}

template <bool kNormal>
int launch(void* out, long long rows, int cols, uint32_t key0, uint32_t key1,
           void* stream) {
  if (out == nullptr || rows < 1 || rows > 0xFFFFFFFFll || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cols + 3) / 4;
  const long long blocks = (rows * groups + 255) / 256;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  random_kernel<kNormal><<<static_cast<unsigned>(blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), rows, cols, groups, key0, key1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out is a device pointer to a contiguous [rows, cols] float32 array. Each
// returns the CUDA error code of the launch (0 on success).
extern "C" int zs_gpu_normal(void* out, long long rows, int cols,
                             uint32_t key0, uint32_t key1, void* stream) {
  return launch<true>(out, rows, cols, key0, key1, stream);
}

extern "C" int zs_gpu_uniform(void* out, long long rows, int cols,
                              uint32_t key0, uint32_t key1, void* stream) {
  return launch<false>(out, rows, cols, key0, key1, stream);
}
