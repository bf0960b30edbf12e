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
// the float32 peak, below it. The grid is a thread per group of 4 columns up
// to kBlocksPerSm blocks per SM; past that (1024 x 1024 is just below it) a
// thread walks the array in a grid-stride loop, kGroupsPerThread groups a
// pass (that many independent Philox calls in flight, all generated before
// any is stored), so a large array costs one wave of blocks and not one
// block per 1024 elements. One Philox call gives
// exactly a group's 4 outputs: where cols is a multiple of 4 (and the array
// starts on 16 bytes) a group is ONE 16-byte store; other widths keep four
// guarded 4-byte stores. The launch chooses between the two, and between
// 32-bit and 64-bit group indices (the division by the groups per row), by
// template flags, never per element.
//
// Built with -fmad=false like the other sources (ops/_build.py); a shared
// library with a plain C interface, each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 4;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices];  // 0 until read; racing readers agree

// kVector: cols % 4 == 0 and out is 16-byte aligned. Index: uint32_t where
// rows * groups and one more pass of the grid fit it, else unsigned long
// long.
template <bool kNormal, bool kVector, typename Index>
__global__ void __launch_bounds__(kThreads)
    random_kernel(float* __restrict__ out, Index total, int cols, int groups,
                  uint32_t key0, uint32_t key1) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  const Index first = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  // The launch keeps total + kGroupsPerThread * stride inside Index.
  for (Index base = first; base < total; base += kGroupsPerThread * stride) {
    float v[kGroupsPerThread][4];
#pragma unroll
    for (int u = 0; u < kGroupsPerThread; ++u) {
      const Index idx = base + u * stride;
      if (idx >= total) continue;
      const Index row = idx / static_cast<Index>(groups);
      const uint32_t g = static_cast<uint32_t>(idx - row * groups);
      if (kNormal) {
        zs::normals4(0u, static_cast<uint32_t>(row), g,
                     zs::kStreamRandomNormal, key0, key1, v[u]);
      } else {
        const zs::U4 b =
            zs::philox4x32_10(0u, static_cast<uint32_t>(row), g,
                              zs::kStreamRandomUniform, key0, key1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][i] = zs::uniform_from_bits(zs::word(b, i));
      }
    }
#pragma unroll
    for (int u = 0; u < kGroupsPerThread; ++u) {
      const Index idx = base + u * stride;
      if (idx >= total) continue;
      if (kVector) {
        reinterpret_cast<float4*>(out)[idx] =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
        const Index row = idx / static_cast<Index>(groups);
        const int g = static_cast<int>(idx - row * groups);
        float* dst = out + static_cast<unsigned long long>(row) * cols + 4 * g;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * g + i < cols) dst[i] = v[u][i];
      }
    }
  }
}

template <bool kNormal, bool kVector, typename Index>
void launch_as(float* out, unsigned long long total, int cols, int groups,
               uint32_t key0, uint32_t key1, unsigned blocks,
               cudaStream_t stream) {
  random_kernel<kNormal, kVector, Index><<<blocks, kThreads, 0, stream>>>(
      out, static_cast<Index>(total), cols, groups, key0, key1);
}

template <bool kNormal>
int launch(void* out, long long rows, int cols, uint32_t key0, uint32_t key1,
           void* stream) {
  if (out == nullptr || rows < 1 || rows > 0xFFFFFFFFll || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sm_count[device] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sm_count[device] = sms;
  }
  const int groups = (cols + 3) / 4;
  const unsigned long long total =
      static_cast<unsigned long long>(rows) * groups;
  // A thread a group while the array is small (the normals' arithmetic
  // wants every thread the card has); past kBlocksPerSm blocks per SM the
  // threads walk on, kGroupsPerThread groups a pass.
  const unsigned long long per_block = kThreads * kGroupsPerThread;
  const unsigned long long wanted = (total + kThreads - 1) / kThreads;
  const unsigned long long cap =
      static_cast<unsigned long long>(g_sm_count[device]) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(wanted < cap ? wanted : cap);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // 32-bit indices while every idx + u * stride stays below 2^32.
  const bool narrow = total + per_block * cap < 0xFFFFFFFFull;
  if (vec && narrow)
    launch_as<kNormal, true, uint32_t>(o, total, cols, groups, key0, key1,
                                       blocks, s);
  else if (vec)
    launch_as<kNormal, true, unsigned long long>(o, total, cols, groups, key0,
                                                 key1, blocks, s);
  else if (narrow)
    launch_as<kNormal, false, uint32_t>(o, total, cols, groups, key0, key1,
                                        blocks, s);
  else
    launch_as<kNormal, false, unsigned long long>(o, total, cols, groups, key0,
                                                  key1, blocks, s);
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
