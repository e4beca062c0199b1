// Shared helpers of the port's kernels: f32 <-> storage-type conversion and
// the launch shape of the warp-per-chunk reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerrf {

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// warp-per-chunk kernels: four warps (four chunks) per block
constexpr int kWarpsPerBlock = 4;
constexpr int kThreadsPerBlock = 32 * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

inline unsigned int row_blocks(long long rows) {
  return static_cast<unsigned int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace nerrf
