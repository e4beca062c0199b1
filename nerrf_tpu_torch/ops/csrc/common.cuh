// Shared helpers of the port's kernels: f32 <-> storage-type conversion and
// the launch shape of the warp-per-row reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerrf {

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// warp-per-row kernels: four warps (four output rows) per block
constexpr int kWarpsPerBlock = 4;
constexpr int kThreadsPerBlock = 32 * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

// a warp-per-row kernel keeps a row's sums in registers: lane l holds
// features l, l + 32, ..., so a row is at most 32 * kMaxChunks wide
constexpr int kMaxChunks = 8;

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

// Calls LAUNCH(C) with C = ceil(F / 32) as a compile-time constant (1 to
// kMaxChunks); any wider F returns cudaErrorInvalidValue.
#define NERRF_DISPATCH_CHUNKS(F, LAUNCH)                              \
  switch (((F) + 31) / 32) {                                          \
    case 1: LAUNCH(1); break;                                         \
    case 2: LAUNCH(2); break;                                         \
    case 3: LAUNCH(3); break;                                         \
    case 4: LAUNCH(4); break;                                         \
    case 5: LAUNCH(5); break;                                         \
    case 6: LAUNCH(6); break;                                         \
    case 7: LAUNCH(7); break;                                         \
    case 8: LAUNCH(8); break;                                         \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }
