// Banded segment sum over nondecreasing ids:
//   out[b, n] = sum_{e: ids[b, e] = n} data[b, e],  ids outside [0, N) dropped.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py
// `_segment_sum_sorted_call` (body `_segment_sum_sorted_kernel`), reached
// through `segment_sum_sorted`: per 128-node output tile, a one-hot MXU
// contraction over the band of edge tiles its (sorted) ids fall in.
//
// Bound on the H100: bytes: one add per input element, against the data,
// the ids and the output, over 3.35 TB/s.  Design: the ids are already
// sorted, so the wrapper takes row pointers with one `searchsorted` (no
// sort, no permutation) and each segment's rows are one contiguous run of
// `data`.  One warp per (window, segment) walks its run and sums in f32
// registers, in row order, with no atomics: the same inputs give the same
// bits on every run.  Two shapes of the walk:
//   * wide rows (F > 16): lane l holds features l, l + 32, ..., the rows
//     taken one after another (neighbouring lanes on neighbouring
//     addresses; the loop is unrolled so several rows' loads are in flight);
//   * narrow rows (F <= 16, e.g. the weight denominators of
//     `segment_mean`, F = 1): F is rounded up to a power of two FP and the
//     warp takes 32 / FP rows at a time (lane l on row l / FP, feature
//     l % FP), then folds the row groups with shuffles in a fixed order.
//     A lane-per-feature walk would idle 31 of 32 lanes at F = 1.
// A long run (the builder pads every window with edges on its last node)
// is still one warp's work: one load latency per row (wide) or per 32 rows
// (F = 1).  Ids outside [0, N) sort before the first pointer or after the
// last and are never read.  One launch for the whole batch.
#include "common.cuh"

namespace nerrf {

template <typename T, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_sum_sorted_wide(const T* __restrict__ data, const int* __restrict__ ptr, int B,
                        int N, int E, int F, T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= static_cast<long long>(B) * N) return;  // whole warps leave together
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);

  const int* p = ptr + static_cast<long long>(b) * (N + 1);
  const int p0 = p[n], p1 = p[n + 1];
  const T* d = data + static_cast<long long>(b) * E * F;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int e = p0; e < p1; ++e) {
    const T* r = d + static_cast<long long>(e) * F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      if (f < F) acc[c] += to_f32(r[f]);
    }
  }

  T* o = out + row * F;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    if (f < F) o[f] = from_f32<T>(acc[c]);
  }
}

template <typename T, int FP>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_sum_sorted_narrow(const T* __restrict__ data, const int* __restrict__ ptr, int B,
                          int N, int E, int F, T* __restrict__ out) {
  constexpr int kGroups = 32 / FP;  // rows taken per step
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= static_cast<long long>(B) * N) return;  // whole warps leave together
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);

  const int* p = ptr + static_cast<long long>(b) * (N + 1);
  const int p0 = p[n], p1 = p[n + 1];
  const T* d = data + static_cast<long long>(b) * E * F;
  const int g = lane / FP;
  const int f = lane - g * FP;

  float acc = 0.f;
  if (f < F) {
    for (int e = p0 + g; e < p1; e += kGroups) acc += to_f32(d[static_cast<long long>(e) * F + f]);
  }
  // lane f (< FP) gathers the groups' partial sums: a fixed-order tree
#pragma unroll
  for (int off = FP; off < 32; off <<= 1) acc += __shfl_down_sync(kFullMask, acc, off);
  if (lane < F) out[row * F + lane] = from_f32<T>(acc);
}

template <typename T>
int launch_segment_sum_sorted(const void* data, const void* ptr, int B, int N, int E, int F,
                              void* out, cudaStream_t s) {
  const dim3 grid(row_blocks(static_cast<long long>(B) * N));
  const T* d = static_cast<const T*>(data);
  const int* p = static_cast<const int*>(ptr);
  T* o = static_cast<T*>(out);
  if (F <= 16) {
    const int fp = F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : F <= 8 ? 8 : 16;
    switch (fp) {
      case 1: segment_sum_sorted_narrow<T, 1><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o); break;
      case 2: segment_sum_sorted_narrow<T, 2><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o); break;
      case 4: segment_sum_sorted_narrow<T, 4><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o); break;
      case 8: segment_sum_sorted_narrow<T, 8><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o); break;
      default: segment_sum_sorted_narrow<T, 16><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
#define NERRF_SEGMENT_SUM_SORTED_LAUNCH(C) \
  segment_sum_sorted_wide<T, C><<<grid, kThreadsPerBlock, 0, s>>>(d, p, B, N, E, F, o)
  NERRF_DISPATCH_CHUNKS(F, NERRF_SEGMENT_SUM_SORTED_LAUNCH)
#undef NERRF_SEGMENT_SUM_SORTED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerrf

// data [B,E,F] (f32 or bf16, F <= 256), ptr [B,N+1] int32 row pointers over
// the nondecreasing ids, out [B,N,F] in data's type.  Returns
// cudaGetLastError().
extern "C" int nerrf_segment_sum_sorted(const void* data, int dtype, const void* ptr, int B,
                                        int N, int E, int F, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nerrf::kBFloat16)
    return nerrf::launch_segment_sum_sorted<__nv_bfloat16>(data, ptr, B, N, E, F, out, s);
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_segment_sum_sorted<float>(data, ptr, B, N, E, F, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
