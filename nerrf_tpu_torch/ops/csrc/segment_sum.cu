// Order-independent segment sum out[b, n] = sum_{s: ids[b, s] = n} data[b, s],
// ids outside [0, N) dropped.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py `_segment_sum_call`
// (body `_segment_sum_kernel`), reached through `segment_sum`, which builds
// the sum as a one-hot matrix product on the MXU.
//
// Bound on the H100: bytes: one add per input element, against the data,
// the ids and the output, over 3.35 TB/s.  Design: deterministic, no
// atomics.  The wrapper stable-sorts each window's ids and takes row
// pointers over the sorted ids, so each segment's rows are one contiguous
// run of the permutation, in their original order.  One warp per (window,
// segment) walks its run: it reads the run's row numbers 32 at a time (one
// coalesced load), then the lanes take the rows one by one from a register
// shuffle, each lane summing features lane, lane + 32, ... in f32
// registers, so neighbouring lanes read neighbouring features.  Rows
// outside [0, N) sort before the first pointer or after the last and are
// never read.  The same inputs give the same bits on every run.  One launch
// for the whole batch.
#include "common.cuh"

namespace nerrf {

template <typename T, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ ptr,
                   const int* __restrict__ perm, int B, int N, int S, int F,
                   T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= static_cast<long long>(B) * N) return;  // whole warps leave together
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);

  const int* p = ptr + static_cast<long long>(b) * (N + 1);
  const int p0 = p[n], p1 = p[n + 1];
  const int* pm = perm + static_cast<long long>(b) * S;
  const T* d = data + static_cast<long long>(b) * S * F;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int base = p0; base < p1; base += 32) {
    const int q = base + lane;
    const int mine = q < p1 ? pm[q] : 0;
    const int count = min(32, p1 - base);
    for (int j = 0; j < count; ++j) {
      const T* r = d + static_cast<long long>(__shfl_sync(kFullMask, mine, j)) * F;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        if (f < F) acc[c] += to_f32(r[f]);
      }
    }
  }

  T* o = out + row * F;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    if (f < F) o[f] = from_f32<T>(acc[c]);
  }
}

template <typename T>
int launch_segment_sum(const void* data, const void* ptr, const void* perm, int B, int N,
                       int S, int F, void* out, cudaStream_t s) {
  const dim3 grid(row_blocks(static_cast<long long>(B) * N));
#define NERRF_SEGMENT_SUM_LAUNCH(C)                                                  \
  segment_sum_kernel<T, C><<<grid, kThreadsPerBlock, 0, s>>>(                        \
      static_cast<const T*>(data), static_cast<const int*>(ptr),                     \
      static_cast<const int*>(perm), B, N, S, F, static_cast<T*>(out))
  NERRF_DISPATCH_CHUNKS(F, NERRF_SEGMENT_SUM_LAUNCH)
#undef NERRF_SEGMENT_SUM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerrf

// data [B,S,F] (f32 or bf16, F <= 256), ptr [B,N+1] int32 over the sorted
// ids, perm [B,S] int32 (stable sort order), out [B,N,F] in data's type.
// Returns cudaGetLastError().
extern "C" int nerrf_segment_sum(const void* data, int dtype, const void* ptr,
                                 const void* perm, int B, int N, int S, int F,
                                 void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nerrf::kBFloat16)
    return nerrf::launch_segment_sum<__nv_bfloat16>(data, ptr, perm, B, N, S, F, out, s);
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_segment_sum<float>(data, ptr, perm, B, N, S, F, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
