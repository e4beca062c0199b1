// Banded segment sum over nondecreasing ids:
//   out[b, n] = sum_{e: ids[b, e] = n} data[b, e],  ids outside [0, N) dropped.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py
// `_segment_sum_sorted_call` (body `_segment_sum_sorted_kernel`), reached
// through `segment_sum_sorted`: per 128-node output tile, a one-hot MXU
// contraction over the band of edge tiles its (sorted) ids fall in.
//
// Bound on the H100: bytes: one add per input element, against the data,
// the ids and the output, over 3.35 TB/s.  Design: segment_chunks.cuh, the
// reduction segment_sum.cu runs, with the identity permutation: the ids are
// sorted, so each segment's rows are one contiguous run of `data` and the
// plan is the row pointers alone (one searchsorted, no sort).  Every
// segment is cut into chunks of at most L = 32 rows, one warp each, so the
// builder's padding band (1192 rows on each window's last node at the
// training rung) is 38 or 39 warps' work, not one's.  Wide rows (F = 160)
// go lanes over 16-byte packs with up to 8 rows in flight; narrow rows
// (F <= 16, e.g. the weight denominators of `segment_mean`, F = 1) go lanes
// over rows and features (a chunk's 32 rows in one step at F = 1), the row
// groups folded with shuffles in a fixed order.  The chunks of a long
// segment combine through f32 partials, added in chunk order by the last to
// arrive, in the same launch (faster on the H100 than a second launch,
// PERF.md).  Deterministic, no atomics on values.  Ids outside [0, N) sort before the
// first pointer or after the last and are never read.  One launch for the
// whole batch.
#include "segment_chunks.cuh"

// data [B,E,F] (f32 or bf16, F <= 256), ptr [B,N+1] int32, partial
// [B,N+ceil(E/32),F] f32 scratch, arrivals [B,N] int32 (zero, and left
// zero), out [B,N,F] in data's type.  Returns cudaGetLastError().
extern "C" int nerrf_segment_sum_sorted(const void* data, int dtype, const void* ptr, int B,
                                        int N, int E, int F, void* partial, void* arrivals,
                                        void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int*>(ptr);
  if (dtype == nerrf::kBFloat16) {
    using T = __nv_bfloat16;
    return nerrf::launch_segment_chunks<T>(
        nerrf::RowsInPlace<T>{static_cast<const T*>(data), q, N, E, F}, B, N, E, F, partial,
        nullptr, arrivals, out, s);
  }
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_segment_chunks<float>(
        nerrf::RowsInPlace<float>{static_cast<const float*>(data), q, N, E, F}, B, N, E, F,
        partial, nullptr, arrivals, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
