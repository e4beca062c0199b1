// Order-independent segment sum out[b, n] = sum_{s: ids[b, s] = n} data[b, s],
// ids outside [0, N) dropped.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py `_segment_sum_call`
// (body `_segment_sum_kernel`), reached through `segment_sum`, which builds
// the sum as a one-hot matrix product on the MXU.
//
// Bound on the H100: bytes: one add per input element, against the data,
// the ids and the output, over 3.35 TB/s.  Design (segment_chunks.cuh):
// rows are read through the plan's stable sort permutation (int64, as
// torch.sort gives it), so each segment is one contiguous run of it, in the
// rows' original order.  Every segment is cut into chunks of at most
// L = 32 rows, one warp each, so no segment is left to one warp: the
// builder's padding tail (1192 rows on one node per window at the training
// rung, 3121 at the detection rung) and the fusion's slot N (3189 rows)
// spread over the grid like any other rows.  L = 32 because a chunk's row
// numbers are then one coalesced load shared by shuffles, one chunk map
// serves every row width, and the longest segment's critical path is 32
// rows plus the add of its ceil(len / 32) + 1 partials.  Rows are read as
// 16-byte packs (F = 160 bf16: 20 lanes of 16 bytes) with up to 8 rows in
// flight and summed in f32.  The chunks of a long segment combine through
// f32 partials: the last chunk to arrive (an arrival counter) adds them in
// chunk order, in the same launch.  That route measured faster on the H100
// than a second launch for the combine (PERF.md).  Deterministic, no
// atomics on values.  A plan of nondecreasing ids has no permutation (perm
// is null) and serves here too.  One launch for the whole batch.
#include "segment_chunks.cuh"

// data [B,S,F] (f32 or bf16, F <= 256), perm [B,S] int64 or null, ptr
// [B,N+1] int32, partial [B,N+ceil(S/32),F] f32 scratch, arrivals [B,N]
// int32 (zero, and left zero), out [B,N,F] in data's type.  Returns
// cudaGetLastError().
extern "C" int nerrf_segment_sum(const void* data, int dtype, const void* perm,
                                 const void* ptr, int B, int N, int S, int F, void* partial,
                                 void* arrivals, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const long long*>(perm);
  const auto* q = static_cast<const int*>(ptr);
  if (dtype == nerrf::kBFloat16) {
    using T = __nv_bfloat16;
    return nerrf::launch_segment_chunks<T>(
        nerrf::RowsPerm<T>{static_cast<const T*>(data), p, q, N, S, F}, B, N, S, F, partial,
        nullptr, arrivals, out, s);
  }
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_segment_chunks<float>(
        nerrf::RowsPerm<float>{static_cast<const float*>(data), p, q, N, S, F}, B, N, S, F,
        partial, nullptr, arrivals, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
