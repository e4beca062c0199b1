// Fused bidirectional SAGE aggregation over sorted CSR edge views.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py `_sage_call`
// (body `_sage_kernel`), reached through `sage_aggregate_fused`:
//
//   out[b, n] = sum_{e: dst(e)=n} wf(e) * msg[b, src(e)]
//             + sum_{e: src(e)=n} wr(e) * msg[b, dst(e)]
//
// over the dst-sorted edge list and the src-sorted view of each window b,
// with pre-normalized f32 weights, f32 accumulation and empty rows exactly 0.
//
// Bound on the H100: bytes.  It does 2 flops per edge and feature against
// one msg row read per edge, far below the card's 295 flops per byte, so the
// floor is msg + ids + weights + out over 3.35 TB/s.  Design: the chunked
// reduction of segment_chunks.cuh (#3 and #4's) over one row space that
// joins both views (RowsSage): both id vectors are nondecreasing, so
// ptr_f + ptr_r is itself a row pointer, and node n's rows are its
// dst-view band followed by its src-view band.  The closed-form chunk map
// cuts that space into chunks of at most 32 rows, one warp each, so no band
// is left to one warp: the longest live band of the detection rung (1193
// edges, src view) is ~38 chunks, and a node whose two bands hold at most
// 32 edges (nearly all) is one chunk that writes its row directly.  A warp
// loads its chunk's gather indices and weights in one coalesced load,
// drops weight-0 edges (the builder's padding, ~2100 per view on each
// window's last node) with a ballot and packs the kept ones to the first
// lanes, then reads the gathered msg rows as 16-byte packs (F = 160 bf16:
// 20 lanes) with up to 8 rows in flight and sums w * row in f32.  A chunk
// whose 32 weights are all 0 writes no partial, only a per-slot flag; the
// last chunk of a long band to arrive adds the flagged-live partials in
// chunk order.  Deterministic, no atomics on values.  One launch for the
// whole batch.
#include "segment_chunks.cuh"

// msg [B,N,F] (f32 or bf16, F <= 256), ptr_* [B,N+1] int32, gidx_* [B,E]
// int32, w_* [B,E] f32, partial [B,N+ceil(2E/32),F] f32 and live
// [B,N+ceil(2E/32)] uint8 scratch, arrivals [B,N] int32 (zero, and left
// zero), out [B,N,F] in msg's type.  Returns cudaGetLastError().
extern "C" int nerrf_sage_aggregate(const void* msg, int dtype, const void* ptr_f,
                                    const void* gidx_f, const void* w_f, const void* ptr_r,
                                    const void* gidx_r, const void* w_r, int B, int N, int E,
                                    int F, void* partial, void* live, void* arrivals, void* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pf = static_cast<const int*>(ptr_f);
  const auto* gf = static_cast<const int*>(gidx_f);
  const auto* wf = static_cast<const float*>(w_f);
  const auto* pr = static_cast<const int*>(ptr_r);
  const auto* gr = static_cast<const int*>(gidx_r);
  const auto* wr = static_cast<const float*>(w_r);
  if (dtype == nerrf::kBFloat16) {
    using T = __nv_bfloat16;
    return nerrf::launch_segment_chunks<T>(
        nerrf::RowsSage<T>{static_cast<const T*>(msg), pf, gf, wf, pr, gr, wr, N, E, F}, B, N,
        2 * E, F, partial, live, arrivals, out, s);
  }
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_segment_chunks<float>(
        nerrf::RowsSage<float>{static_cast<const float*>(msg), pf, gf, wf, pr, gr, wr, N, E, F},
        B, N, 2 * E, F, partial, live, arrivals, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
