// Row gather by nondecreasing indices out[b, e] = table[b, idx[b, e]], a zero
// row where idx is out of range: the adjoint of the banded segment sum
// (segment_sum_sorted.cu), grad_data[e] = g[ids[e]].
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py
// `_gather_sorted_call` (body `_gather_sorted_kernel`), reached as the
// backward of `segment_sum_sorted`: per 128-edge tile, a one-hot MXU
// product against the band of 128-row table tiles its sorted indices span.
// On the H100 the band is free: this is the row copy of gather_rows.cuh, the
// same kernel as gather_rows.cu's (one thread per 16-byte pack of an output
// row, bound by bytes).  Sorted ids change nothing in it; the repeated reads
// of the builder's padding row are served by L1 and L2.
#include "gather_rows.cuh"

// table [B,N,F] (f32 or bf16), idx [B,E] int32 nondecreasing per window,
// out [B,E,F] in table's type.  Returns cudaGetLastError().
extern "C" int nerrf_gather_rows_sorted(const void* table, int dtype, const void* idx, int B,
                                        int N, int E, int F, void* out, void* stream) {
  return nerrf::gather_rows(table, dtype, idx, B, N, E, F, out, stream);
}
