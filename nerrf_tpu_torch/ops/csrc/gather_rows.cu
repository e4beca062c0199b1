// Row gather out[b, e] = table[b, idx[b, e]], a zero row where idx is out of
// range: the forward of `gather_rows` (#2) and the adjoint of the
// order-independent segment sum.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py `_gather_call`
// (body `_gather_kernel`), reached through `gather_rows`, which builds the
// gather as a one-hot matrix product on the MXU.  On the H100 it is the row
// copy of gather_rows.cuh (shared with gather_rows_sorted.cu, whose ids are
// sorted, which the copy does not need): one thread per 16-byte pack of an
// output row, bound by bytes; the header says more.
#include "gather_rows.cuh"

// table [B,N,F] (f32 or bf16), idx [B,E] int32, out [B,E,F] in table's
// type.  Returns cudaGetLastError().
extern "C" int nerrf_gather_rows(const void* table, int dtype, const void* idx,
                                 int B, int N, int E, int F, void* out, void* stream) {
  return nerrf::gather_rows(table, dtype, idx, B, N, E, F, out, stream);
}
