// Row gather out[b, e] = table[b, idx[b, e]], a zero row where idx is out of
// range.
//
// Replaces the TPU kernel nerrf_tpu/ops/pallas_segment.py `_gather_call`
// (body `_gather_kernel`), reached through `gather_rows`, which builds the
// gather as a one-hot matrix product on the MXU.
//
// Bound on the H100: bytes (no arithmetic at all): the table rows the
// indices touch, the indices and the output, over 3.35 TB/s.  Design: a
// plain copy, one thread per output element on a grid-stride loop, so
// neighbouring threads read neighbouring features of one row and write
// neighbouring addresses (coalesced both ways).  The batch of windows is
// flattened into the one grid: one launch per call.
#include "common.cuh"

namespace nerrf {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                   int B, int N, int E, int F, T* __restrict__ out) {
  const long long total = static_cast<long long>(B) * E * F;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long be = i / F;  // flat (window, edge)
    const int f = static_cast<int>(i - be * F);
    const int b = static_cast<int>(be / E);
    const int r = idx[be];
    out[i] = static_cast<unsigned>(r) < static_cast<unsigned>(N)
                 ? table[(static_cast<long long>(b) * N + r) * F + f]
                 : from_f32<T>(0.f);
  }
}

}  // namespace nerrf

// table [B,N,F] (f32 or bf16), idx [B,E] int32, out [B,E,F] in table's
// type.  Returns cudaGetLastError().
extern "C" int nerrf_gather_rows(const void* table, int dtype, const void* idx,
                                 int B, int N, int E, int F, void* out, void* stream) {
  using namespace nerrf;
  const long long total = static_cast<long long>(B) * E * F;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    gather_rows_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), static_cast<const int*>(idx), B, N, E, F,
        static_cast<__nv_bfloat16*>(out));
  } else if (dtype == kFloat32) {
    gather_rows_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx), B, N, E, F,
        static_cast<float*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
