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
// floor is msg + ids + weights + out over 3.35 TB/s.  Design: no one-hot
// contraction (that is a TPU device for scatters); one warp per (window,
// node) walks the node's band of both sorted views, given as row pointers
// the wrapper takes once per forward.  The warp reads the band's ids and
// weights 32 edges at a time (one coalesced load each), and the lanes then
// take the edges one by one from a register shuffle: each lane holds
// features lane, lane + 32, ... of the row in f32 registers, so one pass
// over the band reads every gathered msg row with neighbouring lanes on
// neighbouring features, and the row is written once.  An edge of weight 0
// is skipped (a ballot over the 32 loaded weights): it adds 0 for any finite
// msg, and the builder pads every window with weight-0 edges on its last
// node, so without the skip one warp would walk the whole padding tail.  No
// atomics, so the result is deterministic.  All windows of the batch are
// rows of one grid: one launch per call.
#include "common.cuh"

namespace nerrf {

// adds sum_{e in [e0, e1)} w[e] * msg[g[e]] to acc (lane's features)
template <typename T, int C>
__device__ __forceinline__ void sage_band(float (&acc)[C], const T* __restrict__ m,
                                          const int* __restrict__ g,
                                          const float* __restrict__ w, int e0, int e1,
                                          int N, int F, int lane) {
  for (int base = e0; base < e1; base += 32) {
    const int e = base + lane;
    int s = 0;
    float we = 0.f;
    if (e < e1) {
      s = g[e];
      we = w[e];
    }
    unsigned take = __ballot_sync(
        kFullMask, we != 0.f && static_cast<unsigned>(s) < static_cast<unsigned>(N));
    while (take) {  // take is the same in every lane
      const int j = __ffs(take) - 1;
      take &= take - 1;
      const int sj = __shfl_sync(kFullMask, s, j);
      const float wj = __shfl_sync(kFullMask, we, j);
      const T* r = m + static_cast<long long>(sj) * F;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        if (f < F) acc[c] += wj * to_f32(r[f]);
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreadsPerBlock)
sage_aggregate_kernel(const T* __restrict__ msg,
                      const int* __restrict__ ptr_f, const int* __restrict__ gidx_f,
                      const float* __restrict__ w_f,
                      const int* __restrict__ ptr_r, const int* __restrict__ gidx_r,
                      const float* __restrict__ w_r,
                      int B, int N, int E, int F, T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= static_cast<long long>(B) * N) return;  // whole warps leave together
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);

  const int* pf = ptr_f + static_cast<long long>(b) * (N + 1);
  const int* pr = ptr_r + static_cast<long long>(b) * (N + 1);
  const T* m = msg + static_cast<long long>(b) * N * F;
  const long long eb = static_cast<long long>(b) * E;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  sage_band<T, C>(acc, m, gidx_f + eb, w_f + eb, pf[n], pf[n + 1], N, F, lane);
  sage_band<T, C>(acc, m, gidx_r + eb, w_r + eb, pr[n], pr[n + 1], N, F, lane);

  T* o = out + row * F;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int f = lane + 32 * c;
    if (f < F) o[f] = from_f32<T>(acc[c]);
  }
}

template <typename T>
int launch_sage(const void* msg, const void* ptr_f, const void* gidx_f, const void* w_f,
                const void* ptr_r, const void* gidx_r, const void* w_r, int B, int N,
                int E, int F, void* out, cudaStream_t s) {
  const dim3 grid(row_blocks(static_cast<long long>(B) * N));
#define NERRF_SAGE_LAUNCH(C)                                                        \
  sage_aggregate_kernel<T, C><<<grid, kThreadsPerBlock, 0, s>>>(                    \
      static_cast<const T*>(msg), static_cast<const int*>(ptr_f),                   \
      static_cast<const int*>(gidx_f), static_cast<const float*>(w_f),              \
      static_cast<const int*>(ptr_r), static_cast<const int*>(gidx_r),              \
      static_cast<const float*>(w_r), B, N, E, F, static_cast<T*>(out))
  NERRF_DISPATCH_CHUNKS(F, NERRF_SAGE_LAUNCH)
#undef NERRF_SAGE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerrf

// msg [B,N,F] (f32 or bf16, F <= 256), ptr_* [B,N+1] int32, gidx_* [B,E]
// int32, w_* [B,E] f32, out [B,N,F] in msg's type.  Returns
// cudaGetLastError().
extern "C" int nerrf_sage_aggregate(const void* msg, int dtype,
                                    const void* ptr_f, const void* gidx_f, const void* w_f,
                                    const void* ptr_r, const void* gidx_r, const void* w_r,
                                    int B, int N, int E, int F, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nerrf::kBFloat16)
    return nerrf::launch_sage<__nv_bfloat16>(msg, ptr_f, gidx_f, w_f, ptr_r, gidx_r, w_r,
                                             B, N, E, F, out, s);
  if (dtype == nerrf::kFloat32)
    return nerrf::launch_sage<float>(msg, ptr_f, gidx_f, w_f, ptr_r, gidx_r, w_r, B, N, E,
                                     F, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
