// Exact softmax attention over [B, T, H, D], causal or not: a forward that
// keeps the scores on chip (online softmax) and a backward of two kernels
// that recompute them from the forward's row log-sum-exp.
//
// Replaces the reference's XLA attention, nerrf_tpu/parallel/ring.py
// `_attention_local` (reached through `ring_self_attention` at sp = 1): the
// materialised f32 softmax for T <= 1024, above it a blockwise scan with an
// online softmax over 512-wide key blocks, each block update rematerialised.
// It is no Pallas kernel; on the TPU XLA fuses it.
//
// Bound: operations.  At StreamNet's shapes (D = 128, T = 1024-4096) the two
// products cost 4·T²·D/2 flops a (b, h) causal forward against 8·T·D bytes
// of bf16 Q, K, V and O, hundreds of flops a byte, past the H100's ~295.
// This first kernel computes both products with f32 FMAs on the CUDA cores
// (not the tensor cores): every score, probability and sum is f32, for f32
// and bf16 inputs alike, so the same code serves the float32 parity checks.
// Design:
//  * tiles of 64 queries by 64 keys, 256 threads as 16 x 16; a thread owns
//    4 x 4 scores (rows ty + 16i, columns tx + 16j) and 4 rows of D / 16
//    output columns.  Tiles sit in shared memory as f32 rows padded to D + 1,
//    so the 16 threads of a half warp read 16 banks;
//  * forward: one block a (query tile, b, h); K and then V of a key tile
//    take turns in one buffer; scores scaled, masked (keys past T, and keys
//    after the query when causal), the running max, the denominator and the
//    output rescaled per key tile; writes O in the input type and the row
//    log-sum-exp m + log(l) in f32.  Causal blocks stop at the diagonal
//    tile, so no tile wholly in the future is read; the grid runs the
//    longest rows first;
//  * backward: dS = P o (dP - rowsum(dO o O)), P recomputed as
//    exp(scale·q·k - lse).  attention_bwd_dq: one block a query tile, over
//    the key tiles it sees, dQ += dS·K·scale.  attention_bwd_dkdv: one
//    block a key tile, over the query tiles that see it, dV += Pᵀ·dO and
//    dK += dSᵀ·Q·scale.  Each output element has one writer and every sum a
//    fixed order: no atomics, so two runs give the same bits.
// The products' tensor-core redesign (wgmma, TMA tiles, a producer warp)
// is later work.
#include <math.h>

#include "common.cuh"

namespace nerrf {
namespace attn {

constexpr int kTile = 64;                 // queries, and keys, per tile
constexpr int kSide = 16;                 // threads per side of the 16 x 16 block
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kTile / kSide;      // tile rows (and columns) per thread
constexpr int kPRow = kTile + 1;          // padded row of a score tile

struct Layout {  // element strides of a [B, T, H, D] operand (D's is 1)
  long long sb, st, sh;
  __device__ __forceinline__ long long base(int b, int h) const { return b * sb + h * sh; }
};

// rows [t0, t0 + kTile) of one (b, h) into s[kTile][D + 1] as f32, zero rows
// past T
template <typename Elem, int D>
__device__ __forceinline__ void load_tile(float* s, const Elem* x, long long base,
                                          long long st, int t0, int T) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    s[r * (D + 1) + d] = t < T ? to_f32(x[base + t * st + d]) : 0.f;
  }
}

// rowsum(dO o O) of rows [t0, t0 + kTile), four threads a row in a fixed
// order, and the rows' log-sum-exp (0 past T)
template <typename Elem, int D>
__device__ __forceinline__ void load_row_terms(float* delta, float* lse_s, const Elem* o,
                                               const Elem* dout, Layout ol, int b, int h,
                                               int H, const float* lse, int t0, int T) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, t = t0 + r;
  float acc = 0.f;
  if (t < T) {
    const long long row = ol.base(b, h) + t * ol.st;
    for (int d = part; d < D; d += 4)
      acc = fmaf(to_f32(dout[row + d]), to_f32(o[row + d]), acc);
  }
  acc += __shfl_xor_sync(kFullMask, acc, 1);
  acc += __shfl_xor_sync(kFullMask, acc, 2);
  if (part == 0) {
    delta[r] = acc;
    lse_s[r] = t < T ? lse[((long long)b * H + h) * T + t] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = kSide / 2; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = kSide / 2; off; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// s[i][j] += a[row i]·b[row j] over D, a and b tiles of padded rows; the
// thread's rows of a are ty + 16i, its rows of b tx + 16j
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kRows][kRows], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[kRows], y[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = a[(ty + kSide * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kRows; ++j) y[j] = b[(tx + kSide * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][c] += Σ_kk p[row ty + 16i][kk] · x[kk][tx + 16c], p a score tile,
// x a tile of padded rows
template <int D>
__device__ __forceinline__ void tile_apply(float (&acc)[kRows][D / kSide], const float* p,
                                           const float* x, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float w[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) w[i] = p[(ty + kSide * i) * kPRow + kk];
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) {
      const float xv = x[kk * (D + 1) + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(w[i], xv, acc[i][c]);
    }
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int T, int causal) {
  return qi < T && kj < T && (!causal || kj <= qi);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v, Layout in, Layout ol, int T, int H,
                     int causal, float scale, Elem* __restrict__ o,
                     float* __restrict__ lse) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sQ = smem;
  float* sKV = sQ + kTile * (D + 1);
  float* sP = sKV + kTile * (D + 1);
  const int nq = (T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int q0 = qt * kTile;
  load_tile<Elem, D>(sQ, q, base, in.st, q0, T);

  float acc[kRows][C], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads of sKV (V) and sP are done
    load_tile<Elem, D>(sKV, k, base, in.st, k0, T);
    __syncthreads();
    float s[kRows][kRows] = {};
    tile_dot<D>(s, sQ, sKV, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kSide * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kj = k0 + tx + kSide * j;
        // every row sees key k0 of each tile it visits (k0 <= q0 < T), so
        // the row max is finite and exp(-inf - max) is 0
        s[i][j] = (kj < T && (!causal || kj <= qi)) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kRows; ++j) sP[(ty + kSide * i) * kPRow + tx + kSide * j] = s[i][j];
    }
    __syncthreads();  // every read of K is done and sP is whole
    load_tile<Elem, D>(sKV, v, base, in.st, k0, T);
    __syncthreads();
    tile_apply<D>(acc, sP, sKV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= T) continue;
    const long long row = ol.base(b, h) + qi * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) o[row + tx + kSide * c] = from_f32<Elem>(acc[i][c] / l[i]);
    if (tx == 0) lse[((long long)b * H + h) * T + qi] = m[i] + logf(l[i]);
  }
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                        const Elem* __restrict__ v, Layout in, const Elem* __restrict__ o,
                        const Elem* __restrict__ dout, Layout ol,
                        const float* __restrict__ lse, int T, int H, int causal,
                        float scale, Elem* __restrict__ dq) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);
  float* sDelta = sS + kTile * kPRow;
  float* sLse = sDelta + kTile;
  const int nq = (T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int q0 = qt * kTile;
  load_tile<Elem, D>(sQ, q, base, in.st, q0, T);
  load_tile<Elem, D>(sdO, dout, ol.base(b, h), ol.st, q0, T);
  load_row_terms<Elem, D>(sDelta, sLse, o, dout, ol, b, h, H, lse, q0, T);

  float acc[kRows][C] = {};
  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads of sK and sS are done
    load_tile<Elem, D>(sK, k, base, in.st, k0, T);
    load_tile<Elem, D>(sV, v, base, in.st, k0, T);
    __syncthreads();
    float s[kRows][kRows] = {}, dp[kRows][kRows] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j;
        const float p = visible(q0 + r, k0 + c, T, causal)
                            ? expf(s[i][j] * scale - sLse[r]) : 0.f;
        sS[r * kPRow + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    tile_apply<D>(acc, sS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= T) continue;
    const long long row = ol.base(b, h) + qi * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[row + tx + kSide * c] = from_f32<Elem>(acc[i][c] * scale);
  }
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                          const Elem* __restrict__ v, Layout in, const Elem* __restrict__ o,
                          const Elem* __restrict__ dout, Layout ol,
                          const float* __restrict__ lse, int T, int H, int causal,
                          float scale, Elem* __restrict__ dk, Elem* __restrict__ dv) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sdS = sP + kTile * kPRow;
  float* sDelta = sdS + kTile * kPRow;
  float* sLse = sDelta + kTile;
  const int nq = (T + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // causal: the first key tiles are seen by the most rows
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int k0 = kt * kTile;
  load_tile<Elem, D>(sK, k, base, in.st, k0, T);
  load_tile<Elem, D>(sV, v, base, in.st, k0, T);

  float acc_k[kRows][C] = {}, acc_v[kRows][C] = {};
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's reads of sQ, sdO, sP, sdS and the row terms are done
    load_tile<Elem, D>(sQ, q, base, in.st, q0, T);
    load_tile<Elem, D>(sdO, dout, ol.base(b, h), ol.st, q0, T);
    load_row_terms<Elem, D>(sDelta, sLse, o, dout, ol, b, h, H, lse, q0, T);
    __syncthreads();
    // transposed tiles: rows are keys (ty + 16i), columns queries (tx + 16j)
    float s[kRows][kRows] = {}, dp[kRows][kRows] = {};
    tile_dot<D>(s, sK, sQ, ty, tx);
    tile_dot<D>(dp, sV, sdO, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j;
        const float p = visible(q0 + c, k0 + r, T, causal)
                            ? expf(s[i][j] * scale - sLse[c]) : 0.f;
        sP[r * kPRow + c] = p;
        sdS[r * kPRow + c] = p * (dp[i][j] - sDelta[c]);
      }
    }
    __syncthreads();
    tile_apply<D>(acc_v, sP, sdO, ty, tx);
    tile_apply<D>(acc_k, sdS, sQ, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty + kSide * i;
    if (kj >= T) continue;
    const long long row = ol.base(b, h) + kj * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row + tx + kSide * c] = from_f32<Elem>(acc_k[i][c] * scale);
      dv[row + tx + kSide * c] = from_f32<Elem>(acc_v[i][c]);
    }
  }
}

constexpr size_t fwd_smem(int D) { return sizeof(float) * (2 * kTile * (D + 1) + kTile * kPRow); }
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPRow + 2 * kTile);
}
constexpr size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPRow + 2 * kTile);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out0, *out1;
  Layout in, ol;
  int B, T, H, causal;
  float scale;
};

enum Entry { kFwd = 0, kDq = 1, kDkdv = 2 };

template <typename Elem, int D>
int launch(Entry which, const Args& a, cudaStream_t stream) {
  const int nt = (a.T + kTile - 1) / kTile;
  const dim3 grid(nt, a.B * a.H);
  const Elem *q = static_cast<const Elem*>(a.q), *k = static_cast<const Elem*>(a.k),
             *v = static_cast<const Elem*>(a.v), *o = static_cast<const Elem*>(a.o),
             *dout = static_cast<const Elem*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if (which == kFwd) {
    auto kern = attention_fwd_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
    kern<<<grid, kThreads, fwd_smem(D), stream>>>(q, k, v, a.in, a.ol, a.T, a.H, a.causal,
                                                  a.scale, static_cast<Elem*>(a.out0),
                                                  static_cast<float*>(a.out1));
  } else if (which == kDq) {
    auto kern = attention_bwd_dq_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(D));
    kern<<<grid, kThreads, dq_smem(D), stream>>>(q, k, v, a.in, o, dout, a.ol, lse, a.T, a.H,
                                                 a.causal, a.scale,
                                                 static_cast<Elem*>(a.out0));
  } else {
    auto kern = attention_bwd_dkdv_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem(D));
    kern<<<grid, kThreads, dkdv_smem(D), stream>>>(q, k, v, a.in, o, dout, a.ol, lse, a.T,
                                                   a.H, a.causal, a.scale,
                                                   static_cast<Elem*>(a.out0),
                                                   static_cast<Elem*>(a.out1));
  }
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch_d(Entry which, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<Elem, 16>(which, a, stream);
    case 32: return launch<Elem, 32>(which, a, stream);
    case 64: return launch<Elem, 64>(which, a, stream);
    case 128: return launch<Elem, 128>(which, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(Entry which, int dtype, int D, const Args& a, void* stream) {
  if (a.T <= 0 || a.B * a.H <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_d<float>(which, D, a, s);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(which, D, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace nerrf

using nerrf::attn::Args;
using nerrf::attn::Layout;

// q, k, v [B,T,H,D] (f32 or bf16, strides sb/st/sh, D contiguous) -> o
// [B,T,H,D] contiguous in their type, lse [B,H,T] f32.  Returns
// cudaGetLastError(); D other than 16, 32, 64, 128 -> cudaErrorInvalidValue.
extern "C" int nerrf_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                                   long long sb, long long st, long long sh, int B, int T,
                                   int H, int D, int causal, float scale, void* o, void* lse,
                                   void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kFwd, dtype, D, a, stream);
}

// o, dout contiguous [B,T,H,D], lse [B,H,T] f32 from the forward -> dq
// contiguous [B,T,H,D]
extern "C" int nerrf_attention_bwd_dq(const void* q, const void* k, const void* v, int dtype,
                                      long long sb, long long st, long long sh, const void* o,
                                      const void* dout, const void* lse, int B, int T, int H,
                                      int D, int causal, float scale, void* dq, void* stream) {
  Args a{q, k, v, o, dout, lse, dq, nullptr,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kDq, dtype, D, a, stream);
}

// as nerrf_attention_bwd_dq -> dk, dv contiguous [B,T,H,D]
extern "C" int nerrf_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        int dtype, long long sb, long long st, long long sh,
                                        const void* o, const void* dout, const void* lse,
                                        int B, int T, int H, int D, int causal, float scale,
                                        void* dk, void* dv, void* stream) {
  Args a{q, k, v, o, dout, lse, dk, dv,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kDkdv, dtype, D, a, stream);
}
